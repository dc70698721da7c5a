"""Times variants of the multi-row decode kernels (K4 and K5 above 32 rows a
kv-head) on one NVIDIA GPU.

    python3 chip_decode_variants.py [name,name,...]

Each variant is this checkout's ``neuronx_distributed_tpu_torch`` copied
into ``build/variants/<name>`` (git-ignored) with source substitutions in
``csrc/flash_decode.cu``, built there and run in a process of its own, in
the order given (default: every variant, the first again at the end, to
show the spread). Variants that keep the kernel's function are checked by
``chip_smoke.check_decode_rows`` (the limits, bitwise reproducibility, K5 =
K4 gathered) and timed by it; those named ``*_t`` change the arithmetic to
show what a part of it costs and are timed only, on the same inputs. Each
prints one JSON line: per R (64, 1024, 2048 rows a kv-head at phase 5c's
geometry), K4's and K5's time as CUDA-graph replays, and the registers
``ptxas`` gave the multi-row kernels.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

WGS = "constexpr int RWGS = 3;"
STAGES = "constexpr int RSTAGES = 2;"
VARIANTS = {  # name: (old, new) substitutions in csrc/flash_decode.cu
    "wg3": [],                                   # as built: three warpgroups a block
    "wg2": [(WGS, WGS.replace("3", "2"))],
    "wg1": [(WGS, WGS.replace("3", "1"))],       # one warpgroup, two blocks an SM
    "wg1_stages4": [(WGS, WGS.replace("3", "1")), (STAGES, STAGES.replace("2", "4"))],
    "wg3_no_lo_t": [("    rs_product(o, pl, v_desc, 1);\n", "")],  # P V with P_hi only
    "wg3_no_exp_t": [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "  y = x;")],
}

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[3])
import torch
import chip_smoke as cs
from neuronx_distributed_tpu_torch.kernels import _build
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd

_build.build(["flash_decode"])
report = _build.resource_report("flash_decode").splitlines()
regs = [next(x for x in report[i:] if "Used" in x).split("Used")[1].split(",")[0].strip()
        for i, line in enumerate(report) if "entry function" in line and "_rows" in line]
gen = torch.Generator(device="cuda").manual_seed(0)
rows = {}
for chunk in (16, 256, 512):
    if sys.argv[2].endswith("_t"):  # not the kernel's function: timed only
        q, kc, vc, pos, valid = cs.rows_inputs(gen, chunk)
        kp, vp, bt = cs.scrambled_pages(kc, vc, valid)
        rows[4 * chunk] = dict(
            ms=cs.graph_ms(lambda: tfd.flash_decode_fwd(q, kc, vc, pos, valid), 5),
            paged_ms=cs.graph_ms(lambda: tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, 16), 5))
    else:
        r = cs.check_decode_rows(gen, chunk)
        rows[4 * chunk] = dict(ms=r["ms"], paged_ms=r["paged_ms"], ratio=r["ratio"])
print("RESULT " + json.dumps(dict(variant=sys.argv[2], rows=rows, regs=regs)), flush=True)
"""


def make(name: str) -> str:
    """The variant's copy of the package; returns the directory to import from."""
    dst = os.path.join(ROOT, "build", "variants", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "neuronx_distributed_tpu_torch"),
                    os.path.join(dst, "neuronx_distributed_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(dst, "neuronx_distributed_tpu_torch", "csrc", "flash_decode.cu")
    with open(src) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    return dst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_decode_variants: no CUDA device is available", file=sys.stderr)
        return 1
    order = sys.argv[1].split(",") if len(sys.argv) > 1 else [*VARIANTS, next(iter(VARIANTS))]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(dict(card=card)), flush=True)
    trees = {name: make(name) for name in dict.fromkeys(order)}
    failed = 0
    for name in order:
        r = subprocess.run([sys.executable, "-c", CHILD, trees[name], name, ROOT],
                           capture_output=True, text=True)
        line = next((x for x in r.stdout.splitlines() if x.startswith("RESULT ")), None)
        if line is None:
            failed += 1
            print(f"variant {name} failed (rc {r.returncode}):\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}",
                  flush=True)
        else:
            print(line[len("RESULT "):], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
