"""Times the routed expert product (MX/MXq) of one checkout of this
repository on one NVIDIA GPU, at four depths:

    python3 chip_moe_ab.py <checkout>           # phase 5m(a): the bf16 decode step
    python3 chip_moe_ab.py --int8 <checkout>    # phase 5m(c): 32 int8 layers
    python3 chip_moe_ab.py --kernel <checkout>  # MX/MXq alone on phase 2's cases
    python3 chip_moe_ab.py --sass <checkout>    # their instruction counts

It imports ``neuronx_distributed_tpu_torch`` from ``<checkout>`` (so the
kernels built and the model run are that checkout's) and the helpers of
the ``chip_smoke.py`` beside this script, so two checkouts meet the same
inputs and the same timing.

The step modes make ``mixtral_8x7b`` (every width kept, random weights from
seed 0): cut to 16 layers in bf16, or all 32 with int8 weights filled
weight by weight; they serve ``chip_smoke.serve``'s six requests through a
row engine at 8 slots (the decode step captured once and replayed), then
the same requests once more under the profiler, and print one JSON line:
the card, ms a decode-only step (host wall), decode tokens/s (chunk wall),
TTFT mean, the device's idle share, and the profiled run's device ms by
kernel family with its executed decode steps.

``--kernel`` makes phase 2's Mixtral-8x7B expert stacks (bf16, int8, fp8,
seed 0) and times each of ``chip_smoke.MX_CASES`` as phase 2 does (a CUDA
graph of 10 calls, replayed), beside its bound and, at T = 8 random, the
library call; and the device ms a call of each of its CUDA kernels under
the profiler; one JSON line. ``--sass`` runs ``cuobjdump -sass`` on the
checkout's built ``moe_experts`` library and counts, for each kernel,
the instructions by opcode (the full listing goes to
``chiprun_out/moe_sass_<tree name>.txt``); one JSON line.

To compare two checkouts on one card, run them back to back as old, new,
new, old.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

MODES = ("--int8", "--kernel", "--sass")


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def step_mode(cs, tree: str, int8: bool) -> dict:
    import torch

    from neuronx_distributed_tpu_torch.models.mixtral import (
        MixtralForCausalLM,
        init_params,
        mixtral_8x7b,
    )
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig

    if int8:
        cfg = mixtral_8x7b(quantization=QuantConfig(weights="int8").weight_qconfig())
    else:
        cfg = mixtral_8x7b(num_layers=cs.MOE_LAYERS_BF16)
    model = init_params(MixtralForCausalLM(cfg), seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.MX_KERNELS += ("routed_rows_kernel",)  # a checkout from before the wgmma kernel
    layers = cfg.num_layers  # 5m(c)'s DQ launches: a decode step's, a prefill's
    srv = cs.serve(model, gen, dq=(4 * layers + 1, 7 * layers + 1) if int8 else None)
    prof = cs.profile_serving(model, srv["workload"])
    snap = srv["snap"]
    busy = sum(prof["fams"].values())
    wall_ms = 1e3 * (srv["wall_s"] - snap["capture_s"])
    return dict(
        weights="int8" if int8 else "bf16", layers=layers,
        step_ms=1e3 * srv["decode_s"] / max(srv["decode_only_executed"], 1),
        tokens_per_s=snap["chunk_tokens_per_sec"], ttft_mean_s=snap["mean_ttft"],
        idle_share=1 - busy / wall_ms, device_ms=prof["fams"], executed=prof["executed"],
        per_replay=srv["per_replay"])


def by_kernel(fn, calls: int = 3) -> dict:
    """Device ms a call of each CUDA kernel ``fn`` launches (the profiler,
    after one call outside it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = collections.Counter()
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            m = re.search(r"(\w+_kernel(?:<[^>]*>)?)", e.name)
            ms[m.group(1) if m else e.name[:60]] += e.device_time / 1e3 / calls
    return dict(ms)


def kernel_mode(cs) -> dict:
    import torch

    from neuronx_distributed_tpu_torch.kernels import moe_experts as mx

    gen = torch.Generator(device="cuda").manual_seed(0)
    weights = cs.mx_weights(gen)
    res = {}
    for case, t in cs.MX_CASES:
        x = torch.randn(t, cs.MX_H, generator=gen, device="cuda").to(torch.bfloat16)
        top_e, top_w = cs.mx_routes(gen, case, t)
        for kind, ws in weights.items():
            args = (x, top_e, top_w, *cs.mx_args(ws))
            bound, _, touched, _ = cs.mx_bound(x, top_e, ws)
            r = dict(ms=cs.graph_ms(lambda: mx._kernel_call(*args), 10), bound_ms=bound,
                     touched=touched)
            r["by_kernel"] = by_kernel(lambda: mx._kernel_call(*args))
            if case == "random" and t == 8:
                with cs.f32_reductions():
                    r["library_ms"] = cs.graph_ms(cs.mx_library(x, top_e, top_w, ws, kind), 5)
            res[f"{kind} {case} T={t}"] = r
            torch.cuda.empty_cache()
    return dict(cases=res)


def sass_mode(tree: str) -> dict:
    from neuronx_distributed_tpu_torch.kernels import _build

    _build.build(["moe_experts"])
    lib = os.path.join(_build.BUILD_DIR, _build.lib_name("moe_experts"))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=600).stdout
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"moe_sass_{os.path.basename(tree)}.txt"), "w") as f:
        f.write(text)
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            if os.path.exists(filt):
                name = subprocess.run([filt, name], capture_output=True, text=True,
                                      timeout=60).stdout.strip() or name
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None:
            counts[name][m.group(1)] += 1
    return dict(lib=os.path.basename(lib),
                kernels={k: dict(total=sum(c.values()), **dict(c.most_common()))
                         for k, c in counts.items()})


def main() -> int:
    mode = next((a for a in sys.argv[1:] if a in MODES), None)
    tree = os.path.abspath(sys.argv[-1])
    sys.path.insert(0, tree)
    import torch

    if mode != "--sass" and not torch.cuda.is_available():
        print("chip_moe_ab: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "--sass":
        res = sass_mode(tree)
    else:
        cs = load_smoke()
        from neuronx_distributed_tpu_torch.kernels import _build

        _build.build(["flash_attention", "flash_decode", "dequantize", "moe_experts"])
        res = kernel_mode(cs) if mode == "--kernel" else step_mode(cs, tree, mode == "--int8")
    print(json.dumps(dict(tree=tree, mode=mode or "step", card=card(), **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
