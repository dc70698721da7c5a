"""Times K5q (the int8 pool's decode attention), and a decode step's write
and attention (QW then K5q, and K5q with the write folded in), at the
serving step's own cache state, for one or more checkouts of this
repository, on one NVIDIA GPU.

    python3 chip_k5q_real.py capture
    python3 chip_k5q_real.py time <checkout> [<checkout> ...]

``capture`` serves phase 5f(c) with this checkout: Llama-3-8B (all 32
layers, random bf16 weights from seed 0) quantized to int8 weights behind
the paged engine with an int8 pool of phase 5b's bytes, on
``chip_smoke.paged_workload``'s fifteen requests, the decode step run
eagerly (``chip_smoke.eager_decode_step``, whose streams the captured step
must equal) so that every K5q call passes through its wrapper. It records
the inputs of every layer-0 call, each step's q, block table, positions,
kv_valid and (K5q with the write) new K/V rows and first column, and after
the run layer 0's pools and scales, into git-ignored ``build/k5q_real.pt``. Phase 2's geometries are synthetic; these are the
cache states the serving step attends, with its dead ranges and slot
lengths.

``time`` imports ``neuronx_distributed_tpu_torch`` from each checkout in a
process of its own (so each runs its own K5q; the ``chip_smoke.py`` beside
this script), builds its kernels, and
runs every recorded call: each result must equal K4 on the dequantized
gathered view bit for bit (that checkout's K4). Then it times the calls
as CUDA-graph replays two ways: ``cold_ms``, the recorded calls in order,
each reading the next of ``chip_smoke.K5Q_COLD_COPIES`` copies of the pools
(more bytes than L2 holds, as a serving step's 32 layers read theirs from
device memory); ``warm_ms``, every call on one copy. Then the same two
ways each recorded step's write and attention: QW then K5q (``qw_k5q_*``;
the window's page from the table and the first column) and, where the
checkout has it, K5q with the write (``fused_*``), which must first equal
QW then K5q bit for bit on every call (pools but the null page, out, lse).
Each checkout prints one JSON line; to compare checkouts on one card, name
them in the order old, new, new, old.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
STATE = os.path.join(ROOT, "build", "k5q_real.pt")


def capture() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, llama3_8b
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig

    _build.build(["flash_attention", "flash_decode", "dequantize", "kv_quant"])
    model = init_params(LlamaForCausalLM(llama3_8b()), seed=0)
    cfg = model.config
    layers, d, hkv, ps = cfg.num_layers, cfg.head_dim_, cfg.num_kv_heads, cs.PAGE
    bf16_pages = cs.ROW_SLOTS * cfg.max_seq_len // ps + 1
    n_pages = bf16_pages * (2 * layers * ps * hkv * d * 2) // (2 * layers * (ps * hkv * d + hkv * 2))
    calls, pools = [], []
    kernel_call = tfd._qpaged_kernel_call

    def record(q, k_pool, v_pool, k_scale, v_scale, block_table, q_pos, kv_valid, page_size,
               write=None):
        if not pools:
            pools.append((k_pool, v_pool, k_scale, v_scale))
        if k_pool.data_ptr() == pools[0][0].data_ptr():  # layer 0
            calls.append(dict(q=q.clone(), bt=block_table.clone(), pos=q_pos.clone(),
                              valid=None if kv_valid is None else kv_valid.clone(),
                              **({} if write is None else
                                 dict(k=write[0].clone(), v=write[1].clone(),
                                      w0=write[2].clone()))))
        return kernel_call(q, k_pool, v_pool, k_scale, v_scale, block_table, q_pos, kv_valid,
                           page_size, write=write)

    tfd._qpaged_kernel_call = record
    try:
        r = cs.serve_paged(model, cs.paged_workload(cfg.vocab_size), "fused", eager=True,
                           quantize=QuantConfig(weights="int8", kv="int8"), num_pages=n_pages)
    finally:
        tfd._qpaged_kernel_call = kernel_call
    kq, vq, ks, vs = (t.clone() for t in pools[0])
    os.makedirs(os.path.dirname(STATE), exist_ok=True)
    torch.save(dict(calls=calls, kq=kq, vq=vq, ks=ks, vs=vs, page_size=ps, n_pages=n_pages), STATE)
    live = [int(c["valid"].sum()) if c["valid"] is not None else None for c in calls]
    print(json.dumps(dict(captured=len(calls), steps=r["snap"]["executed_steps"], pool_pages=n_pages,
                          slots=int(calls[0]["q"].shape[0]), bound_cols=[int(c["pos"].max()) + 1
                                                                          for c in calls],
                          live_cols=live)), flush=True)
    return 0


CHILD = r"""
import importlib.util, json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(sys.argv[2], "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from neuronx_distributed_tpu_torch.kernels import _build
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd

_build.build(["flash_decode", "kv_quant"])
st = torch.load(sys.argv[3], map_location="cuda")
ps, calls = st["page_size"], st["calls"]
kq, vq, ks, vs = st["kq"], st["vq"], st["ks"], st["vs"]
for c in calls:
    out, lse = tfd.paged_flash_decode_fwd(c["q"], kq, vq, c["bt"], c["pos"], c["valid"], ps, ks, vs)
    kg = tfd.paged_gather_leaf_dequant(kq, ks, c["bt"], ps)
    vg = tfd.paged_gather_leaf_dequant(vq, vs, c["bt"], ps)
    row, row_lse = tfd.flash_decode_fwd(c["q"], kg, vg, c["pos"], c["valid"])
    if not (torch.equal(out, row) and torch.equal(lse, row_lse)):
        raise AssertionError("K5q differs from K4 on the dequantized gathered view")
    del kg, vg
torch.cuda.empty_cache()
copies = [(kq, vq, ks, vs)] + [tuple(t.clone() for t in (kq, vq, ks, vs))
                               for _ in range(cs.K5Q_COLD_COPIES - 1)]
def run(cold):
    for i, c in enumerate(calls):
        k, v, a, b = copies[i % len(copies) if cold else 0]
        tfd.paged_flash_decode_fwd(c["q"], k, v, c["bt"], c["pos"], c["valid"], ps, a, b)
from neuronx_distributed_tpu_torch.kernels import kv_quant as tkq
fused = getattr(tfd, "qpaged_write_attend_fwd", None)
def two(c, k, v, a, b):
    # QW then K5q: the step's one window page a slot (s = 1)
    first = c["w0"] // ps
    tkq.window_requantize_fwd(k, v, a, b, c["bt"][:, first].long(), c["w0"] - first * ps,
                              c["k"], c["v"])
    return tfd.paged_flash_decode_fwd(c["q"], k, v, c["bt"], c["pos"], c["valid"], ps, a, b)
def one(c, k, v, a, b):
    return fused(c["q"], c["k"], c["v"], k, v, a, b, c["bt"], c["pos"], c["valid"], c["w0"], ps)
if fused is not None:
    for c in calls:
        base = [t.clone() for t in copies[0]]
        want = two(c, *copies[0])
        want_pools = [t.clone() for t in copies[0]]
        for t, x in zip(copies[0], base):
            t.copy_(x)
        got = one(c, *copies[0])
        if not (all(torch.equal(t[1:], w[1:]) for t, w in zip(copies[0], want_pools))
                and all(torch.equal(x, y) for x, y in zip(got, want))):
            raise AssertionError("K5q with the write differs from QW then K5q")
        del base, want_pools
def steps(fn, cold):
    for i, c in enumerate(calls):
        fn(c, *copies[i % len(copies) if cold else 0])
out = dict(tree=sys.argv[1], calls=len(calls))
for _ in range(2):  # the second reading shows the spread
    out.setdefault("cold_ms", []).append(cs.graph_ms(lambda: run(True), 1) / len(calls))
    out.setdefault("warm_ms", []).append(cs.graph_ms(lambda: run(False), 1) / len(calls))
    if "w0" in calls[0]:
        for name, fn in (("qw_k5q", two), ("fused", one)):
            if fn is one and fused is None:
                continue
            for cold in (True, False):
                out.setdefault(f"{name}_{'cold' if cold else 'warm'}_ms", []).append(
                    cs.graph_ms(lambda: steps(fn, cold), 1) / len(calls))
print("RESULT " + json.dumps(out), flush=True)
"""


def time_trees(trees) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(dict(card=card)), flush=True)
    failed = 0
    for tree in trees:
        r = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(tree), ROOT, STATE],
                           capture_output=True, text=True)
        line = next((x for x in r.stdout.splitlines() if x.startswith("RESULT ")), None)
        if line is None:
            failed += 1
            print(f"{tree} failed (rc {r.returncode}):\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}",
                  flush=True)
        else:
            print(line[len("RESULT "):], flush=True)
    return 1 if failed else 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_k5q_real: no CUDA device is available", file=sys.stderr)
        return 1
    if len(sys.argv) >= 2 and sys.argv[1] == "capture":
        return capture()
    if len(sys.argv) >= 3 and sys.argv[1] == "time":
        return time_trees(sys.argv[2:])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
