"""Times the decode kernels K4 (row cache) and K5 (paged cache) and the
serving paths of one checkout of this repository on one NVIDIA GPU.

    python3 chip_decode_ab.py [--int8-only] <checkout>

It imports ``neuronx_distributed_tpu_torch`` from ``<checkout>`` (so the
kernels built are that checkout's) and the input builders and serving
phases of the ``chip_smoke.py`` beside this script, so two checkouts meet
the same inputs and the same timing. It builds the checkout's kernels
first, so no build falls inside a timed phase. K4 at
``chip_smoke.check_k4``'s shapes and K5 at both of ``check_k5``'s
geometries, each timed two ways: 20 calls captured in one CUDA graph and
replayed (device time, the host taken out) and 50 calls back to back (CUDA
events; the host's issue time where it exceeds the device's); and their
multi-row path (R = 64, 1024 and 2048 rows a kv-head) at
``chip_smoke.check_decode_rows``'s inputs, K5 through its scrambled table,
as CUDA-graph replays; K5q (the int8 pool's decode attention) at both of
``check_k5``'s geometries over ``quantize_page_block``'s int8 pages, the
same two ways. Then Llama-3-8B (all 32 layers, random bf16 weights
from seed 0) serves ``chip_smoke.serve``'s six requests and the paged
engine ``chip_smoke.paged_workload``'s fifteen, each once more under the
profiler for device time by kernel family (and, for the paged run, the
caching allocator's device allocations); then phase 5c's prefix-cache
traffic (``chip_smoke.serve_prefix``) on the row and the paged engine,
prefix cache on and off, with the prefill wall by kind, and the row
engine's prefix-on wave once more under the profiler
(``chip_smoke.profile_prefix``: device time by family, the multi-row K4
among them, and the device time inside the suffix prefills); then
``chip_smoke.quant_phase``'s int8-pool leg, 5f(c): int8 weights and an
int8 page pool of phase 5b's bytes on the fifteen paged requests, its ms a
decode-only step, tokens/s and, once more under the profiler, its device
time by family. Where the checkout's engine captures its
decode step in a CUDA graph, the capture's wall is reported apart and taken
out of the wall the idle share is read against, and the profiled runs
capture before the profiler opens. It prints one JSON line: per serving
path, ms per decode-only step, decode tokens/s, TTFT mean and max, and the
idle share; per prefix engine, the prefill wall by kind, TTFT and the
wall, prefix on and off; for the int8 pool the same as per serving path. To compare two checkouts on one card, run them
back to back as old, new, new, old. ``--int8-only`` runs the int8 pool's
parts alone: K5q at both geometries (also with its pages read from device
memory, ``chip_smoke.k5q_cold_ms``); a decode step's write and attention
there, QW then K5q in one CUDA graph against K5q with the write folded in
(``qpaged_write_attend_fwd``, where the checkout has it; its result checked
bit for bit against QW then K5q first); and 5f(c).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys


def prefix_serving(cs, model) -> dict:
    """Phase 5c's traffic on the row and the paged engine, prefix cache on
    and off: the prefill wall by kind (full, suffix: sum, count, mean), TTFT
    and the wall; then the row engine's prefix-on wave under the profiler."""
    from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache

    workload = cs.prefix_workload(model.config.vocab_size)
    out = {}
    for paged in (False, True):
        for on in (True, False):
            r = cs.serve_prefix(model, workload, paged, PrefixCache() if on else None)
            cs.drain_prefix_store(r)
            d = r["delta"]
            out[f"{'paged' if paged else 'row'}_{'on' if on else 'off'}"] = dict(
                wall_s=r["wall_s"], ttft_mean_s=sum(r["ttft"]) / len(r["ttft"]),
                ttft_max_s=max(r["ttft"]), hits=d["prefix_hits"], misses=d["prefix_misses"],
                **{f"prefill_{k}_{x}": d[f"prefill_{k}_{x}"] for k in ("full", "suffix")
                   for x in ("wall_s", "count")},
                **{f"prefill_{k}_mean_s": d[f"prefill_{k}_wall_s"] / max(d[f"prefill_{k}_count"], 1)
                   for k in ("full", "suffix")})
    row = out["row_on"]
    out["row_on_profile"] = cs.profile_prefix(model, workload, row["wall_s"],
                                              row["prefill_suffix_wall_s"])
    return out


def int8_pool_serving(cs, model, workload) -> dict:
    """Phase 5f(c): int8 weights and an int8 pool of phase 5b's bytes behind
    the paged engine on ``workload``; then once more under the profiler."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig

    cfg = model.config
    layers, d, hkv, ps = cfg.num_layers, cfg.head_dim_, cfg.num_kv_heads, cs.PAGE
    bf16_pages = cs.ROW_SLOTS * cfg.max_seq_len // ps + 1
    n_pages = bf16_pages * (2 * layers * ps * hkv * d * 2) // (2 * layers * (ps * hkv * d + hkv * 2))
    qc = QuantConfig(weights="int8", kv="int8")
    r = cs.serve_paged(model, workload, "fused", quantize=qc, num_pages=n_pages, strict=False)
    prof = cs.serve_paged(model, workload, "fused", profiled=True, quantize=qc, num_pages=n_pages,
                          strict=False)
    sn = r["snap"]
    return dict(
        wall_s=r["wall_s"], capture_s=r["capture_s"], pool_pages=n_pages,
        ttft_mean_s=sn["mean_ttft"], decode_tok_s=sn["chunk_tokens_per_sec"],
        ms_per_decode_step=1e3 * r["decode_s"] / max(r["decode_executed"], 1),
        per_replay=r["per_replay"], device_ms=prof["fams"], k5q_records=prof["records"],
        idle_share=1 - sum(prof["fams"].values()) / (1e3 * (r["wall_s"] - r["capture_s"])),
        tokens_equal_profiled_rerun=prof["tokens"] == r["tokens"])


def write_attend_times(cs, tfd, q, kq, vq, ks, vs, bt, pos, valid) -> dict:
    """A decode step's write then attention at K5q's inputs: one new K/V row
    a slot at the last position (its page re-quantized), QW then K5q as one
    CUDA graph (20 steps a replay), and, where the checkout has it, K5q with
    the write, first checked against QW then K5q bit for bit (pools but the
    null page, out, lse)."""
    import torch

    from neuronx_distributed_tpu_torch.kernels import kv_quant as tkq

    gen = torch.Generator(device="cuda").manual_seed(4)
    b, hkv = q.shape[0], kq.shape[2]
    k = torch.randn(b, 1, hkv, 128, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(b, 1, hkv, 128, generator=gen, device="cuda").to(torch.bfloat16)
    c0 = pos[-1:].long()
    pages = bt[:, c0 // 16].long()  # one window page a slot at s = 1
    w0 = c0 - c0 // 16 * 16
    leaves = (kq, vq, ks, vs)

    def two():
        tkq.window_requantize_fwd(*leaves, pages, w0, k, v)
        return tfd.paged_flash_decode_fwd(q, kq, vq, bt, pos, valid, 16, ks, vs)

    out = dict(qw_k5q_ms=cs.graph_ms(two, 20))
    if hasattr(tfd, "qpaged_write_attend_fwd"):
        def fused():
            return tfd.qpaged_write_attend_fwd(q, k, v, *leaves, bt, pos, valid, c0, 16)

        base = [t.clone() for t in leaves]
        want = two()
        want_pools = [t.clone() for t in leaves]
        for t, x in zip(leaves, base):
            t.copy_(x)
        got = fused()
        if not (all(torch.equal(t[1:], w[1:]) for t, w in zip(leaves, want_pools))
                and all(torch.equal(x, y) for x, y in zip(got, want))):
            raise AssertionError("K5q with the write differs from QW then K5q")
        out["fused_ms"] = cs.graph_ms(fused, 20)
    return out


def main() -> int:
    int8_only = sys.argv[1] == "--int8-only"
    tree = os.path.abspath(sys.argv[-1])
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("chip_decode_ab: no CUDA device is available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, llama3_8b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _build.build([n for n in ("flash_attention", "flash_attention_bwd", "flash_decode",
                              "dequantize", "kv_quant")
                  if os.path.exists(os.path.join(_build.CSRC, n + ".cu"))])
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    if int8_only:
        for shapes in ("k4", "serving"):
            q, kp, vp, bt, pos, valid = cs.k5_inputs(gen, shapes)
            (kq, ks), (vq, vs) = tfd.quantize_page_block(kp), tfd.quantize_page_block(vp)
            del kp, vp
            k5q = lambda: tfd.paged_flash_decode_fwd(q, kq, vq, bt, pos, valid, 16, ks, vs)  # noqa: E731
            times[f"k5q_{shapes}"] = dict(graph_ms=cs.graph_ms(k5q, 20), eager_ms=cs.cuda_ms(k5q, 50),
                                          cold_ms=cs.k5q_cold_ms(q, kq, vq, ks, vs, bt, pos, valid, 16))
            times[f"write_attend_{shapes}"] = write_attend_times(cs, tfd, q, kq, vq, ks, vs, bt,
                                                                 pos, valid)
            del q, kq, vq, ks, vs, bt, pos, valid
        torch.cuda.empty_cache()
        model = init_params(LlamaForCausalLM(llama3_8b()), seed=0)
        int8_pool = int8_pool_serving(cs, model, cs.paged_workload(model.config.vocab_size))
        print(json.dumps(dict(tree=tree, card=card, kernels=times, int8_pool_serving=int8_pool)),
              flush=True)
        return 0
    q, kc, vc, pos, valid = cs.k4_inputs(gen)
    k4 = lambda: tfd.flash_decode_fwd(q, kc, vc, pos, valid)  # noqa: E731
    times["k4"] = dict(graph_ms=cs.graph_ms(k4, 20), eager_ms=cs.cuda_ms(k4, 50))
    del q, kc, vc, pos, valid
    for shapes in ("k4", "serving"):
        q, kp, vp, bt, pos, valid = cs.k5_inputs(gen, shapes)
        k5 = lambda: tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, 16)  # noqa: E731
        times[f"k5_{shapes}"] = dict(graph_ms=cs.graph_ms(k5, 20), eager_ms=cs.cuda_ms(k5, 50))
        (kq, ks), (vq, vs) = tfd.quantize_page_block(kp), tfd.quantize_page_block(vp)
        del kp, vp
        k5q = lambda: tfd.paged_flash_decode_fwd(q, kq, vq, bt, pos, valid, 16, ks, vs)  # noqa: E731
        times[f"k5q_{shapes}"] = dict(graph_ms=cs.graph_ms(k5q, 20), eager_ms=cs.cuda_ms(k5q, 50))
        del q, kq, vq, ks, vs, bt, pos, valid
    for chunk in (16, 256, 512):  # R = 4 x chunk: the multi-row path
        q, kc, vc, pos, valid = cs.rows_inputs(gen, chunk)
        kp, vp, bt = cs.scrambled_pages(kc, vc, valid)
        times[f"rows_{4 * chunk}"] = dict(
            k4_graph_ms=cs.graph_ms(lambda: tfd.flash_decode_fwd(q, kc, vc, pos, valid), 5),
            k5_graph_ms=cs.graph_ms(lambda: tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, 16), 5))
        del q, kc, vc, pos, valid, kp, vp, bt
    torch.cuda.empty_cache()

    model = init_params(LlamaForCausalLM(llama3_8b()), seed=0)
    srv = cs.serve(model, gen)
    prof = cs.profile_serving(model, srv["workload"])
    workload = cs.paged_workload(model.config.vocab_size)
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
    paged = cs.serve_paged(model, workload, "fused")
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - allocs
    paged_prof = cs.serve_paged(model, workload, "fused", profiled=True)
    snap, psnap = srv["snap"], paged["snap"]
    # a capture (once per engine, at the first chunk) is no serving work:
    # the idle share is taken over the wall without it
    capture_s = snap.get("capture_s", 0.0)
    serving = dict(wall_s=srv["wall_s"], capture_s=capture_s, ttft_mean_s=snap["mean_ttft"],
                   ttft_max_s=snap["max_ttft"], decode_tok_s=snap["chunk_tokens_per_sec"],
                   ms_per_decode_step=1e3 * srv["decode_s"] / max(srv["decode_only_executed"], 1),
                   decode_compilations=srv["compilations"], device_ms=prof["fams"],
                   k4_records=prof["records"],
                   idle_share=1 - sum(prof["fams"].values()) / (1e3 * (srv["wall_s"] - capture_s)))
    capture_s = paged["capture_s"]
    paged_serving = dict(
        wall_s=paged["wall_s"], capture_s=capture_s, ttft_mean_s=psnap["mean_ttft"],
        ttft_max_s=psnap["max_ttft"], decode_tok_s=psnap["chunk_tokens_per_sec"],
        ms_per_decode_step=1e3 * paged["decode_s"] / max(paged["decode_executed"], 1),
        decode_compilations=paged["compilations"], device_ms=paged_prof["fams"],
        k5_records=paged_prof["records"],
        idle_share=1 - sum(paged_prof["fams"].values()) / (1e3 * (paged["wall_s"] - capture_s)),
        tokens_equal_profiled_rerun=paged_prof["tokens"] == paged["tokens"],
        device_mallocs=allocs)
    prefix = prefix_serving(cs, model)
    int8_pool = int8_pool_serving(cs, model, workload)
    print(json.dumps(dict(tree=tree, card=card, kernels=times, serving=serving,
                          paged_serving=paged_serving, prefix_serving=prefix,
                          int8_pool_serving=int8_pool)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
