"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing here catches its own failure):

1. the card's name and power limit, and the build of every CUDA kernel of
   the serving path from ``neuronx_distributed_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together);
2. each kernel against its plain PyTorch version at the serving path's
   shapes, bf16, with its time, the plain version's, the least time the card
   could take (``bound_ms``) and one PyTorch library call's (SDPA) time;
3. outputs: the full-width model's logits through the kernels against the
   same model with the plain versions swapped in, on a short prompt;
4. serving: ``ServingEngine`` over Llama-3-8B at full width (all 32 layers,
   random bf16 weights from a seed) answering six requests; every kernel's
   launch count is zeroed just before and read just after;
5. the same workload under ``torch.profiler``: device time by kernel
   family and the device's idle share;
6. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Needs a CUDA device: without one it exits non-zero before printing any
result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
# Output limits, elementwise: |out - ref| <= 2^-7 |ref| + c * (P|V|) + 1e-5.
# 2^-7 |ref| is one bf16 ulp of O: both sides round O to bf16 last. P|V| is
# the plain version run on |V|, the softmax-weighted size of what a row
# averages, which bounds any difference in its P·V sum. K1 rounds P to bf16
# for that product (2^-9 relative per term): c = 2^-8, twice that bound. K4
# keeps P in f32 and differs in summation order and expf only: c = 2^-12.
K1_PV = 2.0 ** -8
K4_PV = 2.0 ** -12
LSE_TOL = 5e-4  # f32 on both sides; exp-sums of <= 8192 terms in another order (n * 2^-24)


def log(*a):
    print(*a, flush=True)


def tol_ratio(out, ref, pv, c: float) -> float:
    """Largest |out - ref| over its elementwise limit (above 1 fails)."""
    ref = ref.float()
    limit = 2.0 ** -7 * ref.abs() + c * pv.float() + 1e-5
    return float(((out.float() - ref).abs() / limit).max())


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# --- phase 2: kernels against their plain versions ----------------------------

def check_k1(gen, s: int, pad: int):
    """K1 at prefill shapes: B=1, H=32, Hkv=8, D=128, ``pad`` left-padding
    rows as segment -1."""
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd,
        flash_attention_plain,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    b, h, hkv, d = 1, 32, 8, 128
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(bf)
    k = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(bf)
    v = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(bf)
    seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
    seg[:, :pad] = -1
    out, lse = flash_attention_fwd(q, k, v, True, seg)
    ref, ref_lse = flash_attention_plain(q, k, v, True, seg)
    pv = flash_attention_plain(q, k, v.abs(), True, seg)[0]
    # what a kernel that skipped the last K tile (keys S-64..S-1, the
    # diagonal tile of the last query tile) would return: the limit must fail it
    kv_seg = seg.clone()
    kv_seg[:, s - 64:] = -2
    fault = flash_attention_plain(q, k, v, True, seg, kv_seg)[0]
    torch.cuda.synchronize()
    err, lerr = max_err(out, ref), max_err(lse, ref_lse)
    ratio, fault_ratio = tol_ratio(out, ref, pv, K1_PV), tol_ratio(fault, ref, pv, K1_PV)
    if not (ratio <= 1.0 and lerr <= LSE_TOL):
        raise AssertionError(f"K1 S={s}: max |out err| {err} at {ratio:.3g}x its limit, "
                             f"|lse err| {lerr} (tol {LSE_TOL})")
    if fault_ratio <= 1.0:
        raise AssertionError(f"K1 S={s}: the output limit passes a dropped K tile ({fault_ratio:.3g}x)")
    # the work this input needs: live (query, key) pairs of the causal,
    # segment-masked score matrix, 4*D FLOPs each (QK^T and PV)
    rows = torch.arange(s, device=dev)
    live = (rows[:, None] >= rows[None, :]) & (seg[0][:, None] == seg[0][None, :])
    pairs = int(live.sum()) * b * h
    flops = 4.0 * d * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * (lse.numel() + 2 * s)
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, True, seg), 20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, True, seg), 3, warmup=1)
    mask = live[None, None]  # (1, 1, S, S) boolean, True = attend
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    lib_ms = cuda_ms(lib, 20)
    return dict(err=max(err, lerr), ratio=ratio, fault_ratio=fault_ratio, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=lib_ms)


def check_k4(gen):
    """K4 at decode shapes: 8 slots, s=1, L=8192, a 4100-column bound,
    kv_valid with gaps (left padding and invalid columns)."""
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_fwd,
        flash_decode_plain,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    b, s, h, hkv, d, L, bound_cols = 8, 1, 32, 8, 128, 8192, 4100
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(bf)
    kc = torch.randn(b, L, hkv, d, generator=gen, device=dev).to(bf)
    vc = torch.randn(b, L, hkv, d, generator=gen, device=dev).to(bf)
    pos = torch.tensor([bound_cols - 1], dtype=torch.int32, device=dev)
    valid = torch.zeros(b, L, dtype=torch.bool, device=dev)
    for i in range(b):  # slot i's prompt starts further right: left padding
        valid[i, 400 * i: bound_cols] = True
    valid &= torch.rand(b, L, generator=gen, device=dev) > 0.1  # gap columns
    out, lse = flash_decode_fwd(q, kc, vc, pos, valid)
    ref, ref_lse = flash_decode_plain(q, kc, vc, pos, valid)
    pv = flash_decode_plain(q, kc, vc.abs(), pos, valid)[0]
    # what a kernel that skipped the last, partial 128-column tile (columns
    # 4096..4099) would return: the limit must fail it
    cut = valid.clone()
    cut[:, 4096:bound_cols] = False
    fault = flash_decode_plain(q, kc, vc, pos, cut)[0]
    torch.cuda.synchronize()
    err, lerr = max_err(out, ref), max_err(lse, ref_lse)
    ratio, fault_ratio = tol_ratio(out, ref, pv, K4_PV), tol_ratio(fault, ref, pv, K4_PV)
    if not (ratio <= 1.0 and lerr <= LSE_TOL):
        raise AssertionError(f"K4: max |out err| {err} at {ratio:.3g}x its limit, "
                             f"|lse err| {lerr} (tol {LSE_TOL})")
    if fault_ratio <= 1.0:
        raise AssertionError(f"K4: the output limit passes a dropped tile ({fault_ratio:.3g}x)")
    # least bytes: q, the LIVE K/V columns, the validity bytes up to the
    # bound, out and lse
    live_cols = int(valid[:, :bound_cols].sum())
    nbytes = (2 * q.numel() + 2 * 2 * live_cols * hkv * d + b * bound_cols
              + 2 * out.numel() + 4 * lse.numel())
    flops = 4.0 * live_cols * h * d
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    ms = cuda_ms(lambda: flash_decode_fwd(q, kc, vc, pos, valid), 50)
    plain_ms = cuda_ms(lambda: flash_decode_plain(q, kc, vc, pos, valid), 5, warmup=1)
    cols = torch.arange(L, device=dev)
    mask = (valid & (cols <= pos[-1]))[:, None, None, :]  # (B, 1, 1, L)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    lib_ms = cuda_ms(lib, 50)
    return dict(err=max(err, lerr), ratio=ratio, fault_ratio=fault_ratio, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=lib_ms)


# --- phase 3: outputs against the plain path -----------------------------------

@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain versions (reference
    runs only; the port itself has no such switch)."""
    from neuronx_distributed_tpu_torch.kernels.flash_attention import flash_attention_plain
    from neuronx_distributed_tpu_torch.kernels.flash_decode import flash_decode_plain
    from neuronx_distributed_tpu_torch.modules import attention

    saved = attention.flash_attention, attention.flash_decode_attention
    attention.flash_attention = lambda *a, **kw: flash_attention_plain(*a, **kw)[0]
    attention.flash_decode_attention = lambda *a, **kw: flash_decode_plain(*a, **kw)[0]
    try:
        yield
    finally:
        attention.flash_attention, attention.flash_decode_attention = saved


def teacher_logits(model, ids, steps: int, feed=None):
    """Prefill ``ids`` then ``steps`` decode steps; feeds ``feed`` tokens
    (or the greedy choice) and returns (logits (steps+1, V) f32, tokens)."""
    cache = model.new_cache(1)
    logits = [model(ids, mode="prefill", cache=cache, last_only=True)[0, -1].float()]
    toks = []
    for t in range(steps):
        tok = int(feed[t]) if feed is not None else int(logits[-1].argmax())
        toks.append(tok)
        x = torch.tensor([[tok]], device=ids.device)
        logits.append(model(x, mode="decode", cache=cache, last_only=True)[0, -1].float())
    return torch.stack(logits), toks


def check_outputs(model, gen) -> dict:
    ids = torch.randint(1, model.config.vocab_size, (1, 64), generator=gen, device="cuda")
    with plain_attention():
        ref, toks = teacher_logits(model, ids, 8)
    got, _ = teacher_logits(model, ids, 8, feed=toks)
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits through the kernels")
    scale = float(ref.abs().max())
    rel = max_err(got, ref) / scale
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    in_top5 = bool((got.topk(5, dim=-1).indices == ref.argmax(-1)[:, None]).any(-1).all())
    # bf16 model with random weights: K1 rounds P to bf16 where the plain
    # path keeps f32 (~2^-9 relative per attention output), and 32 random
    # layers amplify it; near-ties among 128256 logits may swap the top-1,
    # so the plain path's choice must stay within the kernels' top 5
    if rel > 5e-2 or not in_top5:
        raise AssertionError(f"logits disagree with the plain path: rel {rel}, "
                             f"argmax {agree}/{ref.shape[0]}, plain top-1 in top-5: {in_top5}")
    return dict(rel_err=rel, argmax_agree=f"{agree}/{ref.shape[0]}", logit_scale=scale)


# --- phase 4: serving ---------------------------------------------------------

def serve(model, gen):
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.kernels.flash_attention import flash_attention_fwd
    from neuronx_distributed_tpu_torch.kernels.flash_decode import flash_decode_fwd
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    lengths = [30, 250, 700, 1500, 2200, 3000]
    new = 32
    prompts = [torch.randint(1, model.config.vocab_size, (n,), generator=gen, device="cuda")
               .cpu().numpy() for n in lengths]
    cfgs = [GenerationConfig(max_new_tokens=new, temperature=0.0) for _ in lengths]
    cfgs[2] = GenerationConfig(max_new_tokens=new, temperature=0.8, top_k=50)
    engine = ServingEngine(model, num_slots=8, decode_chunk_size=8)
    torch.cuda.synchronize()
    flash_attention_fwd.launches = 0
    flash_decode_fwd.launches = 0
    t0 = time.perf_counter()
    reqs = [engine.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
    engine.step()  # admits all six (8 slots): six prefills, then one decode chunk
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps0, executed0 = engine.metrics.steps, engine.metrics.executed_steps
    engine.run()  # decode-only steps
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"flash_attention": flash_attention_fwd.launches,
                "flash_decode": flash_decode_fwd.launches}
    for r in reqs:
        if r.state is not RequestState.DONE or len(r.tokens) != new:
            raise AssertionError(f"request {r.rid}: {r.state} with {len(r.tokens)} tokens")
        if not all(0 <= t < model.config.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid}: token outside the vocabulary")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    snap = engine.metrics.snapshot()
    # executed steps each ran the whole model (and one K4 per layer); used
    # steps had a live slot — the rest were masked no-ops
    if launches["flash_decode"] != snap["executed_steps"] * model.config.num_layers:
        raise AssertionError(f"K4 launches {launches['flash_decode']} != executed steps "
                             f"{snap['executed_steps']} x {model.config.num_layers} layers")
    return dict(wall_s=t2 - t0, admit_s=t1 - t0, decode_s=t2 - t1,
                decode_only_executed=snap["executed_steps"] - executed0,
                decode_only_used=snap["steps"] - steps0, launches=launches, snap=snap,
                prefills=snap["prefills"], workload=(prompts, cfgs))


def profile_serving(model, workload) -> dict:
    """The serving workload once more under ``torch.profiler``: device time
    by kernel family. The profiler slows the host several-fold, so only its
    device times are used (against the unprofiled run's wall)."""
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    prompts, cfgs = workload
    engine = ServingEngine(model, num_slots=8, decode_chunk_size=8)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, (p, c) in enumerate(zip(prompts, cfgs)):
            engine.submit(p, c, seed=i)
        engine.run()
        torch.cuda.synchronize()
    fams = {"flash_attention": 0.0, "flash_decode": 0.0, "gemm": 0.0, "other": 0.0}
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        name = e.name
        fam = ("flash_attention" if "flash_fwd_kernel" in name
               else "flash_decode" if "flash_decode_kernel" in name
               else "gemm" if any(t in name for t in ("nvjet", "gemm", "cutlass", "xmma"))
               else "other")
        fams[fam] += e.device_time / 1e3  # us -> ms
    return fams


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from neuronx_distributed_tpu_torch.kernels import _build
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, llama3_8b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    t0 = time.perf_counter()
    _build.build(["flash_attention", "flash_decode"])
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, both kernels in parallel)")

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = {s: check_k1(gen, s, pad) for s, pad in ((512, 77), (4096, 1001))}
    for s, r in k1.items():
        log(f"K1 flash_attention B=1 S={s} H=32 Hkv=8 D=128: max_err {r['err']:.3g} "
            f"({r['ratio']:.3g}x its limit; a dropped K tile reads {r['fault_ratio']:.3g}x) "
            f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms {r['library_ms']:.4f} (SDPA, bool mask, GQA)")
    k4 = check_k4(gen)
    log(f"K4 flash_decode B=8 s=1 H=32 Hkv=8 D=128 L=8192 bound 4100: max_err {k4['err']:.3g} "
        f"({k4['ratio']:.3g}x its limit; a dropped partial tile reads {k4['fault_ratio']:.3g}x) "
        f"kernel_ms {k4['ms']:.4f} plain_ms {k4['plain_ms']:.4f} bound_ms {k4['bound_ms']:.4f} "
        f"({k4['bound_by']}) library_ms {k4['library_ms']:.4f} (SDPA, bool mask, GQA)")
    torch.cuda.empty_cache()

    cfg = llama3_8b()
    t0 = time.perf_counter()
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    torch.cuda.synchronize()
    log(f"model: llama3_8b, {cfg.num_layers} layers (no depth cut), "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params bf16, "
        f"init {time.perf_counter() - t0:.1f} s")
    out = check_outputs(model, gen)
    log(f"outputs vs plain path (64-token prompt, 8 decode steps): rel_err {out['rel_err']:.3g} "
        f"argmax {out['argmax_agree']} logit_scale {out['logit_scale']:.3g}")

    srv = serve(model, gen)
    snap = srv["snap"]
    log(f"serving: 6 requests (prompts 30..3000, 32 new tokens, 1 sampled), 8 slots, chunk 8: "
        f"wall {srv['wall_s']:.3f} s, prefills {srv['prefills']}, decode steps "
        f"{snap['executed_steps']} executed ({snap['executed_steps'] - snap['steps']} masked no-ops), "
        f"TTFT mean {snap['mean_ttft']:.4f} s max {snap['max_ttft']:.4f} s, "
        f"decode {snap['chunk_tokens_per_sec']:.1f} tok/s (chunk wall), "
        f"prefill wall {snap['prefill_wall_s']:.4f} s, cursor {snap['cursor_high_water']}, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"serving breakdown: admission step (6 prefills + 1 chunk) {srv['admit_s']:.4f} s, "
        f"{srv['decode_only_executed']} decode-only steps executed ({srv['decode_only_used']} "
        f"with a live slot) {srv['decode_s']:.4f} s "
        f"({1e3 * srv['decode_s'] / max(srv['decode_only_executed'], 1):.2f} ms per executed step, 8 slots)")
    log(f"launches on the serving path: {srv['launches']}")
    fams = profile_serving(model, srv["workload"])
    busy = sum(fams.values())
    log("device time of the serving workload (profiler, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in fams.items())
        + f"; busy {busy:.2f} of the unprofiled wall {1e3 * srv['wall_s']:.2f} "
        f"(idle share {1 - busy / (1e3 * srv['wall_s']):.3f})")

    k1_main = k1[4096]
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_attention.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_attention.py:199",
             launches=srv["launches"]["flash_attention"],
             max_abs_err=max(r["err"] for r in k1.values()), ms=k1_main["ms"],
             plain_ms=k1_main["plain_ms"], bound_ms=k1_main["bound_ms"],
             bound_by=k1_main["bound_by"], library_ms=k1_main["library_ms"]),
        dict(name="flash_decode", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:301",
             launches=srv["launches"]["flash_decode"], max_abs_err=k4["err"], ms=k4["ms"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"], bound_by=k4["bound_by"],
             library_ms=k4["library_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
