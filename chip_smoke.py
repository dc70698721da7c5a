"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing here catches its own failure):

1. the card's name and power limit, and the build of every CUDA kernel of
   the serving and training paths from ``neuronx_distributed_tpu_torch/csrc``
   (one ``nvcc`` per source, started together); K1's, K2's, K3's, K4's and
   K5's resources as built (neither K1 nor a decode kernel may spill, nor
   may ptxas serialize K1's ``wgmma`` products);
2. each kernel against its plain PyTorch version at its path's shapes,
   bf16, with its time, the plain version's, the least time the card could
   take (``bound_ms``) and one PyTorch library call's (SDPA) time: K1 at the
   serving prefills (S=512 and 4096, left padding) and at the training batch
   (B=2, S=4096, unpacked and packed), bitwise reproducible, timed as a
   CUDA-graph replay (back to back beside), with its tile plan (visited,
   masked and live tile pairs); K4 at the serving shapes, K5 through a
   scrambled block table at K4's shapes and at the paged serving phase's
   geometry (also bitwise equal to K4 on the gathered view and blind to
   the null page), K2 and K3 at the
   training shapes (unpacked, packed and ragged), each also bitwise
   reproducible. K4, K5 and their SDPA yardstick take less device time
   than the host needs to issue them: their times are CUDA-graph replays
   (``graph_ms``), with the back-to-back time printed beside; K4's and
   K5's split plans (blocks, live tiles, bytes moved against the bound's)
   are printed;
3. outputs: the full-width model's logits through the kernels, with a row
   cache and with a paged cache behind a scrambled block table, against the
   same model with the plain versions swapped in, on a short prompt;
4. serving: ``ServingEngine`` over Llama-3-8B at full width (all 32 layers,
   random bf16 weights from a seed) answering six requests, its decode step
   one CUDA graph captured at the first chunk and replayed; every kernel's
   launch count is zeroed just before and read just after (a replay calls
   no wrapper: replays x launches per replay count for it); then a witness
   run with the eager step patched in, whose token streams must be
   identical;
5. the same workload under ``torch.profiler`` (the decode program captured
   before it opens): device time by kernel family, the device's idle share,
   and the profiler's K4 kernel records, two (range, merge) per executed
   step and layer;
5b. paged serving: the same model behind a paged engine (16 slots, a pool
   of four row slots' bytes) answering 15 mixed-length requests, with K5
   attending the pool, with K4 on the gathered view patched in (before the
   first chunk, so the graph captures it) and with the eager step patched
   in, all with identical token streams; then the K5 run once more under
   the profiler (K5 records counted as in 5);
6. training, kernel path against plain path: one step's loss and gradients
   of a 2-layer Llama-3-8B-width model at S=1024;
7. training: six ``build_train_step`` steps of Llama-3-8B width cut to 8
   layers (fp32 masters, AdamW, remat) on one packed 2 x 4096 batch, launch
   counts zeroed just before and read just after, then one step under the
   profiler;
8. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Needs a CUDA device: without one it exits non-zero before printing any
result.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
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
# Backward limits, elementwise, the same form: |g - ref| <= 2^-7 |ref| +
# c * M + 1e-5, with M the sum of the magnitudes of the terms of g: P|dO|
# for dV, |dS||Q| for dK, |dS||K| for dQ (dS = P (dP - delta) scale). K2 and K3 round P
# and dS to bf16 (2^-9 relative per term) as the A operands of those
# products, where the plain version keeps f32; dS itself, S and dP are f32
# sums of exact bf16 products on both sides. c = 2^-8, twice that bound.
K2K3_C = 2.0 ** -8


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


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device time of ``fn`` with the host taken out: ``iters`` calls
    captured in one CUDA graph, replayed ``replays`` times between CUDA
    events. K4, K5 and SDPA at decode shapes take less device time than the
    host needs to issue them, so back-to-back launches (``cuda_ms``) time
    the host there; both numbers are printed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def decode_plan(valid, bound_cols: int, hkv: int, rows: int, page_size: int = 0) -> dict:
    """What K4/K5 launch and move for one call, from the inputs and the
    kernels' split plan (``split_cols`` columns a block, ``tile_cols`` a
    tile): blocks in the grid, ranges of a slot that start before the bound
    (their blocks run), working blocks (a range with a live tile), live
    tiles, and the bytes the plan moves: the live K/V columns, the table
    entries of live pages (K5), q for every block that runs, the kv_valid
    bytes of every block, the partial O and LSE written and merged, out and
    lse."""
    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("flash_decode")
    split, tile = lib.nxd_flash_decode_split_cols(), lib.nxd_flash_decode_tile_cols()
    b, L = valid.shape
    d = 128
    n_splits, ranges = -(-L // split), -(-bound_cols // split)
    live = torch.nn.functional.pad(valid[:, :bound_cols], (0, ranges * split - bound_cols))
    live_tiles = int(live.reshape(b, -1, tile).any(-1).sum()) * hkv
    working = int(live.reshape(b, ranges, split).any(-1).sum()) * hkv
    grid, in_bound = hkv * b * n_splits, hkv * b * ranges
    moved = (2 * 2 * d * int(live.sum()) * hkv                          # live K and V
             + in_bound * 2 * rows * d + grid * split                   # q, kv_valid
             + 4 * rows * (2 * in_bound + working * d + in_bound * d)   # partials: written, merged
             + 2 * b * hkv * rows * d + 4 * b * hkv * rows)             # out, lse
    if page_size:
        moved += 4 * int(live.reshape(b, -1, page_size).any(-1).sum()) * hkv
    return dict(grid=grid, splits=n_splits, ranges=ranges, in_bound=in_bound, working=working,
                live_tiles=live_tiles, read_bytes=moved)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# --- phase 2: kernels against their plain versions ----------------------------

K1_SHAPES = (  # (name, B, S, segments): the serving prefills, then the training batch
    ("serving", 1, 512, 77), ("serving", 1, 4096, 1001),
    ("training", 2, 4096, None), ("training", 2, 4096, "packed"))


def k1_inputs(gen, b: int, s: int, segments):
    """``check_k1``'s inputs: q (B, S, 32, 128), k and v (B, S, 8, 128) and
    the segment ids: ``pad`` (an int) left-padding rows as segment -1, the
    training batch's packed documents (``"packed"``), or none."""
    import numpy as np

    dev, bf = torch.device("cuda"), torch.bfloat16
    h, hkv, d = 32, 8, 128
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(bf)
    k = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(bf)
    v = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(bf)
    seg = None
    if segments == "packed":
        seg = torch.from_numpy(packed_segments(np.random.default_rng(s), b, s)).to(dev)
    elif segments is not None:
        seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
        seg[:, :segments] = -1
    return q, k, v, seg


def k1_plan(q, k, seg) -> dict:
    """K1's tile plan for one call (``flash_fwd_tile_plan``, the kernel's
    own predicate): (query tile, key tile, head, batch) pairs in the grid,
    visited, masked, and live (holding a live pair of the plain mask); and
    the FLOPs of the visited tiles over the live pairs' (the bound's)."""
    from neuronx_distributed_tpu_torch.kernels.flash_attention import (
        FWD_K_TILE,
        FWD_Q_TILE,
        _live,
        _seg_tile_ranges,
        flash_fwd_tile_plan,
    )

    b, s, h, _ = q.shape
    sk = k.shape[1]
    ranges = {}
    if seg is not None:
        ranges = dict(q_ranges=_seg_tile_ranges(seg, FWD_Q_TILE),
                      k_ranges=_seg_tile_ranges(seg, FWD_K_TILE))
    plan = flash_fwd_tile_plan(s, sk, True, h=h, b=b, **ranges)
    live = _live(q, k, True, seg, seg)[:, 0, 0]
    nq, nk = plan["visited"].shape[1:]
    live = torch.nn.functional.pad(live, (0, nk * FWD_K_TILE - sk, 0, nq * FWD_Q_TILE - s))
    live_tiles = live.reshape(b, nq, FWD_Q_TILE, nk, FWD_K_TILE).any(4).any(2).cpu()
    visited = int(plan["visited"].sum()) * h
    pairs = int(live.sum()) * h
    return dict(grid=b * nq * nk * h, visited=visited, masked=int(plan["masked"].sum()) * h,
                live=int(live_tiles.sum()) * h, blocks=int(plan["order"].shape[0]),
                work_over_bound=visited * FWD_Q_TILE * FWD_K_TILE / pairs)


def check_k1(gen, b: int, s: int, segments):
    """K1 at one of ``K1_SHAPES``: B, S, H=32, Hkv=8, D=128, causal, bf16;
    against the plain version, twice for the same bits, timed (a CUDA-graph
    replay of the wrapper's call, device time only, and back to back)
    beside its bound and SDPA: a boolean mask where there are segments,
    ``is_causal`` (a fused causal kernel) where there are none."""
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd,
        flash_attention_plain,
    )

    dev = torch.device("cuda")
    q, k, v, seg = k1_inputs(gen, b, s, segments)
    out, lse = flash_attention_fwd(q, k, v, True, seg)
    again, again_lse = flash_attention_fwd(q, k, v, True, seg)
    ref, ref_lse = flash_attention_plain(q, k, v, True, seg)
    pv = flash_attention_plain(q, k, v.abs(), True, seg)[0]
    # what a kernel that skipped the keys S-64..S-1 (part of the diagonal
    # tile of the last query tile) would return: the limit must fail it
    q_seg = seg if seg is not None else torch.zeros(b, s, dtype=torch.int32, device=dev)
    kv_seg = q_seg.clone()
    kv_seg[:, s - 64:] = -2
    fault = flash_attention_plain(q, k, v, True, q_seg, kv_seg)[0]
    torch.cuda.synchronize()
    err, lerr = max_err(out, ref), max_err(lse, ref_lse)
    ratio, fault_ratio = tol_ratio(out, ref, pv, K1_PV), tol_ratio(fault, ref, pv, K1_PV)
    del ref, pv, fault
    tag = f"K1 B={b} S={s} {segments if segments is not None else 'unsegmented'}"
    if not (ratio <= 1.0 and lerr <= LSE_TOL):
        raise AssertionError(f"{tag}: max |out err| {err} at {ratio:.3g}x its limit, "
                             f"|lse err| {lerr} (tol {LSE_TOL})")
    if fault_ratio <= 1.0:
        raise AssertionError(f"{tag}: the output limit passes a dropped K tile ({fault_ratio:.3g}x)")
    if not (torch.equal(out, again) and torch.equal(lse, again_lse)):
        raise AssertionError(f"{tag}: two runs differ in their bits")
    # the work this input needs: live (query, key) pairs of the causal,
    # segment-masked score matrix, 4*D FLOPs each (QK^T and PV)
    h, d = q.shape[2], q.shape[3]
    pairs = live_pairs(seg, b, s, dev) * h
    flops = 4.0 * d * pairs
    seg_bytes = 0 if seg is None else 2 * 4 * seg.numel()
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * lse.numel() + seg_bytes
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    call = lambda: flash_attention_fwd(q, k, v, True, seg)  # noqa: E731
    ms, eager_ms = graph_ms(call, 10), cuda_ms(call, 20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, True, seg), 3, warmup=1)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if seg is None:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
    else:
        rows = torch.arange(s, device=dev)
        mask = (rows[:, None] >= rows[None, :]) & (seg[:, :, None] == seg[:, None, :])
        mask = mask[:, None]  # (B, 1, S, S) boolean, True = attend
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    lib_ms = graph_ms(lib, 10)
    return dict(b=b, s=s, segments=segments, err=max(err, lerr), ratio=ratio, fault_ratio=fault_ratio,
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=lib_ms, library_eager_ms=cuda_ms(lib, 20), tflops=flops / ms / 1e9,
                plan=k1_plan(q, k, seg))


def k4_inputs(gen):
    """``check_k4``'s inputs: q (8, 1, 32, 128), a row cache (8, 8192, 8,
    128), the position 4099, kv_valid with left padding (slot i from column
    400 i) and 10% gap columns."""
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
    return q, kc, vc, pos, valid


def check_k4(gen):
    """K4 at decode shapes: 8 slots, s=1, L=8192, a 4100-column bound,
    kv_valid with gaps (left padding and invalid columns)."""
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_fwd,
        flash_decode_plain,
    )

    b, h, hkv, d, L, bound_cols = 8, 32, 8, 128, 8192, 4100
    q, kc, vc, pos, valid = k4_inputs(gen)
    dev = q.device
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
    ms = graph_ms(lambda: flash_decode_fwd(q, kc, vc, pos, valid), 20)
    eager_ms = cuda_ms(lambda: flash_decode_fwd(q, kc, vc, pos, valid), 50)
    plain_ms = cuda_ms(lambda: flash_decode_plain(q, kc, vc, pos, valid), 5, warmup=1)
    cols = torch.arange(L, device=dev)
    mask = (valid & (cols <= pos[-1]))[:, None, None, :]  # (B, 1, 1, L)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    lib_ms = graph_ms(lib, 20)
    return dict(err=max(err, lerr), ratio=ratio, fault_ratio=fault_ratio, ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
                library_eager_ms=cuda_ms(lib, 50),
                plan=dict(decode_plan(valid, bound_cols, hkv, 4), bound_bytes=nbytes))


def k5_shapes(name: str):
    """(slots, pool pages, live bound, per-slot valid column runs) of K5's
    two checks, page_size 16, L=8192. ``"k4"``: K4's shapes, 8 slots over
    the row-equivalent pool plus the null page, slot i valid from column
    400 i to the bound (gaps are added later). ``"serving"``: the paged
    serving phase's geometry, 16 slots over a 2049-page pool, the bound at
    3109 (mid tile): 12 chats of 100-400 columns and 3 documents of
    2000-3000 in the workload's order, each context from a page-aligned
    start right-aligned under the bound, then a gap, then the last 8 decode
    columns; slot 15 idle (no valid column, no page)."""
    import numpy as np

    if name == "k4":
        return 8, 8 * 512 + 1, 4100, [[(400 * i, 4100)] for i in range(8)]
    rng = np.random.default_rng(3)
    chats = [int(n) for n in rng.integers(100, 401, size=12)]
    docs = [int(n) for n in rng.integers(2000, 3001, size=3)]
    lens = []
    for i, n in enumerate(chats):
        lens.append(n)
        if i % 4 == 3:
            lens.append(docs[i // 4])
    bound = 3109
    runs = []
    for n in lens:
        lo = (bound - 8 - n) // 16 * 16
        runs.append([(lo, lo + n), (bound - 8, bound)])
    return 16, 2049, bound, runs + [[]]


def k5_inputs(gen, shapes: str):
    """``check_k5``'s inputs at ``k5_shapes(shapes)``: q, the pools (page 0
    scaled by 64), the block table, the position and kv_valid."""
    import numpy as np

    dev, bf = torch.device("cuda"), torch.bfloat16
    b, n_pages, bound_cols, runs = k5_shapes(shapes)
    s, h, hkv, d, L, ps = 1, 32, 8, 128, 8192, 16
    n_log = L // ps
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(bf)
    kp = torch.randn(n_pages, ps, hkv, d, generator=gen, device=dev).to(bf)
    vp = torch.randn(n_pages, ps, hkv, d, generator=gen, device=dev).to(bf)
    kp[0].mul_(64.0)
    vp[0].mul_(64.0)
    pos = torch.tensor([bound_cols - 1], dtype=torch.int32, device=dev)
    valid = torch.zeros(b, L, dtype=torch.bool, device=dev)
    perm = iter(np.random.default_rng(5).permutation(np.arange(1, n_pages)).tolist())
    table = np.zeros((b, n_log), np.int32)
    for i, slot_runs in enumerate(runs):
        for lo, hi in slot_runs:
            valid[i, lo:hi] = True
        if slot_runs:
            for j in range(slot_runs[0][0] // ps, -(-bound_cols // ps)):
                table[i, j] = next(perm)
    if shapes == "k4":
        valid &= torch.rand(b, L, generator=gen, device=dev) > 0.1  # gap columns
    return q, kp, vp, torch.from_numpy(table).to(dev), pos, valid


def check_k5(gen, shapes: str, timed: bool):
    """K5 at ``k5_shapes(shapes)``, s=1: each slot's logical pages from its
    first valid column's page through the bound's map to a numpy-seeded
    random permutation of pool pages; its unmapped pages (left padding,
    past the bound, an idle slot's) to page 0, which holds random garbage.
    At K4's shapes ``kv_valid`` also has random gaps, as in ``check_k4``."""
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_fwd,
        paged_flash_decode_fwd,
        paged_flash_decode_plain,
        paged_gather_leaf,
    )

    dev = torch.device("cuda")
    b, n_pages, bound_cols, _ = k5_shapes(shapes)
    h, hkv, d, L, ps = 32, 8, 128, 8192, 16
    q, kp, vp, bt, pos, valid = k5_inputs(gen, shapes)
    table = bt.cpu().numpy()
    out, lse = paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    again, again_lse = paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    kg, vg = paged_gather_leaf(kp, bt, ps), paged_gather_leaf(vp, bt, ps)
    row, row_lse = flash_decode_fwd(q, kg, vg, pos, valid)
    kp0, vp0 = kp[0].clone(), vp[0].clone()
    kp[0].normal_(generator=gen).mul_(-300.0)
    vp[0].normal_(generator=gen).mul_(300.0)
    other, other_lse = paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    kp[0], vp[0] = kp0, vp0
    ref, ref_lse = paged_flash_decode_plain(q, kp, vp, bt, pos, valid, ps)
    pv = paged_flash_decode_plain(q, kp, vp.abs(), bt, pos, valid, ps)[0]
    # what a kernel that skipped the last, partial 128-column tile would
    # return: the limit must fail it
    cut = valid.clone()
    cut[:, (bound_cols - 1) // 128 * 128:bound_cols] = False
    fault = paged_flash_decode_plain(q, kp, vp, bt, pos, cut, ps)[0]
    torch.cuda.synchronize()
    err, lerr = max_err(out, ref), max_err(lse, ref_lse)
    ratio, fault_ratio = tol_ratio(out, ref, pv, K4_PV), tol_ratio(fault, ref, pv, K4_PV)
    tag = f"K5 ({shapes} shapes)"
    if not (ratio <= 1.0 and lerr <= LSE_TOL):
        raise AssertionError(f"{tag}: max |out err| {err} at {ratio:.3g}x its limit, "
                             f"|lse err| {lerr} (tol {LSE_TOL})")
    if fault_ratio <= 1.0:
        raise AssertionError(f"{tag}: the output limit passes a dropped tile ({fault_ratio:.3g}x)")
    if not (torch.equal(out, row) and torch.equal(lse, row_lse)):
        raise AssertionError(f"{tag} differs from K4 on the gathered view (must be bitwise equal)")
    if not (torch.equal(out, other) and torch.equal(lse, other_lse)):
        raise AssertionError(f"{tag}: the output depends on the null page's content")
    if not (torch.equal(out, again) and torch.equal(lse, again_lse)):
        raise AssertionError(f"{tag}: two runs differ in their bits")
    # least bytes: q, the LIVE K/V columns, the table entries up to the
    # bound, the validity bytes up to the bound, out and lse
    live_cols = int(valid[:, :bound_cols].sum())
    nbytes = (2 * q.numel() + 2 * 2 * live_cols * hkv * d + 4 * b * -(-bound_cols // ps)
              + b * bound_cols + 2 * out.numel() + 4 * lse.numel())
    flops = 4.0 * live_cols * h * d
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    res = dict(err=max(err, lerr), ratio=ratio, fault_ratio=fault_ratio, bound_ms=bound,
               bound_by=bound_by, slots=b, pages=n_pages, bound_cols=bound_cols,
               mapped=int((table != 0).sum()), live_cols=live_cols)
    res["ms"] = graph_ms(lambda: paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps), 20)
    res["eager_ms"] = cuda_ms(lambda: paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps), 50)
    res["plan"] = dict(decode_plan(valid, bound_cols, hkv, 4, ps), bound_bytes=nbytes)
    if not timed:
        return res
    res["plain_ms"] = cuda_ms(lambda: paged_flash_decode_plain(q, kp, vp, bt, pos, valid, ps), 5,
                              warmup=1)
    res["gather_ms"] = cuda_ms(lambda: (paged_gather_leaf(kp, bt, ps),
                                        paged_gather_leaf(vp, bt, ps)), 20)
    cols = torch.arange(L, device=dev)
    mask = (valid & (cols <= pos[-1]))[:, None, None, :]  # (B, 1, 1, L)
    qt, kt, vt = q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    res["library_ms"] = graph_ms(lib, 20)
    return res


def packed_segments(rng, b: int, s: int, lo: int = 200, hi: int = 3000):
    """(B, S) int32 segment ids of documents of lo..hi tokens packed end to
    end (a document cut by the window edge keeps its id)."""
    import numpy as np

    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        pos, doc = 0, 0
        while pos < s:
            n = int(rng.integers(lo, hi + 1))
            seg[i, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    return seg


def live_pairs(seg, b: int, s: int, dev) -> int:
    """Live (query, key) pairs of one head over a batch of ``b`` rows:
    causal, equal segment ids (no segments: every row its causal prefix)."""
    rows = torch.arange(s, device=dev)
    causal = rows[:, None] >= rows[None, :]
    if seg is None:
        return b * int(causal.sum())
    return sum(int((causal & (r[:, None] == r[None, :])).sum()) for r in seg)


def bwd_magnitudes(q, k, v, do, lse, delta, seg, kv_seg):
    """The sums of term magnitudes each backward output is limited by:
    (dK: |dS||Q|, dV: P|dO|, dQ: |dS||K|), f32; dS = P (dP - delta) scale."""
    from neuronx_distributed_tpu_torch.kernels.flash_attention import backward_scores

    b, s, h, d = q.shape
    hkv = k.shape[2]
    p, ds = backward_scores(q, k, v, do, lse, delta, True, seg, kv_seg)
    dog = do.float().abs().reshape(b, s, hkv, h // hkv, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    del p
    ds = ds.abs_()
    qg = q.float().abs().reshape(b, s, hkv, h // hkv, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float().abs()).reshape(b, s, h, d)
    return dk, dv, dq


def check_k2k3(gen, s: int, packed: bool, timed: bool):
    """K2 and K3 at training shapes: B=2, H=32, Hkv=8, D=128, bf16, causal,
    optionally packed segment ids. LSE from K1, delta = rowsum(dO * O)."""
    import numpy as np
    from torch.nn import functional as F

    from neuronx_distributed_tpu_torch.kernels.flash_attention import (
        flash_attention_dkdv,
        flash_attention_dkdv_plain,
        flash_attention_dq,
        flash_attention_dq_plain,
        flash_attention_fwd,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    b, h, hkv, d = 2, 32, 8, 128
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(bf)
    k = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(bf)
    v = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(bf)
    do = torch.randn(b, s, h, d, generator=gen, device=dev).to(bf)
    seg = (torch.from_numpy(packed_segments(np.random.default_rng(s), b, s)).to(dev)
           if packed else None)
    out, lse = flash_attention_fwd(q, k, v, True, seg)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, True, seg)
    dk, dv = flash_attention_dkdv(*args)
    dq = flash_attention_dq(*args)
    dk2, dv2 = flash_attention_dkdv(*args)
    dq2 = flash_attention_dq(*args)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b_) for a, b_ in ((dk, dk2), (dv, dv2), (dq, dq2)))
    del dk2, dv2, dq2
    rk, rv = flash_attention_dkdv_plain(*args)
    rq = flash_attention_dq_plain(*args)
    mk, mv, mq = bwd_magnitudes(q, k, v, do, lse, delta, seg, seg)
    ratios = {name: tol_ratio(got, ref, mag, K2K3_C)
              for name, got, ref, mag in (("dk", dk, rk, mk), ("dv", dv, rv, mv), ("dq", dq, rq, mq))}
    errs = {"dk": max_err(dk, rk), "dv": max_err(dv, rv), "dq": max_err(dq, rq)}
    # deliberately wrong kernels: K2 without the last key tile (those keys'
    # dK/dV come out 0), K3 without the first (rows 0..63 see only it)
    kv_seg = seg.clone() if seg is not None else torch.zeros(b, s, dtype=torch.int32, device=dev)
    q_seg = seg if seg is not None else torch.zeros_like(kv_seg)
    last, first = kv_seg.clone(), kv_seg.clone()
    last[:, (s - 1) // 64 * 64:] = -2
    first[:, :64] = -2
    fk, fv = flash_attention_dkdv_plain(q, k, v, do, lse, delta, True, q_seg, last)
    fq = flash_attention_dq_plain(q, k, v, do, lse, delta, True, q_seg, first)
    fault = {"dk": tol_ratio(fk, rk, mk, K2K3_C), "dv": tol_ratio(fv, rv, mv, K2K3_C),
             "dq": tol_ratio(fq, rq, mq, K2K3_C)}
    del rk, rv, rq, mk, mv, mq, fk, fv, fq
    torch.cuda.synchronize()
    tag = f"S={s} {'packed' if packed else 'unpacked'}"
    if not same_bits:
        raise AssertionError(f"K2/K3 {tag}: two runs differ in their bits")
    if max(ratios.values()) > 1.0:
        raise AssertionError(f"K2/K3 {tag}: outside the limit: {ratios} (max errs {errs})")
    if min(fault.values()) <= 1.0:
        raise AssertionError(f"K2/K3 {tag}: the limit passes a dropped key tile: {fault}")
    res = dict(err=errs, ratio=ratios, fault=fault)
    if not timed:
        return res
    pairs = live_pairs(seg, b, s, dev) * h
    seg_bytes = 0 if seg is None else 2 * 4 * seg.numel()
    io = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + 4 * (lse.numel() + delta.numel())
    work = {  # name: (FLOPs: 2*D per live pair per product, bytes read once + written once)
        "dkdv": (4 * 2.0 * d * pairs, io + seg_bytes + 2 * (k.numel() + v.numel())),
        "dq": (3 * 2.0 * d * pairs, io + seg_bytes + 2 * q.numel()),
    }
    for name, fn, plain in (
            ("dkdv", lambda: flash_attention_dkdv(*args), lambda: flash_attention_dkdv_plain(*args)),
            ("dq", lambda: flash_attention_dq(*args), lambda: flash_attention_dq_plain(*args))):
        flops, nbytes = work[name]
        ms = cuda_ms(fn, 10)
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        res[name] = dict(
            ms=ms, plain_ms=cuda_ms(plain, 2, warmup=1), bound_ms=bound,
            bound_by="operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes",
            tflops=flops / ms / 1e9, over_bound=ms / bound)
    if packed:  # SDPA has no segment mask short of a dense one: no yardstick here
        res["library_ms"] = None
        return res
    # yardstick: SDPA's backward (dQ, dK and dV together) = fwd+bwd - fwd
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    g = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    fwd_ms = cuda_ms(sdpa, 10)
    both_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), g), 10)
    res["library_ms"] = both_ms - fwd_ms
    return res


# --- phase 3: outputs against the plain path -----------------------------------

@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain versions (reference
    runs only; the port itself has no such switch)."""
    from neuronx_distributed_tpu_torch.kernels.flash_attention import flash_attention_plain
    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_plain,
        paged_flash_decode_plain,
    )
    from neuronx_distributed_tpu_torch.modules import attention

    saved = (attention.flash_attention, attention.flash_decode_attention,
             attention.paged_flash_decode_attention)
    attention.flash_attention = lambda *a, **kw: flash_attention_plain(*a, **kw)[0]
    attention.flash_decode_attention = lambda *a, **kw: flash_decode_plain(*a, **kw)[0]
    attention.paged_flash_decode_attention = lambda *a, **kw: paged_flash_decode_plain(*a, **kw)[0]
    try:
        yield
    finally:
        (attention.flash_attention, attention.flash_decode_attention,
         attention.paged_flash_decode_attention) = saved


@contextlib.contextmanager
def gathered_paged_attention():
    """Attend a paged cache by gathering its logical view and running K4 on
    it, in place of K5 (the witness K5's serving run is held to; the port
    itself has no such switch)."""
    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_attention,
        paged_gather_leaf,
    )
    from neuronx_distributed_tpu_torch.modules import attention

    def gathered(q, k_pool, v_pool, block_table, q_pos, kv_valid=None, page_size=16):
        return flash_decode_attention(q, paged_gather_leaf(k_pool, block_table, page_size),
                                      paged_gather_leaf(v_pool, block_table, page_size),
                                      q_pos, kv_valid)

    saved, attention.paged_flash_decode_attention = attention.paged_flash_decode_attention, gathered
    try:
        yield
    finally:
        attention.paged_flash_decode_attention = saved


def scrambled_paged_cache(model, seed: int = 0):
    """A batch-1 paged cache (page_size 16, K5 attending) whose logical
    pages 0..7 map to a numpy-seeded random choice of pool pages and whose
    other entries point at page 0, filled with random garbage."""
    import numpy as np

    n_log = model.config.max_seq_len // 16
    cache = model.new_paged_cache(1, num_pages=n_log + 1, page_size=16)
    table = np.zeros((1, n_log), np.int32)
    table[0, :8] = np.random.default_rng(seed).permutation(np.arange(1, n_log + 1))[:8]
    cache.upload_table(table)
    g = torch.Generator(device=cache.k.device).manual_seed(seed)
    for pool in (cache.k, cache.v):
        pool[:, 0].normal_(generator=g)
    return cache


def teacher_logits(model, ids, steps: int, feed=None, cache=None):
    """Prefill ``ids`` then ``steps`` decode steps through ``cache`` (a fresh
    row cache by default); feeds ``feed`` tokens (or the greedy choice) and
    returns (logits (steps+1, V) f32, tokens)."""
    cache = model.new_cache(1) if cache is None else cache
    logits = [model(ids, mode="prefill", cache=cache, last_only=True)[0, -1].float()]
    toks = []
    for t in range(steps):
        tok = int(feed[t]) if feed is not None else int(logits[-1].argmax())
        toks.append(tok)
        x = torch.tensor([[tok]], device=ids.device)
        logits.append(model(x, mode="decode", cache=cache, last_only=True)[0, -1].float())
    return torch.stack(logits), toks


def check_outputs(model, gen) -> dict:
    """The kernels' logits against the plain path's, through a row cache
    (K1, K4) and through a paged cache behind a scrambled table (K1, K5)."""
    ids = torch.randint(1, model.config.vocab_size, (1, 64), generator=gen, device="cuda")
    with plain_attention():
        ref, toks = teacher_logits(model, ids, 8)
    res = {}
    for name, cache in (("row", None), ("paged", scrambled_paged_cache(model))):
        got, _ = teacher_logits(model, ids, 8, feed=toks, cache=cache)
        if not torch.isfinite(got).all():
            raise AssertionError(f"non-finite logits through the kernels ({name} cache)")
        scale = float(ref.abs().max())
        rel = max_err(got, ref) / scale
        agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
        in_top5 = bool((got.topk(5, dim=-1).indices == ref.argmax(-1)[:, None]).any(-1).all())
        # bf16 model with random weights: K1 rounds P to bf16 where the plain
        # path keeps f32 (~2^-9 relative per attention output), and 32 random
        # layers amplify it; near-ties among 128256 logits may swap the top-1,
        # so the plain path's choice must stay within the kernels' top 5
        if rel > 5e-2 or not in_top5:
            raise AssertionError(f"logits ({name} cache) disagree with the plain path: rel {rel}, "
                                 f"argmax {agree}/{ref.shape[0]}, plain top-1 in top-5: {in_top5}")
        res[name] = dict(rel_err=rel, argmax_agree=f"{agree}/{ref.shape[0]}", logit_scale=scale)
    return res


# --- phase 4: serving ---------------------------------------------------------

@contextlib.contextmanager
def eager_decode_step():
    """Run the engine's decode step eagerly in place of its captured graph
    (the witness the graph engine's streams are held to; the engine itself
    has no such switch)."""
    from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram

    saved = DecodeProgram.__call__
    DecodeProgram.__call__ = lambda self: self.step()
    try:
        yield
    finally:
        DecodeProgram.__call__ = saved


def decode_program(engine):
    """The engine's decode program, or None (not made yet, or a checkout
    whose engine launches every decode op from Python)."""
    return getattr(engine, "decode_program", None)


def engine_launches(engine, counts: dict):
    """(kernel launches of a run by wrapper, those of them the capture's
    warm-up made). A replay calls no wrapper, so the launches of the
    replays, ``replays x launches per replay``, are added to the wrappers'
    counts ``counts``; the warm-up (one masked no-op step before capture)
    launched through the wrappers what one replay launches, and is no
    decode step."""
    out, warm = dict(counts), dict.fromkeys(counts, 0)
    prog = decode_program(engine)
    if prog is not None:
        for name, n in prog.launches_per_replay.items():
            out[name] += prog.replays * n
            warm[name] = prog.captures * n
    return out, warm


def check_program(engine, what: str, eager: bool) -> None:
    """One captured decode program whose replays are the executed steps
    (none and eager steps for the witness)."""
    prog, snap = decode_program(engine), engine.metrics.snapshot()
    if prog is None:
        return
    want = (0, 0) if eager else (1, snap["executed_steps"])
    if (engine.decode_compilations, prog.replays) != want:
        raise AssertionError(f"{what}: decode_compilations {engine.decode_compilations}, replays "
                             f"{prog.replays}; want {want}")


def decode_records(prof, paged: bool) -> int:
    """The profiler's CUDA kernel records of K4 (``paged``: K5): the range
    kernel and the merge, two per call."""
    n = 0
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        if "flash_decode_kernel" in e.name and ("paged_" in e.name) == paged:
            n += 1
    return n


def serve(model, gen):
    """Phase 4's workload through the engine as it serves (its decode
    program captured at the first chunk)."""
    lengths = [30, 250, 700, 1500, 2200, 3000]
    new = 32
    prompts = [torch.randint(1, model.config.vocab_size, (n,), generator=gen, device="cuda")
               .cpu().numpy() for n in lengths]
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig

    cfgs = [GenerationConfig(max_new_tokens=new, temperature=0.0) for _ in lengths]
    cfgs[2] = GenerationConfig(max_new_tokens=new, temperature=0.8, top_k=50)
    return serve_workload(model, (prompts, cfgs))


def serve_workload(model, workload, eager: bool = False) -> dict:
    """Six requests into 8 slots, chunk 8: all admitted in the first step
    (six prefills, then one decode chunk), then decode-only steps. Every
    kernel's launch count is zeroed just before and read just after.
    ``eager`` runs the decode step eagerly (the witness)."""
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    prompts, cfgs = workload
    layers = model.config.num_layers
    engine = ServingEngine(model, num_slots=8, decode_chunk_size=8)
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    with eager_decode_step() if eager else contextlib.nullcontext():
        t0 = time.perf_counter()
        reqs = [engine.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
        engine.step()  # admits all six (8 slots): six prefills, then one decode chunk
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps0, executed0 = engine.metrics.steps, engine.metrics.executed_steps
        engine.run()  # decode-only steps
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches, warm = engine_launches(engine, {name: c.launches for name, c in counters.items()})
    for r in reqs:
        if r.state is not RequestState.DONE or len(r.tokens) != r.config.max_new_tokens:
            raise AssertionError(f"request {r.rid}: {r.state} with {len(r.tokens)} tokens")
        if not all(0 <= t < model.config.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid}: token outside the vocabulary")
    if min(launches["flash_attention"], launches["flash_decode"]) < 1:
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    if launches["paged_flash_decode"] or launches["flash_attention_dkdv"] or launches["flash_attention_dq"]:
        raise AssertionError(f"row serving launched a kernel of another path: {launches}")
    snap = engine.metrics.snapshot()
    # executed steps each ran the whole model (and one K4 per layer); used
    # steps had a live slot — the rest were masked no-ops
    if launches["flash_decode"] - warm["flash_decode"] != snap["executed_steps"] * layers:
        raise AssertionError(f"K4 launches {launches['flash_decode']} (warm-up "
                             f"{warm['flash_decode']}) != executed steps "
                             f"{snap['executed_steps']} x {layers} layers")
    check_program(engine, "serving", eager)
    prog = decode_program(engine)
    return dict(wall_s=t2 - t0, admit_s=t1 - t0, decode_s=t2 - t1,
                decode_only_executed=snap["executed_steps"] - executed0,
                decode_only_used=snap["steps"] - steps0, launches=launches, snap=snap,
                prefills=snap["prefills"], workload=workload,
                tokens=[list(r.tokens) for r in reqs],
                compilations=getattr(engine, "decode_compilations", None),
                replays=prog.replays if prog is not None else None,
                per_replay=dict(prog.launches_per_replay) if prog is not None else None)


def prewarm(engine) -> float:
    """Capture the engine's decode program before the profiler opens (0 for
    a checkout without one)."""
    return engine.prewarm() if hasattr(engine, "prewarm") else 0.0


def profile_serving(model, workload) -> dict:
    """The serving workload once more under ``torch.profiler``: device time
    by kernel family, and the profiler's count of K4 kernel records against
    the executed steps. The decode program is captured before the profiler
    opens. The profiler slows the host several-fold, so only its device
    times are used (against the unprofiled run's wall)."""
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    prompts, cfgs = workload
    engine = ServingEngine(model, num_slots=8, decode_chunk_size=8)
    capture_s = prewarm(engine)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, (p, c) in enumerate(zip(prompts, cfgs)):
            engine.submit(p, c, seed=i)
        engine.run()
        torch.cuda.synchronize()
    executed = engine.metrics.executed_steps
    records = decode_records(prof, paged=False)
    if records != 2 * executed * model.config.num_layers:
        raise AssertionError(f"profiled serving: {records} K4 kernel records != 2 x {executed} "
                             f"executed steps x {model.config.num_layers} layers")
    fams = device_time_by_family(prof, {"flash_attention": "flash_fwd_kernel",
                                        "flash_decode": "flash_decode_kernel"})
    return dict(fams=fams, records=records, executed=executed, capture_s=capture_s)


def paged_workload(vocab: int):
    """12 chat turns of 100-400 tokens and 3 documents of 2000-3000 tokens,
    a document after every fourth chat (the JAX bench's paged leg,
    ``bench.py:1049-1087``, at Llama-3-8B scale); 32 new tokens each,
    temperature 0.8 with top_k 20 except two greedy requests."""
    import numpy as np

    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig

    rng = np.random.default_rng(3)
    chats = [rng.integers(1, vocab, size=int(rng.integers(100, 401))) for _ in range(12)]
    docs = [rng.integers(1, vocab, size=int(rng.integers(2000, 3001))) for _ in range(3)]
    prompts = []
    for i, p in enumerate(chats):
        prompts.append(p)
        if i % 4 == 3:
            prompts.append(docs[i // 4])
    cfgs = [GenerationConfig(max_new_tokens=32, temperature=0.8, top_k=20) for _ in prompts]
    for i in (1, 9):
        cfgs[i] = GenerationConfig(max_new_tokens=32, temperature=0.0)
    return prompts, cfgs


PAGED_SLOTS, PAGE, ROW_SLOTS = 16, 16, 4


def serve_paged(model, workload, attention: str, profiled: bool = False,
                eager: bool = False) -> dict:
    """The paged engine (16 slots, page_size 16, chunk 8, conservative,
    FIFO) over a pool of ROW_SLOTS row slots' bytes plus the null page,
    answering ``workload``; every kernel's launch count is zeroed just
    before and read just after. ``attention`` is ``"fused"`` (the engine as
    it serves, K5) or ``"gather"`` (K4 on the gathered view patched in, the
    witness: patched before the first chunk, so the graph captures it).
    ``eager`` runs the decode step eagerly (the graph's witness).
    ``profiled`` captures the decode program first, then runs under the
    profiler and adds the device time by family and the profiler's count
    of K5 records (its walls are the profiler's, not the engine's)."""
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    cfg = model.config
    engine = ServingEngine(model, num_slots=PAGED_SLOTS, decode_chunk_size=8, kv_page_size=PAGE,
                           kv_num_pages=ROW_SLOTS * cfg.max_seq_len // PAGE + 1)
    prompts, cfgs = workload
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    capture_s = prewarm(engine) if profiled else 0.0
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
           else contextlib.nullcontext())
    route = gathered_paged_attention() if attention == "gather" else contextlib.nullcontext()
    decode_s, decode_executed = 0.0, 0
    with route, eager_decode_step() if eager else contextlib.nullcontext(), ctx as prof:
        t0 = time.perf_counter()
        reqs = [engine.submit(p, c, seed=i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
        while engine.has_work:
            prefills, executed = engine.metrics.prefills, engine.metrics.executed_steps
            t1 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            if engine.metrics.prefills == prefills:  # a decode-only step
                decode_s += time.perf_counter() - t1
                decode_executed += engine.metrics.executed_steps - executed
        wall = time.perf_counter() - t0
    launches, warm = engine_launches(engine, {name: c.launches for name, c in counters.items()})
    engine.cache.check()
    for r in reqs:
        if r.state is not RequestState.DONE or len(r.tokens) != 32:
            raise AssertionError(f"paged request {r.rid}: {r.state} with {len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"paged request {r.rid}: token outside the vocabulary")
    snap = engine.metrics.snapshot()
    want = {"paged_flash_decode": 0, "flash_decode": 0}
    want["paged_flash_decode" if attention == "fused" else "flash_decode"] = (
        snap["executed_steps"] * cfg.num_layers)
    got = {k: launches[k] - warm[k] for k in want}
    if got != want:
        raise AssertionError(f"paged ({attention}) decode launches {got} != {want}")
    if launches["flash_attention"] != snap["prefills"] * cfg.num_layers:
        raise AssertionError(f"paged ({attention}) K1 launches {launches['flash_attention']} != "
                             f"{snap['prefills']} prefills x {cfg.num_layers} layers")
    if snap["peak_occupancy"] <= ROW_SLOTS:
        raise AssertionError(f"paged: at most {snap['peak_occupancy']} requests decoded at once, "
                             f"no more than the {ROW_SLOTS} row slots of the same bytes")
    check_program(engine, f"paged serving ({attention})", eager)
    prog = decode_program(engine)
    res = dict(tokens=[list(r.tokens) for r in reqs], launches=launches, snap=snap, wall_s=wall,
               decode_s=decode_s, decode_executed=decode_executed,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               pool_gib=engine.cache.nbytes / 2**30,
               compilations=getattr(engine, "decode_compilations", None),
               capture_s=capture_s or snap.get("capture_s", 0.0),
               replays=prog.replays if prog is not None else None)
    if profiled:
        res["records"] = decode_records(prof, paged=attention == "fused")
        if res["records"] != 2 * snap["executed_steps"] * cfg.num_layers:
            raise AssertionError(f"profiled paged serving: {res['records']} K5 kernel records != "
                                 f"2 x {snap['executed_steps']} executed steps x "
                                 f"{cfg.num_layers} layers")
        res["fams"] = device_time_by_family(prof, {
            "paged_flash_decode": "paged_flash_decode_kernel",
            "flash_attention": "flash_fwd_kernel", "flash_decode": "flash_decode_kernel"})
    del engine
    torch.cuda.empty_cache()
    return res


def device_time_by_family(prof, kernels: dict) -> dict:
    """Device ms of a profile by family: each of ``kernels`` (family: a
    substring of its CUDA kernel's name; the first that matches wins), GEMMs,
    and everything else."""
    fams = {**{fam: 0.0 for fam in kernels}, "gemm": 0.0, "other": 0.0}
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        name = e.name
        fam = next((f for f, key in kernels.items() if key in name), None)
        if fam is None:
            fam = ("gemm" if any(t in name for t in ("nvjet", "gemm", "cutlass", "xmma"))
                   else "other")
        fams[fam] += e.device_time / 1e3  # us -> ms
    return fams


# --- phases 6-7: training ------------------------------------------------------

EOS_ID = 128001  # Llama-3's <|end_of_text|>


def packed_batch(vocab: int, b: int, s: int, seed: int = 0) -> dict:
    """``b`` windows of ``s`` tokens from ``pack_documents`` over random
    documents of 200..3000 tokens with an EOS separator: ids, labels,
    segment ids and the boundary loss mask (as ``PackedCorpus`` emits)."""
    import numpy as np

    from neuronx_distributed_tpu_torch.trainer.data import pack_documents

    rng = np.random.default_rng(seed)
    docs, n = [], 0
    while n < b * (s + 1):
        docs.append(rng.integers(1, vocab - 1, size=int(rng.integers(200, 3001))))
        n += len(docs[-1]) + 1
    windows, segs = pack_documents(docs, s, EOS_ID, return_segments=True)
    w, g = windows[:b], segs[:b]
    return {"input_ids": w[:, :-1], "labels": w[:, 1:], "segment_ids": g[:, :-1],
            "loss_mask": (g[:, :-1] == g[:, 1:]).astype(np.float32)}


def kernel_counters():
    from neuronx_distributed_tpu_torch.kernels.flash_attention import (
        flash_attention_dkdv,
        flash_attention_dq,
        flash_attention_fwd,
    )
    from neuronx_distributed_tpu_torch.kernels.flash_decode import (
        flash_decode_fwd,
        paged_flash_decode_fwd,
    )

    return {"flash_attention": flash_attention_fwd, "flash_attention_dkdv": flash_attention_dkdv,
            "flash_attention_dq": flash_attention_dq, "flash_decode": flash_decode_fwd,
            "paged_flash_decode": paged_flash_decode_fwd}


def train_vs_plain() -> dict:
    """One step's loss and gradients of a 2-layer llama3_8b-width model at
    S=1024 through the kernels, and with the plain versions swapped in."""
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, llama3_8b
    from neuronx_distributed_tpu_torch.parallel.grads import global_grad_norm
    from neuronx_distributed_tpu_torch.trainer.trainer import _to_device, default_loss_fn

    model = init_params(LlamaForCausalLM(llama3_8b(num_layers=2), trainable=True), seed=1)
    batch = _to_device(packed_batch(model.config.vocab_size, 2, 1024, seed=1), model.device)
    watched = [n for n, _ in model.named_parameters() if ".attn.qkv." in n]
    runs = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        with plain_attention() if plain else contextlib.nullcontext():
            loss = default_loss_fn(model, batch)
            loss.backward()
        grads = dict(model.named_parameters())
        runs.append((float(loss.detach()), float(global_grad_norm([p.grad for p in model.parameters()])),
                     {n: grads[n].grad.clone() for n in watched}))
    (lk, nk, gk), (lp, np_, gp) = runs
    rel = {n: float((gk[n] - gp[n]).norm() / gp[n].norm()) for n in watched}
    out = dict(loss=lk, loss_rel=abs(lk - lp) / abs(lp), gnorm_rel=abs(nk - np_) / np_,
               qkv_grad_rel=max(rel.values()), qkv_grad_worst=max(rel, key=rel.get))
    del model, runs, gk, gp
    torch.cuda.empty_cache()
    # bf16 model: K1 rounds P, K2/K3 round P and dS to bf16 where the plain
    # path keeps f32 (~2^-9 relative per term); the q/k/v projection
    # gradients are the ones that attention's backward alone produces
    if not (out["loss_rel"] <= 1e-3 and out["gnorm_rel"] <= 1e-2 and out["qkv_grad_rel"] <= 2e-2):
        raise AssertionError(f"training: kernel path vs plain path: {out}")
    return out


def train_phase(steps: int = 6) -> dict:
    """Llama-3-8B width at 8 layers, fp32 masters, AdamW (lr 1e-3, weight
    decay 0.1, clip 1.0), remat on: ``steps`` steps on one packed batch."""
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, llama3_8b
    from neuronx_distributed_tpu_torch.trainer import (
        OptimizerConfig,
        build_train_step,
        create_train_state,
        make_optimizer,
    )

    cfg = llama3_8b(num_layers=8)
    b, s = 2, 4096
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, trainable=True)
    opt_cfg = OptimizerConfig(learning_rate=1e-3, weight_decay=0.1, max_grad_norm=1.0)
    optimizer = make_optimizer(opt_cfg)
    state = create_train_state(model, optimizer, seed=0)
    step = build_train_step(model, optimizer, max_grad_norm=opt_cfg.max_grad_norm)
    batch = packed_batch(cfg.vocab_size, b, s)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    losses, walls = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": 2 * cfg.num_layers * steps, "flash_attention_dkdv":
            cfg.num_layers * steps, "flash_attention_dq": cfg.num_layers * steps, "flash_decode": 0,
            "paged_flash_decode": 0}
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: {losses}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    fams = device_time_by_family(prof, {"flash_attention": "flash_fwd_kernel",
                                        "flash_attention_dkdv": "flash_dkdv_kernel",
                                        "flash_attention_dq": "flash_dq_kernel"})
    seg = torch.from_numpy(batch["segment_ids"]).cuda()
    pairs = live_pairs(seg, b, s, seg.device)
    d, h = cfg.head_dim_, cfg.num_heads
    embed = model.model.embed.weight.numel()
    # model FLOPs: 6 per matmul parameter per token (fwd + bwd; the embedding
    # lookup has none) and attention's two products, 4*D*H per live pair
    # forward, 3x that with the backward; the remat recompute is not counted
    flops = 6.0 * (n_params - embed) * b * s + 12.0 * d * h * pairs * cfg.num_layers
    wall = statistics.median(walls[1:])
    del state, step, model, optimizer
    torch.cuda.empty_cache()
    return dict(losses=losses, walls=walls, wall=wall, tokens_per_s=b * s / wall,
                flops=flops, mfu=flops / wall / PEAK_BF16_FLOPS, peak_gib=peak / 2**30,
                launches=launches, fams=fams, n_params=n_params, init_s=init_s,
                pairs=pairs, docs=int(seg.max()) + 1)


def ptxas_lines(report: list, sym: str) -> list:
    """The ``ptxas -v`` lines of kernel ``sym`` in a library's report."""
    at = next(i for i, line in enumerate(report) if "entry function" in line and sym in line)
    out = []
    for line in report[at + 1:]:
        if "entry function" in line:
            break
        out.append(line.split(":", 1)[-1].strip())
    return out


def fwd_resources() -> dict:
    """K1's resources as built, as ``bwd_resources``; K1 must not spill, and
    ptxas must not have serialized its ``wgmma`` products (C7514/C7515)."""
    import ctypes

    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("flash_attention")
    text = _build.resource_report("flash_attention")
    vals = (ctypes.c_int * 4)()
    _build.check(lib.nxd_flash_attention_fwd_resources(vals), "flash_fwd_kernel")
    ptxas = ptxas_lines(text.splitlines(), "flash_fwd_kernel")
    spills = [line for line in ptxas if "spill" in line]
    if vals[2] or not spills or any("0 bytes spill stores, 0 bytes spill loads" not in line
                                    for line in spills):
        raise AssertionError(f"K1 spills: {vals[2]} B local a thread; ptxas: {ptxas}")
    if "C7514" in text or "C7515" in text:
        raise AssertionError(f"ptxas serialized K1's wgmma products:\n{text}")
    return dict(kernel="flash_fwd_kernel", smem=vals[0], regs=vals[1], local=vals[2],
                blocks_per_sm=vals[3], ptxas="; ".join(ptxas))


def bwd_resources() -> list:
    """K2's and K3's resources as built: dynamic shared memory, registers a
    thread at entry, spill bytes and blocks per SM from the runtime, and the
    ``ptxas -v`` lines of each kernel."""
    import ctypes

    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("flash_attention_bwd")
    report = _build.resource_report("flash_attention_bwd").splitlines()
    out = []
    for which, sym in ((0, "flash_dkdv_kernel"), (1, "flash_dq_kernel")):
        vals = (ctypes.c_int * 4)()
        _build.check(lib.nxd_flash_attention_bwd_resources(which, vals), sym)
        out.append(dict(kernel=sym, smem=vals[0], regs=vals[1], local=vals[2], blocks_per_sm=vals[3],
                        ptxas="; ".join(ptxas_lines(report, sym))))
    return out


def decode_resources() -> tuple:
    """K4's and K5's resources as built, at R <= 4 (Llama-3-8B's group of 4
    at s = 1) and R <= 32: dynamic shared memory, registers a thread, local
    bytes and blocks per SM from the runtime; and ``ptxas -v``'s spill line
    of every decode kernel and merge, which must show no spill. Returns
    (the resources, the number of kernels ``ptxas`` reported)."""
    import ctypes

    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("flash_decode")
    out = []
    for paged in (0, 1):
        for rmax in (4, 32):
            vals = (ctypes.c_int * 4)()
            _build.check(lib.nxd_flash_decode_resources(paged, rmax, vals), "flash_decode")
            out.append(dict(kernel=f"{'paged_' if paged else ''}flash_decode_kernel<{rmax}>",
                            smem=vals[0], regs=vals[1], local=vals[2], blocks_per_sm=vals[3]))
    report = _build.resource_report("flash_decode").splitlines()
    spills = [line.strip() for line in report if "spill" in line]
    if any("0 bytes spill stores, 0 bytes spill loads" not in line for line in spills):
        raise AssertionError("a decode kernel spills:\n" + "\n".join(spills))
    return out, len(spills)


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
    _build.build(["flash_attention", "flash_attention_bwd", "flash_decode"])
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, the three sources in parallel)")
    for r in [fwd_resources(), *bwd_resources()]:
        log(f"{r['kernel']}: {r['smem']} B dynamic shared memory a block, {r['regs']} registers a "
            f"thread at entry, {r['local']} B local a thread, {r['blocks_per_sm']} block(s) per SM; "
            f"ptxas: {r['ptxas']}")
    dres, n_spill_lines = decode_resources()
    for r in dres:
        log(f"{r['kernel']}: {r['smem']} B dynamic shared memory a block, {r['regs']} registers a "
            f"thread, {r['local']} B local a thread, {r['blocks_per_sm']} block(s) per SM")
    log(f"ptxas -v, csrc/flash_decode.cu: {n_spill_lines} kernels, none spills")

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = [check_k1(gen, b, s, segments) for _, b, s, segments in K1_SHAPES]
    for (path, *_), r in zip(K1_SHAPES, k1):
        seg = ("unsegmented" if r["segments"] is None else "packed" if r["segments"] == "packed"
               else f"pad {r['segments']}")
        tag = f"K1 flash_attention B={r['b']} S={r['s']} H=32 Hkv=8 D=128 causal {seg} ({path})"
        log(f"{tag}: max_err {r['err']:.3g} ({r['ratio']:.3g}x its limit; a dropped K tile reads "
            f"{r['fault_ratio']:.3g}x); two runs bitwise equal; kernel_ms {r['ms']:.4f} (graph "
            f"replay; back to back {r['eager_ms']:.4f}) plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}; {r['ms'] / r['bound_ms']:.2f}x, "
            f"{r['tflops']:.1f} TFLOP/s) library_ms {r['library_ms']:.4f} (SDPA, "
            f"{'is_causal' if r['segments'] is None else 'bool mask'}, GQA; graph replay; back to "
            f"back {r['library_eager_ms']:.4f})")
        pl = r["plan"]
        log(f"{tag} tile plan: {pl['blocks']} blocks, {pl['grid']} (query tile, key tile) pairs "
            f"over the heads, {pl['visited']} visited, {pl['masked']} of them masked, {pl['live']} "
            f"hold a live pair; the visited tiles hold {pl['work_over_bound']:.3f}x the live pairs")
    k4 = check_k4(gen)
    log(f"K4 flash_decode B=8 s=1 H=32 Hkv=8 D=128 L=8192 bound 4100: max_err {k4['err']:.3g} "
        f"({k4['ratio']:.3g}x its limit; a dropped partial tile reads {k4['fault_ratio']:.3g}x) "
        f"kernel_ms {k4['ms']:.4f} (graph replay; back to back {k4['eager_ms']:.4f}) plain_ms "
        f"{k4['plain_ms']:.4f} bound_ms {k4['bound_ms']:.4f} ({k4['bound_by']}) library_ms "
        f"{k4['library_ms']:.4f} (SDPA, bool mask, GQA; graph replay; back to back "
        f"{k4['library_eager_ms']:.4f})")
    k5 = check_k5(gen, "k4", timed=True)
    k5s = check_k5(gen, "serving", timed=False)
    for name, r in (("K4's shapes", k5), ("the paged serving geometry", k5s)):
        log(f"K5 paged_flash_decode at {name}: B={r['slots']} s=1 H=32 Hkv=8 D=128 L=8192 "
            f"bound {r['bound_cols']} page_size 16, pool {r['pages']} pages ({r['mapped']} mapped "
            f"through a scrambled table), garbage null page, {r['live_cols']} live columns: "
            f"max_err {r['err']:.3g} ({r['ratio']:.3g}x its limit; a dropped partial tile reads "
            f"{r['fault_ratio']:.3g}x); bitwise equal to K4 on the gathered view, blind to the "
            f"null page, two runs bitwise equal; kernel_ms {r['ms']:.4f} (graph replay; back to "
            f"back {r['eager_ms']:.4f}) bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    for name, r in (("K4", k4), ("K5 at K4's shapes", k5), ("K5 at the paged serving geometry", k5s)):
        pl = r["plan"]
        log(f"{name} split plan: grid {pl['grid']} blocks ({pl['splits']} ranges of a slot and "
            f"kv-head, {pl['ranges']} before the bound: {pl['in_bound']} blocks run, "
            f"{pl['working']} with a live tile, {pl['live_tiles']} live 64-column tiles); "
            f"bytes the plan moves {pl['read_bytes']} against the bound's {pl['bound_bytes']} "
            f"({pl['read_bytes'] / pl['bound_bytes']:.3f}x)")
    log(f"K5 at K4's shapes: plain_ms {k5['plain_ms']:.4f} library_ms {k5['library_ms']:.4f} "
        f"(SDPA on the gathered view, bool mask, GQA; graph replay) + gather_ms {k5['gather_ms']:.4f} "
        f"(K and V views)")
    k23 = {(s, packed): check_k2k3(gen, s, packed, timed=s == 4096)
           for s, packed in ((4096, False), (4096, True), (1000, False))}
    for (s, packed), r in k23.items():
        log(f"K2/K3 flash_attention_dkdv/dq B=2 S={s} H=32 Hkv=8 D=128 causal "
            f"{'packed' if packed else 'unpacked'}: max_err "
            + ", ".join(f"{n} {r['err'][n]:.3g} ({r['ratio'][n]:.3g}x its limit; a dropped key "
                        f"tile reads {r['fault'][n]:.3g}x)" for n in ("dk", "dv", "dq"))
            + "; two runs bitwise equal")
    k23_main = k23[(4096, False)]
    for packed in (False, True):
        for n in ("dkdv", "dq"):
            r = k23[(4096, packed)][n]
            log(f"K{2 if n == 'dkdv' else 3} flash_attention_{n} S=4096 "
                f"{'packed' if packed else 'unpacked'}: kernel_ms {r['ms']:.4f} plain_ms "
                f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}); "
                f"{r['tflops']:.1f} TFLOP/s, {r['over_bound']:.2f}x its bound")
    log(f"SDPA backward (dQ, dK, dV together; fwd+bwd - fwd, is_causal, GQA) S=4096: "
        f"library_ms {k23_main['library_ms']:.4f}")
    torch.cuda.empty_cache()

    cfg = llama3_8b()
    t0 = time.perf_counter()
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    torch.cuda.synchronize()
    log(f"model: llama3_8b, {cfg.num_layers} layers (no depth cut), "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params bf16, "
        f"init {time.perf_counter() - t0:.1f} s")
    for name, out in check_outputs(model, gen).items():
        log(f"outputs vs plain path ({name} cache{', scrambled table, K5' if name == 'paged' else ''}"
            f"; 64-token prompt, 8 decode steps): rel_err {out['rel_err']:.3g} argmax "
            f"{out['argmax_agree']} logit_scale {out['logit_scale']:.3g}")

    srv = serve(model, gen)
    snap = srv["snap"]
    wit = serve_workload(model, srv["workload"], eager=True)
    if wit["tokens"] != srv["tokens"]:
        diff = [i for i, (a, b) in enumerate(zip(srv["tokens"], wit["tokens"])) if a != b]
        raise AssertionError(f"serving token streams differ between the decode graph and the "
                             f"eager step: requests {diff}")
    log(f"serving: 6 requests (prompts 30..3000, 32 new tokens, 1 sampled), 8 slots, chunk 8: "
        f"wall {srv['wall_s']:.3f} s (capture {snap['capture_s']:.4f} s of it), prefills "
        f"{srv['prefills']}, decode steps "
        f"{snap['executed_steps']} executed ({snap['executed_steps'] - snap['steps']} masked no-ops), "
        f"TTFT mean {snap['mean_ttft']:.4f} s max {snap['max_ttft']:.4f} s, "
        f"decode {snap['chunk_tokens_per_sec']:.1f} tok/s (chunk wall), "
        f"prefill wall {snap['prefill_wall_s']:.4f} s, cursor {snap['cursor_high_water']}, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for name, r in (("decode graph", srv), ("eager step (witness)", wit)):
        log(f"serving breakdown, {name}: admission step (6 prefills + 1 chunk"
            f"{', its capture included' if r is srv else ''}) {r['admit_s']:.4f} s, "
            f"{r['decode_only_executed']} decode-only steps executed ({r['decode_only_used']} "
            f"with a live slot) {r['decode_s']:.4f} s "
            f"({1e3 * r['decode_s'] / max(r['decode_only_executed'], 1):.2f} ms per executed "
            f"step, 8 slots), TTFT mean {r['snap']['mean_ttft']:.4f} s")
    log(f"serving decode program: decode_compilations {srv['compilations']}, captured at the "
        f"first chunk in {snap['capture_s']:.4f} s (warm-up included), {srv['replays']} replays "
        f"= executed steps, launches per replay {srv['per_replay']}; the eager step's token "
        f"streams are identical")
    log(f"launches on the serving path: {srv['launches']} (replays x launches per replay, plus "
        f"the wrappers' own: prefills and the capture's warm-up)")
    prof_row = profile_serving(model, srv["workload"])
    fams = prof_row["fams"]
    busy = sum(fams.values())
    wall_ms = 1e3 * (srv["wall_s"] - snap["capture_s"])
    log("device time of the serving workload (profiler, ms; decode program captured before the "
        "profiler opened): " + ", ".join(f"{k} {v:.2f}" for k, v in fams.items())
        + f"; busy {busy:.2f} of the unprofiled wall less its capture {wall_ms:.2f} "
        f"(idle share {1 - busy / wall_ms:.3f}); K4 kernel records {prof_row['records']} = 2 x "
        f"{prof_row['executed']} executed steps x {cfg.num_layers} layers (range + merge)")

    torch.cuda.empty_cache()
    workload = paged_workload(cfg.vocab_size)
    fused = serve_paged(model, workload, "fused")
    gather = serve_paged(model, workload, "gather")
    eager = serve_paged(model, workload, "fused", eager=True)
    for name, r in (("gather", gather), ("eager step", eager)):
        if fused["tokens"] != r["tokens"]:
            diff = [i for i, (a, b) in enumerate(zip(fused["tokens"], r["tokens"])) if a != b]
            raise AssertionError(f"paged token streams differ between fused and {name}: "
                                 f"requests {diff}")
    prof = serve_paged(model, workload, "fused", profiled=True)
    if prof["tokens"] != fused["tokens"]:
        raise AssertionError("paged token streams differ between the fused run and its profiled rerun")
    chats = [len(p) for p in workload[0] if len(p) < 1000]
    docs = [len(p) for p in workload[0] if len(p) >= 1000]
    log(f"paged serving: 15 requests (12 chats of {min(chats)}..{max(chats)} tokens, 3 documents "
        f"of {min(docs)}..{max(docs)}; 32 new tokens, 2 greedy), "
        f"{PAGED_SLOTS} slots, page_size {PAGE}, pool {fused['pool_gib']:.3f} GiB "
        f"(= {ROW_SLOTS} row slots + the null page), chunk 8, conservative; fused, gather "
        f"(captured with the patch in force) and eager-step token streams identical")
    for name, r in (("fused (K5)", fused), ("gather (K4)", gather), ("fused, eager step", eager)):
        sn = r["snap"]
        log(f"paged serving {name}: wall {r['wall_s']:.3f} s (capture {sn['capture_s']:.4f} s of "
            f"it), decode_compilations {r['compilations']}, replays {r['replays']}, prefills "
            f"{sn['prefills']}, decode "
            f"steps {sn['executed_steps']} executed ({sn['executed_steps'] - sn['steps']} masked "
            f"no-ops), TTFT mean {sn['mean_ttft']:.4f} s max {sn['max_ttft']:.4f} s, decode "
            f"{sn['chunk_tokens_per_sec']:.1f} tok/s (chunk wall), {r['decode_executed']} "
            f"decode-only steps executed {r['decode_s']:.4f} s "
            f"({1e3 * r['decode_s'] / max(r['decode_executed'], 1):.2f} ms per executed step), "
            f"mean occupancy {sn['mean_occupancy']:.2f}, peak occupancy {sn['peak_occupancy']}, "
            f"peak pages mapped {sn['peak_pages_mapped']}, peak mem {r['peak_gib']:.1f} GiB")
        log(f"launches on the paged serving path ({name}): {r['launches']}")
    busy = sum(prof["fams"].values())
    wall_ms = 1e3 * (fused["wall_s"] - fused["capture_s"])
    log(f"device time of the paged serving workload, fused (profiler, ms; decode program "
        f"captured before the profiler opened, in {prof['capture_s']:.4f} s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in prof["fams"].items())
        + f"; busy {busy:.2f} of the unprofiled wall less its capture {wall_ms:.2f} "
        f"(idle share {1 - busy / wall_ms:.3f}); K5 kernel records {prof['records']} = 2 x "
        f"{prof['snap']['executed_steps']} executed steps x {cfg.num_layers} layers")

    del model
    torch.cuda.empty_cache()

    tvp = train_vs_plain()
    log(f"training, kernel path vs plain path (2 layers, 2 x 1024 packed, one step): loss "
        f"{tvp['loss']:.5f} rel_err {tvp['loss_rel']:.3g}, grad norm rel_err {tvp['gnorm_rel']:.3g}, "
        f"q/k/v projection grads rel_err <= {tvp['qkv_grad_rel']:.3g} ({tvp['qkv_grad_worst']})")
    tr = train_phase()
    log(f"training: llama3_8b width, 8 layers (depth cut: fp32 masters + grads + 2 AdamW moments "
        f"= 16 B/param), {tr['n_params'] / 1e9:.3f} B params, init {tr['init_s']:.1f} s; batch 2 x "
        f"4096 packed ({tr['docs']} documents, {tr['pairs']} live attention pairs per head), "
        f"remat on, AdamW lr 1e-3 wd 0.1 clip 1.0")
    log("training losses: " + ", ".join(f"{x:.5f}" for x in tr["losses"])
        + "; step walls (s): " + ", ".join(f"{x:.4f}" for x in tr["walls"]))
    log(f"training: step wall {tr['wall']:.4f} s (median of steps 2-6), {tr['tokens_per_s']:.1f} "
        f"tokens/s, model {tr['flops'] / tr['wall'] / 1e12:.1f} TFLOP/s, mfu {tr['mfu']:.4f} "
        f"(of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s), peak mem {tr['peak_gib']:.2f} GiB")
    log(f"launches on the training path (6 steps): {tr['launches']}")
    busy = sum(tr["fams"].values())
    log("device time of one training step (profiler, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in tr["fams"].items())
        + f"; busy {busy:.2f} of the unprofiled step wall {1e3 * tr['wall']:.2f} "
        f"(idle share {1 - busy / (1e3 * tr['wall']):.3f})")

    k1_main = k1[1]  # the serving prefill at S=4096
    launches = {name: srv["launches"][name] + fused["launches"][name] + tr["launches"][name]
                for name in tr["launches"]}
    log(f"launches on the main paths (serving, paged serving with K5, training): {launches}")
    k23_err = {n: max(r["err"][n] for r in k23.values()) for n in ("dk", "dv", "dq")}
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_attention.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_attention.py:199",
             launches=launches["flash_attention"],
             max_abs_err=max(r["err"] for r in k1), ms=k1_main["ms"],
             plain_ms=k1_main["plain_ms"], bound_ms=k1_main["bound_ms"],
             bound_by=k1_main["bound_by"], library_ms=k1_main["library_ms"]),
        dict(name="flash_attention_dkdv", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_attention.py:389",
             launches=launches["flash_attention_dkdv"],
             max_abs_err=max(k23_err["dk"], k23_err["dv"]), ms=k23_main["dkdv"]["ms"],
             plain_ms=k23_main["dkdv"]["plain_ms"], bound_ms=k23_main["dkdv"]["bound_ms"],
             bound_by=k23_main["dkdv"]["bound_by"], library_ms=k23_main["library_ms"]),
        dict(name="flash_attention_dq", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_attention.py:448",
             launches=launches["flash_attention_dq"], max_abs_err=k23_err["dq"],
             ms=k23_main["dq"]["ms"], plain_ms=k23_main["dq"]["plain_ms"],
             bound_ms=k23_main["dq"]["bound_ms"], bound_by=k23_main["dq"]["bound_by"],
             library_ms=k23_main["library_ms"]),
        dict(name="flash_decode", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:301",
             launches=launches["flash_decode"], max_abs_err=k4["err"], ms=k4["ms"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"], bound_by=k4["bound_by"],
             library_ms=k4["library_ms"]),
        dict(name="paged_flash_decode", route="cuda",
             source="neuronx_distributed_tpu_torch/csrc/flash_decode.cu",
             replaces="neuronx_distributed_tpu/kernels/flash_decode.py:617",
             launches=launches["paged_flash_decode"], max_abs_err=k5["err"], ms=k5["ms"],
             plain_ms=k5["plain_ms"], bound_ms=k5["bound_ms"], bound_by=k5["bound_by"],
             library_ms=k5["library_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
