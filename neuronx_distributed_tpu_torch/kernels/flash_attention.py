"""Flash attention, forward and backward (counterpart of
``neuronx_distributed_tpu/kernels/flash_attention.py``).

Three hand-written CUDA kernels, each behind a wrapper that launches it for
CUDA tensors (or raises) and runs the plain PyTorch version beside it for
CPU tensors; nothing else decides:

* ``flash_attention_fwd`` — K1, ``csrc/flash_attention.cu`` (replaces the
  Pallas ``_fwd_kernel``/``_flash_fwd``, ``flash_attention.py:78,199``);
* ``flash_attention_dkdv`` — K2, ``csrc/flash_attention_bwd.cu`` (replaces
  ``_dkdv_kernel``/``_flash_dkdv``, ``:242,389``);
* ``flash_attention_dq`` — K3, the same source (replaces ``_dq_kernel``/
  ``_flash_dq``, ``:315,448``).

:class:`FlashAttentionFunction` wires them as the JAX ``custom_vjp``
``_flash_attention_bhsd`` does (``:493-511``); :func:`flash_attention` goes
through it only when an input requires grad. The public API keeps the JAX
``(B, S, H, D)`` layout, GQA by ``h // group`` and the equal-segment mask
(padding = segment ``-1``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _check_args(q, k, v, segment_ids, kv_segment_ids):
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if (segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("segment_ids and kv_segment_ids must be given together")


def _live(q, k, causal, segment_ids, kv_segment_ids) -> torch.Tensor:
    """(B, 1, 1, S, Sk) True where query row i may attend key j: causal
    top-left (j <= i), equal segment ids."""
    b, s, sk = q.shape[0], q.shape[1], k.shape[1]
    live = torch.ones((b, 1, 1, s, sk), dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        live = live & (rows >= cols)
    if segment_ids is not None:
        live = live & (segment_ids[:, :, None] == kv_segment_ids[:, None, :])[:, None, None]
    return live


def flash_attention_plain(q, k, v, causal: bool = True,
                          segment_ids: Optional[torch.Tensor] = None,
                          kv_segment_ids: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch (f32): ``(out (B, S, H, D)
    in q.dtype, lse (B, H, S) f32)``. Rows with a live key equal
    ``xla_attention``; a row with none gives O = 0 and LSE ~ -1e30, the
    kernel's fully-masked-row guard. Causal is top-left aligned (row i sees
    keys <= i), as in the TPU kernel."""
    kv_segment_ids = kv_segment_ids if kv_segment_ids is not None else segment_ids
    _check_args(q, k, v, segment_ids, kv_segment_ids)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.to(torch.float32).reshape(b, s, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * (1.0 / math.sqrt(d))
    scores = torch.where(_live(q, k, causal, segment_ids, kv_segment_ids), scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    ref = torch.where(m > NEG_INF / 2, m, 0.0)
    p = torch.exp(scores - ref)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    lc = l.clamp_min(1e-30)
    out = out / lc.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(lc)).reshape(b, h, s)
    return out.reshape(b, s, h, d).to(q.dtype), lse


def _seg_tile_ranges(seg: torch.Tensor, tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (min, max) of segment ids, (B, ceil(S / tile)) int32 each
    (``_seg_block_ranges``, ``flash_attention.py:66``). A ragged last tile
    is padded with its last id: the padded rows are masked in-kernel."""
    b, s = seg.shape
    n = -(-s // tile)
    if n * tile != s:
        seg = torch.cat([seg, seg[:, -1:].expand(b, n * tile - s)], dim=1)
    lo, hi = torch.aminmax(seg.reshape(b, n, tile), dim=-1)
    return lo.to(torch.int32).contiguous(), hi.to(torch.int32).contiguous()


# K1's tiles (``csrc/flash_attention.cu`` BQ, BK): the wrapper checks the
# library's values against these.
FWD_Q_TILE = 128
FWD_K_TILE = 128


def flash_fwd_tile_plan(s: int, sk: int, causal: bool, h: int = 1, b: int = 1,
                        q_ranges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        k_ranges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> dict:
    """What K1 does for S query rows and Sk keys, by the kernel's own
    predicate: ``visited`` and ``masked`` (B, nQ, nK) bool over (query tile
    of 128 rows, key tile of 128 keys) pairs, and ``order`` (grid, 3) int64,
    the (query tile, head, batch) of each block in launch order.

    A pair is visited when its key tile starts at or below the query tile's
    last row (causal) and, with segments, when the per-tile ranges
    (``_seg_tile_ranges`` of the q / kv segment ids: ``q_ranges``,
    ``k_ranges``) can meet. A visited pair is masked when it cuts the
    diagonal, the ragged key edge or a segment boundary (its ranges are not
    all one id); an unmasked pair is live for every valid row and key.
    Blocks run heaviest first: the highest query tiles lead, across every
    (head, batch)."""
    nq, nk = -(-s // FWD_Q_TILE), -(-sk // FWD_K_TILE)
    q0 = torch.arange(nq)[:, None] * FWD_Q_TILE
    k0 = torch.arange(nk)[None, :] * FWD_K_TILE
    visited = torch.ones(nq, nk, dtype=torch.bool)
    masked = k0 + FWD_K_TILE > sk
    if causal:
        visited = visited & (k0 <= q0 + FWD_Q_TILE - 1)
        masked = masked | (k0 + FWD_K_TILE - 1 > q0)
    visited, masked = visited.expand(b, nq, nk), masked.expand(b, nq, nk)
    if q_ranges is not None:
        (qmn, qmx), (kmn, kmx) = ((r.cpu() for r in rs) for rs in (q_ranges, k_ranges))
        qmn, qmx, kmn, kmx = qmn[:, :, None], qmx[:, :, None], kmn[:, None, :], kmx[:, None, :]
        visited = visited & (qmx >= kmn) & (qmn <= kmx)
        masked = masked | ~((qmn == qmx) & (kmn == qmn) & (kmx == qmn))
    idx = torch.arange(nq * h * b)
    order = torch.stack([nq - 1 - idx // (h * b), idx % (h * b) // b, idx % b], dim=1)
    return dict(visited=visited.contiguous(), masked=(masked & visited).contiguous(), order=order)


def _check_operands(**tensors) -> None:
    """What the CUDA kernels take: bf16 with a unit-stride, 16-byte aligned
    head dim and 16-byte multiples for every other stride (K1, K2 and K3 read
    their operands through TMA tensor maps, which require both)."""
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernel takes bf16 {name}, got {t.dtype}")
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must have a unit-stride, 16-byte aligned head dim")


def _kernel_call(q, k, v, causal, q_seg, k_seg):
    from neuronx_distributed_tpu_torch.kernels import _build

    b, s, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _check_operands(q=q, k=k, v=v)
    lib = _build.load("flash_attention")
    if d != lib.nxd_flash_attention_head_dim():
        raise ValueError(f"flash attention kernel is built for head_dim 128, got {d}")
    tiles = (lib.nxd_flash_attention_fwd_q_tile(), lib.nxd_flash_attention_fwd_k_tile())
    if tiles != (FWD_Q_TILE, FWD_K_TILE):
        raise RuntimeError(f"flash_attention library tiles {tiles} != the plan's "
                           f"{(FWD_Q_TILE, FWD_K_TILE)}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    segs = (None,) * 6
    if q_seg is not None:
        same = k_seg is q_seg and FWD_Q_TILE == FWD_K_TILE  # self-attention: one pass
        q_seg = q_seg.to(torch.int32).contiguous()
        k_seg = q_seg if same else k_seg.to(torch.int32).contiguous()
        q_ranges = _seg_tile_ranges(q_seg, FWD_Q_TILE)
        k_ranges = q_ranges if same else _seg_tile_ranges(k_seg, FWD_K_TILE)
        segs = (q_seg, k_seg, *q_ranges, *k_ranges)
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        q_seg.stride(0) if q_seg is not None else 0,
        k_seg.stride(0) if k_seg is not None else 0,
    )
    vp = ctypes.c_void_p
    fn = lib.nxd_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([vp] * 11 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, vp])
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in segs),
        b, s, sk, h, hkv, int(causal), strides, 1.0 / math.sqrt(d),
        _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention_fwd")
    return out, lse


def flash_attention_fwd(q, k, v, causal: bool = True,
                        segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of flash attention on (B, S, H, D) q and (B, Sk, Hkv,
    D) k/v. CUDA tensors launch the kernel (bf16, head_dim 128) or raise;
    CPU tensors run the plain version. ``launches`` counts kernel launches."""
    kv_segment_ids = kv_segment_ids if kv_segment_ids is not None else segment_ids
    _check_args(q, k, v, segment_ids, kv_segment_ids)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, segment_ids, kv_segment_ids)
    out = _kernel_call(q, k, v, causal, segment_ids, kv_segment_ids)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention on (B, S, H, D) inputs (the JAX public API, minus the
    TPU block sizes: ragged lengths are masked in-kernel). ``segment_ids``
    (B, S): positions attend only within equal ids (``-1`` = padding);
    ``kv_segment_ids`` defaults to ``segment_ids``. Differentiable through
    :class:`FlashAttentionFunction` when an input requires grad; otherwise
    (serving) the bare forward kernel runs."""
    kv_segment_ids = kv_segment_ids if kv_segment_ids is not None else segment_ids
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, segment_ids, kv_segment_ids, causal)
    return flash_attention_fwd(q, k, v, causal, segment_ids, kv_segment_ids)[0]


# --- backward -----------------------------------------------------------------

def backward_scores(q, k, v, dout, lse, delta, causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(P, dS)`` (B, Hkv, G, S, Sk) f32 of the backward kernels, recomputed
    from the forward's LSE as ``_dkdv_kernel``/``_dq_kernel`` do: masked
    entries are -1e30 before the exp and P = 0 wherever the masked score is
    not above -5e29 (a fully masked row has LSE ~ -1e30, so ``exp(s - lse)``
    is never taken there); ``dS = P * (dO V^T - delta) * scale``."""
    kv_segment_ids = kv_segment_ids if kv_segment_ids is not None else segment_ids
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.to(torch.float32).reshape(b, s, hkv, g, d)
    dog = dout.to(torch.float32).reshape(b, s, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * scale
    scores = torch.where(_live(q, k, causal, segment_ids, kv_segment_ids), scores, NEG_INF)
    lse = lse.reshape(b, hkv, g, s, 1)
    p = torch.where(scores > NEG_INF / 2, torch.exp(scores - lse), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.to(torch.float32))
    ds = p * (dp - delta.reshape(b, hkv, g, s, 1)) * scale
    return p, ds


def flash_attention_dkdv_plain(q, k, v, dout, lse, delta, causal: bool = True,
                               segment_ids: Optional[torch.Tensor] = None,
                               kv_segment_ids: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's arithmetic in plain PyTorch (f32): ``(dK, dV)`` (B, Sk, Hkv, D)
    in k's/v's dtype, the group's q-heads summed into their kv-head.
    ``lse`` and ``delta`` are (B, H, S) f32."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    p, ds = backward_scores(q, k, v, dout, lse, delta, causal, segment_ids, kv_segment_ids)
    dog = dout.to(torch.float32).reshape(b, s, hkv, h // hkv, d)
    qg = q.to(torch.float32).reshape(b, s, hkv, h // hkv, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dq_plain(q, k, v, dout, lse, delta, causal: bool = True,
                             segment_ids: Optional[torch.Tensor] = None,
                             kv_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3's arithmetic in plain PyTorch (f32): dQ (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    _, ds = backward_scores(q, k, v, dout, lse, delta, causal, segment_ids, kv_segment_ids)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.to(torch.float32))
    return dq.reshape(b, s, h, d).to(q.dtype)


def _check_bwd_args(q, k, v, dout, lse, delta, segment_ids, kv_segment_ids):
    _check_args(q, k, v, segment_ids, kv_segment_ids)
    b, s, h, _ = q.shape
    if dout.shape != q.shape:
        raise ValueError(f"dout shape {tuple(dout.shape)} != q shape {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, s) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({b}, {h}, {s}) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _bwd_kernel_call(which, q, k, v, dout, lse, delta, causal, q_seg, k_seg):
    """Launch K2 (``which="dkdv"``, returns (dk, dv)) or K3 (``"dq"``)."""
    from neuronx_distributed_tpu_torch.kernels import _build

    b, s, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _check_operands(q=q, k=k, v=v, dout=dout)
    lib = _build.load("flash_attention_bwd")
    if d != lib.nxd_flash_attention_bwd_head_dim():
        raise ValueError(f"flash attention kernel is built for head_dim 128, got {d}")
    lse, delta = lse.contiguous(), delta.contiguous()
    if which == "dkdv":
        outs = (torch.empty((b, sk, hkv, d), dtype=k.dtype, device=q.device),
                torch.empty((b, sk, hkv, d), dtype=v.dtype, device=q.device))
        q_tile = lib.nxd_flash_attention_dkdv_q_tile()
    else:
        outs = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device),)
        q_tile = lib.nxd_flash_attention_dq_q_tile()
    segs = (None,) * 6
    if q_seg is not None:
        q_seg = q_seg.to(torch.int32).contiguous()
        k_seg = k_seg.to(torch.int32).contiguous()
        segs = (q_seg, k_seg, *_seg_tile_ranges(q_seg, q_tile),
                *_seg_tile_ranges(k_seg, lib.nxd_flash_attention_bwd_k_tile()))
    strides = (ctypes.c_longlong * 17)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
        *outs[0].stride()[:3],
        q_seg.stride(0) if q_seg is not None else 0,
        k_seg.stride(0) if k_seg is not None else 0,
    )
    vp = ctypes.c_void_p
    fn = getattr(lib, f"nxd_flash_attention_{which}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([vp] * (6 + len(outs) + 6) + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, vp])
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(t.data_ptr() for t in outs),
        *(t.data_ptr() if t is not None else None for t in segs),
        b, s, sk, h, hkv, int(causal), strides, 1.0 / math.sqrt(d),
        _build.stream_ptr(q.device),
    )
    _build.check(err, f"flash_attention_{which}")
    return outs


def flash_attention_dkdv(q, k, v, dout, lse, delta, causal: bool = True,
                         segment_ids: Optional[torch.Tensor] = None,
                         kv_segment_ids: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` of flash attention from (B, S, H, D) q/dout, (B, Sk,
    Hkv, D) k/v and the forward's (B, H, S) f32 ``lse`` with ``delta =
    rowsum(dout * out)``. CUDA tensors launch K2 (bf16, head_dim 128) or
    raise; CPU tensors run the plain version. ``launches`` counts kernel
    launches."""
    kv_segment_ids = kv_segment_ids if kv_segment_ids is not None else segment_ids
    _check_bwd_args(q, k, v, dout, lse, delta, segment_ids, kv_segment_ids)
    if q.device.type == "cpu":
        return flash_attention_dkdv_plain(q, k, v, dout, lse, delta, causal, segment_ids,
                                          kv_segment_ids)
    out = _bwd_kernel_call("dkdv", q, k, v, dout, lse, delta, causal, segment_ids,
                           kv_segment_ids)
    flash_attention_dkdv.launches += 1
    return out


flash_attention_dkdv.launches = 0


def flash_attention_dq(q, k, v, dout, lse, delta, causal: bool = True,
                       segment_ids: Optional[torch.Tensor] = None,
                       kv_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dQ of flash attention (inputs as :func:`flash_attention_dkdv`). CUDA
    tensors launch K3 (bf16, head_dim 128) or raise; CPU tensors run the
    plain version. ``launches`` counts kernel launches."""
    kv_segment_ids = kv_segment_ids if kv_segment_ids is not None else segment_ids
    _check_bwd_args(q, k, v, dout, lse, delta, segment_ids, kv_segment_ids)
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, dout, lse, delta, causal, segment_ids,
                                        kv_segment_ids)
    (dq,) = _bwd_kernel_call("dq", q, k, v, dout, lse, delta, causal, segment_ids,
                             kv_segment_ids)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention: the JAX ``custom_vjp``
    ``_flash_attention_bhsd`` (``flash_attention.py:493-511``). Forward is
    K1 and saves ``q, k, v, out, lse`` and the segment ids; backward forms
    ``delta = rowsum(dO * O)`` in f32 as a torch op (JAX does it outside
    Pallas, ``:483``), then runs K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, kv_segment_ids, causal):
        out, lse = flash_attention_fwd(q, k, v, causal, segment_ids, kv_segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids, kv_segment_ids)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_seg, k_seg = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(-1)
        delta = delta.transpose(1, 2).contiguous()  # (B, H, S), as lse
        dk, dv = flash_attention_dkdv(q, k, v, dout, lse, delta, ctx.causal, q_seg, k_seg)
        dq = flash_attention_dq(q, k, v, dout, lse, delta, ctx.causal, q_seg, k_seg)
        return dq, dk, dv, None, None, None
