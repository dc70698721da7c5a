"""Flash attention forward (counterpart of
``neuronx_distributed_tpu/kernels/flash_attention.py``, forward only).

``flash_attention_fwd`` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` (it replaces the Pallas ``_fwd_kernel``/
``_flash_fwd``, ``flash_attention.py:78,179``) for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors; nothing else decides. The
public API keeps the JAX ``(B, S, H, D)`` layout, GQA by ``h // group`` and
the equal-segment mask (padding = segment ``-1``). The backward kernels
(``_flash_dkdv``/``_flash_dq``) belong to the training slice.
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
    hkv, sk = k.shape[2], k.shape[1]
    g = h // hkv
    qg = q.to(torch.float32).reshape(b, s, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * (1.0 / math.sqrt(d))
    live = torch.ones((b, 1, 1, s, sk), dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        live = live & (rows >= cols)
    if segment_ids is not None:
        live = live & (segment_ids[:, :, None] == kv_segment_ids[:, None, :])[:, None, None]
    scores = torch.where(live, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    ref = torch.where(m > NEG_INF / 2, m, 0.0)
    p = torch.exp(scores - ref)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    lc = l.clamp_min(1e-30)
    out = out / lc.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(lc)).reshape(b, h, s)
    return out.reshape(b, s, h, d).to(q.dtype), lse


def _kernel_call(q, k, v, causal, q_seg, k_seg):
    from neuronx_distributed_tpu_torch.kernels import _build

    b, s, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernel takes bf16 {name}, got {t.dtype}")
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must have a unit-stride, 16-byte aligned head dim")
    lib = _build.load("flash_attention")
    if d != lib.nxd_flash_attention_head_dim():
        raise ValueError(f"flash attention kernel is built for head_dim 128, got {d}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if q_seg is not None:
        q_seg = q_seg.to(torch.int32).contiguous()
        k_seg = k_seg.to(torch.int32).contiguous()
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    fn = lib.nxd_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [vp] * 7 + [ctypes.c_int] * 6 + [ll] * 14 + [ctypes.c_float, vp]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        q_seg.data_ptr() if q_seg is not None else None,
        k_seg.data_ptr() if k_seg is not None else None,
        b, s, sk, h, hkv, int(causal),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        q_seg.stride(0) if q_seg is not None else 0,
        k_seg.stride(0) if k_seg is not None else 0,
        1.0 / math.sqrt(d), _build.stream_ptr(q.device),
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
    ``kv_segment_ids`` defaults to ``segment_ids``."""
    return flash_attention_fwd(q, k, v, causal, segment_ids, kv_segment_ids)[0]
