"""Flash decode: cached attention for serving (counterpart of
``neuronx_distributed_tpu/kernels/flash_decode.py``, row layout only).

``flash_decode_fwd`` launches the hand-written CUDA kernel
``csrc/flash_decode.cu`` (it replaces the Pallas ``_decode_kernel``/
``_flash_decode_call``, ``flash_decode.py:233,285``) for CUDA tensors and
runs :func:`flash_decode_plain` for CPU tensors. On the card every decode
step launches it, at any cache length: the JAX package's 1024-column
threshold was a TPU trade against XLA's einsum. The paged kernel (K5,
``paged_flash_decode_attention``) belongs to the paged-cache slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def flash_decode_plain(q, k_cache, v_cache, q_pos, kv_valid=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch (f32), mirroring the einsum
    path of ``decode_attention`` (``attention.py:762-775`` via
    ``ring_attention._block_attn``): ``(out (B, s, H, D) in q.dtype, lse
    (B, Hkv, R) f32)`` with rows folded as ``r = g * s + t``."""
    b, s, h, d = q.shape
    hkv, L = k_cache.shape[2], k_cache.shape[1]
    g = h // hkv
    qt = q.to(torch.float32).transpose(1, 2).reshape(b, hkv, g, s, d)
    kt = k_cache.to(torch.float32).transpose(1, 2)
    vt = v_cache.to(torch.float32).transpose(1, 2)
    q_pos = q_pos.reshape(-1)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qt, kt) * (1.0 / math.sqrt(d))
    k_pos = torch.arange(L, device=q.device)
    live = (q_pos[:, None] >= k_pos[None, :])[None, None, None]
    if kv_valid is not None:
        live = live & kv_valid.to(torch.bool)[:, None, None, None, :]
    scores = torch.where(live, scores, NEG_INF)
    m = scores.amax(-1)
    safe_m = torch.where(m > NEG_INF / 2, m, 0.0)
    p = torch.where(scores > NEG_INF / 2, torch.exp(scores - safe_m[..., None]), 0.0)
    l = p.sum(-1)
    num = torch.einsum("bhgqk,bhkd->bhgqd", p, vt)
    out = num / l.clamp_min(1e-20)[..., None]
    lse = torch.where(l > 0, safe_m + torch.log(l.clamp_min(1e-30)), NEG_INF)
    out = out.reshape(b, h, s, d).transpose(1, 2).to(q.dtype)
    return out, lse.reshape(b, hkv, g * s)


def _kernel_call(q, k_cache, v_cache, q_pos, kv_valid):
    from neuronx_distributed_tpu_torch.kernels import _build

    b, s, h, d = q.shape
    L, hkv = k_cache.shape[1], k_cache.shape[2]
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash decode kernel takes bf16 {name}, got {t.dtype}")
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must have a unit-stride, 16-byte aligned head dim")
    lib = _build.load("flash_decode")
    if d != lib.nxd_flash_decode_head_dim():
        raise ValueError(f"flash decode kernel is built for head_dim 128, got {d}")
    r = (h // hkv) * s
    if r > lib.nxd_flash_decode_max_rows():
        raise ValueError(f"flash decode kernel folds at most 32 rows per kv-head, got {r}")
    q_pos = q_pos.reshape(-1).to(torch.int32).contiguous()
    if q_pos.device != q.device or q_pos.numel() != s:
        raise ValueError("q_pos must hold one position per query token, on q's device")
    if kv_valid is not None:
        if kv_valid.shape != (b, L) or kv_valid.stride(1) != 1:
            raise ValueError(f"kv_valid must be a row-contiguous ({b}, {L}) mask")
        kv_valid = kv_valid.to(torch.bool)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hkv, r), dtype=torch.float32, device=q.device)
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    fn = lib.nxd_flash_decode_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [vp] * 7 + [ctypes.c_int] * 5 + [ll] * 13 + [ctypes.c_float, vp]
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lse.data_ptr(), q_pos.data_ptr(),
        kv_valid.data_ptr() if kv_valid is not None else None,
        b, s, h, hkv, L,
        *q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *out.stride()[:3], kv_valid.stride(0) if kv_valid is not None else 0,
        1.0 / math.sqrt(d), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_decode_fwd")
    return out, lse


def flash_decode_fwd(q, k_cache, v_cache, q_pos, kv_valid=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of cached decode attention: q (B, s, H, D) rows at
    cache positions ``q_pos`` (s,) against the cache (B, L, Hkv, D); each row
    attends slots ``<=`` its position, minus slots where ``kv_valid`` (B, L)
    is False. CUDA tensors launch the kernel (bf16, head_dim 128) or raise;
    CPU tensors run the plain version. ``launches`` counts kernel launches."""
    if q.shape[2] % k_cache.shape[2] != 0:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k_cache.shape[2]}")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, q_pos, kv_valid)
    out = _kernel_call(q, k_cache, v_cache, q_pos, kv_valid)
    flash_decode_fwd.launches += 1
    return out


flash_decode_fwd.launches = 0


def flash_decode_attention(q, k_cache, v_cache, q_pos: torch.Tensor,
                           kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cached decode attention output (B, s, H, D) — the JAX public API."""
    return flash_decode_fwd(q, k_cache, v_cache, q_pos, kv_valid)[0]
