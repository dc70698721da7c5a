"""Flash decode: cached attention for serving (counterpart of
``neuronx_distributed_tpu/kernels/flash_decode.py``: the row layout, the
paged transport and the paged kernel; the quantized pages belong to a later
slice).

``flash_decode_fwd`` launches the hand-written CUDA kernel K4 of
``csrc/flash_decode.cu`` (it replaces the Pallas ``_decode_kernel``/
``_flash_decode_call``, ``flash_decode.py:233,285``) for CUDA tensors and
runs :func:`flash_decode_plain` for CPU tensors. On the card every decode
step launches it, at any cache length: the JAX package's 1024-column
threshold was a TPU trade against XLA's einsum.

``paged_flash_decode_fwd`` launches K5 of the same source (it replaces
``_paged_decode_kernel``/``paged_flash_decode_attention``,
``flash_decode.py:481,532``): K4's tile loop reading K/V straight from a page
pool through a block table, equal bit for bit to K4 on the gathered view.
For CPU tensors it runs :func:`paged_flash_decode_plain`, the gather
(:func:`paged_gather_leaf`) followed by :func:`flash_decode_plain`.
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


def _checked(what, q, k, v, q_pos, kv_valid, L):
    """The argument checks K4 and K5 share: bf16 with unit-stride, 16-byte
    aligned head dims, head_dim 128, at most 32 rows per kv-head, one
    position per query token, a row-contiguous (B, L) validity mask.
    Returns (library, rows per kv-head, q_pos int32, kv_valid bool)."""
    from neuronx_distributed_tpu_torch.kernels import _build

    b, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} takes bf16 {name}, got {t.dtype}")
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must have a unit-stride, 16-byte aligned head dim")
    lib = _build.load("flash_decode")
    if d != lib.nxd_flash_decode_head_dim():
        raise ValueError(f"{what} is built for head_dim 128, got {d}")
    r = (h // k.shape[2]) * s
    if r > lib.nxd_flash_decode_max_rows():
        raise ValueError(f"{what} folds at most 32 rows per kv-head, got {r}")
    q_pos = q_pos.reshape(-1).to(torch.int32).contiguous()
    if q_pos.device != q.device or q_pos.numel() != s:
        raise ValueError("q_pos must hold one position per query token, on q's device")
    if kv_valid is not None:
        if kv_valid.shape != (b, L) or kv_valid.stride(1) != 1:
            raise ValueError(f"kv_valid must be a row-contiguous ({b}, {L}) mask")
        kv_valid = kv_valid.to(torch.bool)
    return lib, r, q_pos, kv_valid


def _kernel_call(q, k_cache, v_cache, q_pos, kv_valid):
    from neuronx_distributed_tpu_torch.kernels import _build

    b, s, h, d = q.shape
    L, hkv = k_cache.shape[1], k_cache.shape[2]
    lib, r, q_pos, kv_valid = _checked("flash decode kernel", q, k_cache, v_cache, q_pos,
                                       kv_valid, L)
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


# --- paged KV: the block-table transport and K5 --------------------------------
#
# A paged cache stores K/V as a POOL of fixed-size pages (..., P, page_size,
# Hkv, D) plus a per-slot block table (B, n_log) int32 mapping logical page j
# of slot b to a physical pool page; page 0 is the reserved null page that
# every unmapped entry points at, whose columns ``kv_valid`` must mask.


def paged_gather_leaf(pool: torch.Tensor, block_table: torch.Tensor,
                      page_size: int) -> torch.Tensor:
    """The logical cache view (..., B, n_log * page_size, Hkv, D) of one pool
    leaf (..., P, page_size, Hkv, D): slot b's logical columns
    ``[j * page_size, (j + 1) * page_size)`` read physical page
    ``block_table[b, j]`` (JAX ``paged_gather_leaf``, ``flash_decode.py:74``).
    A copy: the ``"gather"`` attention route and the plain version read it."""
    pax = pool.dim() - 4
    b, n_log = block_table.shape
    out = pool.index_select(pax, block_table.reshape(-1).to(torch.long))
    return out.reshape(*pool.shape[:pax], b, n_log * page_size, *pool.shape[pax + 2:])


def paged_flash_decode_plain(q, k_pool, v_pool, block_table, q_pos, kv_valid=None,
                             page_size: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's arithmetic in plain PyTorch: gather the logical view through the
    block table, then :func:`flash_decode_plain`."""
    k = paged_gather_leaf(k_pool, block_table, page_size)
    v = paged_gather_leaf(v_pool, block_table, page_size)
    return flash_decode_plain(q, k, v, q_pos, kv_valid)


def _paged_kernel_call(q, k_pool, v_pool, block_table, q_pos, kv_valid, page_size):
    from neuronx_distributed_tpu_torch.kernels import _build

    b, s, h, d = q.shape
    hkv = k_pool.shape[2]
    n_log = block_table.shape[1]
    if page_size < 1 or 128 % page_size:
        raise ValueError(f"paged flash decode kernel takes a page_size dividing 128, got {page_size}")
    if (block_table.dtype != torch.int32 or block_table.device != q.device
            or block_table.shape[0] != b or block_table.stride(1) != 1):
        raise ValueError(f"block_table must be a row-contiguous ({b}, n_log) int32 tensor on q's device")
    lib, r, q_pos, kv_valid = _checked("paged flash decode kernel", q, k_pool, v_pool, q_pos,
                                       kv_valid, n_log * page_size)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hkv, r), dtype=torch.float32, device=q.device)
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    fn = lib.nxd_paged_flash_decode_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [vp] * 8 + [ctypes.c_int] * 6 + [ll] * 14 + [ctypes.c_float, vp]
    err = fn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        lse.data_ptr(), q_pos.data_ptr(),
        kv_valid.data_ptr() if kv_valid is not None else None, block_table.data_ptr(),
        b, s, h, hkv, n_log, page_size.bit_length() - 1,
        *q.stride()[:3], *k_pool.stride()[:3], *v_pool.stride()[:3],
        *out.stride()[:3], kv_valid.stride(0) if kv_valid is not None else 0,
        block_table.stride(0), 1.0 / math.sqrt(d), _build.stream_ptr(q.device),
    )
    _build.check(err, "paged_flash_decode_fwd")
    return out, lse


def paged_flash_decode_fwd(q, k_pool, v_pool, block_table, q_pos, kv_valid=None,
                           page_size: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of paged cached decode attention: q (B, s, H, D) rows
    at logical positions ``q_pos`` (s,) attend each slot's cache read
    straight from the single-layer pools ``k_pool``/``v_pool`` (P,
    page_size, Hkv, D) through ``block_table`` (B, n_log) int32, masked by
    ``kv_valid`` (B, n_log * page_size). Table entries must be pool page ids
    (the page manager hands out nothing else); page 0's columns must be
    masked. CUDA tensors launch K5 (bf16, head_dim 128, page_size dividing
    128) or raise; CPU tensors run the plain version. ``launches`` counts
    kernel launches."""
    if q.shape[2] % k_pool.shape[2] != 0:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k_pool.shape[2]}")
    if k_pool.dim() != 4 or k_pool.shape[1] != page_size or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools must be (P, {page_size}, Hkv, D) and alike, got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pool, v_pool, block_table, q_pos, kv_valid,
                                        page_size)
    out = _paged_kernel_call(q, k_pool, v_pool, block_table, q_pos, kv_valid, page_size)
    paged_flash_decode_fwd.launches += 1
    return out


paged_flash_decode_fwd.launches = 0


def paged_flash_decode_attention(q, k_pool, v_pool, block_table, q_pos: torch.Tensor,
                                 kv_valid: Optional[torch.Tensor] = None,
                                 page_size: int = 16) -> torch.Tensor:
    """Paged cached decode attention output (B, s, H, D) — the JAX public
    API (``paged_flash_decode_attention``, ``flash_decode.py:532``)."""
    return paged_flash_decode_fwd(q, k_pool, v_pool, block_table, q_pos, kv_valid,
                                  page_size)[0]
