"""The int8 page pool's write: a write window's pages re-quantized (no
Pallas counterpart: XLA fuses JAX's ``scatter_cache_window``,
``modules/attention.py:544``, with ``quantize_page_block``,
``kernels/flash_decode.py:187``, into the donated decode chunk).

A write of ``s`` tokens into an int8 pool (``PagedKVCache``, ``kv_quant=
"int8"``) re-quantizes every page of its write window: the ``n_win`` pool
pages ``pages`` (B, n_win) that hold the window's logical pages, whose
window column ``w0 + t`` takes token ``t`` of the new rows. Each page is
dequantized, takes the new rows, and is quantized again with a fresh
scale per (page, kv-head); pages outside the window keep their bits.

``window_requantize_fwd`` launches QW of ``csrc/kv_quant.cu`` for CUDA
tensors (one launch for K and V of a layer) and runs
:func:`window_requantize_plain` for CPU tensors: the arithmetic of JAX's
window re-quantization, and of QW bit for bit on every page but the null
page 0, which rows whose window runs past their table share and write in
any order. On the serving path QW writes the prefills; a decode step's
write is folded into its attention (``kernels/flash_decode.py
qpaged_write_attend_fwd``), which takes the window of :func:`write_window`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from neuronx_distributed_tpu_torch.observability.programs import metered

from neuronx_distributed_tpu_torch.kernels.flash_decode import (
    paged_read_pages_leaf_dequant,
    quantize_page_block,
)


def window_pages(s: int, page_size: int) -> int:
    """Logical pages of the write window of ``s`` consecutive columns: one
    for one column; else, wherever they start, ``(s - 1) // page_size + 2``
    (the device knows the first column, the host does not)."""
    return 1 if s == 1 else (s - 1) // page_size + 2


def write_window(block_table: torch.Tensor, c0: torch.Tensor, s: int, page_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The write window of ``s`` consecutive logical columns from ``c0`` (a
    one-element int64 device tensor) of every row of ``block_table`` (B,
    n_log): ``(pages (B, n_win) int64, w0 (1,))``, the pool pages of the
    window's logical pages (past the table's end: the null page 0) and the
    first column's place in the window. Device ops only, no host read: a
    captured step replays it at every cursor."""
    n_log = block_table.shape[1]
    first = c0.reshape(1) // page_size
    lp = first + torch.arange(window_pages(s, page_size), device=block_table.device)
    pages = block_table[:, lp.clamp(max=n_log - 1)].long()
    return torch.where(lp < n_log, pages, 0), c0.reshape(1) - first * page_size


def window_requantize_plain(k_pool, v_pool, k_scale, v_scale, pages, w0, k, v) -> None:
    """Write ``k``/``v`` (B, s, Hkv, D) into the write window of int8 pool
    leaves ``k_pool``/``v_pool`` (P, page_size, Hkv, D) with scales (P, 1,
    Hkv, 1), in place: for each leaf the window's pages ``pages`` (B,
    n_win) dequantized (B, n_win * page_size, Hkv, D), the rows put in at
    window columns ``w0 + arange(s)`` (``w0`` a one-element tensor), the
    pages quantized (:func:`quantize_page_block`) and written back. Rows
    that share the null page write it in any order; nothing reads it."""
    b, n_win = pages.shape
    ps = k_pool.shape[1]
    cols = w0.reshape(1) + torch.arange(k.shape[1], device=k.device)
    for pool, scale, x in ((k_pool, k_scale, k), (v_pool, v_scale, v)):
        block = paged_read_pages_leaf_dequant(pool, scale, pages, ps)
        block = block.view(b, n_win, ps, *pool.shape[2:])
        block.view(b, n_win * ps, *pool.shape[2:]).index_copy_(1, cols, x)
        q, s = quantize_page_block(block)
        pool[pages] = q
        scale[pages] = s


@functools.lru_cache(maxsize=None)
def _lib():
    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("kv_quant")
    fn = lib.nxd_window_requantize_fwd
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.restype = i
    fn.argtypes = [vp] * 8 + [i] * 5 + [ctypes.POINTER(ctypes.c_longlong), vp]
    return fn, lib.nxd_window_requantize_head_dim()


def _kernel_call(k_pool, v_pool, k_scale, v_scale, pages, w0, k, v) -> None:
    from neuronx_distributed_tpu_torch.kernels import _build

    fn, head_dim = _lib()
    dev = k.device
    n_pages, ps, hkv, d = k_pool.shape
    b, s = k.shape[:2]
    if d != head_dim or not 1 <= ps <= 128:
        raise ValueError(f"QW takes head_dim {head_dim} and page_size 1..128, got {d}, {ps}")
    for name, t, dt, shape in (("k_pool", k_pool, torch.int8, k_pool.shape),
                               ("v_pool", v_pool, torch.int8, k_pool.shape),
                               ("k_scale", k_scale, torch.bfloat16, (n_pages, 1, hkv, 1)),
                               ("v_scale", v_scale, torch.bfloat16, (n_pages, 1, hkv, 1)),
                               ("k", k, torch.bfloat16, (b, s, hkv, d)),
                               ("v", v, torch.bfloat16, (b, s, hkv, d))):
        if t.dtype != dt or t.device != dev or tuple(t.shape) != tuple(shape):
            raise TypeError(f"QW takes {name} as {dt} {tuple(shape)} on k's device, got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.dim() == 4 and shape[-1] == d and (
                t.stride(-1) != 1 or t.data_ptr() % 16
                or any(st * t.element_size() % 16 for st in t.stride()[:-1])):
            raise ValueError(f"{name} must have a unit-stride, 16-byte aligned head dim")
    if (pages.dtype != torch.int64 or pages.device != dev or pages.dim() != 2
            or pages.shape[0] != b or pages.stride(1) != 1):
        raise ValueError(f"pages must be a row-contiguous ({b}, n_win) int64 tensor on k's device")
    if w0.dtype != torch.int64 or w0.device != dev or w0.numel() != 1:
        raise ValueError("w0 must be one int64 on k's device")
    strides = (ctypes.c_longlong * 17)(
        *k_pool.stride()[:3], *v_pool.stride()[:3], k_scale.stride(0), k_scale.stride(2),
        v_scale.stride(0), v_scale.stride(2), *k.stride()[:3], *v.stride()[:3], pages.stride(0))
    err = fn(k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
             k.data_ptr(), v.data_ptr(), pages.data_ptr(), w0.data_ptr(),
             b, pages.shape[1], hkv, s, ps, strides, _build.stream_ptr(dev))
    _build.check(err, "window_requantize_fwd")


def qw_bytes(k_pool, k_scale, k, v, n_pages: int) -> int:
    """QW's bytes on shapes: the new rows read, each of ``n_pages`` window
    pages' codes and scale read and written, K and V."""
    page = k_pool[0].numel() * k_pool.element_size() + k_scale[0].numel() * k_scale.element_size()
    return (k.numel() + v.numel()) * k.element_size() + 2 * 2 * n_pages * page


def _qw_cost(k_pool, v_pool, k_scale, v_scale, pages, w0, k, v):
    """QW's count for the program ledger, on shapes (:func:`qw_bytes`)."""
    return 0.0, qw_bytes(k_pool, k_scale, k, v, pages.numel())


@metered("window_requantize", _qw_cost)
def window_requantize_fwd(k_pool, v_pool, k_scale, v_scale, pages, w0, k, v) -> None:
    """The write of :func:`window_requantize_plain`, in place. CUDA tensors
    launch QW (int8 pools, bf16 scales and rows, head_dim 128, page_size at
    most 128, int64 ``pages`` and ``w0``) or raise; CPU tensors run the
    plain version. ``launches`` counts the calls that launched QW (one
    launch each, both leaves)."""
    if k.device.type == "cpu":
        window_requantize_plain(k_pool, v_pool, k_scale, v_scale, pages, w0, k, v)
        return
    _kernel_call(k_pool, v_pool, k_scale, v_scale, pages, w0, k, v)
    window_requantize_fwd.launches += 1


window_requantize_fwd.launches = 0
