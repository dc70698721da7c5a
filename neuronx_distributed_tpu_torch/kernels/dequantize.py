"""Weight dequantize: int8 or fp8 codes with their scales to the compute
dtype (no Pallas counterpart: XLA fuses JAX's dequantize,
``quantization/layers.py:33``, into the matmul's operand load).

``dequantize_fwd`` launches DQ of ``csrc/dequantize.cu`` for CUDA tensors
(bf16 out, one pass: 1 byte read and 2 written a weight) and runs
:func:`dequantize_plain` for CPU tensors: ``(q.float() * scale).to(dtype)``,
the arithmetic of JAX's ``quantized_matmul`` and of DQ bit for bit.
:func:`dequantize_plain` is also the port's JAX ``dequantize``
(``quantization/utils.py:120``) and the int8 KV pages' dequantize
(``kernels/flash_decode.py``).
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace

import torch

from neuronx_distributed_tpu_torch.observability.programs import metered


def dequantize_plain(q: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(q * scale)`` in f32, cast to ``dtype``; ``scale`` broadcasts
    against the codes ``q``."""
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> SimpleNamespace:
    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("dequantize")
    fn = lib.nxd_dequantize_fwd
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.restype = i
    fn.argtypes = [vp, vp, ll, vp, ll, ll, i, i, vp]
    return SimpleNamespace(fn=fn, vec=lib.nxd_dequantize_vec())


def _kernel_call(q, scale, dtype):
    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _lib()
    if q.dtype not in (torch.int8, torch.float8_e4m3fn):
        raise TypeError(f"dequantize kernel takes int8 or fp8 e4m3 codes, got {q.dtype}")
    if q.dim() != 2 or not q.is_contiguous() or q.shape[1] % lib.vec or q.data_ptr() % 16:
        raise ValueError(f"dequantize kernel takes contiguous, 16-byte aligned (out, in) codes "
                         f"with in a multiple of {lib.vec}, got {tuple(q.shape)}")
    if scale.dtype != torch.float32 or scale.device != q.device or (
            scale.numel() != 1 and tuple(scale.shape) != (q.shape[0],)) or not scale.is_contiguous():
        raise ValueError(f"scale must be f32 on q's device, ({q.shape[0]},) or one value")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    n_blocks = min(-(-q.numel() // (256 * lib.vec)), 132 * 16)
    err = lib.fn(q.data_ptr(), scale.data_ptr(), 0 if scale.numel() == 1 else 1,
                 out.data_ptr(), q.shape[0], q.shape[1], int(q.dtype == torch.float8_e4m3fn),
                 n_blocks, _build.stream_ptr(q.device))
    _build.check(err, "dequantize_fwd")
    return out


def _dq_cost(q, scale, dtype):
    """DQ's count for the program ledger: one multiply an element; the
    codes and scales read once, the 2-byte output written once."""
    return float(q.numel()), q.numel() * (q.element_size() + 2) + scale.numel() * scale.element_size()


@metered("dequantize", _dq_cost)
def dequantize_fwd(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The weight ``q`` (out, in) int8 or fp8 e4m3 dequantized with
    ``scale`` (out,) or () f32 to ``dtype``. CUDA tensors launch DQ (bf16
    only) or raise; CPU tensors run the plain
    version. ``launches`` counts the calls that launched DQ. The output is
    a fresh tensor: in a captured step the caching allocator hands the
    next linear's call the block this one's product freed."""
    if q.device.type == "cpu":
        return dequantize_plain(q, scale.reshape(-1, 1) if scale.dim() else scale, dtype)
    if dtype != torch.bfloat16:
        raise TypeError(f"dequantize kernel writes bf16, got {dtype}")
    out = _kernel_call(q, scale, dtype)
    dequantize_fwd.launches += 1
    return out


dequantize_fwd.launches = 0
