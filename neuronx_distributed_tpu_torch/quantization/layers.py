"""The weight-only quantized product (counterpart of
``neuronx_distributed_tpu/quantization/layers.py``: ``quantized_matmul``).

JAX dequantizes the 1-byte weight and runs a dense GEMM in the activation
dtype; XLA fuses the dequantize into the GEMM's operand load. Here DQ
(``kernels/dequantize.py``) writes the dequantized weight in one pass and
``F.linear`` runs the GEMM on it (JAX leaves that GEMM to XLA too, outside
any Pallas kernel). The quantized linears themselves are
``parallel/layers.py``'s, built with ``quantization_config=``; the
quantized expert stacks (JAX ``QuantizedExpertFusedColumnParallel`` :113,
``RowParallel`` :162) are ``modules/moe/moe_parallel_layers.py``'s, and
:func:`dequantize_stack` dequantizes one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from neuronx_distributed_tpu_torch.kernels.dequantize import dequantize_fwd


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                     out_dtype: torch.dtype, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x W^T (+ bias)`` with ``W`` dequantized to ``out_dtype`` (JAX
    ``quantized_matmul``, ``layers.py:33``, in torch's ``(out, in)``
    layout). ``w_q`` (out, in) int8/fp8 with ``scale`` (out,) or () f32
    is dequantized by DQ for CUDA tensors, by the plain version for CPU
    tensors."""
    return F.linear(x.to(out_dtype), dequantize_fwd(w_q, scale, out_dtype), bias)


def dequantize_stack(w_q: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype
                     ) -> torch.Tensor:
    """A quantized 3-D expert stack ``(E, out, in)`` with scales ``(E,
    out)`` or ``(E,)`` dequantized to ``out_dtype`` (JAX dequantizes the
    stack in ``_declare_kernel``, ``parallel/layers.py:83``, then runs its
    einsum): one DQ pass over the stack as ``E * out`` rows on the card,
    the plain version on the CPU."""
    e, o, i = w_q.shape
    rows = scale if scale.dim() == 2 else scale[:, None].expand(e, o)
    return dequantize_fwd(w_q.reshape(e * o, i), rows.reshape(e * o).contiguous(),
                          out_dtype).reshape(e, o, i)
