"""Linear and embedding layers at tp=1 (counterpart of
``neuronx_distributed_tpu/parallel/layers.py``).

The JAX layers keep an fp32 ``param_dtype`` parameter and cast it to the
compute ``dtype`` before every product (``layers.py:74,226,292,477``). The
port stores weights one of two ways, chosen by ``trainable``:

* serving (``trainable=False``): each weight is STORED in the compute dtype,
  frozen (``requires_grad=False``), so the arithmetic is the same and a bf16
  model takes half the memory;
* training (``trainable=True``): fp32 master weights (``param_dtype``) with
  ``requires_grad=True``, cast to the compute dtype inside ``forward`` as
  JAX does — autograd then returns fp32 gradients of a bf16 product, and
  the optimizer updates the fp32 leaves.

A linear built with ``quantization_config=`` serves weight-only quantized
weights (JAX ``_declare_quantized``, ``layers.py:86``): ``weight`` is an
int8/fp8 buffer and ``scale`` an f32 buffer beside it, ``(out,)`` per
channel or ``()`` per tensor, which ``quantization/utils.py
quantize_state_dict`` fills; the product dequantizes and runs a dense GEMM
(``quantization/layers.py quantized_matmul``). JAX serves quantized weights
only, so ``trainable=True`` with a quantization config raises.

Weights use torch's ``(out, in)`` layout; ``models/convert.py`` transposes
flax ``(in, out)`` kernels. There is no mesh in this slice, so the
column/row split is only a name that keeps the reference's structure: both
are plain linears.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuronx_distributed_tpu_torch.quantization.config import (
    QuantizationConfig,
    QuantizationType,
)
from neuronx_distributed_tpu_torch.quantization.layers import quantized_matmul


def _param(shape, dtype, param_dtype, trainable: bool, device, fill=torch.empty):
    """A weight stored in ``param_dtype`` and trainable, or frozen in the
    compute ``dtype`` (see the module docstring)."""
    return nn.Parameter(fill(shape, dtype=param_dtype if trainable else dtype, device=device),
                        requires_grad=trainable)


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int, use_bias: bool,
                 dtype: torch.dtype, device: torch.device,
                 param_dtype: torch.dtype = torch.float32, trainable: bool = False,
                 quantization_config: Optional[QuantizationConfig] = None):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.dtype = dtype
        self.quantization_config = qcfg = quantization_config
        if qcfg is None:
            self.weight = _param((output_size, input_size), dtype, param_dtype, trainable, device)
        elif trainable:
            raise ValueError("quantized weights serve only: a linear with a quantization "
                             "config cannot be trainable")
        else:
            per_tensor = qcfg.quantization_type == QuantizationType.PER_TENSOR_SYMMETRIC
            self.register_buffer("weight", torch.zeros(
                (output_size, input_size), dtype=qcfg.quantized_dtype.torch_dtype, device=device))
            self.register_buffer("scale", torch.ones(
                () if per_tensor else (output_size,), dtype=torch.float32, device=device))
        self.bias = (_param((output_size,), dtype, param_dtype, trainable, device, torch.zeros)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(self.dtype) if self.bias is not None else None
        if self.quantization_config is not None:
            return quantized_matmul(x, self.weight, self.scale, self.dtype, bias)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class ColumnParallelLinear(_Linear):
    """``Y = X W^T + b`` (reference ``layers.py:186``; tp=1)."""

    def __init__(self, input_size: int, output_size: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 param_dtype: torch.dtype = torch.float32, trainable: bool = False,
                 quantization_config: Optional[QuantizationConfig] = None):
        super().__init__(input_size, output_size, use_bias, dtype, device, param_dtype,
                         trainable, quantization_config)


class RowParallelLinear(_Linear):
    """``Y = X W^T + b`` (reference ``layers.py:250``; tp=1, so there is no
    partial-sum reduction)."""

    def __init__(self, input_size: int, output_size: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 param_dtype: torch.dtype = torch.float32, trainable: bool = False,
                 quantization_config: Optional[QuantizationConfig] = None):
        super().__init__(input_size, output_size, use_bias, dtype, device, param_dtype,
                         trainable, quantization_config)


class ParallelEmbedding(nn.Module):
    """Token embedding (reference ``layers.py:454``; tp=1). The lookup
    gathers first and casts after: the same values and gradient as casting
    the table first (JAX), without a compute-dtype copy of the whole table
    each step."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 param_dtype: torch.dtype = torch.float32, trainable: bool = False):
        super().__init__()
        self.dtype = dtype
        self.weight = _param((num_embeddings, features), dtype, param_dtype, trainable, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)
