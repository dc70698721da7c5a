"""Expert-fused linears at one rank (counterpart of
``neuronx_distributed_tpu/modules/moe/moe_parallel_layers.py``:
``ExpertFusedColumnParallelLinear`` :34, ``ExpertFusedRowParallelLinear``
:59) and the storage every 3-D expert stack shares.

A stack is torch's ``(E, out, in)`` (JAX's kernels are ``(E, in, out)``).
Built with ``quantization_config=`` it holds int8/fp8 codes with f32
scales, ``(E, out)`` per channel or ``(E,)`` per tensor (JAX
``QuantizedExpertFusedColumnParallel`` / ``RowParallel``,
``quantization/layers.py:113``, :162, whose ``(E, 1, out)`` scales
``models/convert.py`` reshapes), and each product dequantizes the stack
first, as JAX does. A trainable stack is an fp32 master that each product
casts to the compute dtype (``stack_weight``), so its gradient is fp32.
Without a mesh the column and row split are names that keep the
reference's structure; the ep/tp sharding is ROADMAP item 9.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from neuronx_distributed_tpu_torch.parallel.layers import _param
from neuronx_distributed_tpu_torch.quantization.config import (
    QuantizationConfig,
    QuantizationType,
)
from neuronx_distributed_tpu_torch.quantization.layers import dequantize_stack
from neuronx_distributed_tpu_torch.quantization.utils import scale_name


def add_stack(module: nn.Module, name: str, shape, dtype: torch.dtype,
              param_dtype: torch.dtype, device, trainable: bool,
              qcfg: Optional[QuantizationConfig]) -> None:
    """Give ``module`` the expert stack ``name`` of ``shape`` (E, out, in):
    a float parameter (stored as ``parallel/layers.py`` stores weights), or
    with ``qcfg`` a code buffer with its scale buffer beside it (``scale``
    beside ``weight``, else ``<name>_scale``: ``quantization/utils.py
    scale_name``)."""
    if qcfg is None:
        setattr(module, name, _param(shape, dtype, param_dtype, trainable, device))
        return
    if trainable:
        raise ValueError("quantized expert weights serve only: they cannot be trainable")
    per_tensor = qcfg.quantization_type == QuantizationType.PER_TENSOR_SYMMETRIC
    module.register_buffer(name, torch.zeros(shape, dtype=qcfg.quantized_dtype.torch_dtype,
                                             device=device))
    module.register_buffer(scale_name(name), torch.ones(
        shape[:1] if per_tensor else shape[:2], dtype=torch.float32, device=device))


def stack_weight(module: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """The stack ``name`` in ``dtype``: a float stack cast, a quantized one
    dequantized."""
    w = getattr(module, name)
    scale = getattr(module, scale_name(name), None)
    if scale is None:
        return w.to(dtype)
    return dequantize_stack(w, scale, dtype)


class _ExpertFused(nn.Module):
    def __init__(self, num_experts: int, input_size: int, output_size: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 param_dtype: torch.dtype = torch.float32, trainable: bool = False,
                 quantization_config: Optional[QuantizationConfig] = None):
        super().__init__()
        self.dtype = dtype
        self.quantization_config = quantization_config
        add_stack(self, "weight", (num_experts, output_size, input_size), dtype, param_dtype,
                  device, trainable, quantization_config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (E, C, in) -> (E, C, out): each expert's rows through its
        own weight."""
        return torch.einsum("eci,eoi->eco", x.to(self.dtype),
                            stack_weight(self, "weight", self.dtype))


class ExpertFusedColumnParallelLinear(_ExpertFused):
    """A per-expert product ``(E, C, in) x (E, out, in) -> (E, C, out)``
    (JAX :34; tp = ep = 1)."""


class ExpertFusedRowParallelLinear(_ExpertFused):
    """A per-expert product ``(E, C, in) x (E, out, in) -> (E, C, out)``
    (JAX :59; tp = 1, so there is no partial sum to reduce)."""
