"""Linear and embedding layers at tp=1 (counterpart of
``neuronx_distributed_tpu/parallel/layers.py``).

The JAX layers keep an fp32 ``param_dtype`` parameter and cast it to the
compute ``dtype`` before every product (``layers.py:74,226,292,477``). Here
each weight is STORED in that compute dtype, so the arithmetic is the same
and a bf16 model takes half the memory. Weights use torch's ``(out, in)``
layout; ``models/convert.py`` transposes flax ``(in, out)`` kernels.

There is no mesh in this slice, so the column/row split is only a name that
keeps the reference's structure: both are plain linears.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int, use_bias: bool,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(output_size, input_size, dtype=dtype, device=device),
            requires_grad=False,
        )
        self.bias = (
            nn.Parameter(torch.zeros(output_size, dtype=dtype, device=device),
                         requires_grad=False)
            if use_bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight, self.bias)


class ColumnParallelLinear(_Linear):
    """``Y = X W^T + b`` (reference ``layers.py:186``; tp=1)."""

    def __init__(self, input_size: int, output_size: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(input_size, output_size, use_bias, dtype, device)


class RowParallelLinear(_Linear):
    """``Y = X W^T + b`` (reference ``layers.py:250``; tp=1, so there is no
    partial-sum reduction)."""

    def __init__(self, input_size: int, output_size: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(input_size, output_size, use_bias, dtype, device)


class ParallelEmbedding(nn.Module):
    """Token embedding (reference ``layers.py:454``; tp=1). The table is
    stored in the compute dtype the JAX layer casts it to."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(num_embeddings, features, dtype=dtype, device=device),
            requires_grad=False,
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)
