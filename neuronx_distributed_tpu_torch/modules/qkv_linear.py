"""GQA QKV projection (counterpart of
``neuronx_distributed_tpu/modules/qkv_linear.py``): separate ``q_proj``/
``k_proj``/``v_proj`` linears (``qkv_linear.py:65-81``), tp=1."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from neuronx_distributed_tpu_torch.parallel.layers import ColumnParallelLinear


class GQAQKVColumnParallelLinear(nn.Module):
    """Computes (q, k, v) projections. ``hidden_size → (H·D, Hkv·D, Hkv·D)``."""

    def __init__(self, hidden_size: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None,
                 param_dtype: torch.dtype = torch.float32, trainable: bool = False):
        super().__init__()
        common = dict(use_bias=use_bias, dtype=dtype, device=device, param_dtype=param_dtype,
                      trainable=trainable)
        self.q_proj = ColumnParallelLinear(hidden_size, num_heads * head_dim, **common)
        self.k_proj = ColumnParallelLinear(hidden_size, num_kv_heads * head_dim, **common)
        self.v_proj = ColumnParallelLinear(hidden_size, num_kv_heads * head_dim, **common)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.q_proj(x), self.k_proj(x), self.v_proj(x)
