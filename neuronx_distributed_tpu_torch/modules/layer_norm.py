"""LayerNorm (counterpart of ``neuronx_distributed_tpu/modules/layer_norm.py``):
computed in fp32 on an fp32 upcast of the input (``layer_norm.py:30-36``),
output in the compute dtype. ``use_bias=False`` drops the bias (DBRX's norms
carry none, ``models/dbrx.py:89-91``). The weights are fp32 and train when
``trainable``, as :class:`RMSNorm`'s."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float = 1e-5, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None,
                 trainable: bool = False):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(hidden_size, dtype=param_dtype, device=device),
                                   requires_grad=trainable)
        self.bias = (nn.Parameter(torch.zeros(hidden_size, dtype=param_dtype, device=device),
                                  requires_grad=trainable) if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(torch.float32) if self.bias is not None else None
        y = F.layer_norm(x.to(torch.float32), self.weight.shape, self.weight.to(torch.float32),
                         bias, self.eps)
        return y.to(self.dtype)
