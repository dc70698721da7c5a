"""RMSNorm (counterpart of ``neuronx_distributed_tpu/modules/rms_norm.py``):
fp32 upcast with an fp32 weight (``rms_norm.py:40-43``), output in the
compute dtype."""

from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.ones(hidden_size, dtype=param_dtype, device=device),
            requires_grad=False,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.weight.to(torch.float32)).to(self.dtype)
