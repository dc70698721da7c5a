"""MoE aux losses (counterpart of
``neuronx_distributed_tpu/modules/moe/loss_function.py``): the
Switch-Transformer balance loss ``E * sum_e f_e * P_e`` (``f_e`` the share
of routed (token, slot) assignments on expert e, ``P_e`` its mean router
probability; 1.0 for a uniform assignment) and the ST-MoE router z-loss."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def load_balancing_loss_func(router_probs: torch.Tensor, top_e: torch.Tensor,
                             num_experts: int, top_k: Optional[int] = None) -> torch.Tensor:
    """``router_probs`` (T, E), ``top_e`` (T, k) expert ids -> a 0-d f32
    loss (JAX ``load_balancing_loss_func``, ``loss_function.py:17``)."""
    del top_k  # implied by top_e's shape
    mask = F.one_hot(top_e.long(), num_experts).to(torch.float32)  # (T, k, E)
    tokens_per_expert = mask.mean(dim=(0, 1))
    prob_per_expert = router_probs.to(torch.float32).mean(dim=0)
    return num_experts * torch.sum(tokens_per_expert * prob_per_expert)


def router_z_loss_func(router_logits: torch.Tensor) -> torch.Tensor:
    """The mean squared logsumexp of the router logits (JAX
    ``router_z_loss_func``, ``loss_function.py:33``)."""
    z = torch.logsumexp(router_logits.to(torch.float32), dim=-1)
    return torch.mean(z ** 2)
