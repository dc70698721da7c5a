"""The MoE layer (counterpart of ``neuronx_distributed_tpu/modules/moe/model.py``
``MoE`` :41): router, then expert MLPs, on ``(B, S, H)`` activations.

Returns ``(out, aux)``: ``aux`` holds the Switch balance loss and the router
z-loss for the trainer to weight, or is None under ``with_aux=False`` (a
serving forward, which reads neither: JAX computes them and XLA drops them
unused; a captured decode step would run them). The tokens are shuffled (and unshuffled
after the experts) only when ``token_shuffle`` and not ``deterministic``;
the shuffle and the router's input jitter draw from ``generator``, an
explicit ``torch.Generator`` on the tokens' device (JAX's rngs cannot be
reproduced; ROADMAP §3). Without a mesh there is no sequence-parallel
layout to leave or re-enter.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from neuronx_distributed_tpu_torch.modules.moe.expert_mlps import ExpertMLPs
from neuronx_distributed_tpu_torch.modules.moe.loss_function import (
    load_balancing_loss_func,
    router_z_loss_func,
)
from neuronx_distributed_tpu_torch.modules.moe.routing import make_router
from neuronx_distributed_tpu_torch.modules.moe.token_shuffling import (
    shuffle_tokens,
    unshuffle_tokens,
)
from neuronx_distributed_tpu_torch.quantization.config import QuantizationConfig


class MoE(nn.Module):
    """Router + experts. The router's weight is f32 and never quantized;
    ``quantization_config`` quantizes the expert stacks only."""

    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int,
                 top_k: int = 2, router_kind: str = "top_k", router_act_fn: str = "softmax",
                 router_jitter_eps: float = 0.0, hidden_act: str = "silu", glu_mlp: bool = True,
                 capacity_factor: Optional[float] = None, expert_strategy: str = "auto",
                 token_shuffle: bool = False, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None, trainable: bool = False,
                 quantization_config: Optional[QuantizationConfig] = None):
        super().__init__()
        self.num_experts = num_experts
        self.token_shuffle = token_shuffle
        self.router = make_router(router_kind, hidden_size, num_experts, top_k,
                                  act_fn=router_act_fn, jitter_eps=router_jitter_eps,
                                  device=device, trainable=trainable)
        self.experts = ExpertMLPs(num_experts, hidden_size, intermediate_size, top_k=top_k,
                                  hidden_act=hidden_act, glu_mlp=glu_mlp,
                                  capacity_factor=capacity_factor, strategy=expert_strategy,
                                  dtype=dtype, param_dtype=param_dtype, device=device,
                                  trainable=trainable, quantization_config=quantization_config)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, with_aux: bool = True
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        b, s, h = x.shape
        tokens = x.reshape(b * s, h)
        perm = None
        if self.token_shuffle and not deterministic:
            tokens, perm = shuffle_tokens(tokens, generator)
        route = self.router(tokens, deterministic, generator)
        out = self.experts(tokens, route.top_e, route.top_w)
        if perm is not None:
            out = unshuffle_tokens(out, perm)
        aux = None
        if with_aux:
            aux = {"load_balancing_loss": load_balancing_loss_func(route.probs, route.top_e,
                                                                   self.num_experts),
                   "router_z_loss": router_z_loss_func(route.logits)}
        return out.reshape(b, s, h).to(x.dtype), aux
