"""Medusa multi-head model (counterpart of
``neuronx_distributed_tpu/models/medusa.py``: the Medusa-1 architecture, a
frozen base LM plus K extra decoding heads, each a residual SiLU block
followed by an lm_head-shaped projection, predicting tokens t+2..t+K+1).

:class:`MedusaForCausalLM` holds a Llama backbone and LM head (its own, or
an existing :class:`~neuronx_distributed_tpu_torch.models.llama.
LlamaForCausalLM`'s modules, shared and not copied) and the heads
``medusa_{i}`` / ``medusa_head_{i}``, named as the flax params are. The
heads read the backbone's final hidden states, so a caller that needs only
some of the logits (the LM head at one position, or no heads at all, as in
the tree verify) runs the backbone and picks its heads
(:meth:`MedusaForCausalLM.medusa_logits`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuronx_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    _weights,
)
from neuronx_distributed_tpu_torch.parallel.layers import ColumnParallelLinear
from neuronx_distributed_tpu_torch.parallel.losses import parallel_cross_entropy


class MedusaResBlock(nn.Module):
    """h + SiLU(W·h + b) — the reference Medusa head block (JAX
    ``MedusaResBlock``, ``models/medusa.py:21``)."""

    def __init__(self, config: LlamaConfig, device, trainable: bool = False):
        super().__init__()
        self.proj = ColumnParallelLinear(config.hidden_size, config.hidden_size, use_bias=True,
                                         **_weights(config, device, trainable))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + F.silu(self.proj(x))


class MedusaForCausalLM(nn.Module):
    """Base Llama + ``num_medusa_heads`` decoding heads (JAX
    ``MedusaForCausalLM``, ``models/medusa.py:59``). Returns ``(logits
    (B,S,V), medusa_logits (B,S,heads,V))``.

    Built alone it makes its backbone and LM head as ``LlamaForCausalLM``
    does (``device``, ``trainable``). Built with ``base=``, it takes that
    model's backbone and LM head modules as its own, by reference (no copy:
    a 16 GB bf16 base serves both), on the base's device; ``trainable``
    then applies to the heads alone, so a frozen bf16 base carries fp32
    master heads that train."""

    def __init__(self, config: LlamaConfig, num_medusa_heads: int = 4, device=None,
                 trainable: bool = False, base: Optional[LlamaForCausalLM] = None):
        super().__init__()
        if base is None:
            base = LlamaForCausalLM(config, device, trainable)
        elif base.config != config:
            raise ValueError("base model's config differs from the Medusa config")
        if num_medusa_heads < 1:
            raise ValueError(f"num_medusa_heads must be >= 1, got {num_medusa_heads}")
        self.config, self.trainable = config, trainable
        self.num_medusa_heads = num_medusa_heads
        self.model, self.lm_head = base.model, base.lm_head
        dev = base.device
        for i in range(num_medusa_heads):
            self.add_module(f"medusa_{i}", MedusaResBlock(config, dev, trainable))
            self.add_module(f"medusa_head_{i}", ColumnParallelLinear(
                config.hidden_size, config.vocab_size, use_bias=False,
                **_weights(config, dev, trainable)))

    device = LlamaForCausalLM.device
    new_cache = LlamaForCausalLM.new_cache

    def head_logits(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Head ``i``'s logits (..., V) from hidden states ``x``."""
        return getattr(self, f"medusa_head_{i}")(getattr(self, f"medusa_{i}")(x))

    def medusa_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Every head's logits (..., heads, V) from hidden states ``x``."""
        return torch.stack([self.head_logits(i, x) for i in range(self.num_medusa_heads)],
                           dim=-2)

    def forward(self, input_ids, mode: str = "train", cache=None, positions=None,
                segment_ids=None, padding_mask=None, attn_mask=None):
        """``(logits, medusa_logits)``; the arguments are
        ``LlamaForCausalLM``'s (``attn_mask``: a tree step's mask)."""
        x = self.model(input_ids, mode, cache, positions, segment_ids, padding_mask, attn_mask)
        return self.lm_head(x), self.medusa_logits(x)

    def head_parameters(self):
        """The heads' parameters (what head training updates)."""
        return [p for name, p in self.named_parameters() if name.startswith("medusa")]


@torch.no_grad()
def init_medusa_heads(model: MedusaForCausalLM, seed: int = 0) -> MedusaForCausalLM:
    """Random head weights from ``seed`` on the model's device, by
    ``init_params``'s rule (linears N(0, 1/fan_in), biases 0); the base is
    left as it is."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for p in model.head_parameters():
        if p.ndim == 2:
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
        else:
            p.zero_()
    return model


def medusa_head_loss(model: MedusaForCausalLM, input_ids: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Medusa-1 head-training objective (JAX ``medusa_head_loss``,
    ``models/medusa.py:38``): head ``i`` predicts the token ``i+2``
    positions ahead, so its cross-entropy target is ``labels`` shifted left
    by ``i+1``, the positions without a target masked; the mean over heads.

    The base is frozen (Medusa-1): the backbone runs under ``no_grad``, so
    gradients reach the heads alone, as JAX differentiates the head subtree
    only. The loss is taken head by head: each head's (B, S, V) logits are
    a tensor of their own, never stacked into (B, S, heads, V)."""
    with torch.no_grad():
        x = model.model(input_ids)
    b, s = labels.shape
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(model.num_medusa_heads):
        shift = i + 1
        tgt = torch.roll(labels, -shift, dims=1)
        valid = (torch.arange(s, device=x.device) < s - shift).to(torch.float32)[None]
        losses = parallel_cross_entropy(model.head_logits(i, x), tgt)
        total = total + (losses * valid).sum() / torch.clamp(valid.sum() * b, min=1.0)
    return total / model.num_medusa_heads
