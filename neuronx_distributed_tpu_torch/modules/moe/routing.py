"""Routers (counterpart of ``neuronx_distributed_tpu/modules/moe/routing.py``).

The logits are f32 (the input cast to f32 against an f32 weight) whatever
the compute dtype, and the router weight is never quantized, as in JAX.
Weights are torch's ``(E, H)``; ``models/convert.py`` transposes flax's
``(H, E)``. Input jitter draws from an explicit ``torch.Generator`` on the
tokens' device (a train step's, ``trainer/trainer.py step_generator``),
which cannot reproduce ``jax.random`` (ROADMAP §3). Under autograd the
affinities differentiate through the activation; the chosen experts (and
the Sinkhorn balancing that picks them) do not. Expert ids are int64,
torch's index dtype (JAX's are int32).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn


class RouterOutput(NamedTuple):
    logits: torch.Tensor  # (T, E) f32 pre-activation
    probs: torch.Tensor   # (T, E) f32 activation output (the aux loss's input)
    top_e: torch.Tensor   # (T, k) int64 chosen expert ids
    top_w: torch.Tensor   # (T, k) f32 affinities


class RouterBase(nn.Module):
    """Linear router: hidden -> per-expert logits (JAX ``RouterBase``,
    ``routing.py:28``). ``act_fn`` is "softmax" or "sigmoid";
    ``jitter_eps`` multiplies the input by U[1 - eps, 1 + eps] noise when
    not deterministic."""

    def __init__(self, hidden_size: int, num_experts: int, top_k: int = 2,
                 act_fn: str = "softmax", jitter_eps: float = 0.0, device=None,
                 trainable: bool = False):
        super().__init__()
        if act_fn not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown router act_fn {act_fn!r}")
        self.num_experts, self.top_k = num_experts, top_k
        self.act_fn, self.jitter_eps = act_fn, jitter_eps
        self.weight = nn.Parameter(
            torch.empty((num_experts, hidden_size), dtype=torch.float32, device=device),
            requires_grad=trainable)

    def _logits(self, x: torch.Tensor, deterministic: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.jitter_eps > 0.0 and not deterministic:
            noise = torch.empty_like(x).uniform_(1.0 - self.jitter_eps, 1.0 + self.jitter_eps,
                                                 generator=generator)
            x = x * noise
        return x.to(torch.float32) @ self.weight.to(torch.float32).t()

    def _activate(self, logits: torch.Tensor) -> torch.Tensor:
        if self.act_fn == "sigmoid":
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=-1)


class RouterTopK(RouterBase):
    """Top-k router (JAX ``RouterTopK``, ``routing.py:71``): the affinities
    renormalized over the k chosen experts when
    ``normalize_top_k_affinities`` and the activation is softmax
    (Mixtral)."""

    def __init__(self, *args, normalize_top_k_affinities: bool = True, **kw):
        super().__init__(*args, **kw)
        self.normalize_top_k_affinities = normalize_top_k_affinities

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> RouterOutput:
        logits = self._logits(x, deterministic, generator)
        probs = self._activate(logits)
        top_w, top_e = torch.topk(probs, self.top_k, dim=-1)
        if self.normalize_top_k_affinities and self.act_fn == "softmax":
            top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        return RouterOutput(logits, probs, top_e, top_w)


class RouterSinkhorn(RouterBase):
    """Sinkhorn-balanced router (JAX ``RouterSinkhorn``, ``routing.py:94``):
    when not deterministic, a fixed number of Sinkhorn iterations on the
    max-subtracted cost balances the assignment that selects the experts,
    and the affinities are the plain activation at the chosen experts; when
    deterministic, plain top-k of the activation."""

    def __init__(self, *args, sinkhorn_iterations: int = 4, **kw):
        super().__init__(*args, **kw)
        self.sinkhorn_iterations = sinkhorn_iterations

    def _sinkhorn(self, logits: torch.Tensor) -> torch.Tensor:
        cost = torch.exp(logits - logits.max().detach())
        t, e = cost.shape
        d0 = torch.ones(t, dtype=torch.float32, device=cost.device)
        d1 = torch.ones(e, dtype=torch.float32, device=cost.device)
        eps = 1e-8
        for _ in range(self.sinkhorn_iterations):
            d0 = 1.0 / (t * ((cost * d1[None, :]).sum(1) + eps))
            d1 = 1.0 / (e * ((cost * d0[:, None]).sum(0) + eps))
        return cost * d0[:, None] * d1[None, :]

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> RouterOutput:
        logits = self._logits(x, deterministic, generator)
        probs = self._activate(logits)
        if deterministic:
            top_w, top_e = torch.topk(probs, self.top_k, dim=-1)
        else:
            top_e = torch.topk(self._sinkhorn(logits), self.top_k, dim=-1).indices
            top_w = torch.gather(probs, -1, top_e)
        return RouterOutput(logits, probs, top_e, top_w)


ROUTERS = {"top_k": RouterTopK, "sinkhorn": RouterSinkhorn}


def make_router(kind: str, hidden_size: int, num_experts: int, top_k: int, **kw) -> RouterBase:
    """A router of ``kind`` ("top_k" or "sinkhorn"; JAX ``make_router``,
    ``routing.py:134``)."""
    return ROUTERS[kind](hidden_size, num_experts, top_k, **kw)
