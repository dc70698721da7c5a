"""Expert MLP strategies at one rank (counterpart of
``neuronx_distributed_tpu/modules/moe/expert_mlps.py`` ``ExpertMLPs`` :221).

The strategies and the policy between them are JAX's:

* ``selective`` (JAX ``_selective`` :327), the decode path for at most
  ``selective_threshold`` tokens: each token through its k experts, on the
  stacks in the compute dtype. CPU tensors run JAX's gathered einsums
  (``kernels/moe_experts.py``'s plain version), which differentiate as
  JAX's do; CUDA tensors launch MX, or MXq for quantized experts, which read
  each routed expert once where the gathered einsums would copy a token's
  expert slices. MX has no backward: on a CUDA input that needs a gradient
  the route raises (a silent launch would leave the experts' gradients
  empty).
* ``all_experts`` (:343): every token through every expert, combined by its
  affinities; torch einsums.
* ``capacity_factor`` (:361, :367): capacity ``C = min(T, ceil(cf * T * k /
  E))`` with JAX's slot priority (token-major) and dropping; torch einsums.
* ``blockwise`` (:441-483): dropless, the (token, slot) pairs sorted by
  expert (a stable sort) and run as grouped products. JAX's
  ``jax.lax.ragged_dot`` is code XLA generates outside any Pallas kernel; here
  it is ``torch._grouped_mm``. The group sizes are a one-hot sum on the
  device (``torch.bincount`` reads its maximum to the host, which a captured
  step cannot do) and the offsets their device ``cumsum``, so the route
  needs no host read. Each token's k results are combined in slot order
  (JAX scatter-adds them; the order of a sum of k terms aside, the same
  values). Under autograd the grouped products differentiate through
  ``torch._grouped_mm``'s backward (the weight gradient a grouped product
  along the pairs, 2-D x 2-D with ``offs``). That backward refuses a
  stride-0 gradient (a ``.sum()`` straight on its output); the route's
  products only ever receive gathered or elementwise gradients, which are
  dense.

Quantized experts (``quantization_config=``; JAX ``_declare_kernel``
:48) hold codes and f32 scales (``moe_parallel_layers.add_stack``):
``selective`` dequantizes in MXq's load; the other routes dequantize the
stacks first (DQ on the card), as JAX dequantizes and then runs its einsum.

Weights are torch's ``(E, out, in)``: ``gate_proj``/``up_proj`` ``(E, I,
H)``, ``down_proj`` ``(E, H, I)``. The ep/tp paths (JAX
``_sharded_blockwise_mlp*`` :63-219 and the mesh branches) are multi-GPU work:
``ep``/``tp`` above 1 raise ``NotImplementedError`` (ROADMAP item 9).
"""

from __future__ import annotations

from math import ceil
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuronx_distributed_tpu_torch.kernels.moe_experts import (
    ACTIVATIONS,
    moe_experts,
    moe_experts_quantized,
)
from neuronx_distributed_tpu_torch.modules.moe.moe_parallel_layers import add_stack, stack_weight
from neuronx_distributed_tpu_torch.quantization.config import QuantizationConfig
from neuronx_distributed_tpu_torch.quantization.utils import scale_name

STRATEGIES = ("auto", "all_experts", "capacity_factor", "blockwise", "selective")


def expert_groups(top_e: torch.Tensor, num_experts: int):
    """The blockwise route's dispatch, on the device: ``(order, offs)``,
    the (token, slot) pairs sorted by expert (stable: pair order within an
    expert) and each expert's end offset in that order (int32, the
    ``offs`` of ``torch._grouped_mm``), from a one-hot sum."""
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sizes = F.one_hot(flat_e.long(), num_experts).sum(0)
    return order, torch.cumsum(sizes, 0).to(torch.int32)


def grouped_mm(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows ``a`` (N, in) sorted by expert, each through its expert of the
    stack ``w`` (E, out, in): (N, out) (JAX ``ragged_dot``)."""
    return torch._grouped_mm(a, w.transpose(-2, -1), offs=offs)


def grouped_mlp(xs, gate, up, down, offs, act: str = "silu", glu: bool = True):
    """JAX ``_grouped_mlp`` (:53) on expert-sorted rows."""
    h = grouped_mm(xs, up, offs)
    if glu:
        h = ACTIVATIONS[act](grouped_mm(xs, gate, offs)) * h
    else:
        h = ACTIVATIONS[act](h)
    return grouped_mm(h, down, offs)


def blockwise(x, top_e, top_w, gate, up, down, num_experts: int, act: str = "silu",
              glu: bool = True) -> torch.Tensor:
    """The dropless grouped route (JAX ``_blockwise`` :441-483 at one
    rank) on stacks in the compute dtype: the pairs sorted by expert, the
    grouped MLP, then each token's k results combined in slot order."""
    t, k = top_e.shape
    order, offs = expert_groups(top_e, num_experts)
    ys = grouped_mlp(x[order // k], gate, up, down, offs, act, glu)
    y = torch.empty_like(ys)
    y[order] = ys  # back to pair order: token t's slots at t * k + j
    return torch.einsum("tkh,tk->th", y.reshape(t, k, -1), top_w.to(ys.dtype))


class ExpertMLPs(nn.Module):
    """3-D expert stacks and the strategies over them (module docstring).
    ``capacity_factor=None`` is dropless."""

    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int,
                 top_k: int = 2, hidden_act: str = "silu", glu_mlp: bool = True,
                 capacity_factor: Optional[float] = None, strategy: str = "auto",
                 all_experts_threshold: int = 4, selective_threshold: int = 8,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 device=None, trainable: bool = False,
                 quantization_config: Optional[QuantizationConfig] = None,
                 ep: int = 1, tp: int = 1):
        super().__init__()
        if ep > 1 or tp > 1:
            raise NotImplementedError("expert and tensor parallelism shard the experts over "
                                      "several GPUs (ROADMAP item 9)")
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown expert strategy {strategy!r}")
        if hidden_act not in ACTIVATIONS:
            raise ValueError(f"unknown hidden_act {hidden_act!r}")
        self.num_experts, self.top_k = num_experts, top_k
        self.hidden_act, self.glu_mlp = hidden_act, glu_mlp
        self.capacity_factor, self.strategy = capacity_factor, strategy
        self.all_experts_threshold = all_experts_threshold
        self.selective_threshold = selective_threshold
        self.dtype = dtype
        self.quantization_config = quantization_config
        e, h, i = num_experts, hidden_size, intermediate_size
        store = (dtype, param_dtype, device, trainable, quantization_config)
        if glu_mlp:
            add_stack(self, "gate_proj", (e, i, h), *store)
        add_stack(self, "up_proj", (e, i, h), *store)
        add_stack(self, "down_proj", (e, h, i), *store)

    def resolve_strategy(self, n_tokens: Optional[int] = None) -> str:
        """The route for ``n_tokens`` tokens (JAX ``_resolve_strategy``
        :282)."""
        if self.strategy != "auto":
            return self.strategy
        if n_tokens is not None and n_tokens <= self.selective_threshold:
            return "selective"
        if self.capacity_factor is not None:
            return "capacity_factor"
        if self.num_experts <= self.all_experts_threshold:
            return "all_experts"
        return "blockwise"

    def capacity(self, n_tokens: int) -> int:
        cf = self.capacity_factor if self.capacity_factor is not None else 1.0
        return min(n_tokens, int(ceil(cf * n_tokens * self.top_k / self.num_experts)))

    def _weights(self):
        """The stacks in the compute dtype (quantized ones dequantized)."""
        gate = stack_weight(self, "gate_proj", self.dtype) if self.glu_mlp else None
        return gate, stack_weight(self, "up_proj", self.dtype), stack_weight(
            self, "down_proj", self.dtype)

    def _mlp(self, x, gate, up, down, eq_in: str, eq_out: str):
        h = torch.einsum(eq_in, x, up)
        if self.glu_mlp:
            h = ACTIVATIONS[self.hidden_act](torch.einsum(eq_in, x, gate)) * h
        else:
            h = ACTIVATIONS[self.hidden_act](h)
        return torch.einsum(eq_out, h, down)

    def forward(self, x: torch.Tensor, top_e: torch.Tensor, top_w: torch.Tensor) -> torch.Tensor:
        """``x`` (T, H) tokens, ``top_e`` (T, k) expert ids, ``top_w`` (T,
        k) affinities -> (T, H) combined expert outputs."""
        x = x.to(self.dtype)
        strategy = self.resolve_strategy(x.shape[0])
        if strategy == "selective":
            return self._selective(x, top_e, top_w)
        if strategy == "all_experts":
            return self._all_experts(x, top_e, top_w)
        if strategy == "capacity_factor":
            return self._capacity_factor(x, top_e, top_w)
        return self._blockwise(x, top_e, top_w)

    def _selective(self, x, top_e, top_w):
        names = ("gate_proj", "up_proj", "down_proj")
        kw = dict(act=self.hidden_act, glu=self.glu_mlp)
        if self.quantization_config is None:
            # a trainable model's fp32 masters in the compute dtype, as the
            # other routes cast them (MX takes bf16 stacks)
            stacks = self._weights()
            if (x.device.type == "cuda" and torch.is_grad_enabled()
                    and any(t is not None and t.requires_grad for t in (x, top_w, *stacks))):
                raise RuntimeError(
                    "the selective expert route launches MX, which has no backward: a "
                    "differentiated MoE forward of at most selective_threshold tokens needs "
                    "another expert_strategy (blockwise, all_experts, capacity_factor)")
            return moe_experts(x, top_e, top_w, *stacks, **kw)
        gate = self.gate_proj if self.glu_mlp else None
        scales = [getattr(self, scale_name(n)) if hasattr(self, n) else None for n in names]
        return moe_experts_quantized(x, top_e, top_w, gate, self.up_proj, self.down_proj,
                                     *scales, **kw)

    def _all_experts(self, x, top_e, top_w):
        comb = (F.one_hot(top_e.long(), self.num_experts).to(torch.float32)
                * top_w[..., None].to(torch.float32)).sum(1)  # (T, E)
        y = self._mlp(x, *self._weights(), "th,eih->tei", "tei,ehi->teh")
        return torch.einsum("teh,te->th", y, comb.to(y.dtype))

    def _capacity_factor(self, x, top_e, top_w):
        t, e, k = x.shape[0], self.num_experts, self.top_k
        c = self.capacity(t)
        flat_e = top_e.reshape(-1).long()  # token-major slot order = priority
        oh = F.one_hot(flat_e, e).to(torch.float32)  # (N, E)
        pos = ((torch.cumsum(oh, dim=0) - 1.0) * oh).sum(-1)  # each slot's queue position
        keep = (pos < c).to(torch.float32)
        # a dropped slot's position one-hot is all zeros, as jax.nn.one_hot's
        pos_oh = (pos.long()[:, None] == torch.arange(c, device=x.device)).to(torch.float32)
        oh3 = (oh * keep[:, None]).reshape(t, k, e)
        pos3 = pos_oh.reshape(t, k, c)
        dispatch = torch.einsum("tke,tkc->tec", oh3, pos3)
        combine = torch.einsum("tke,tkc,tk->tec", oh3, pos3, top_w.to(torch.float32))
        xin = torch.einsum("tec,th->ech", dispatch.to(x.dtype), x)
        y = self._mlp(xin, *self._weights(), "ech,eih->eci", "eci,ehi->ech")
        return torch.einsum("tec,ech->th", combine.to(y.dtype), y)

    def _blockwise(self, x, top_e, top_w):
        return blockwise(x, top_e, top_w, *self._weights(), self.num_experts, self.hidden_act,
                         self.glu_mlp)
