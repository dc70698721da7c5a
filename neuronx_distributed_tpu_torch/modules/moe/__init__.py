"""The Mixture-of-Experts stack at one rank (counterpart of
``neuronx_distributed_tpu/modules/moe/``): routers (:mod:`routing`), the
expert strategies (:mod:`expert_mlps`), the expert-fused linears
(:mod:`moe_parallel_layers`), the token shuffle (:mod:`token_shuffling`),
the aux losses (:mod:`loss_function`) and the MoE layer (:mod:`model`).
The ep/tp-sharded paths are multi-GPU work (ROADMAP item 9)."""

from neuronx_distributed_tpu_torch.modules.moe.expert_mlps import ExpertMLPs
from neuronx_distributed_tpu_torch.modules.moe.loss_function import (
    load_balancing_loss_func,
    router_z_loss_func,
)
from neuronx_distributed_tpu_torch.modules.moe.model import MoE
from neuronx_distributed_tpu_torch.modules.moe.moe_parallel_layers import (
    ExpertFusedColumnParallelLinear,
    ExpertFusedRowParallelLinear,
)
from neuronx_distributed_tpu_torch.modules.moe.routing import (
    RouterOutput,
    RouterSinkhorn,
    RouterTopK,
    make_router,
)
from neuronx_distributed_tpu_torch.modules.moe.token_shuffling import (
    shuffle_tokens,
    unshuffle_tokens,
)

__all__ = [
    "MoE", "ExpertMLPs", "RouterOutput", "RouterTopK", "RouterSinkhorn", "make_router",
    "ExpertFusedColumnParallelLinear", "ExpertFusedRowParallelLinear",
    "load_balancing_loss_func", "router_z_loss_func", "shuffle_tokens", "unshuffle_tokens",
]
