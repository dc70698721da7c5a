"""SLO-aware multi-tenant scheduling (counterpart of
``neuronx_distributed_tpu/serving/sched``).

The queue behind :class:`~neuronx_distributed_tpu_torch.serving.scheduler.
Scheduler` is a POLICY: ``ServingEngine(scheduling=)`` takes ``"fifo"``
(the default, decision for decision the pre-policy scheduler), ``"slo"``
(priority tiers with aging, deficit-weighted round-robin token fairness,
and admission and preemption fed back from the live SLO measurements) or a
:class:`SchedulingPolicy`.

* ``policy``: the interface, the one selection scan and round ordering
  every policy shares, and :class:`FifoPolicy`;
* ``priority``: strict tiers (realtime > interactive > standard > batch)
  with a continuous aging discount;
* ``fairness``: :class:`DeficitRoundRobin` over decode token budgets;
* ``feedback``: :class:`SloPolicy`, attainment-pressure admission and
  cheapest-victim preemption.

All host-side over host state: no device read.
"""

from neuronx_distributed_tpu_torch.serving.sched.fairness import (
    DeficitRoundRobin,
    FairnessConfig,
    tier_weight,
)
from neuronx_distributed_tpu_torch.serving.sched.feedback import (
    FeedbackConfig,
    SloFeedback,
    SloPolicy,
    victim_cost,
)
from neuronx_distributed_tpu_torch.serving.sched.policy import (
    FifoPolicy,
    SchedulingPolicy,
    make_policy,
    order_round,
    scan_queue,
)
from neuronx_distributed_tpu_torch.serving.sched.priority import (
    TIER_RANK,
    PriorityConfig,
    effective_rank,
    tier_rank,
)

__all__ = [
    "DeficitRoundRobin",
    "FairnessConfig",
    "FeedbackConfig",
    "FifoPolicy",
    "PriorityConfig",
    "SchedulingPolicy",
    "SloFeedback",
    "SloPolicy",
    "TIER_RANK",
    "effective_rank",
    "make_policy",
    "order_round",
    "scan_queue",
    "tier_rank",
    "tier_weight",
    "victim_cost",
]
