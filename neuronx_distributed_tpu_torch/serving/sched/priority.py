"""Priority classes with starvation-free aging (counterpart of
``neuronx_distributed_tpu/serving/sched/priority.py``).

Four strict tiers, rank 0 admitting first:

    realtime (0) > interactive (1) > standard (2) > batch (3)

An unknown string maps to ``standard``: the tiers are a contract with the
traffic layer's ``TenantProfile.priority``, not an enum, so a label like
``"bulk-reindex"`` degrades instead of raising mid-admission.

Strict tiers starve, so a queued request's effective rank drops by one tier
per ``aging_s`` seconds of queue wait, continuously: any request eventually
outranks fresh top-tier arrivals, and two requests submitted a moment apart
never swap places. Host arithmetic over timestamps the request carries.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover
    from neuronx_distributed_tpu_torch.serving.scheduler import Request

# strict tier ranks: lower admits first
TIER_RANK = {
    "realtime": 0,
    "interactive": 1,
    "standard": 2,
    "batch": 3,
}
_DEFAULT_RANK = TIER_RANK["standard"]


def tier_rank(priority: Optional[str]) -> int:
    """Rank of a priority string; an unknown label is ``standard``."""
    return TIER_RANK.get(priority or "standard", _DEFAULT_RANK)


@dataclasses.dataclass(frozen=True)
class PriorityConfig:
    """``aging_s`` seconds of queue wait promote a request by one tier:
    batch work waits at most ``3 * aging_s`` before it outranks
    everything."""

    aging_s: float = 2.0

    def __post_init__(self):
        if self.aging_s <= 0:
            raise ValueError(f"aging_s must be > 0, got {self.aging_s}")


def effective_rank(req: "Request", now: float, config: PriorityConfig) -> float:
    """Tier rank minus the aging discount: the priority term of the SLO
    policy's ordering key, decreasing in queue wait. A preempted request
    ages from its ORIGINAL submit time, so it resumes with its seniority."""
    waited = 0.0
    if req.submit_time is not None and now > req.submit_time:
        waited = now - req.submit_time
    return tier_rank(req.priority) - waited / config.aging_s
