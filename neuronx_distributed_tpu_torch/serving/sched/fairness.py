"""Per-tenant token-rate fairness: deficit-weighted round-robin
(counterpart of ``neuronx_distributed_tpu/serving/sched/fairness.py``).

Slots are the engine's scarce resource, but tenants consume them in tokens:
one document tenant's burst of long generations can hold every slot while a
chat tenant's short turns queue behind it. Deficit round-robin over decode
token budgets:

* every admission round, each tenant WITH QUEUED WORK earns
  ``quantum_tokens x weight(tenant)`` of deficit (weights follow the
  priority tiers, so an interactive tenant earns faster than batch);
* every decode token a tenant's requests emit is charged against its
  deficit (the engine's ``on_tokens`` hook: host ints);
* the policy prefers the tenants with the largest deficit.

Deficits stay within ``[-burst_tokens, burst_tokens]``: the cap keeps an
idle tenant from banking unbounded credit, the floor keeps one saturated
tenant's debt from pinning it last once the others drain.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from neuronx_distributed_tpu_torch.serving.sched.priority import tier_rank

# weight per priority tier rank (0 = realtime ... 3 = batch): one tier up
# doubles the earned token rate
_TIER_WEIGHTS = (8.0, 4.0, 2.0, 1.0)


def tier_weight(priority: Optional[str]) -> float:
    return _TIER_WEIGHTS[tier_rank(priority)]


@dataclasses.dataclass(frozen=True)
class FairnessConfig:
    """``quantum_tokens``: a weight-1 (batch) tenant's credit a round, about
    one slot-chunk of work; ``burst_tokens`` bounds credit and debt."""

    quantum_tokens: int = 32
    burst_tokens: int = 512

    def __post_init__(self):
        if self.quantum_tokens < 1:
            raise ValueError(f"quantum_tokens must be >= 1, got {self.quantum_tokens}")
        if self.burst_tokens < self.quantum_tokens:
            raise ValueError("burst_tokens must be >= quantum_tokens "
                             f"({self.burst_tokens} < {self.quantum_tokens})")


class DeficitRoundRobin:
    """Per-tenant deficit counters over decode token budgets."""

    def __init__(self, config: Optional[FairnessConfig] = None, weight=tier_weight):
        self.config = config or FairnessConfig()
        self._weight = weight
        self._deficit: Dict[str, float] = {}
        self.tokens_charged = 0  # lifetime (snapshot only)

    def replenish(self, queued: Iterable[tuple]) -> None:
        """One admission round's credit: each ``(tenant, priority)`` with
        queued work earns ``quantum x weight``, capped at the burst."""
        cap = float(self.config.burst_tokens)
        for tenant, priority in queued:
            d = self._deficit.get(tenant, 0.0) + self.config.quantum_tokens * self._weight(priority)
            self._deficit[tenant] = min(d, cap)

    def charge(self, tenant: str, tokens: int) -> None:
        """Decode tokens ``tenant`` consumed, spent from its deficit."""
        floor = -float(self.config.burst_tokens)
        self._deficit[tenant] = max(self._deficit.get(tenant, 0.0) - tokens, floor)
        self.tokens_charged += tokens

    def deficit(self, tenant: str) -> float:
        return self._deficit.get(tenant, 0.0)

    def rank(self, tenant: str) -> float:
        """The ordering term: the deficit negated and normalized by the
        burst cap, in [-1, 1] (the most starved tenant sorts first)."""
        return -self.deficit(tenant) / float(self.config.burst_tokens)

    def snapshot(self) -> dict:
        return {
            "deficits": {t: round(d, 3) for t, d in sorted(self._deficit.items())},
            "tokens_charged": self.tokens_charged,
        }
