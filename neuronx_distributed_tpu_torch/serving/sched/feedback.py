"""Feedback-driven SLO scheduling (counterpart of
``neuronx_distributed_tpu/serving/sched/feedback.py``): the policy that
closes the loop from the SLO measurements back into admission.

:class:`SloPolicy` reads the engine's live host-side counters (the
``SLOTracker``'s attainment, the per-tenant TTFT histograms) as its control
signal:

* **ordering**: each admission round the queue is stably reordered by
  priority tier with aging (``priority.py``), the DWRR fairness rank
  (``fairness.py``) and an attainment-pressure boost: a tenant whose
  attainment fell below target, or whose LIVE TTFT p99 already exceeds its
  spec, admits ahead of attaining tenants. The scan is the shared one in
  ``policy.py``.
* **preemption**: when every slot is held and a pressured tenant's work
  waits behind an attaining tenant's, :meth:`SloPolicy.victims` nominates
  the cheapest victim, cost = pages held x resume-prefill work. The engine
  vacates it through the preempt/resume machinery (its stream stays
  bit-identical); a cooldown and a per-round cap keep it from thrashing.
* **routing**: :meth:`SloPolicy.route_bias`, per-tenant pressure in slot
  units.

Every input is host state (tracker counters, histogram buckets, host block
tables): no device read.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional

from neuronx_distributed_tpu_torch.serving.sched.fairness import (
    DeficitRoundRobin,
    FairnessConfig,
)
from neuronx_distributed_tpu_torch.serving.sched.policy import (
    SchedulingPolicy,
    order_round,
    scan_queue,
)
from neuronx_distributed_tpu_torch.serving.sched.priority import (
    PriorityConfig,
    effective_rank,
)

if TYPE_CHECKING:  # pragma: no cover
    from neuronx_distributed_tpu_torch.serving.scheduler import Request


@dataclasses.dataclass(frozen=True)
class FeedbackConfig:
    """Controller dials. ``target_attainment`` is the floor below which a
    tenant is pressured; ``min_decided`` gates the attainment term until
    enough requests were classified (the live TTFT warning has no gate).
    ``pressure_boost`` turns pressure (0..1) into tier units. Preemption:
    at most ``max_victims`` a round, never from a pressured tenant, never
    within ``cooldown_s`` of the last, never a request with fewer than
    ``min_victim_remaining`` tokens left (its slot frees itself sooner)."""

    target_attainment: float = 0.9
    min_decided: int = 4
    pressure_boost: float = 2.0
    fairness_gain: float = 1.0
    preempt: bool = True
    max_victims: int = 1
    cooldown_s: float = 0.25
    min_victim_remaining: int = 4


class SloFeedback:
    """Host reads over the live SLO surfaces, as a 0..1 pressure a
    tenant."""

    def __init__(self, metrics, config: FeedbackConfig):
        self._metrics = metrics
        self._config = config

    def pressure(self, tenant: str) -> float:
        """0.0: attaining (or no spec, or no signal yet); 1.0: failing. The
        larger of the attainment gap (normalized to the target) and the
        live TTFT p99's overshoot of the spec."""
        tracker = self._metrics.slo
        if tracker is None:
            return 0.0
        spec = tracker.spec_for(tenant)
        if spec is None:
            return 0.0
        cfg = self._config
        p = 0.0
        if tracker.decided(tenant) >= cfg.min_decided:
            gap = cfg.target_attainment - tracker.attainment(tenant)
            if gap > 0.0:
                p = min(1.0, gap / max(cfg.target_attainment, 1e-9))
        if spec.ttft_p99_s is not None:
            live = self._metrics.tenant_latency("ttft", tenant, 0.99)
            if live > spec.ttft_p99_s:
                p = max(p, min(1.0, live / spec.ttft_p99_s - 1.0))
        return p

    def attaining(self, tenant: str) -> bool:
        return self.pressure(tenant) == 0.0


def victim_cost(engine, req: "Request") -> float:
    """What preempting ``req`` throws away: pages held x the prefill work
    its resume redoes (``PrefixCache.match_len`` is a read-only peek). Both
    are host tables; a row engine's cost is the resume work alone."""
    ctx = req.context_ids
    work = len(ctx)
    if engine.prefix is not None:
        work -= engine.prefix.match_len(ctx)
    work = max(work, 1)
    pages = 1
    if engine._page_size is not None and req.slot is not None:
        pages = max(len(engine.cache.slot_pages(req.slot)), 1)
    return float(pages * work)


class SloPolicy(SchedulingPolicy):
    """Priority tiers, DWRR fairness and attainment feedback over the
    shared selection path."""

    name = "slo"

    def __init__(self, priority: Optional[PriorityConfig] = None,
                 fairness: Optional[FairnessConfig] = None,
                 feedback: Optional[FeedbackConfig] = None):
        self.priority = priority or PriorityConfig()
        self.fairness = DeficitRoundRobin(fairness or FairnessConfig())
        self.config = feedback or FeedbackConfig()
        self._engine = None
        self._feedback: Optional[SloFeedback] = None
        self._last_preempt_t: Optional[float] = None
        self.preemptions_requested = 0

    def bind(self, engine) -> None:
        self._engine = engine
        self._feedback = SloFeedback(engine.metrics, self.config)

    def _order_key(self, req: "Request", now: float):
        rank = effective_rank(req, now, self.priority)
        rank += self.fairness.rank(req.tenant) * self.config.fairness_gain
        if self._feedback is not None:
            rank -= self._feedback.pressure(req.tenant) * self.config.pressure_boost
        return (rank, req.rid)  # rid breaks ties: arrival order

    def select(self, queue, free_slots, in_flight_tokens, max_tokens_in_flight, fits=None,
               prefill_cost=None, now=None):
        now = 0.0 if now is None else now
        live = {}
        for r in queue:
            if not r.finished:
                live.setdefault(r.tenant, r.priority)
        self.fairness.replenish(live.items())
        if live:
            # the policy's order IS the queue order: reorder the scheduler's
            # deque in place (a requeued victim keeps its seniority through
            # the key, not its position)
            ordered = sorted(queue, key=lambda r: self._order_key(r, now))
            queue.clear()
            queue.extend(ordered)
        selected = scan_queue(queue, free_slots, in_flight_tokens, max_tokens_in_flight, fits)
        # fairness meters decode tokens only (on_tokens); the prefill is
        # priced by the round order
        return order_round(selected, prefill_cost)

    def victims(self, now: float) -> List["Request"]:
        cfg, eng = self.config, self._engine
        if not cfg.preempt or eng is None or self._feedback is None:
            return []
        if eng.cache.free_slots > 0:
            return []  # admission can proceed without preempting
        if self._last_preempt_t is not None and now - self._last_preempt_t < cfg.cooldown_s:
            return []
        pressured = {}
        for req in eng.scheduler.queued_requests:
            p = self._feedback.pressure(req.tenant)
            if p > 0.0:
                pressured[req.tenant] = max(pressured.get(req.tenant, 0.0), p)
        if not pressured:
            return []
        # active requests of ATTAINING tenants, with enough left that a
        # preempt and resume beats waiting for them to retire
        candidates = [r for r in eng._slot_req
                      if r is not None and not r.finished and r.tenant not in pressured
                      and self._feedback.attaining(r.tenant)
                      and r.remaining_new_tokens >= cfg.min_victim_remaining]
        if not candidates:
            return []
        candidates.sort(key=lambda r: (victim_cost(eng, r), r.rid))
        chosen = candidates[:cfg.max_victims]
        self._last_preempt_t = now
        self.preemptions_requested += len(chosen)
        return chosen

    def on_tokens(self, tenant: str, n: int) -> None:
        self.fairness.charge(tenant, n)

    def route_bias(self, tenant: Optional[str]) -> float:
        if tenant is None or self._feedback is None:
            return 0.0
        return self._feedback.pressure(tenant)

    def snapshot(self) -> dict:
        return {
            "policy": self.name,
            "preemptions_requested": self.preemptions_requested,
            "fairness": self.fairness.snapshot(),
        }
