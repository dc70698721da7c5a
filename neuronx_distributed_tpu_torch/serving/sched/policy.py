"""The scheduling-policy seam: one selection path, pluggable order
(counterpart of ``neuronx_distributed_tpu/serving/sched/policy.py``).

:func:`scan_queue` and :func:`order_round`, moved out of
``Scheduler.select``, are the one selection path every policy rides;
``Scheduler.select`` delegates to its bound policy. A
:class:`SchedulingPolicy` decides, on host state alone (no device read):

* **queue order**: :meth:`SchedulingPolicy.select` may reorder the live
  queue before the scan, which never overtakes (the first request that
  does not fit blocks the rest);
* **preemption**: :meth:`SchedulingPolicy.victims` nominates active
  requests to vacate, through the engine's resume machinery, so streams
  stay bit-identical;
* **routing bias**: :meth:`SchedulingPolicy.route_bias`, a replica
  router's per-tenant term.

:class:`FifoPolicy` is the default and reproduces the pre-policy
``Scheduler.select`` decision for decision.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Deque, List, Optional

if TYPE_CHECKING:  # pragma: no cover
    from neuronx_distributed_tpu_torch.serving.scheduler import Request


def scan_queue(queue: "Deque[Request]", free_slots: int, in_flight_tokens: int,
               max_tokens_in_flight: Optional[int],
               fits: Optional[Callable[["Request"], bool]] = None) -> List["Request"]:
    """THE selection scan: the queue-order prefix that fits
    ``free_slots``, the token budget and the engine's capacity predicate
    ``fits`` (checked in queue order, so it may accumulate a projected
    cursor). Selected requests leave the queue in state PREFILL. The first
    request that does not fit blocks everything behind it."""
    from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

    selected: List["Request"] = []
    budget = in_flight_tokens
    while queue and len(selected) < free_slots:
        req = queue[0]
        if req.finished:  # cancelled or shed while queued
            queue.popleft()
            continue
        if (max_tokens_in_flight is not None
                and budget + req.token_footprint > max_tokens_in_flight):
            break  # nothing overtakes the blocked head
        if fits is not None and not fits(req):
            break
        queue.popleft()
        req.state = RequestState.PREFILL
        budget += req.token_footprint
        selected.append(req)
    return selected


def order_round(selected: List["Request"],
                prefill_cost: Optional[Callable[["Request"], int]] = None) -> List["Request"]:
    """THE round ordering: longest prefill first (the longest prompt sets
    the shared cache cursor, so the shorter ones roll in under it);
    ``prefill_cost`` replaces the context length with the EFFECTIVE work
    (the prefix-cache engine passes the context less its reusable prefix).
    Ordering only: selection already happened."""
    selected.sort(key=prefill_cost or (lambda r: len(r.context_ids)), reverse=True)
    return selected


class SchedulingPolicy:
    """The interface every queue policy implements; every hook takes and
    returns host values."""

    name = "base"

    def bind(self, engine) -> None:
        """Late wiring to the engine whose queue this policy orders (called
        once from ``ServingEngine.__init__``)."""

    def select(self, queue: "Deque[Request]", free_slots: int, in_flight_tokens: int,
               max_tokens_in_flight: Optional[int],
               fits: Optional[Callable[["Request"], bool]] = None,
               prefill_cost: Optional[Callable[["Request"], int]] = None,
               now: Optional[float] = None) -> List["Request"]:
        raise NotImplementedError

    def victims(self, now: float) -> List["Request"]:
        """Active requests this policy wants preempted now. Default: none."""
        return []

    def on_tokens(self, tenant: str, n: int) -> None:
        """Decode-token accounting hook (host ints)."""

    def route_bias(self, tenant: Optional[str]) -> float:
        """A replica router's per-tenant load term in slot units (0.0: no
        opinion)."""
        return 0.0

    def snapshot(self) -> dict:
        return {"policy": self.name}


class FifoPolicy(SchedulingPolicy):
    """The pre-policy scheduler: the FIFO scan and longest-prefill-first
    ordering; no reordering, no preemption, no routing bias."""

    name = "fifo"

    def select(self, queue, free_slots, in_flight_tokens, max_tokens_in_flight, fits=None,
               prefill_cost=None, now=None):
        selected = scan_queue(queue, free_slots, in_flight_tokens, max_tokens_in_flight, fits)
        return order_round(selected, prefill_cost)


def make_policy(spec) -> SchedulingPolicy:
    """``ServingEngine(scheduling=)``: ``"fifo"`` (the default), ``"slo"``
    (priority tiers, DWRR fairness and attainment feedback) or a
    :class:`SchedulingPolicy` instance."""
    if isinstance(spec, SchedulingPolicy):
        return spec
    if spec in (None, "fifo"):
        return FifoPolicy()
    if spec == "slo":
        from neuronx_distributed_tpu_torch.serving.sched.feedback import SloPolicy

        return SloPolicy()
    raise ValueError(f"unknown scheduling policy {spec!r} (expected 'fifo', 'slo', or a "
                     "SchedulingPolicy instance)")
