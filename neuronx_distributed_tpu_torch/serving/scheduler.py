"""Request lifecycle and the policy seam (counterpart of
``neuronx_distributed_tpu/serving/scheduler.py``).

Queue ORDER and admission selection belong to the scheduler's bound
:class:`~neuronx_distributed_tpu_torch.serving.sched.SchedulingPolicy`
(``serving/sched/``): by default FIFO with a token-budget guard, the queue
scanned in arrival order up to the first request that does not fit (no
overtaking), the selected round handed back LONGEST-PREFILL-FIRST (the
longest prompt sets the shared cache cursor, so the shorter prompts roll in
under it). ``max_tokens_in_flight`` bounds the sum over in-flight requests
of (context + remaining new tokens). Intake, cancellation, deadline expiry
(:meth:`Scheduler.expire`, JAX ``scheduler.py:178``) and the request index
stay here. Each request carries its ``tenant`` and ``priority``, which the
metrics attribute and the SLO policy orders by.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    CANCELLED = "cancelled"
    # terminal fault states: TIMED_OUT, shed for missing its queue timeout
    # or its deadline; FAILED, given up for cause (``Request.error`` says why:
    # a prefill fault, or a quarantined slot under the "fail" policy)
    TIMED_OUT = "timed_out"
    FAILED = "failed"


@dataclasses.dataclass(eq=False)  # identity: requests are compared as objects
class Request:
    """One generation request flowing through the engine.

    ``tokens`` accumulates generated ids (the last entry is the pending
    decode input, not yet fed to the model). ``seed`` selects the request's
    counter-based sampling stream; token ``i`` draws index ``i``, so the
    stream is that of a solo ``generate(prompt, seed=seed)``."""

    rid: int
    prompt: np.ndarray  # (S,) int32
    config: GenerationConfig
    seed: int
    # attribution: the tenant that submitted it and its priority class
    # (``serving/sched/priority.py``), host strings
    tenant: str = "default"
    priority: str = "standard"
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    preemptions: int = 0
    error: Optional[str] = None
    # absolute engine-clock deadlines (None: unbounded): ``deadline`` ends
    # the request wherever it is (at chunk boundaries once decoding);
    # ``queue_deadline`` sheds it if it has not been admitted by then
    deadline: Optional[float] = None
    queue_deadline: Optional[float] = None
    submit_time: Optional[float] = None
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def context_ids(self) -> np.ndarray:
        """Tokens already FED to the model (prompt + all generated but the
        pending last one) — what a resume after preemption prefills."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt, np.asarray(self.tokens[:-1], np.int32)])

    @property
    def remaining_new_tokens(self) -> int:
        return self.config.max_new_tokens - len(self.tokens)

    @property
    def token_footprint(self) -> int:
        """Worst-case cache-column claim: context + tokens still to come."""
        return len(self.prompt) + len(self.tokens) + self.remaining_new_tokens

    @property
    def finished(self) -> bool:
        return self.state in (RequestState.DONE, RequestState.CANCELLED,
                              RequestState.TIMED_OUT, RequestState.FAILED)


class Scheduler:
    """Request bookkeeping and the policy seam: ``select`` delegates to
    the bound policy (``policy=``: ``"fifo"``, ``"slo"`` or a
    ``SchedulingPolicy``)."""

    def __init__(self, max_tokens_in_flight: Optional[int] = None, policy=None):
        from neuronx_distributed_tpu_torch.serving.sched import make_policy

        self.max_tokens_in_flight = max_tokens_in_flight
        self.policy = make_policy(policy)
        self._queue: Deque[Request] = deque()
        self._requests: Dict[int, Request] = {}
        # set once a deadline-carrying request arrives: without one,
        # expire() costs O(1) a step instead of a scan of the queue
        self._saw_deadlines = False

    def submit(self, request: Request) -> None:
        request.state = RequestState.QUEUED
        self._requests[request.rid] = request
        self._queue.append(request)
        if request.deadline is not None or request.queue_deadline is not None:
            self._saw_deadlines = True

    def requeue_front(self, requests: List[Request]) -> None:
        """Preempted requests rejoin at the FRONT in arrival order."""
        for req in sorted(requests, key=lambda r: r.rid, reverse=True):
            req.state = RequestState.QUEUED
            self._queue.appendleft(req)

    def cancel(self, rid: int) -> bool:
        """Mark a request cancelled. Queued requests drop immediately;
        running ones are reaped by the engine at its next step."""
        req = self._requests.get(rid)
        if req is None or req.finished:
            return False
        req.state = RequestState.CANCELLED
        if req in self._queue:
            self._queue.remove(req)
        return True

    def release(self, rid: int) -> Optional[Request]:
        """Withdraw a QUEUED request from this scheduler entirely, queue and
        index, and return it live (state untouched) so that another engine
        can adopt it (JAX ``release``, ``scheduler.py:160``: the router's
        rebalancing, a warm restart's surrendered queue). Unlike
        :meth:`cancel` the request does not finish, and this scheduler
        forgets the rid, so a later restore can never admit it here twice.
        None for an unknown, finished or not-queued rid."""
        req = self._requests.get(rid)
        if req is None or req.finished or req.state is not RequestState.QUEUED:
            return None
        try:
            self._queue.remove(req)
        except ValueError:
            return None  # admitted into a slot: not releasable
        del self._requests[rid]
        return req

    def expire(self, now: float) -> List[tuple]:
        """Pop every queued request whose queue timeout or deadline has
        passed (``now >= deadline``) and return ``(request, reason)`` pairs;
        the engine marks them TIMED_OUT. The queue timeout governs FIRST
        admission only: a request requeued after preemption or recovery was
        admitted in time (``admit_time`` set), so only its deadline can still
        shed it. The survivors keep their order."""
        expired: List[tuple] = []
        if not self._queue or not self._saw_deadlines:
            return expired
        keep: Deque[Request] = deque()
        for req in self._queue:
            if req.state is not RequestState.QUEUED:
                keep.append(req)
            elif (req.queue_deadline is not None and req.admit_time is None
                  and now >= req.queue_deadline):
                expired.append((req, "queue timeout before admission"))
            elif req.deadline is not None and now >= req.deadline:
                expired.append((req, "deadline exceeded while queued"))
            else:
                keep.append(req)
        self._queue = keep
        return expired

    def select(self, free_slots: int, in_flight_tokens: int,
               fits: Optional[Callable[[Request], bool]] = None,
               prefill_cost: Optional[Callable[[Request], int]] = None,
               now: Optional[float] = None) -> List[Request]:
        """One admission round through the bound policy
        (``serving/sched/policy.py``: ``scan_queue`` then ``order_round``):
        the policy-ordered queue prefix that fits ``free_slots``, the token
        budget and the engine's capacity predicate ``fits`` (checked in
        queue order, so it may accumulate a projected cursor), leaving the
        queue in state PREFILL, longest prefill first; ``prefill_cost``
        replaces the context length as the ordering key with the EFFECTIVE
        prefill (the prefix-cache engine passes the context less its
        reusable prefix). ``now`` feeds time-aware policies (aging,
        preemption cooldowns); FIFO ignores it."""
        return self.policy.select(self._queue, free_slots, in_flight_tokens,
                                  self.max_tokens_in_flight, fits, prefill_cost, now=now)

    @property
    def requests(self) -> Dict[int, Request]:
        return self._requests

    @property
    def queued_requests(self) -> List[Request]:
        """Live (unfinished) queue entries, in queue order."""
        return [r for r in self._queue if not r.finished]

    @property
    def queued(self) -> int:
        return sum(1 for r in self._queue if not r.finished)

    def upcoming(self, n: int) -> List[Request]:
        """The first ``n`` live queued requests in plain queue order (JAX
        ``upcoming``, ``scheduler.py:257``): the host page tier's prefetch
        pre-pass peeks here. Read-only and policy-blind: it never consults
        the policy, so it cannot perturb admission; a prefetch for a request
        the policy admits later merely moves its pages early."""
        if n <= 0:
            return []
        out: List[Request] = []
        for r in self._queue:
            if r.finished:
                continue
            out.append(r)
            if len(out) >= n:
                break
        return out

    def queued_by_tenant(self) -> Dict[str, int]:
        """Live queue depth per tenant, tenant-sorted (a halt's post-mortem
        records it: who was waiting)."""
        depths: Dict[str, int] = {}
        for r in self.queued_requests:
            depths[r.tenant] = depths.get(r.tenant, 0) + 1
        return dict(sorted(depths.items()))

    def get(self, rid: int) -> Optional[Request]:
        return self._requests.get(rid)
