"""Request lifecycle + admission policy (counterpart of
``neuronx_distributed_tpu/serving/scheduler.py`` with its FIFO policy,
``serving/sched/policy.py``).

Admission is FIFO with a token-budget guard: the queue is scanned in arrival
order and stops at the first request that does not fit (no overtaking). The
requests selected in one round are handed back LONGEST-PREFILL-FIRST: the
longest prompt sets the shared cache cursor, so the shorter prompts roll in
under the same cursor. ``max_tokens_in_flight`` bounds Σ over in-flight
requests of (context + remaining new tokens).
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
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    preemptions: int = 0
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
        return self.state in (RequestState.DONE, RequestState.CANCELLED)


class Scheduler:
    """Request bookkeeping and the FIFO admission scan."""

    def __init__(self, max_tokens_in_flight: Optional[int] = None):
        self.max_tokens_in_flight = max_tokens_in_flight
        self._queue: Deque[Request] = deque()
        self._requests: Dict[int, Request] = {}

    def submit(self, request: Request) -> None:
        request.state = RequestState.QUEUED
        self._requests[request.rid] = request
        self._queue.append(request)

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

    def select(self, free_slots: int, in_flight_tokens: int,
               fits: Optional[Callable[[Request], bool]] = None) -> List[Request]:
        """Pick the queue-order prefix that fits ``free_slots``, the token
        budget and the engine's capacity predicate ``fits`` (checked in
        queue order, so it may accumulate a projected cursor). Selected
        requests leave the queue in state PREFILL, longest prefill first."""
        selected: List[Request] = []
        budget = in_flight_tokens
        while self._queue and len(selected) < free_slots:
            req = self._queue[0]
            if req.finished:
                self._queue.popleft()
                continue
            if (self.max_tokens_in_flight is not None
                    and budget + req.token_footprint > self.max_tokens_in_flight):
                break  # nothing overtakes the blocked head
            if fits is not None and not fits(req):
                break
            self._queue.popleft()
            req.state = RequestState.PREFILL
            budget += req.token_footprint
            selected.append(req)
        selected.sort(key=lambda r: len(r.context_ids), reverse=True)
        return selected

    @property
    def requests(self) -> Dict[int, Request]:
        return self._requests

    @property
    def queued(self) -> int:
        return sum(1 for r in self._queue if not r.finished)

    def get(self, rid: int) -> Optional[Request]:
        return self._requests.get(rid)
