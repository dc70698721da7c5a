"""The message seam of the serving fabric (counterpart of
``neuronx_distributed_tpu/serving/transport.py``: the transport errors,
``Envelope``, ``InProcessTransport`` and ``ChaosTransport``).

Every router-to-replica and disaggregated handoff interaction (submit,
adopt, page export and import, probe, restore) rides a transport instead of
a bare method call:

* :class:`InProcessTransport`, the default: with no faults the target
  callable runs once, synchronously, and its result comes back unchanged,
  so behaviour equals a direct call; the transport adds host-side
  bookkeeping and an idempotency cache.
* :class:`ChaosTransport` asks a
  :class:`~neuronx_distributed_tpu_torch.serving.faults.FaultInjector`
  before each delivery attempt and drops, duplicates, delays or partitions
  messages by their send index, deterministically.

Each logical message is an :class:`Envelope` with an ``(rid, seq)``
idempotency key: ``seq`` is minted once per :meth:`InProcessTransport.call`,
so the retries of one message share a key and a new message gets a fresh
one. Delivery consults a bounded dedup cache keyed by ``(target, op, rid,
seq)``: a duplicated or retried delivery whose first attempt already ran
returns the cached outcome (result or application exception) without
running the target again, so a retried handoff can never admit a request
twice. Sends ride :func:`~neuronx_distributed_tpu_torch.utils.retry.
with_retries` with ``TransportError`` transient; a per-message deadline
(``deadline_s``) is checked before every attempt and raises
:class:`TransportTimeout`, which is not retried.

No tensor ever enters an envelope: the seam costs no device read."""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from neuronx_distributed_tpu_torch.utils.retry import RetryPolicy, with_retries

__all__ = [
    "Envelope",
    "TransportError",
    "TransportTimeout",
    "PartitionedError",
    "InProcessTransport",
    "ChaosTransport",
    "DEFAULT_TRANSPORT_RETRY",
]


class TransportError(RuntimeError):
    """A send failed in flight (a drop, a lost ack, a partition): retried."""


class TransportTimeout(TransportError):
    """The message's deadline lapsed before delivery: not retried."""


class PartitionedError(TransportError):
    """The target is unreachable (a partition window): retried, but every
    attempt inside the window fails the same way."""


@dataclasses.dataclass(frozen=True)
class Envelope:
    """One logical message. ``(rid, seq)`` is the idempotency key; ``seq``
    is minted once a message, so its retries reuse it. ``deadline`` is
    absolute on the transport's clock (None: no deadline)."""

    op: str
    rid: int
    seq: int
    deadline: Optional[float] = None


# the in-process "network" recovers at once: the attempt count (5) is what
# rides out a bounded fault window, not the waits; sleep defaults to a no-op
DEFAULT_TRANSPORT_RETRY = RetryPolicy(max_attempts=5, first_wait=0.02, min_wait=0.005)

_PROBE_RETRY = RetryPolicy(max_attempts=1, first_wait=0.0, min_wait=0.0)


class InProcessTransport:
    """The default transport: synchronous local delivery, exactly once.

    ``time_fn`` is the clock deadlines are checked against (the engines'
    virtual clock in tests); ``sleep_fn`` takes each retry's wait (default:
    no wait). The dedup cache keeps the last ``dedup_capacity`` outcomes
    (FIFO eviction)."""

    #: True on transports that may inject faults
    faulty = False

    def __init__(self, time_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Optional[Callable[[float], None]] = None,
                 retry: RetryPolicy = DEFAULT_TRANSPORT_RETRY, dedup_capacity: int = 4096):
        if dedup_capacity < 1:
            raise ValueError(f"dedup_capacity must be >= 1, got {dedup_capacity}")
        self._clock = time_fn
        self._sleep = sleep_fn if sleep_fn is not None else (lambda _s: None)
        self.retry = retry
        self._seq = 0
        self._send_idx = 0  # delivery attempts, across all messages
        self._dedup: "OrderedDict[Tuple[Any, str, int, int], Tuple[str, Any]]" = OrderedDict()
        self._dedup_capacity = int(dedup_capacity)
        self.stats: Dict[str, int] = dict.fromkeys((
            "messages", "deliveries", "retries", "drops", "ack_drops", "dup_deliveries",
            "delays", "timeouts", "partitioned", "dedup_hits", "give_ups"), 0)

    # --- sending ------------------------------------------------------------

    def call(self, target: Any, op: str, fn: Callable[[], Any], *, rid: int = -1,
             deadline_s: Optional[float] = None, retry: Optional[RetryPolicy] = None) -> Any:
        """Send one logical message: run ``fn`` at ``target`` (any hashable
        address) and return its result. ``rid`` attributes it to a request
        (the idempotency key), ``deadline_s`` bounds its delivery from now,
        ``retry`` overrides the policy (a probe is one attempt). An
        application exception of ``fn`` propagates unchanged and is cached,
        so a duplicate re-raises it without running ``fn``;
        :class:`TransportError` is retried, :class:`TransportTimeout` is
        final."""
        self._seq += 1
        now = self._clock()
        env = Envelope(op=op, rid=int(rid), seq=self._seq,
                       deadline=None if deadline_s is None else now + float(deadline_s))
        self.stats["messages"] += 1
        attempts = 0

        def once():
            nonlocal attempts
            if attempts:
                self.stats["retries"] += 1
            attempts += 1
            if env.deadline is not None and self._clock() > env.deadline:
                self.stats["timeouts"] += 1
                raise TransportTimeout(f"transport {env.op} to {target!r} (rid={env.rid}, "
                                       f"seq={env.seq}) missed its {deadline_s}s deadline")
            return self._attempt(target, env, fn)

        try:
            return with_retries(once, what=f"transport {op} -> {target!r}",
                                policy=self.retry if retry is None else retry,
                                transient=(TransportError,), passthrough=(TransportTimeout,),
                                sleep=self._sleep)
        except TransportError:
            self.stats["give_ups"] += 1
            raise

    def probe(self, target: Any, fn: Callable[[], Any], *,
              deadline_s: Optional[float] = None) -> Any:
        """A health probe: one attempt, one verdict (the watchdog's
        consecutive-failure thresholds do the retrying)."""
        return self.call(target, "probe", fn, deadline_s=deadline_s, retry=_PROBE_RETRY)

    # --- delivery -----------------------------------------------------------

    def _attempt(self, target: Any, env: Envelope, fn: Callable[[], Any]) -> Any:
        """One delivery attempt (a subclass injects faults here)."""
        self._send_idx += 1
        return self._deliver(target, env, fn)

    def _deliver(self, target: Any, env: Envelope, fn: Callable[[], Any]) -> Any:
        key = (target, env.op, env.rid, env.seq)
        hit = self._dedup.get(key)
        if hit is not None:
            # this (rid, seq) already ran: its recorded outcome, not a rerun
            self.stats["dedup_hits"] += 1
            kind, value = hit
            if kind == "raise":
                raise value
            return value
        self.stats["deliveries"] += 1
        try:
            result = fn()
        except Exception as e:  # an application outcome: cached, never retried
            self._remember(key, ("raise", e))
            raise
        self._remember(key, ("ok", result))
        return result

    def _remember(self, key, outcome: Tuple[str, Any]) -> None:
        self._dedup[key] = outcome
        while len(self._dedup) > self._dedup_capacity:
            self._dedup.popitem(last=False)

    # --- introspection ------------------------------------------------------

    def snapshot(self) -> Dict[str, int]:
        out = dict(self.stats)
        out["dedup_entries"] = len(self._dedup)
        return out


class ChaosTransport(InProcessTransport):
    """A fault-injecting transport: before each delivery attempt it asks
    ``faults.on_transport_send(send_idx, target, op)`` for an action: drop
    the send, drop only the ack (deliver, then report a failure so that the
    sender retries into the dedup cache), deliver twice, delay against the
    message deadline, or fail the whole window as a partition. ``send_idx``
    counts attempts transport-wide, so a schedule is deterministic for a
    deterministic workload."""

    faulty = True

    def __init__(self, faults, **kwargs):
        super().__init__(**kwargs)
        self.faults = faults

    def _attempt(self, target: Any, env: Envelope, fn: Callable[[], Any]) -> Any:
        idx = self._send_idx
        self._send_idx += 1
        action = None
        if self.faults is not None:
            action = self.faults.on_transport_send(idx, target, env.op)
        if action is None:
            return self._deliver(target, env, fn)
        kind = action[0]
        if kind == "partition":
            self.stats["partitioned"] += 1
            raise PartitionedError(f"target {target!r} unreachable: partition window (send {idx})")
        if kind == "drop":
            self.stats["drops"] += 1
            raise TransportError(f"transport {env.op} to {target!r} dropped in flight (send {idx})")
        if kind == "delay":
            by = float(action[1])
            self.stats["delays"] += 1
            if env.deadline is not None and self._clock() + by > env.deadline:
                self.stats["timeouts"] += 1
                raise TransportTimeout(f"transport {env.op} to {target!r} delayed {by}s past "
                                       f"its deadline (send {idx})")
            self._sleep(by)
            return self._deliver(target, env, fn)
        if kind == "drop_ack":
            # the target ran; only the reply was lost: the sender's retry
            # must land in the dedup cache
            self._deliver(target, env, fn)
            self.stats["ack_drops"] += 1
            raise TransportError(f"ack for {env.op} to {target!r} (rid={env.rid}, "
                                 f"seq={env.seq}) lost (send {idx})")
        if kind == "dup":
            # the same envelope arrives twice; the second copy replays the
            # first's outcome from the cache, an application error included
            self.stats["dup_deliveries"] += 1
            try:
                self._deliver(target, env, fn)
            except Exception:
                pass
            return self._deliver(target, env, fn)
        raise ValueError(f"unknown transport fault action {action!r}")
