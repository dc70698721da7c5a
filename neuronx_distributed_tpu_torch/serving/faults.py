"""Deterministic fault injection for the serving engine (counterpart of
``neuronx_distributed_tpu/serving/faults.py``: the ``InjectedFault`` family
and ``FaultInjector`` with the hooks one engine consults).

Chaos tests need failures that are SCHEDULED, not random: a dispatch that
raises at exactly chunk ``k``, a readback poisoned for exactly slot ``s``, a
prefill that fails on exactly the ``n``-th admission, a clock that jumps
mid-run. ``FaultInjector`` is a passive schedule the engine consults at its
hook points; with no injector (the default) every hook is skipped.

Injection points (every index 0-based and deterministic):

* ``fail_dispatch(at=k, times=t)``: the k-th..(k+t-1)-th decode dispatch
  ATTEMPTS raise ``InjectedDispatchError`` before the chunk's first step
  runs, so the cache and slot state are untouched (a host-side enqueue
  failure). ``times=None`` fails every attempt from ``at`` on: the way to
  drive the engine into ``HALTED``.
* ``poison_readback(at=k, slot=s, token=v)``: the k-th successful readback's
  host token block gets slot ``s``'s first token replaced by ``v``
  (out of the vocabulary by default), a corrupted device buffer; the
  neighbours' columns are untouched. A poison whose slot is not active at
  readback ``k`` defers to the next readback.
* ``fail_prefill(at=n, times=t)``: the n-th prefill call raises
  ``InjectedPrefillError`` (an out-of-memory-like admission failure).
* ``poison_prefix(at=k, times=t)``: the STORED prefix entry that the k-th
  reuse attempt is about to seed from is perturbed in place (every float
  leaf of its copy); the engine's reuse-time validation must evict it and
  fall back to a full prefill.
* ``poison_page(at=k, slot=s)``: paged engines; at the k-th successful
  readback the first pool page slot ``s`` maps is declared poisoned: the
  engine retires THE PAGE and requeues exactly the requests whose tables
  map it, copy-on-write sharers included. Defers like ``poison_readback``.
* ``skew_clock(by=s, after=t)``: the engine clock reads ``s`` seconds ahead
  (from real time ``after`` on, if given), driving deadline and queue
  timeout shedding without sleeping.
* ``fail_draft_dispatch(at=k, times=t)``: the k-th speculative dispatch
  attempts raise ``InjectedDraftError`` before the round's first step; the
  engine decodes that chunk with the plain step and resyncs the draft.
* ``flip_bits(target="kv_pool", at=k, times=t)``: silent corruption: ONE
  low-order bit of the first pool page of the entry that the k-th prefix
  reuse attempt maps is flipped, on the device and before validation; only
  the per-page fingerprint check can catch it.
* ``fail_spill(at=k, times=t)``: engines with a host page tier
  (``kv_host_pages=``); the k-th..(k+t-1)-th spill attempts raise
  ``InjectedSpillError`` before anything leaves the pool: the engine
  degrades to plain eviction.
* ``fail_prefetch(at=k, times=t)``: the k-th prefetch attempts raise
  ``InjectedPrefetchError`` before any device write: the engine drops the
  host entry and serves the request with a full prefill.
* ``poison_host_page(at=k, times=t)``: the k-th prefetch attempts find
  their entry's FIRST host page corrupted in place (one byte flipped,
  ``HostPageStore.corrupt``): the CRC check must reject the whole fetch.

* ``poison_draft(at=k, times=t)``: speculative engines whose draft owns its
  tensors (``ServingEngine(draft_params=)``); the k-th..(k+t-1)-th dispatch
  attempts run on a corrupted draft (every float tensor ``-w + 3.7``):
  every proposal is garbage, every round all-rejects, and the streams must
  not change. JAX corrupts a copy; the captured round reads fixed
  addresses, so the engine writes the corrupted values in before the
  dispatch and the clean ones back after it. An engine whose draft shares
  the target's tensors (the early-exit draft) refuses the schedule.

* ``fail_handoff(at=k, times=t)``: the k-th..(k+t-1)-th disaggregated
  HANDOFF attempts raise ``InjectedHandoffError`` before the page-table
  transfer binds a slot: the server releases the staged pages and falls
  back to a coupled prefill on the decode engine.
* The transport schedules, consulted by ``serving/transport.py
  ChaosTransport`` at every delivery attempt (its transport-wide send
  index): ``drop_send`` (dropped in flight, the retry delivers),
  ``drop_ack`` (delivered, the reply lost: the retry must hit the dedup
  cache), ``dup_send`` (delivered twice), ``delay_send(by=)`` (a delay past
  the message's deadline times out) and ``partition(target)`` (every send
  to ``target`` in the window fails; ``times=None``: for good).

* ``flip_bits(target="params", at=k, times=t)``: silent weight corruption:
  at the k-th..(k+t-1)-th engine ``step()`` calls ONE low-order bit of the
  engine's first weight tensor (in its fixed integrity order) is flipped IN
  PLACE on the device (``integrity/chaos.py``; JAX binds a flipped copy,
  the port's captured programs read fixed addresses). Liveness probes see
  nothing; the router's fingerprint vote must. An engine whose weights
  another engine also serves refuses the schedule (``ValueError``): the
  flip would corrupt both, and no vote could see it.

``counters`` records every fault actually fired, under the JAX package's
names, so chaos tests can assert that the schedule ran."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch


class InjectedFault(RuntimeError):
    """Base class of injected failures (never raised by real code)."""


class InjectedDispatchError(InjectedFault):
    """Scheduled decode-dispatch failure."""


class InjectedDraftError(InjectedFault):
    """Scheduled SPECULATIVE dispatch failure: the engine decodes the chunk
    with the plain step instead, streams unchanged."""


class InjectedPrefillError(InjectedFault):
    """Scheduled prefill failure (an out-of-memory-like admission fault)."""


class InjectedSpillError(InjectedFault):
    """Scheduled KV spill failure: the engine degrades to plain eviction."""


class InjectedPrefetchError(InjectedFault):
    """Scheduled KV prefetch failure: the engine drops the host copy and
    falls back to a full prefill."""


class InjectedHandoffError(InjectedFault):
    """Scheduled disaggregated HANDOFF failure: the server falls back to a
    coupled prefill of the request on the decode engine."""


class FaultInjector:
    """Schedule-driven fault source consulted by ``ServingEngine`` hooks."""

    def __init__(self):
        # [at, end) half-open attempt windows; end=None: open-ended
        self._dispatch_windows: List[Tuple[int, Optional[int]]] = []
        self._poisons: Dict[int, List[Tuple[int, int]]] = {}  # readback -> [(slot, token)]
        self._prefill_windows: List[Tuple[int, Optional[int]]] = []
        self._prefix_windows: List[Tuple[int, Optional[int]]] = []
        self._draft_dispatch_windows: List[Tuple[int, Optional[int]]] = []
        self._page_poisons: Dict[int, List[int]] = {}  # readback -> [slot]
        self._pool_flip_windows: List[Tuple[int, Optional[int]]] = []
        self._params_flip_windows: List[Tuple[int, Optional[int]]] = []
        self._spill_windows: List[Tuple[int, Optional[int]]] = []
        self._prefetch_windows: List[Tuple[int, Optional[int]]] = []
        self._host_page_windows: List[Tuple[int, Optional[int]]] = []
        self._draft_poison_windows: List[Tuple[int, Optional[int]]] = []
        self._handoff_windows: List[Tuple[int, Optional[int]]] = []
        self._send_drops: List[Tuple[int, Optional[int]]] = []
        self._ack_drops: List[Tuple[int, Optional[int]]] = []
        self._send_dups: List[Tuple[int, Optional[int]]] = []
        self._send_delays: List[Tuple[int, Optional[int], float]] = []
        self._partitions: Dict[object, List[Tuple[int, Optional[int]]]] = {}
        self._skew: float = 0.0
        self._skew_after: Optional[float] = None
        # the JAX package's counter names, that of a hook not ported included
        self.counters: Dict[str, int] = dict.fromkeys((
            "dispatch_failures", "poisoned_readbacks", "prefill_failures", "poisoned_prefixes",
            "draft_dispatch_failures", "poisoned_drafts", "poisoned_pages", "handoff_failures",
            "spill_failures", "prefetch_failures", "poisoned_host_pages", "bit_flips",
            "dropped_sends", "dropped_acks", "dup_sends", "delayed_sends", "partitioned_sends"),
            0)

    # --- schedule construction ----------------------------------------------

    @staticmethod
    def _window(at: int, times: Optional[int]) -> Tuple[int, Optional[int]]:
        return at, None if times is None else at + times

    def fail_dispatch(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        self._dispatch_windows.append(self._window(at, times))
        return self

    def poison_readback(self, at: int, slot: int, token: int = -1) -> "FaultInjector":
        self._poisons.setdefault(at, []).append((slot, token))
        return self

    def fail_prefill(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        self._prefill_windows.append(self._window(at, times))
        return self

    def poison_prefix(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        self._prefix_windows.append(self._window(at, times))
        return self

    def fail_draft_dispatch(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        """The ``at``-th..(at+times-1)-th speculative dispatch attempts
        raise :class:`InjectedDraftError` before the round's first step: the
        engine decodes that chunk with the plain step (streams unchanged,
        no token lost), then resyncs the draft cache."""
        self._draft_dispatch_windows.append(self._window(at, times))
        return self

    def poison_page(self, at: int = 0, times: int = 1, slot: int = 0) -> "FaultInjector":
        """At the ``at``-th..(at+times-1)-th successful readbacks of a paged
        engine, poison the first pool page slot ``slot`` maps: the engine
        retires the page and requeues exactly the requests that map it."""
        for i in range(times):
            self._page_poisons.setdefault(at + i, []).append(slot)
        return self

    def flip_bits(self, target: str, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        """Single-bit SILENT corruption (JAX ``flip_bits``). ``"params"``
        flips one low-order bit of the engine's weights in place at the
        ``at``-th..(at+times-1)-th ``step()`` calls (the router vote's
        model); ``"kv_pool"`` flips one bit of the first pool page the
        ``at``-th prefix reuse attempts map, before validation (the
        per-page fingerprint check's model)."""
        if target == "params":
            self._params_flip_windows.append(self._window(at, times))
        elif target == "kv_pool":
            self._pool_flip_windows.append(self._window(at, times))
        else:
            raise ValueError(f"flip_bits target must be params|kv_pool, got {target!r}")
        return self

    @property
    def flips_params(self) -> bool:
        """Whether the schedule holds a ``flip_bits("params")``."""
        return bool(self._params_flip_windows)

    def skew_clock(self, by: float, after: Optional[float] = None) -> "FaultInjector":
        self._skew = by
        self._skew_after = after
        return self

    def poison_draft(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        """The ``at``-th..(at+times-1)-th speculative dispatch attempts run
        on a corrupted draft (every float tensor ``-w + 3.7``): proposals
        become garbage, rounds all-reject, the streams stay as they were.
        Needs a draft with tensors of its own (``draft_params=``)."""
        self._draft_poison_windows.append(self._window(at, times))
        return self

    @property
    def poisons_draft(self) -> bool:
        """Whether the schedule holds a ``poison_draft``."""
        return bool(self._draft_poison_windows)

    def fail_spill(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        """The ``at``-th..(at+times-1)-th KV spill attempts raise
        :class:`InjectedSpillError` before anything leaves the pool: the
        entry's pins are intact and the engine evicts it instead."""
        self._spill_windows.append(self._window(at, times))
        return self

    def fail_prefetch(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        """The ``at``-th..(at+times-1)-th KV prefetch attempts raise
        :class:`InjectedPrefetchError` before any device write: the engine
        drops the host entry and serves the request with a full prefill."""
        self._prefetch_windows.append(self._window(at, times))
        return self

    def poison_host_page(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        """Flip one byte of the FIRST host page the ``at``-th..(at+times-1)-th
        prefetch attempts are about to fetch (host-RAM bit rot, through the
        store's own ``corrupt``): the CRC check must reject the whole fetch."""
        self._host_page_windows.append(self._window(at, times))
        return self

    def fail_handoff(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        """The ``at``-th..(at+times-1)-th disaggregated handoff attempts
        raise :class:`InjectedHandoffError` before the page-table transfer
        binds a slot (nothing half-mapped: the staged context survives for
        the server to release)."""
        self._handoff_windows.append(self._window(at, times))
        return self

    def drop_send(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        """The ``at``-th.. transport delivery attempts are dropped in flight
        (``TransportError`` before the target runs)."""
        self._send_drops.append(self._window(at, times))
        return self

    def drop_ack(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        """The ``at``-th.. transport deliveries RUN at the target but their
        replies are lost: the sender retries a message that already ran,
        which must land in the transport's idempotency cache."""
        self._ack_drops.append(self._window(at, times))
        return self

    def dup_send(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        """The ``at``-th.. transport deliveries arrive TWICE; the second
        copy must be absorbed by the idempotency cache."""
        self._send_dups.append(self._window(at, times))
        return self

    def delay_send(self, at: int = 0, times: Optional[int] = 1,
                   by: float = 1.0) -> "FaultInjector":
        """The ``at``-th.. transport deliveries are delayed ``by`` seconds;
        a delay past the message's deadline is a ``TransportTimeout``."""
        self._send_delays.append(self._window(at, times) + (by,))
        return self

    def partition(self, target, at: int = 0, times: Optional[int] = None) -> "FaultInjector":
        """``target`` (a replica index or a disaggregated address) is
        unreachable for the ``at``-th.. delivery attempts
        (``PartitionedError``); ``times=None`` partitions it for good."""
        self._partitions.setdefault(target, []).append(self._window(at, times))
        return self

    # --- engine hooks --------------------------------------------------------

    @staticmethod
    def _hit(windows, index: int) -> bool:
        return any(index >= at and (end is None or index < end) for at, end in windows)

    def on_dispatch(self, attempt: int) -> None:
        """Called with the 0-based dispatch ATTEMPT index (failed attempts
        count, so a retry schedule is deterministic); raises when the
        schedule says this attempt fails."""
        if self._hit(self._dispatch_windows, attempt):
            self.counters["dispatch_failures"] += 1
            raise InjectedDispatchError(f"injected dispatch failure at attempt {attempt}")

    def on_spec_dispatch(self, attempt: int) -> None:
        """Called with the dispatch attempt index before a SPECULATIVE chunk
        (the attempt counter is :meth:`on_dispatch`'s)."""
        if self._hit(self._draft_dispatch_windows, attempt):
            self.counters["draft_dispatch_failures"] += 1
            raise InjectedDraftError(f"injected draft dispatch failure at attempt {attempt}")

    def on_spec_params(self, attempt: int) -> bool:
        """Called with the dispatch attempt index before a speculative
        chunk: whether this dispatch runs on a poisoned draft (JAX
        ``on_spec_params``, which returns the corrupted copy; the engine
        corrupts its draft in place and restores it after the dispatch)."""
        if not self._hit(self._draft_poison_windows, attempt):
            return False
        self.counters["poisoned_drafts"] += 1
        return True

    def _poison_slots(self, readback: int, active) -> List[Tuple[int, int]]:
        """The (slot, token) poisons that land at ``readback``; those whose
        slot is not active defer to the next readback."""
        fire, deferred = [], []
        for slot, token in self._poisons.pop(readback, ()):
            (deferred if active is not None and not bool(active[slot]) else fire).append(
                (slot, token))
        if deferred:
            self._poisons.setdefault(readback + 1, []).extend(deferred)
        self.counters["poisoned_readbacks"] += len(fire)
        return fire

    def on_readback(self, readback: int, toks, counts, active=None):
        """Called with the 0-based successful-readback index, the HOST token
        block ``(chunk, slots)``, each slot's count ``(slots,)`` and the
        active mask. Returns the (possibly poisoned) pair; the counter moves
        only when garbage lands where the engine must catch it."""
        fire = self._poison_slots(readback, active)
        if fire:
            toks, counts = toks.copy(), counts.copy()
        for slot, token in fire:
            if counts[slot] <= 0:
                counts[slot] = 1  # a poisoned slot claims at least one token
            toks[0, slot] = token
        return toks, counts

    def on_spec_readback(self, readback: int, toks, counts, active=None):
        """:meth:`on_readback` for a speculative chunk: ``toks`` (rounds,
        slots, gamma), ``counts`` (rounds, slots); the poison lands in the
        victim's first round."""
        fire = self._poison_slots(readback, active)
        if fire:
            toks, counts = toks.copy(), counts.copy()
        for slot, token in fire:
            if counts[0, slot] <= 0:
                counts[0, slot] = 1
            toks[0, slot, 0] = token
        return toks, counts

    def on_page_readback(self, readback: int, slot_pages, active=None) -> List[int]:
        """Called by paged engines with the successful-readback index and
        ``slot_pages`` (slot -> the pool pages its table maps). Returns the
        pages poisoned at this readback; a slot that is not active, or maps
        nothing, defers to the next readback."""
        pages: List[int] = []
        deferred: List[int] = []
        for slot in self._page_poisons.pop(readback, ()):
            mapped = slot_pages(slot) if active is None or bool(active[slot]) else []
            if not mapped:
                deferred.append(slot)
                continue
            pages.append(int(mapped[0]))
            self.counters["poisoned_pages"] += 1
        if deferred:
            self._page_poisons.setdefault(readback + 1, []).extend(deferred)
        return pages

    def on_prefill(self, call: int) -> None:
        """Called with the 0-based prefill call index before the prefill."""
        if self._hit(self._prefill_windows, call):
            self.counters["prefill_failures"] += 1
            raise InjectedPrefillError(f"injected prefill failure at call {call} "
                                       "(RESOURCE_EXHAUSTED: out of memory)")

    def on_spill(self, attempt: int) -> None:
        """Called by engines with a host tier with the 0-based spill attempt
        index, before the pages leave the pool."""
        if self._hit(self._spill_windows, attempt):
            self.counters["spill_failures"] += 1
            raise InjectedSpillError(f"injected spill failure at attempt {attempt}")

    def on_prefetch(self, attempt: int, store=None, host_ids=()) -> None:
        """Called with the 0-based prefetch attempt index, the host store and
        the host ids about to be fetched, BEFORE verification: a scheduled
        ``poison_host_page`` corrupts the first page in place, a scheduled
        ``fail_prefetch`` raises."""
        if self._hit(self._host_page_windows, attempt) and store is not None and host_ids:
            store.corrupt(host_ids[0])
            self.counters["poisoned_host_pages"] += 1
        if self._hit(self._prefetch_windows, attempt):
            self.counters["prefetch_failures"] += 1
            raise InjectedPrefetchError(f"injected prefetch failure at attempt {attempt}")

    def on_handoff(self, attempt: int) -> None:
        """Called by the disaggregated server with the 0-based handoff
        attempt index before ``admit_staged`` runs."""
        if self._hit(self._handoff_windows, attempt):
            self.counters["handoff_failures"] += 1
            raise InjectedHandoffError(f"injected handoff failure at attempt {attempt}")

    def on_transport_send(self, send: int, target, op: str):
        """Called by ``ChaosTransport`` with the transport-wide 0-based
        delivery-attempt index, the target address and the op name. Returns
        an action, ``("partition",)``, ``("drop",)``, ``("drop_ack",)``,
        ``("dup",)`` or ``("delay", by)``, or None for a clean delivery. A
        partition wins over the per-send faults."""
        windows = self._partitions.get(target)
        if windows is not None and self._hit(windows, send):
            self.counters["partitioned_sends"] += 1
            return ("partition",)
        if self._hit(self._send_drops, send):
            self.counters["dropped_sends"] += 1
            return ("drop",)
        if self._hit(self._ack_drops, send):
            self.counters["dropped_acks"] += 1
            return ("drop_ack",)
        if self._hit(self._send_dups, send):
            self.counters["dup_sends"] += 1
            return ("dup",)
        for at, end, by in self._send_delays:
            if send >= at and (end is None or send < end):
                self.counters["delayed_sends"] += 1
                return ("delay", by)
        return None

    def on_engine_params(self, step: int, leaves: Callable[[], list]) -> bool:
        """Called with the 0-based engine ``step()`` index and a callable
        giving the engine's weight tensors in its fixed integrity order (JAX
        ``on_engine_params``, ``faults.py:536``), called only when a
        ``flip_bits("params")`` window hits: then ONE low-order bit of the
        first tensor is flipped in place (numerically near-invisible
        corruption only a bit-level fingerprint sees) and True returned."""
        if not self._hit(self._params_flip_windows, step):
            return False
        from neuronx_distributed_tpu_torch.integrity.chaos import flip_tree_bit

        flip_tree_bit(leaves())
        self.counters["bit_flips"] += 1
        return True

    def on_prefix_reuse(self, reuse: int, entry, cache=None) -> None:
        """Called with the 0-based prefix REUSE-attempt index, the matched
        ``PrefixEntry`` and (paged engines) the cache manager, BEFORE
        validation. ``poison_prefix`` perturbs a row entry's stored copy in
        place (shapes kept, so validation must catch it by content);
        ``flip_bits("kv_pool")`` flips one bit of a paged entry's first
        page."""
        if (cache is not None and getattr(entry, "page_ids", None)
                and self._hit(self._pool_flip_windows, reuse)):
            self._flip_pool_page(cache, int(entry.page_ids[0]))
            self.counters["bit_flips"] += 1
        if not self._hit(self._prefix_windows, reuse) or getattr(entry, "tree", None) is None:
            return  # a paged entry holds no copy: page corruption is poison_page's
        entry.tree.k.add_(1024.0)
        entry.tree.v.add_(1024.0)
        self.counters["poisoned_prefixes"] += 1

    @staticmethod
    def _flip_pool_page(cache, pid: int) -> None:
        """Flip bit 0 of byte 0 of pool page ``pid`` in the first
        page-carrying pool leaf in the JAX package's leaf order (layer 0's
        K), in place on the device: memory bit rot, no host read."""
        page = cache.cache.k[0, pid].reshape(-1).view(torch.uint8)
        page[:1].bitwise_xor_(1)

    def now(self, real_now: float) -> float:
        """Clock hook: the engine's view of time, skewed per schedule."""
        if self._skew and (self._skew_after is None or real_now >= self._skew_after):
            return real_now + self._skew
        return real_now
