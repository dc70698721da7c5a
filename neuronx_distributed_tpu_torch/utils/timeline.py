"""Chrome-trace event timeline (counterpart of
``neuronx_distributed_tpu/utils/timeline.py``).

Host-side events append to one list and dump to the ``chrome://tracing`` /
Perfetto JSON format: duration events (``mark_event_start``/``_end`` or
``event()``), counter tracks, instants, and flow events (``flow()``, the
arrows Perfetto draws between the events of one request's life; see
``observability/tracing.py``). Device time is the profiler's
(``torch.profiler``); this timeline is the scheduling view.

Durability: ``save()`` writes atomically (a temporary file, then a rename),
so a crash mid-dump never leaves a truncated trace over a good one, and an
``atexit`` hook flushes whatever accumulated if the process ends without an
explicit save (the serving engine also saves at a halt). Thread ids are
small integers in first-seen order.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
import weakref
from typing import Optional


def _atexit_flush(ref: "weakref.ref") -> None:
    """The atexit target, holding only a weak reference: a discarded
    Timeline (and its events) stays collectable."""
    tl = ref()
    if tl is not None:
        tl._atexit_save()


class Timeline:
    """Host-event timeline writing Chrome trace-event JSON; with
    ``trace_file_path=None`` it is disabled and every call returns at
    once."""

    def __init__(self, trace_file_path: Optional[str] = None, rank: int = 0):
        self.trace_file_path = trace_file_path
        self.rank = rank
        self._events: list = []
        self._open: dict = {}
        self._lock = threading.Lock()
        self._t0 = time.perf_counter_ns()
        self._tids: dict = {}
        self._dirty = False
        if self.enabled:
            atexit.register(_atexit_flush, weakref.ref(self))

    @property
    def enabled(self) -> bool:
        return self.trace_file_path is not None

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _tid(self) -> int:
        """Stable small track id of the calling thread. Caller holds
        ``_lock``."""
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    def _append(self, ev: dict) -> None:
        """Caller holds ``_lock``."""
        self._events.append(ev)
        self._dirty = True

    def mark_event_start(self, name: str, category: str = "host") -> None:
        if not self.enabled:
            return
        with self._lock:
            self._open[(name, category)] = self._now_us()

    def mark_event_end(self, name: str, category: str = "host",
                       args: Optional[dict] = None) -> None:
        """Close a duration event; ``args`` attaches a payload (the decode
        chunk's token count beside its readback span, for instance)."""
        if not self.enabled:
            return
        with self._lock:
            start = self._open.pop((name, category), None)
            if start is None:
                return
            ev = {"name": name, "cat": category, "ph": "X", "ts": start,
                  "dur": self._now_us() - start, "pid": self.rank, "tid": self._tid()}
            if args:
                ev["args"] = dict(args)
            self._append(ev)

    def event(self, name: str, category: str = "host", args: Optional[dict] = None):
        """Context-manager form of a duration event."""
        timeline = self

        class _Ctx:
            def __enter__(self):
                timeline.mark_event_start(name, category)
                return self

            def __exit__(self, *exc):
                timeline.mark_event_end(name, category, args=args)
                return False

        return _Ctx()

    def counter(self, name: str, value: float, category: str = "host") -> None:
        """A counter track sample (``ph: "C"``): slot occupancy, queue
        depth, tokens a chunk."""
        if not self.enabled:
            return
        with self._lock:
            self._append({"name": name, "cat": category, "ph": "C", "ts": self._now_us(),
                          "pid": self.rank, "args": {name: value}})

    def instant(self, name: str, category: str = "host", args: Optional[dict] = None) -> None:
        """A zero-duration marker with an optional payload."""
        if not self.enabled:
            return
        with self._lock:
            ev = {"name": name, "cat": category, "ph": "i", "ts": self._now_us(),
                  "pid": self.rank, "s": "g", "tid": self._tid()}
            if args:
                ev["args"] = dict(args)
            self._append(ev)

    def flow(self, name: str, flow_id, phase: str, category: str = "flow",
             args: Optional[dict] = None) -> None:
        """One Chrome flow event: ``phase`` ``"s"`` (start), ``"t"`` (step)
        or ``"f"`` (end); the events of one flow share ``name``, ``cat`` and
        ``flow_id``. ``bp: "e"`` binds each to its enclosing slice."""
        if not self.enabled:
            return
        if phase not in ("s", "t", "f"):
            raise ValueError(f"flow phase must be s/t/f, got {phase!r}")
        with self._lock:
            ev = {"name": name, "cat": category, "ph": phase, "id": flow_id, "bp": "e",
                  "ts": self._now_us(), "pid": self.rank, "tid": self._tid()}
            if args:
                ev["args"] = dict(args)
            self._append(ev)

    def save(self) -> None:
        """Dump the events atomically (a temporary file, then a rename)."""
        if not self.enabled:
            return
        with self._lock:
            payload = {"traceEvents": list(self._events)}
            self._dirty = False
        tmp = f"{self.trace_file_path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.trace_file_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _atexit_save(self) -> None:
        """Best-effort final flush, only of events recorded since the last
        save."""
        if self._dirty:
            try:
                self.save()
            except Exception:
                pass  # interpreter teardown: nothing sane left to do
