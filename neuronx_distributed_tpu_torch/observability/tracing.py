"""Request-scoped tracing: one connected Perfetto flow per request
(counterpart of ``neuronx_distributed_tpu/observability/tracing.py``).

Every request gets a trace id at ``submit()`` (its rid, unique in its
engine, which is a trace file's scope), and every lifecycle transition
emits a Chrome flow event (``ph`` s/t/f keyed by that id) beside an instant
carrying the payload, so Perfetto draws the arrows queue wait, admission,
prefix lookup, prefill, first token, each decode chunk, and retire, shed,
quarantine, recovery or preemption: one trace explains one request's life.

Every emit takes host scalars the engine already owns (token counts from
the chunk's one read, rids, reasons); nothing here touches a device value.
Without a timeline (or with a disabled one) every call returns at once.
"""

from __future__ import annotations

from typing import Optional

from neuronx_distributed_tpu_torch.utils.timeline import Timeline

__all__ = ["RequestTracer", "FLOW_CATEGORY"]

# one category for request-lifecycle flows, so trace processors can select
# them
FLOW_CATEGORY = "request"


class RequestTracer:
    """Emits one connected flow per request onto a shared Timeline:
    ``begin`` opens it (at submit), ``step`` adds a linked waypoint,
    ``end`` closes it (retire, shed, cancel, fail). Each flow event has an
    instant twin at the same time carrying the payload."""

    def __init__(self, timeline: Optional[Timeline]):
        self.timeline = timeline

    @property
    def enabled(self) -> bool:
        tl = self.timeline
        return tl is not None and tl.enabled

    def _emit(self, rid: int, stage: str, phase: str, args: Optional[dict] = None) -> None:
        tl = self.timeline
        payload = {"rid": rid, "stage": stage}
        if args:
            payload.update(args)
        tl.flow(f"r{rid}", rid, phase, FLOW_CATEGORY, args=payload)
        tl.instant(f"{stage} r{rid}", FLOW_CATEGORY, args=payload)

    def begin(self, rid: int, args: Optional[dict] = None) -> None:
        """Open the request's flow (submit time)."""
        if self.enabled:
            self._emit(rid, "submit", "s", args)

    def step(self, rid: int, stage: str, args: Optional[dict] = None) -> None:
        """A linked waypoint inside the request's life."""
        if self.enabled:
            self._emit(rid, stage, "t", args)

    def end(self, rid: int, stage: str, args: Optional[dict] = None) -> None:
        """Close the request's flow (its terminal state)."""
        if self.enabled:
            self._emit(rid, stage, "f", args)
