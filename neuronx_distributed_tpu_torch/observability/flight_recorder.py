"""Flight recorder: a bounded ring of recent structured events and the
post-mortem dumped from it (counterpart of
``neuronx_distributed_tpu/observability/flight_recorder.py``: ``redact`` and
``FlightRecorder``).

The serving engine feeds it its state transitions, dispatch failures,
recoveries, quarantines and sheds as they happen, and dumps it as a
redacted JSON post-mortem the moment the engine halts, so the last N things
that happened before the halt are on record even when nobody was watching.

Redaction: payload CONTENT never enters the ring, only its shape. Strings
are truncated, sequences collapse to ``{"len": n}``, nested dicts are
redacted to a bounded depth, tensors and arrays record their type and
shape, anything else its type name. Token ids and prompts cannot appear in
a dump.

``record()`` takes host scalars and costs one dict build and a deque
append; it never touches a device value, so feeding it from the engine
adds no device read."""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "redact"]

_MAX_STR = 200
_MAX_SEQ = 8  # short numeric tuples (shapes, bucket ids) pass through
_MAX_DEPTH = 3
SCHEMA_VERSION = 1


def redact(value: Any, depth: int = 0) -> Any:
    """``value`` collapsed to its redacted, JSON-safe form."""
    if value is None or isinstance(value, (bool, int, float)):
        if isinstance(value, float) and value != value:  # NaN -> JSON-safe
            return "nan"
        return value
    if isinstance(value, str):
        return value if len(value) <= _MAX_STR else value[:_MAX_STR] + "…"
    if isinstance(value, dict):
        if depth >= _MAX_DEPTH:
            return {"keys": len(value)}
        return {str(k)[:64]: redact(v, depth + 1) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        if len(value) <= _MAX_SEQ and all(
                v is None or isinstance(v, (bool, int, float)) for v in value):
            return ["nan" if isinstance(v, float) and v != v else v for v in value]
        return {"len": len(value)}
    shape = getattr(value, "shape", None)
    if shape is not None:  # ndarray / tensor: the shape is host metadata
        return {"type": type(value).__name__, "shape": [int(s) for s in shape]}
    return {"type": type(value).__name__}


class FlightRecorder:
    """Bounded ring of structured events with atomic post-mortem dumps.

    ``dump_dir=None`` keeps post-mortems in memory only
    (``last_postmortem``); with a directory set, each dump writes
    ``postmortem_<subsystem>_<seq>.json`` atomically (a temporary file and a
    rename)."""

    def __init__(self, capacity: int = 512, dump_dir: Optional[str] = None,
                 subsystem: str = "run"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.dump_dir = dump_dir
        self.subsystem = subsystem
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0  # events ever recorded
        self._dumps = 0
        self.last_postmortem: Optional[dict] = None
        self.last_dump_path: Optional[str] = None

    # --- recording ----------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """Append one structured event (host scalars only). ``kind`` is the
        event class (``health``, ``dispatch_failure``, ``halt``, ...);
        fields are redacted on entry."""
        self._seq += 1
        ev: Dict[str, Any] = {"seq": self._seq, "t_mono": time.monotonic(), "kind": kind}
        if fields:
            ev.update(redact(fields))
        self._ring.append(ev)

    def events(self) -> List[dict]:
        """The ring's contents, oldest first."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    # --- post-mortem --------------------------------------------------------

    def build_postmortem(self, reason: str, extra: Optional[dict] = None) -> dict:
        payload = {
            "schema": SCHEMA_VERSION,
            "subsystem": self.subsystem,
            "reason": redact(str(reason)),
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "events_recorded": self._seq,
            "events_kept": len(self._ring),
            "events": list(self._ring),
        }
        if extra:
            payload["extra"] = redact(extra)
        return payload

    def dump(self, reason: str, extra: Optional[dict] = None) -> Optional[str]:
        """Build and keep the post-mortem; with ``dump_dir`` also write it.
        Returns the file's path (None when kept in memory only). Never
        raises: it runs inside halt paths, whose job (stopping safely with
        the work requeued) a full disk must not take over."""
        payload = self.build_postmortem(reason, extra)
        self.last_postmortem = payload
        self._dumps += 1
        if self.dump_dir is None:
            return None
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
        except Exception:
            return None

        def _candidate():
            return os.path.join(self.dump_dir,
                                f"postmortem_{self.subsystem}_{self._dumps:03d}.json")

        # never overwrite an earlier record: a restarted run (a new
        # recorder, its count back at 0) skips past what earlier runs left
        path = _candidate()
        while os.path.exists(path):
            self._dumps += 1
            path = _candidate()
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        self.last_dump_path = path
        return path
