"""Device profiler windows, compile events and device memory gauges
(counterpart of ``neuronx_distributed_tpu/observability/profiler.py``:
``profile_window`` ``:42``, ``install_compile_listener`` ``:71``,
``record_device_memory`` ``:101``).

* :func:`profile_window`: ``torch.profiler`` around a block (CPU activity,
  and CUDA activity on the card), written as a Chrome trace,
  ``<path>/trace.json``, which Perfetto (ui.perfetto.dev, "Open trace
  file") and ``chrome://tracing`` read. Exception-safe, one live window a
  process (a second is refused), a no-op for a falsy ``path``.
  :class:`ProfileWindow` is the same window opened and closed by hand (the
  serving engine's ``profile_dir=``, which profiles decode chunks [2, 5)).
* :func:`install_compile_listener`: counts the port's compile events into a
  registry: kernel builds (``nvcc``) and library loads in
  ``kernels/_build.py``, and CUDA-graph captures
  (``inference/graphs.DecodeProgram``), with their durations.
* :func:`record_device_memory`: ``torch.cuda.memory_stats`` and
  ``mem_get_info`` as gauges per device; 0 devices on the CPU.

Nothing here runs on the serving or training hot path."""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import torch

__all__ = ["ProfileWindow", "profile_window", "install_compile_listener",
           "record_device_memory", "TRACE_NAME"]

TRACE_NAME = "trace.json"
_active = threading.Lock()  # one live profiler window a process


class ProfileWindow:
    """One ``torch.profiler`` window writing ``<path>/trace.json`` at
    :meth:`stop`. :meth:`start` raises ``RuntimeError`` when another window
    of this process is live."""

    def __init__(self, path: str):
        self.path = path
        self.trace_path = os.path.join(path, TRACE_NAME)
        self._prof = None

    def start(self) -> None:
        if not _active.acquire(blocking=False):
            raise RuntimeError("a torch.profiler window is already live in this process; close "
                               "it before opening another")
        try:
            os.makedirs(self.path, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        except BaseException:
            _active.release()
            raise
        self._prof = prof

    def stop(self):
        """Close the window and write its trace; returns the profiler (its
        ``key_averages()`` and events), or None when none was live."""
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(self.trace_path)
        finally:
            _active.release()
        return prof


@contextlib.contextmanager
def profile_window(path: Optional[str]):
    """Profile the enclosed block into ``path`` (yields the
    :class:`ProfileWindow`); a falsy ``path`` disables."""
    if not path:
        yield None
        return
    window = ProfileWindow(path)
    window.start()
    try:
        yield window
    finally:
        window.stop()


def install_compile_listener(registry) -> bool:
    """Count the port's compile events into ``registry``: the counter
    ``torch_compile_events`` and the histogram ``torch_compile_time_s``
    (kernel builds and loads, graph captures). Returns True (the hook always
    exists); listeners are process-wide, so install once a registry."""
    from neuronx_distributed_tpu_torch.kernels import _build

    count = registry.counter("torch_compile_events",
                             help="kernel builds and loads, CUDA-graph captures")
    hist = registry.histogram("torch_compile_time_s", help="compile event durations (s)")

    def listener(event: str, seconds: float, **kw) -> None:
        count.inc()
        hist.observe(seconds)

    _build.COMPILE_LISTENERS.append(listener)
    return True


def record_device_memory(registry) -> int:
    """Per-device gauges ``device{i}_bytes_in_use`` (allocated),
    ``device{i}_peak_bytes_in_use``, ``device{i}_bytes_reserved``,
    ``device{i}_bytes_limit`` (total memory) and ``device{i}_bytes_free``
    from ``torch.cuda.memory_stats`` and ``mem_get_info``, with
    ``device{i}_memory_utilization`` = (limit - free) / limit. Returns how
    many devices reported (0 on the CPU)."""
    if not torch.cuda.is_available():
        return 0
    n = torch.cuda.device_count()
    for i in range(n):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        values = {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                  "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                  "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
                  "bytes_limit": total, "bytes_free": free}
        for key, v in values.items():
            registry.gauge(f"device{i}_{key}", help=f"torch.cuda memory: {key}").set(int(v))
        registry.gauge(f"device{i}_memory_utilization",
                       help="(bytes_limit - bytes_free) / bytes_limit").set(
            float(total - free) / float(total))
    return n
