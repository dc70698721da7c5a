"""``MetricsCallback``: the trainer's per-step metrics dict into a registry
(counterpart of ``neuronx_distributed_tpu/observability/callback.py``).

Attach one to ``Trainer(callbacks=[...])`` (optionally sharing the registry
with a serving engine): the step-time histogram, the step counter, the
tokens and skips gauges, the health gauge, and a gauge a metrics key. The
trainer's host-read budget (one deferred read a step) holds with it
attached: device scalars of the dict (``loss``, ``grad_norm``, the guard's
flags) are stored RAW in their gauges and read only when the registry is
exported (``Gauge.set``), so ``on_step_end`` never waits on the device. Host
values (throughput, counters, the wall this callback measures) go straight
in. The health gauge reads the trainer through a weak reference, as the
engine's gauges do (``observability/programs.py weak_reader``): a trainer
that holds this callback is freed as soon as its last reference goes, with
no wait for the cyclic collector, and a registry kept past it reads -1
there."""

from __future__ import annotations

import time
from typing import Optional

from neuronx_distributed_tpu_torch.observability.programs import weak_reader
from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry

__all__ = ["MetricsCallback"]

# metrics-dict keys holding host numbers; every other key is gauged raw
_HOST_KEYS = (
    "throughput_seq_s",
    "dispatch_retries",
    "emergency_checkpoints",
    "callback_errors",
)


class MetricsCallback:
    """Trainer callback exporting the per-step metrics dict into a
    ``MetricsRegistry`` (duck-typed against ``trainer.loop.Callback``, so
    the observability package never imports the trainer)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None, prefix: str = "train"):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.prefix = prefix
        self._t_last: Optional[float] = None
        p = prefix
        self._h_step = self.registry.histogram(f"{p}_step_time_s",
                                               help="wall time between step completions (s)")
        self._c_steps = self.registry.counter(f"{p}_steps", help="train steps completed")
        self._g_tokens = self.registry.gauge(f"{p}_tokens_seen",
                                             help="cumulative tokens trained on")
        self._g_skips = self.registry.gauge(f"{p}_anomaly_skips",
                                            help="device-skipped anomalous steps")

    def on_train_start(self, trainer) -> None:
        self._t_last = time.perf_counter()
        self.registry.gauge(f"{self.prefix}_health", help="0=ok 1=degraded 2=halted").set_fn(
            weak_reader(trainer, lambda t: {"ok": 0, "degraded": 1, "halted": 2}.get(
                t.health().value, -1), default=-1))

    def on_step_end(self, trainer, metrics: dict) -> None:
        now = time.perf_counter()
        if self._t_last is not None:
            self._h_step.observe(now - self._t_last)
        self._t_last = now
        self._c_steps.inc()
        self._g_tokens.set(trainer.tokens_seen)
        self._g_skips.set(trainer.anomaly_skips)
        p = self.prefix
        for key, value in metrics.items():
            if key in _HOST_KEYS:
                self.registry.gauge(f"{p}_{key}").set(float(value))
            else:
                # possibly a device scalar: stored raw, read at export
                self.registry.gauge(f"{p}_{key}").set(value)

    def on_train_end(self, trainer) -> None:
        self.registry.gauge(f"{self.prefix}_train_seconds",
                            help="cumulative fit() wall time (s)").set(trainer.train_seconds)
