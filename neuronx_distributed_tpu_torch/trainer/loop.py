"""The training loop with callbacks and fault tolerance (counterpart of
``neuronx_distributed_tpu/trainer/loop.py``: ``TrainerHealth``,
``TrainerHalted``, ``Callback``, ``ThroughputMeter``, ``MetricsLogger``,
``ProgressBar``, ``HooksCallback``, ``CheckpointCallback`` and ``Trainer``).

One ``Trainer`` over the in-place train step of ``trainer/trainer.py``,
with JAX's fault-tolerance contract:

* **Anomaly guard** — the step decides ``good_step`` on the device and
  skips a bad update bit for bit. The host budgets the skips against
  ``AnomalyGuardConfig.budget`` one step late: at the end of step N the
  guard's flag pair (and, at a sentinel check, the two fingerprints) is
  copied ``non_blocking`` into a pinned buffer with an event, and the loop
  waits on that event only after step N+1's launches are issued, so the
  read overlaps the card's work. That is the loop's ONE host read a step
  (:meth:`Trainer._host_read` counts them, ``host_reads``); with the guard
  and the sentinel off it reads nothing. Over the budget it HALTS with an
  emergency checkpoint.
* **Dispatch recovery** — a failed dispatch retries with the shared
  decrementing-jitter :class:`~neuronx_distributed_tpu_torch.utils.retry.
  RetryPolicy`. There are no donated buffers: a failure raised before the
  step's first in-place write (``TrainState.updating`` still False) leaves
  the state as it was, and the retry runs on it; one raised after it tore
  the state (JAX's consumed buffers), and the run halts for cause with no
  checkpoint. ``max_attempts`` consecutive failures halt with an emergency
  checkpoint of the intact state. A CUDA runtime error or a kernel error is
  sticky and raises at once.
* **Exact resume** — checkpoints carry the seed (the port's counterpart of
  JAX's base key: :meth:`Trainer.step_rng` is counter-based on (seed,
  step), and a MoE step's jitter and shuffle draw from it), the data
  cursor, the guard carry and the step and throughput bookkeeping, so
  ``fit(resume_from=...)`` after a kill reproduces the uninterrupted run
  bit for bit.
* **Graceful preemption** — SIGTERM/SIGINT finish the step in flight,
  write ``step_N`` through the done-marker protocol and return
  (``preempted``); a second signal falls through to the original handler.
* **Silent corruption** — ``integrity=SentinelConfig(...)`` runs the canary
  (``integrity/sentinel.py``) at every check step: the same step twice, TF
  over the state after each; a disagreement rolls the run back to the last
  verified state and re-trains (bit-identical by determinism).
* **Callback isolation** — a raising callback is logged, counted
  (``callback_errors``) and survived; ``on_train_end`` reaches every one.
* **Health** — ``OK/DEGRADED/HALTED`` (DEGRADED within
  ``degraded_cooldown_steps`` of a fault).

Every fault path is drivable through :class:`~neuronx_distributed_tpu_torch.
trainer.faults.FaultInjector`. ``pipeline=``, ZeRO-1 and the sentinel's dp
vote are multi-GPU work (ROADMAP item 9) and raise ``NotImplementedError``."""

from __future__ import annotations

import dataclasses
import enum
import logging
import os
import signal as _signal
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, List, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.kernels._build import KernelError
from neuronx_distributed_tpu_torch.trainer.checkpoint import (
    DONE_MARKER,
    create_checkpoint_storage,
    finalize_checkpoints,
    latest_checkpoint_tag,
    load_checkpoint,
    save_checkpoint,
)
from neuronx_distributed_tpu_torch.trainer.trainer import (
    AnomalyGuardConfig,
    OptimizerConfig,
    _takes_generator,
    _to_device,
    build_train_step,
    create_train_state,
    default_loss_fn,
    init_anomaly_guard_state,
    make_optimizer,
    step_generator,
    step_seed,
)
from neuronx_distributed_tpu_torch.utils.retry import RetryPolicy
from neuronx_distributed_tpu_torch.utils.timeline import Timeline

logger = logging.getLogger(__name__)

__all__ = ["Callback", "CheckpointCallback", "HooksCallback", "MetricsLogger", "ProgressBar",
           "ThroughputMeter", "Trainer", "TrainerHalted", "TrainerHealth", "step_seed"]

# sticky device errors: never retried (ROADMAP §3, as the serving engine)
_FATAL = (torch.AcceleratorError, KernelError)
class TrainerHealth(enum.Enum):
    """``Trainer.health()``: ``OK``; ``DEGRADED`` (an anomaly skip, dispatch
    retry, callback error or corruption within ``degraded_cooldown_steps``);
    ``HALTED`` (a budget exhausted; ``halt_reason`` says which)."""

    OK = "ok"
    DEGRADED = "degraded"
    HALTED = "halted"


class TrainerHalted(RuntimeError):
    """Raised by ``fit`` when the run halts; ``emergency_tag`` names the
    emergency checkpoint written first (None when none was written)."""

    def __init__(self, reason: str, emergency_tag: Optional[str] = None):
        super().__init__(reason)
        self.reason = reason
        self.emergency_tag = emergency_tag


class Callback:
    """Hook points."""

    def on_train_start(self, trainer: "Trainer") -> None: ...

    def on_step_end(self, trainer: "Trainer", metrics: dict) -> None: ...

    def on_train_end(self, trainer: "Trainer") -> None: ...


class ThroughputMeter:
    """Moving-average sequences/s over the last ``window`` steps."""

    def __init__(self, batch_size: int, window: int = 10):
        self.batch_size = batch_size
        self.window = window
        self._times: deque = deque(maxlen=window + 1)
        self.throughput = 0.0

    def update(self) -> float:
        self._times.append(time.perf_counter())
        if len(self._times) >= 2:
            dt = self._times[-1] - self._times[0]
            self.throughput = self.batch_size * (len(self._times) - 1) / max(dt, 1e-9)
        return self.throughput


class MetricsLogger(Callback):
    """Step-gated metric logging, optionally into TensorBoard (optional:
    without it, file logging only). Each logged step reads its metrics."""

    def __init__(self, log_every: int = 10, tensorboard_dir: Optional[str] = None):
        self.log_every = log_every
        self._tb = None
        if tensorboard_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception as e:  # tensorboard is optional
                logger.warning("tensorboard unavailable (%s); file logging only", e)

    def on_step_end(self, trainer, metrics):
        if trainer.step % self.log_every != 0:
            return
        scalars = {k: float(v) for k, v in metrics.items()}
        logger.info("step %d: %s", trainer.step,
                    " ".join(f"{k}={v:.4f}" for k, v in scalars.items()))
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, trainer.step)

    def on_train_end(self, trainer):
        if self._tb is not None:
            self._tb.flush()


class ProgressBar(Callback):
    """A tqdm bar when tqdm is installed; otherwise nothing."""

    def __init__(self, total_steps: Optional[int] = None):
        self.total_steps = total_steps
        self._bar = None

    def on_train_start(self, trainer):
        try:
            from tqdm import tqdm

            self._bar = tqdm(total=self.total_steps, desc="train", unit="step")
        except Exception:
            self._bar = None

    def on_step_end(self, trainer, metrics):
        if self._bar is not None:
            self._bar.update(1)
            self._bar.set_postfix({k: f"{float(v):.4f}" for k, v in metrics.items()
                                   if k == "loss"})

    def on_train_end(self, trainer):
        if self._bar is not None:
            self._bar.close()


class HooksCallback(Callback):
    """The trainable parameters' global norm every ``every`` steps, handed
    to ``sink`` (default: the logger) as ``{"params": norm}`` (JAX's one
    top-level group)."""

    def __init__(self, every: int = 50, sink: Optional[Callable] = None):
        self.every = every
        self.sink = sink or (lambda d: logger.info("param norms: %s", d))

    def on_step_end(self, trainer, metrics):
        if trainer.step % self.every != 0:
            return
        leaves = [p.detach() for p in trainer.state.params.parameters() if p.requires_grad]
        if leaves:
            norm = torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in leaves))
            self.sink({"params": float(norm)})


class CheckpointCallback(Callback):
    """Periodic checkpoints with retention. ``save_on_end`` writes a final
    ``step_N`` from ``on_train_end`` unless that tag already committed (a
    periodic or preemption save) or the run halted. Every save carries the
    trainer's exact-resume ``user_content``."""

    def __init__(self, checkpoint_dir: str, every: int = 100, num_kept: Optional[int] = 3,
                 async_save: bool = True, save_on_end: bool = True):
        self.checkpoint_dir = checkpoint_dir
        self.every = every
        self.num_kept = num_kept
        self.async_save = async_save
        self.save_on_end = save_on_end

    def _save(self, trainer, async_save: bool) -> None:
        trainer.save_tagged_checkpoint(self.checkpoint_dir, f"step_{trainer.step}",
                                       num_kept=self.num_kept, async_save=async_save)

    def on_step_end(self, trainer, metrics):
        if trainer.step % self.every == 0:
            self._save(trainer, self.async_save)

    def on_train_end(self, trainer):
        # drain the async saves FIRST: a pending step_N commit wins over the
        # save_on_end rewrite of the same tag
        finalize_checkpoints()
        if not self.save_on_end or trainer.step == 0 or trainer.halt_reason is not None:
            return
        storage = create_checkpoint_storage(self.checkpoint_dir)
        if storage.file_exists(os.path.join(f"step_{trainer.step}", DONE_MARKER)):
            return
        self._save(trainer, async_save=False)
        finalize_checkpoints()


@dataclasses.dataclass
class _PendingRead:
    """A step's values on their way to the host: ``host`` (pinned on the
    card) filled by a ``non_blocking`` copy that ``event`` fences."""

    host: torch.Tensor
    event: Any
    guard_step: Optional[int]
    n_fp: int


def _microbatch(batch: dict, n: int) -> dict:
    """(B, ...) -> (n, B/n, ...) on every leaf (JAX ``microbatch``)."""
    out = {}
    for k, a in batch.items():
        if a.shape[0] % n != 0:
            raise ValueError(f"batch dim {a.shape[0]} not divisible by {n} microbatches")
        out[k] = a.reshape((n, a.shape[0] // n) + tuple(a.shape[1:]))
    return out


@dataclasses.dataclass
class Trainer:
    """The training loop over ``model`` (a ``LlamaForCausalLM`` or a
    ``MixtralForCausalLM`` built with ``trainable=True`` on its device),
    with the fault-tolerance layer of the module docstring. A Mixtral
    trains on ``loss_fn=lambda b, generator: model.loss(...)``: the step
    hands it :meth:`step_rng`'s generator (``build_train_step``)."""

    model: Any
    optimizer_config: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    callbacks: List[Callback] = dataclasses.field(default_factory=list)
    # loss_fn(batch) -> loss (build_train_step's); default_loss_fn on the model
    loss_fn: Optional[Callable] = None
    timeline: Optional[Timeline] = None
    # pipeline parallelism is multi-GPU work (ROADMAP item 9): must stay None
    pipeline: Optional[Any] = None
    # torch.profiler trace directory: profiles steps [2, 5) of fit()
    profile_dir: Optional[str] = None

    # --- fault tolerance ---------------------------------------------------------
    anomaly_guard: Optional[AnomalyGuardConfig] = dataclasses.field(
        default_factory=AnomalyGuardConfig)
    dispatch_retry: Optional[RetryPolicy] = None
    fault_injector: Optional[Any] = None
    # where emergency and preemption checkpoints go; else the first
    # CheckpointCallback's directory
    emergency_dir: Optional[str] = None
    degraded_cooldown_steps: int = 20
    # None: fit() builds one whose post-mortems land beside the checkpoints
    flight_recorder: Optional[Any] = None
    # None: fit() builds one (on a MetricsCallback's registry when attached)
    program_ledger: Optional[Any] = None
    handle_signals: bool = True
    # integrity.sentinel.SentinelConfig; None = off
    integrity: Optional[Any] = None

    step: int = 0
    state: Any = None
    steps_run: int = 0  # steps the last fit() ran (resumed ones excluded)
    # anomaly_skips mirrors the checkpoint-carried device counter the budget
    # reads; the others accumulate over the Trainer's life
    anomaly_skips: int = 0
    dispatch_retries: int = 0
    emergency_checkpoints: int = 0
    callback_errors: int = 0
    checkpoint_integrity_failures: int = 0
    tokens_seen: int = 0
    train_seconds: float = 0.0
    halt_reason: Optional[str] = None
    preempted: bool = False
    # device-to-host reads of the last fit() (the deferred per-step reads)
    host_reads: int = 0

    # --- warm start --------------------------------------------------------------

    def manifest(self):
        """The :class:`~neuronx_distributed_tpu_torch.inference.aot.
        ProgramManifest` of this trainer's programs (after a fit): its
        kernel libraries are what :meth:`prewarm` loads."""
        if getattr(self, "programs", None) is None:
            raise RuntimeError("manifest() needs a fitted Trainer")
        return self.programs.manifest()

    def prewarm(self, manifest=None, cache_dir: Optional[str] = None) -> dict:
        """Load the manifest's kernel libraries from ``cache_dir`` (built
        when absent; ``SkewError`` when built from other sources) so the
        first step builds nothing. The programs themselves are not replayed:
        a train step writes the state in place, and no prewarm may change
        the state or the data cursor (JAX's replay only traces). Returns
        ``{"deferred": False, "replayed": [], "skipped": {...},
        "kernels_cached": [...]}``."""
        from neuronx_distributed_tpu_torch.inference import aot

        if manifest is None and cache_dir is not None and os.path.exists(
                os.path.join(cache_dir, aot.MANIFEST_NAME)):
            manifest = aot.ProgramManifest.load(cache_dir)
        elif isinstance(manifest, (str, os.PathLike)):
            manifest = aot.ProgramManifest.load(os.fspath(manifest))
        if manifest is None:
            return {"deferred": False, "replayed": [], "skipped": {}, "kernels_cached": []}
        cached = aot.load_kernels(cache_dir, manifest.meta.get("kernels", {}))
        why = "a train program writes the state in place: the prewarm loads its kernels only"
        return {"deferred": False, "replayed": [],
                "skipped": {name: why for name in manifest.names()}, "kernels_cached": cached}

    # --- health ---------------------------------------------------------------------

    def health(self) -> TrainerHealth:
        if self.halt_reason is not None:
            return TrainerHealth.HALTED
        last = getattr(self, "_last_fault_step", None)
        if last is not None and self.step - last < self.degraded_cooldown_steps:
            return TrainerHealth.DEGRADED
        return TrainerHealth.OK

    # --- the exact-resume payload ------------------------------------------------------

    def step_rng(self) -> torch.Generator:
        """This step's generator on the model's device, seeded
        :func:`step_seed` (seed, step): the one the train step hands a
        ``loss_fn`` that takes a ``generator`` (``build_train_step``). The
        checkpoint carries the seed, so a resumed run's step generators
        equal the uninterrupted run's."""
        return step_generator(self._seed, self.step, self._device)

    def checkpoint_user_content(self, extra: Optional[dict] = None) -> dict:
        """What every checkpoint carries besides the tensors: the step, the
        seed, the data cursor, the guard carry and the bookkeeping. Reads the
        guard carry from the device (once a save)."""
        uc = {
            "step": int(self.step),
            "tokens_seen": int(self.tokens_seen),
            "train_seconds": float(self.train_seconds + (
                time.perf_counter() - getattr(self, "_fit_t0", time.perf_counter()))),
            "anomaly_skips": int(self.anomaly_skips),
            "dispatch_retries": int(self.dispatch_retries),
        }
        if getattr(self, "_seed", None) is not None:
            uc["seed"] = int(self._seed)
        src = getattr(self, "_data_source", None)
        if src is not None:
            # mid-step (a failed dispatch) or with the probe batch still
            # untrained, the live cursor is one ahead of the truth
            if getattr(self, "_mid_step", False) or getattr(self, "_pending_untrained", False):
                uc["data_state"] = self._data_state_prepull
            else:
                uc["data_state"] = src.state()
        guard = getattr(self.state, "guard", None) if self.state is not None else None
        if guard is not None:
            uc["guard"] = {"gnorm_ema": float(guard["gnorm_ema"]),
                           "good_steps": int(guard["good_steps"]),
                           "skips": int(guard["skips"])}
        if extra:
            uc.update(extra)
        return uc

    def save_tagged_checkpoint(self, checkpoint_dir: str, tag: str, *,
                               extra: Optional[dict] = None, num_kept: Optional[int] = None,
                               async_save: bool = False) -> None:
        """The one save path of every tagged checkpoint (periodic,
        preemption, emergency): the model's state dict and the optimizer
        state, the full exact-resume ``user_content``, then the post-save
        hooks."""
        save_checkpoint(checkpoint_dir, tag=tag,
                        items={"model": self.state.params, "optimizer": self.state.opt_state},
                        user_content=self.checkpoint_user_content(extra),
                        num_kept_ckpts=num_kept, async_save=async_save)
        inj = self.fault_injector
        if async_save and inj is not None and (
                getattr(inj, "pending_corruption", lambda _: False)(tag)
                or getattr(inj, "pending_shard_flip", lambda: False)()):
            # a scheduled corruption must hit a COMMITTED save
            finalize_checkpoints()
        self.notify_checkpoint_saved(checkpoint_dir, tag)

    def notify_checkpoint_saved(self, checkpoint_dir: str, tag: str) -> None:
        tl = getattr(self, "_tl", None)
        if tl is not None:
            tl.instant("checkpoint", "trainer", args={"tag": tag})
        self._flight_record("checkpoint", tag=tag, step=self.step)
        if self.fault_injector is not None:
            self.fault_injector.on_checkpoint_saved(checkpoint_dir, tag)

    def _checkpoint_dir(self) -> Optional[str]:
        if self.emergency_dir is not None:
            return self.emergency_dir
        for cb in self.callbacks:
            d = getattr(cb, "checkpoint_dir", None)
            if d is not None:
                return d
        return None

    # --- fault machinery ------------------------------------------------------------------

    def _flight_record(self, kind: str, **fields) -> None:
        fl = getattr(self, "_flight", None)
        if fl is not None:
            fl.record(kind, **fields)

    def _save_emergency_checkpoint(self, reason: str) -> Optional[str]:
        d = self._checkpoint_dir()
        if d is None:
            logger.warning("halting without an emergency checkpoint — no checkpoint directory "
                           "known (set Trainer.emergency_dir)")
            return None
        tag = f"emergency_step_{self.step}"
        self.save_tagged_checkpoint(d, tag, extra={"emergency": reason})
        self.emergency_checkpoints += 1
        self._tl.instant("emergency_checkpoint", "trainer", args={"tag": tag})
        self._flight_record("emergency_checkpoint", tag=tag, dir=d)
        logger.warning("emergency checkpoint '%s' written to %s", tag, d)
        return tag

    def _halt(self, reason: str, save: bool = True) -> None:
        self.halt_reason = reason
        tag = self._save_emergency_checkpoint(reason) if save else None
        self._tl.instant("halted", "trainer", args={"reason": reason})
        fl = getattr(self, "_flight", None)
        if fl is not None:
            fl.record("halt", reason=reason, step=self.step, emergency_tag=tag)
            extra = {
                "step": self.step,
                "emergency_tag": tag,
                "anomaly_skips": self.anomaly_skips,
                "dispatch_retries": self.dispatch_retries,
                "callback_errors": self.callback_errors,
                "tokens_seen": self.tokens_seen,
                "checkpoint_integrity_failures": self.checkpoint_integrity_failures,
            }
            sentinel = getattr(self, "_sentinel", None)
            if sentinel is not None:
                extra["integrity"] = dict(sentinel.counters)
                extra["integrity"]["quarantined_devices"] = ",".join(
                    str(d) for d in sentinel.quarantined_devices)
            hbm = getattr(self, "hbm", None)
            if hbm is not None:
                extra["hbm"] = hbm.halt_summary()
            programs = getattr(self, "programs", None)
            if programs is not None:
                extra["programs"] = programs.halt_summary()
            fl.dump(reason, extra=extra)
        logger.error("training HALTED: %s", reason)
        raise TrainerHalted(reason, emergency_tag=tag)

    def _dispatch(self, train_step, prepared):
        """One dispatch with bounded recovery (JAX ``_dispatch``): a failure
        before the step's first in-place write retries on the intact state;
        one after it (``state.updating``) halts for cause; ``max_attempts``
        consecutive failures halt with an emergency checkpoint."""
        policy = self._dispatch_policy
        while True:
            attempt = self._dispatch_attempts
            self._dispatch_attempts += 1
            try:
                if self.fault_injector is not None:
                    self.fault_injector.on_dispatch(attempt)
                out = train_step(self.state, prepared)
                if self._consecutive_dispatch_failures:
                    self._tl.instant("recovery", "trainer",
                                     args={"after_failures": self._consecutive_dispatch_failures,
                                           "step": self.step})
                    self._flight_record("recovery", step=self.step,
                                        after_failures=self._consecutive_dispatch_failures)
                    self._consecutive_dispatch_failures = 0
                return out
            except KeyboardInterrupt:
                raise
            except (TypeError, ValueError, NotImplementedError):
                raise  # deterministic programming errors: a retry is noise
            except _FATAL:
                raise  # sticky: the context or the kernel is unusable
            except Exception as e:
                n = self._consecutive_dispatch_failures = self._consecutive_dispatch_failures + 1
                self.dispatch_retries += 1
                self._last_fault_step = self.step
                self._tl.instant("dispatch_failure", "trainer",
                                 args={"error": str(e)[:200], "consecutive": n,
                                       "step": self.step})
                self._flight_record("dispatch_failure", step=self.step, error=str(e),
                                    consecutive=n)
                logger.warning("train-step dispatch failed at step %d (%s: %s) — consecutive "
                               "failure %d/%d", self.step, type(e).__name__, e, n,
                               policy.max_attempts)
                if self.state.updating:
                    # the step had begun writing the state: nothing intact to
                    # retry on or to checkpoint
                    self._halt(f"dispatch failed after the step began updating the state in "
                               f"place ({type(e).__name__}: {e}) — resume from the last "
                               "checkpoint", save=False)
                if n >= policy.max_attempts:
                    self._halt(f"{n} consecutive dispatch failures "
                               f"(last: {type(e).__name__}: {e})")
                time.sleep(policy.wait(n - 1))

    def _stage_read(self, guard_step: Optional[int], good, skips, fps) -> None:
        """Queue this step's values for the next :meth:`_account_guard`:
        one int64 vector, copied ``non_blocking`` into pinned memory behind
        an event on the card."""
        vals = ([good, skips] if guard_step is not None else []) + list(fps or ())
        if not vals:
            return
        dev = self._device
        packed = torch.stack([v.reshape(()).to(torch.int64) for v in vals])
        event = None
        if dev.type == "cuda":
            host = torch.empty(packed.shape, dtype=torch.int64, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = packed
        self._pending = _PendingRead(host, event, guard_step, len(fps or ()))

    def _host_read(self, pending: _PendingRead) -> List[int]:
        """THE device-to-host read of the loop: wait for the copy's event
        and take the host values. ``host_reads`` counts them."""
        self.host_reads += 1
        if pending.event is not None:
            pending.event.synchronize()
        return pending.host.tolist()

    def _account_guard(self) -> None:
        """Budget the previous step's guard flags (and judge its sentinel
        check) from its staged values, read only now that the next step is
        issued."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        try:
            vals = self._host_read(pending)
        except (KeyboardInterrupt, TrainerHalted):
            raise
        except Exception as e:
            # a device-side failure of the step surfaces at its read: the
            # state it wrote is poisoned, so nothing to retry or save
            self._halt(f"train-step execution failed (surfaced at the deferred guard readback): "
                       f"{type(e).__name__}: {e} — resume from the last checkpoint", save=False)
        n_guard = 0 if pending.guard_step is None else 2
        if pending.guard_step is not None:
            at_step, good, skips = pending.guard_step, bool(vals[0]), int(vals[1])
            if not good:
                self._last_fault_step = self.step
                self._tl.instant("anomaly_skip", "trainer", args={"step": at_step, "skips": skips})
                self._flight_record("anomaly_skip", step=at_step, skips=skips)
                logger.warning("anomalous step %d skipped on device (%d skips total)", at_step,
                               skips)
            self.anomaly_skips = skips
            budget = self.anomaly_guard.budget if self.anomaly_guard else None
            if budget is not None and skips > budget:
                self._halt(f"anomaly budget exceeded: {skips} skipped steps > budget {budget}")
        if pending.n_fp:
            verdict = self._sentinel.judge(vals[n_guard:])
            if verdict is not None and verdict.detected:
                self._handle_sdc(verdict)

    def _handle_sdc(self, verdict) -> None:
        """A check failed: roll back to the last verified (state, step, data
        cursor, tokens) and keep looping (the discarded steps re-train
        bit-identically). No rollback point: halt for cause."""
        s = self._sentinel
        self._last_fault_step = self.step
        convicted = ",".join(str(d) for d in verdict.convicted_devices)
        self._tl.instant("sdc_detected", "trainer",
                         args={"step": verdict.step, "mode": verdict.mode,
                               "localized": verdict.localized, "devices": convicted})
        self._flight_record("sdc_detected", step=verdict.step, mode=verdict.mode,
                            localized=verdict.localized, devices=convicted)
        for d in verdict.convicted_devices:
            self._flight_record("device_quarantined", device=int(d), step=verdict.step)
        logger.error("silent data corruption detected at step %d (%s vote%s) — convicted "
                     "device(s): %s", verdict.step, verdict.mode,
                     "" if verdict.localized else ", UNLOCALIZED", convicted or "<none>")
        if not s.can_rollback() or self._data_source is None:
            self._halt(f"silent data corruption detected at step {verdict.step} "
                       f"({verdict.mode} check) with no in-memory rollback point — resume from "
                       "the last verified checkpoint")
        rb = s.rollback()
        self.step = self.state.step = rb["step"]
        self.tokens_seen = rb["tokens_seen"]
        if rb["data_state"] is not None:
            self._data_source.restore(rb["data_state"])
            self._data_state_prepull = rb["data_state"]
        self._drop_pending_guard = True  # this step's flags describe a discarded state
        self._flight_record("sdc_rollback", to_step=self.step, detected_at=verdict.step)
        self._tl.instant("sdc_rollback", "trainer",
                         args={"to_step": self.step, "detected_at": verdict.step})
        logger.warning("rolled back to verified step %d — re-training the discarded window "
                       "(bit-identical by determinism)", self.step)

    def _on_checkpoint_corrupt(self, tag: str, detail: str) -> None:
        """``load_checkpoint``'s hook: a tag failed verification."""
        self.checkpoint_integrity_failures += 1
        self._last_fault_step = self.step
        self._tl.instant("checkpoint_integrity_failure", "trainer",
                         args={"tag": tag, "detail": str(detail)[:200]})
        self._flight_record("checkpoint_integrity_failure", tag=tag, detail=str(detail))
        logger.error("checkpoint '%s' failed integrity verification (%s) — falling back to the "
                     "previous completed tag", tag, detail)

    # --- signals ------------------------------------------------------------------------

    def _install_signal_handlers(self) -> dict:
        self._preempt_signum = None
        if not self.handle_signals or threading.current_thread() is not threading.main_thread():
            return {}
        orig = {}

        def handler(signum, frame):
            if self._preempt_signum is None:
                self._preempt_signum = signum
                logger.warning("signal %d received — finishing the in-flight step, "
                               "checkpointing, then exiting cleanly (send again to force)", signum)
            else:  # a second signal falls through to the original behaviour
                prev = orig.get(signum)
                _signal.signal(signum, _signal.SIG_DFL if prev is None else prev)
                os.kill(os.getpid(), signum)

        for sig in (_signal.SIGTERM, _signal.SIGINT):
            try:
                orig[sig] = _signal.signal(sig, handler)
            except (ValueError, OSError):
                pass
        return orig

    def _restore_signal_handlers(self, orig: dict) -> None:
        for sig, h in orig.items():
            if h is None:
                continue  # installed by non-Python code: nothing to restore it to
            try:
                _signal.signal(sig, h)
            except (ValueError, OSError, TypeError):
                pass

    def _graceful_preempt(self) -> None:
        """The step in flight finished: write ``step_N`` through the
        done-marker protocol and leave the loop."""
        self.preempted = True
        d = self._checkpoint_dir()
        tag = f"step_{self.step}"
        if d is not None:
            finalize_checkpoints()  # a pending async save of this tag wins
            if not create_checkpoint_storage(d).file_exists(os.path.join(tag, DONE_MARKER)):
                self.save_tagged_checkpoint(d, tag,
                                            extra={"preempted": int(self._preempt_signum or 0)})
        self._tl.instant("preempted", "trainer",
                         args={"signal": int(self._preempt_signum or 0), "step": self.step})
        self._flight_record("preempted", step=self.step, signal=int(self._preempt_signum or 0))
        logger.warning("preempted by signal %s at step %d — checkpoint %s; exiting cleanly",
                       self._preempt_signum, self.step,
                       tag if d is not None else "SKIPPED (no checkpoint dir)")

    # --- callbacks -------------------------------------------------------------------------

    def _safe_callback(self, cb, method: str, *args) -> None:
        """A raising callback is logged, counted and survived (a fault for
        ``health()``)."""
        try:
            getattr(cb, method)(*args)
        except (KeyboardInterrupt, TrainerHalted):
            raise
        except Exception as e:
            self.callback_errors += 1
            self._last_fault_step = self.step
            self._tl.instant("callback_error", "trainer",
                             args={"callback": type(cb).__name__, "hook": method,
                                   "error": str(e)[:200]})
            self._flight_record("callback_error", callback=type(cb).__name__, hook=method,
                                error=str(e))
            logger.exception("callback %s.%s raised (%s: %s) — training continues",
                             type(cb).__name__, method, type(e).__name__, e)

    # --- state ------------------------------------------------------------------------------

    def _state_leaves(self) -> List[torch.Tensor]:
        """The train state's tensors in a fixed order: the trainable
        parameters, ``mu``, ``nu``, the count, the guard carry."""
        st = self.state
        out = [p for p in st.params.parameters() if p.requires_grad]
        out += list(st.opt_state["mu"]) + list(st.opt_state["nu"]) + [st.opt_state["count"]]
        if st.guard is not None:
            out += [st.guard[k] for k in ("gnorm_ema", "good_steps", "skips")]
        return out

    def _build_observability(self, device: torch.device) -> None:
        from neuronx_distributed_tpu_torch.observability.callback import MetricsCallback
        from neuronx_distributed_tpu_torch.observability.flight_recorder import FlightRecorder
        from neuronx_distributed_tpu_torch.observability.hbm import HBMLedger, tree_nbytes
        from neuronx_distributed_tpu_torch.observability.programs import (
            ProgramLedger,
            weak_reader,
        )

        self._flight = self.flight_recorder if self.flight_recorder is not None else \
            FlightRecorder(dump_dir=self._checkpoint_dir(), subsystem="trainer")
        if self.program_ledger is None:
            reg = next((cb.registry for cb in self.callbacks if isinstance(cb, MetricsCallback)),
                       None)
            self.program_ledger = ProgramLedger(registry=reg, prefix="train",
                                                subsystem="trainer", timeline=self._tl,
                                                device=device)
        self.programs = self.program_ledger
        self.hbm = HBMLedger(device=device, view=self.programs.view)

        def res(fn):
            return weak_reader(self, fn)

        self.hbm.add_resident("params", res(lambda t: tree_nbytes(
            [p for p in t.state.params.parameters() if p.requires_grad])))
        self.hbm.add_resident("opt_state", res(lambda t: tree_nbytes(t.state.opt_state)))
        self.hbm.add_resident("anomaly_guard", res(lambda t: tree_nbytes(t.state.guard)))

    def _build_sentinel(self) -> None:
        from neuronx_distributed_tpu_torch.integrity.sentinel import TrainerSentinel, _copy
        from neuronx_distributed_tpu_torch.kernels.tree_fingerprint import TreeFingerprint
        from neuronx_distributed_tpu_torch.observability.hbm import tree_nbytes
        from neuronx_distributed_tpu_torch.observability.programs import weak_reader

        leaves = self._state_leaves()
        self._sentinel = TrainerSentinel(
            self.integrity, leaves=leaves,
            fingerprint_fn=self.programs.wrap("integrity_fingerprint", TreeFingerprint(leaves),
                                              meter_first=True),
            copy_fn=self.programs.wrap("integrity_copy", _copy, meter_first=True))
        self.hbm.add_resident("integrity_snapshots", weak_reader(self, lambda t: sum(
            tree_nbytes(b) for b in t._sentinel.snapshot_states())))

    def _resume(self, resume_from: str, device: torch.device):
        """Restore the newest verified tag of ``resume_from`` in place.
        Returns the tag, or None when the directory holds no completed one."""
        tag = latest_checkpoint_tag(resume_from)
        if tag is None:
            return None
        _, uc, tag = load_checkpoint(
            resume_from, tag=tag,
            items_target={"model": self.state.params, "optimizer": self.state.opt_state},
            on_corrupt=self._on_checkpoint_corrupt)
        uc = uc or {}
        self.step = self.state.step = int(uc.get("step", 0))
        if uc.get("seed") is not None:
            self._seed = int(uc["seed"])
        self.tokens_seen = int(uc.get("tokens_seen", self.tokens_seen))
        self.train_seconds = float(uc.get("train_seconds", self.train_seconds))
        gc = uc.get("guard")
        if gc is not None and self.state.guard is not None:
            # in place: the restored carry keeps the step's and TF's addresses
            fresh = init_anomaly_guard_state(gc, device=device)
            with torch.no_grad():
                for k, t in fresh.items():
                    self.state.guard[k].copy_(t)
            self.anomaly_skips = int(gc["skips"])
        self.dispatch_retries = int(uc.get("dispatch_retries", self.dispatch_retries))
        ds = uc.get("data_state")
        if ds is not None and self._data_source is not None:
            self._data_source.restore(ds)
            self._data_state_prepull = ds
        logger.info("resumed from '%s' at step %d", tag, self.step)
        return tag, ds is not None and self._data_source is not None

    # --- the loop -----------------------------------------------------------------------------

    def fit(self, data_iter: Iterable[dict], seed: int, max_steps: int,
            sample_batch: Optional[dict] = None, resume_from: Optional[str] = None) -> dict:
        """Run ``max_steps`` over ``data_iter`` (host batches with at least
        ``input_ids``/``labels``) from parameters initialised from ``seed``
        (the JAX ``rng_key``), or from the newest verified checkpoint of
        ``resume_from``. Returns the last step's metrics (device scalars).
        Raises :class:`TrainerHalted` when a budget is exhausted (after the
        emergency checkpoint and every callback's ``on_train_end``)."""
        if self.pipeline is not None:
            raise NotImplementedError("pipeline parallelism spans several GPUs (ROADMAP item 9)")
        self._data_source = (data_iter if hasattr(data_iter, "state")
                             and hasattr(data_iter, "restore") else None)
        self._mid_step = False
        self._data_state_prepull = self._data_source.state() if self._data_source else None
        data_iter = iter(data_iter)
        self.steps_run = 0
        self.host_reads = 0
        self._eval_step = None
        self.halt_reason = None
        self.preempted = False
        self._seed = int(seed)
        self._dispatch_attempts = 0
        self._consecutive_dispatch_failures = 0
        self._last_fault_step = None
        self._pending: Optional[_PendingRead] = None
        self._drop_pending_guard = False
        self._sentinel = None
        self._dispatch_policy = self.dispatch_retry or RetryPolicy(
            max_attempts=3, first_wait=0.05, min_wait=0.01)
        self._tl = tl = self.timeline or Timeline(None)
        device = self._device = next(self.model.parameters()).device
        self._build_observability(device)
        inj = self.fault_injector
        first = sample_batch if sample_batch is not None else next(data_iter)
        cfg = self.optimizer_config
        optimizer = make_optimizer(cfg)
        guard_cfg = self.anomaly_guard
        self.state = create_train_state(self.model, optimizer, seed=self._seed)
        if guard_cfg is not None:
            self.state.guard = init_anomaly_guard_state(device=device)
        accum = cfg.grad_accum_steps
        if self.integrity is not None:
            self._build_sentinel()
        pending = first if sample_batch is None else None
        # the probe pull advanced the cursor past a batch nothing trained on
        self._pending_untrained = pending is not None
        if resume_from is not None:
            resumed = self._resume(resume_from, device)
            if resumed is not None and resumed[1]:
                # the probe batch came from the pre-restore cursor: drop it
                pending = None
                self._pending_untrained = False
        # after the resume: the step generators' seed is the checkpoint's
        step_fn = build_train_step(self.model, optimizer, max_grad_norm=cfg.max_grad_norm,
                                   loss_fn=self.loss_fn, grad_accum_steps=accum,
                                   anomaly_guard=guard_cfg, seed=self._seed)

        def prepare(batch):
            batch = _to_device(batch, device)
            return _microbatch(batch, accum) if accum > 1 else batch

        self._prepare = prepare
        # the first dispatch runs under the cost meter: no request waits here
        train_step = self._train_step = self.programs.wrap("train_step", step_fn,
                                                           meter_first=True)
        if self._sentinel is not None:
            self._sentinel.set_baseline(self.step, self._data_state_prepull
                                        if self._data_source is not None else None,
                                        self.tokens_seen)
        meter = ThroughputMeter(batch_size=int(np.shape(first["input_ids"])[0]))
        batch_tokens = int(np.prod(np.shape(first["input_ids"])))
        for cb in self.callbacks:
            self._safe_callback(cb, "on_train_start", self)
        metrics: dict = {}
        window = None
        self._fit_t0 = self._step_wall_t0 = time.perf_counter()
        orig_handlers = self._install_signal_handlers()
        halted: Optional[TrainerHalted] = None
        error: Optional[BaseException] = None
        try:
            while True:
                while self.step < max_steps:
                    if inj is not None:
                        inj.on_step_start(self.step)
                    if self._preempt_signum is not None:
                        self._graceful_preempt()
                        break
                    if pending is not None:
                        batch, pending = pending, None
                        self._pending_untrained = False
                    else:
                        if self._data_source is not None:
                            self._data_state_prepull = self._data_source.state()
                        batch = next(data_iter)
                    # from here until the dispatch lands an exit must save the
                    # PRE-pull cursor, or a resume would skip this batch
                    self._mid_step = True
                    if inj is not None:
                        batch = inj.corrupt_batch(self.step, batch)
                    if self.profile_dir is not None:
                        window = self._profile(window)
                    prepared = prepare(batch)
                    if self._sentinel is not None and self._sentinel.wants_pre_copy(self.step):
                        self._sentinel.pre_dispatch(prepared)
                    with tl.event("train_step"):
                        self.state, metrics = self._dispatch(train_step, prepared)
                    if inj is not None and hasattr(inj, "on_state"):
                        # a scheduled flip lands on the live state before the check
                        self.state = inj.on_state(self.step, self.state)
                    self._mid_step = False
                    self.step += 1
                    self.steps_run += 1
                    self.tokens_seen += batch_tokens
                    now_wall = time.perf_counter()
                    if self.steps_run > 1 and not train_step.last_call_compiled:
                        self.programs.observe_wall("train_step", now_wall - self._step_wall_t0)
                    self._step_wall_t0 = now_wall
                    # the PREVIOUS step's values, now that this one is issued
                    self._account_guard()
                    metrics = dict(metrics)
                    metrics["throughput_seq_s"] = meter.update()
                    metrics["dispatch_retries"] = self.dispatch_retries
                    metrics["emergency_checkpoints"] = self.emergency_checkpoints
                    metrics["callback_errors"] = self.callback_errors
                    # a rollback inside _account_guard discarded this step
                    sdc_rolled, self._drop_pending_guard = self._drop_pending_guard, False
                    fps = None
                    if (self._sentinel is not None and not sdc_rolled
                            and self._sentinel.is_check_step(self.step - 1)):
                        fps = self._sentinel.post_dispatch(
                            train_step, self.state, self.step,
                            self._data_source.state() if self._data_source is not None
                            else None, self.tokens_seen)
                    if not sdc_rolled:
                        guard_step = self.step - 1 if guard_cfg is not None else None
                        self._stage_read(guard_step, metrics.get("good_step"),
                                         metrics.get("anomaly_skips"), fps)
                    for cb in self.callbacks:
                        self._safe_callback(cb, "on_step_end", self, metrics)
                    if self._preempt_signum is not None:
                        self._graceful_preempt()
                        break
                # the last step's values; a rollback here lowers self.step and
                # the outer loop trains on
                self._account_guard()
                if self.preempted or self.step >= max_steps:
                    break
        except TrainerHalted as e:
            halted = e
        except KeyboardInterrupt:
            raise
        except BaseException as e:
            # any other failure still owes the callbacks their on_train_end
            error = e
        finally:
            self.train_seconds += time.perf_counter() - self._fit_t0
            self._fit_t0 = time.perf_counter()
            self._restore_signal_handlers(orig_handlers)
            if window is not None:
                window.stop()
        for cb in self.callbacks:
            self._safe_callback(cb, "on_train_end", self)
        tl.save()
        if error is not None:
            raise error
        if halted is not None:
            raise halted
        return metrics

    def _profile(self, window):
        """The profiler window over steps [2, 5) of this fit."""
        from neuronx_distributed_tpu_torch.observability.profiler import ProfileWindow

        if self.steps_run == 2 and window is None:
            window = ProfileWindow(self.profile_dir)
            window.start()
        elif self.steps_run == 5 and window is not None:
            window.stop()
            window = None
        return window

    def evaluate(self, data_iter: Iterable[dict], max_steps: int) -> dict:
        """Mean loss over ``max_steps`` batches with the current parameters,
        no update: the losses summed on the device in float64 and read once.
        Needs a fitted Trainer."""
        if self.state is None:
            raise RuntimeError("evaluate() needs a fitted Trainer (state is None)")
        if getattr(self, "_eval_step", None) is None:
            model = self.model
            loss_fn = self.loss_fn or (lambda batch: default_loss_fn(model, batch))
            draws = _takes_generator(loss_fn)

            def eval_step(batch):
                with torch.no_grad():
                    loss = loss_fn(batch, generator=self.step_rng()) if draws else loss_fn(batch)
                    return loss.detach().to(torch.float64)

            self._eval_step = self.programs.wrap("eval_step", eval_step, meter_first=True)
        data_iter = iter(data_iter)
        total, n = None, 0
        while n < max_steps:
            try:
                batch = next(data_iter)
            except StopIteration:
                break
            loss = self._eval_step(_to_device(batch, self._device))
            total = loss if total is None else total + loss
            n += 1
        if n == 0:
            raise ValueError("evaluate(): data_iter yielded no batches")
        self.host_reads += 1
        return {"eval_loss": float(total) / n, "eval_steps": n}
