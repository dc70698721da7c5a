"""Deterministic fault injection for the training loop (counterpart of
``neuronx_distributed_tpu/trainer/faults.py``: ``InjectedFault``,
``InjectedDispatchError``, ``FaultInjector`` and its hooks).

``Trainer.fit`` consults the injector through hooks that do nothing without
one. Schedules (0-based step, dispatch-attempt or save indices):

* ``nan_loss(at=k, times=t)``: steps k..k+t-1 get a ``loss_mask`` of NaN,
  so the real masked-mean loss is NaN; the guard must skip the step;
* ``spike_grads(at=k, times=t, factor=1e6)``: the mask scaled by
  ``-factor``: the negative sum lands in the masked mean's ``max(sum, 1)``
  clamp, so the loss and every gradient scale by the full factor, finite;
* ``fail_dispatch(at=j, times=t)``: dispatch attempts j..j+t-1 raise
  :class:`InjectedDispatchError` before the step runs (the state intact,
  the recoverable case); ``times=None`` fails every attempt from j on;
* ``corrupt_checkpoint(tag)``: ``tag``'s ``done`` marker is deleted right
  after its save commits (a run killed between the payload and the marker);
* ``flip_bits(target, at=k, times=t, device=d)``: one low-order bit.
  ``"params"``/``"opt_state"`` flip bit 0 of byte 0 of the first tensor
  (the embedding; the optimizer's ``count``) right after step k's
  dispatch, IN PLACE in the live tensor (JAX binds a flipped copy; the
  port's state is updated in place and its fingerprint table reads fixed
  addresses). The mutable trailing budget of each window keeps a
  rolled-back window from being flipped again. One device holds the only
  copy, so ``device`` is None or 0. ``"checkpoint_shard"`` flips one byte
  of the largest payload file of saves k..k+t-1 after they commit;
* ``deliver_sigterm(at=k)``: a real ``SIGTERM`` to this process at the start
  of step k.

``counters`` records every fault that fired."""

from __future__ import annotations

import os
import signal
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["FaultInjector", "InjectedDispatchError", "InjectedFault"]


class InjectedFault(RuntimeError):
    """Base class of injected training failures (never raised by real code)."""


class InjectedDispatchError(InjectedFault):
    """A scheduled train-step dispatch failure."""


class FaultInjector:
    """Schedule-driven fault source consulted by ``Trainer.fit``'s hooks."""

    def __init__(self):
        # [at, end) windows; end None = open-ended
        self._nan_windows: List[Tuple[int, Optional[int]]] = []
        self._spike_windows: List[Tuple[int, Optional[int], float]] = []
        self._dispatch_windows: List[Tuple[int, Optional[int]]] = []
        self._corrupt_tags: Set[str] = set()
        self._sigterm_steps: Set[int] = set()
        # [at, end, target, device, remaining fires] (mutable: see flip_bits)
        self._flip_state_windows: List[list] = []
        self._flip_shard_windows: List[Tuple[int, Optional[int]]] = []
        self._saves_seen = 0
        self.counters: Dict[str, int] = {
            "nan_losses": 0,
            "spiked_grads": 0,
            "dispatch_failures": 0,
            "corrupted_checkpoints": 0,
            "sigterms": 0,
            "bit_flips": 0,
        }

    # --- schedules ------------------------------------------------------------

    def nan_loss(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        self._nan_windows.append((at, None if times is None else at + times))
        return self

    def spike_grads(self, at: int = 0, times: Optional[int] = 1,
                    factor: float = 1e6) -> "FaultInjector":
        self._spike_windows.append((at, None if times is None else at + times, factor))
        return self

    def fail_dispatch(self, at: int = 0, times: Optional[int] = 1) -> "FaultInjector":
        self._dispatch_windows.append((at, None if times is None else at + times))
        return self

    def corrupt_checkpoint(self, tag: str) -> "FaultInjector":
        self._corrupt_tags.add(tag)
        return self

    def flip_bits(self, target: str, at: int = 0, times: Optional[int] = 1,
                  device: Optional[int] = None) -> "FaultInjector":
        """Single-bit flips of ``target`` (``params``, ``opt_state`` or
        ``checkpoint_shard``) at steps (or saves) at..at+times-1."""
        if device not in (None, 0):
            raise ValueError(f"the port trains on one device: flip_bits takes device None or 0, "
                             f"got {device!r} (per-replica copies come with multi-GPU training)")
        end = None if times is None else at + times
        if target in ("params", "opt_state"):
            # the trailing slot is the remaining-fires budget: a flip is a
            # transient event, so a window re-trained after a rollback is not
            # flipped again (None = unlimited)
            self._flip_state_windows.append([at, end, target, device, times])
        elif target == "checkpoint_shard":
            self._flip_shard_windows.append((at, end))
        else:
            raise ValueError(f"flip_bits target must be params|opt_state|checkpoint_shard, got "
                             f"{target!r}")
        return self

    def deliver_sigterm(self, at: int) -> "FaultInjector":
        self._sigterm_steps.add(at)
        return self

    def pending_corruption(self, tag: str) -> bool:
        """True when ``corrupt_checkpoint`` is scheduled for ``tag``: the save
        path drains async commits first so the corruption hits a committed
        checkpoint."""
        return tag in self._corrupt_tags

    def pending_shard_flip(self) -> bool:
        """True when a ``checkpoint_shard`` window covers the next committed
        save (the same drain contract)."""
        return self._hit(self._flip_shard_windows, self._saves_seen)

    # --- hooks -------------------------------------------------------------------

    @staticmethod
    def _hit(windows, index: int) -> bool:
        return any(index >= at and (end is None or index < end) for at, end in windows)

    def on_step_start(self, step: int) -> None:
        """Before step ``step``'s batch: a scheduled real SIGTERM."""
        if step in self._sigterm_steps:
            self._sigterm_steps.discard(step)
            self.counters["sigterms"] += 1
            os.kill(os.getpid(), signal.SIGTERM)

    def corrupt_batch(self, step: int, batch: dict) -> dict:
        """Step ``step``'s host batch, its ``loss_mask`` poisoned (NaN) or
        scaled (spike) when a schedule hits; otherwise the batch itself."""
        import numpy as np

        nan = self._hit(self._nan_windows, step)
        spike = next((f for at, end, f in self._spike_windows
                      if step >= at and (end is None or step < end)), None)
        if not nan and spike is None:
            return batch
        batch = dict(batch)
        mask = batch.get("loss_mask")
        if mask is None:
            mask = np.ones(np.shape(batch["input_ids"]), dtype=np.float32)
        else:
            mask = np.array(mask, dtype=np.float32, copy=True)
        if nan:
            mask[...] = np.nan
            self.counters["nan_losses"] += 1
        else:
            mask *= -abs(spike)
            self.counters["spiked_grads"] += 1
        batch["loss_mask"] = mask
        return batch

    def on_state(self, step: int, state):
        """Right after step ``step``'s dispatch (before the sentinel's
        check): a scheduled flip of the first tensor of the params or the
        optimizer state, in place. Returns ``state``."""
        hits = []
        for w in self._flip_state_windows:
            at, end, target, _, left = w
            if step < at or (end is not None and step >= end) or left == 0:
                continue
            if left is not None:
                w[4] = left - 1
            hits.append(target)
        if not hits:
            return state
        from neuronx_distributed_tpu_torch.integrity.chaos import flip_tree_bit
        from neuronx_distributed_tpu_torch.trainer.checkpoint import _flatten

        for target in hits:
            if target == "params":
                leaves = [p for p in state.params.parameters() if p.requires_grad]
            else:
                leaves = [t for _, t in _flatten(state.opt_state)]
            flip_tree_bit(leaves)
            self.counters["bit_flips"] += 1
        return state

    def on_dispatch(self, attempt: int) -> None:
        """Before dispatch attempt ``attempt`` (failed attempts count): a
        scheduled failure raises here, before the step touches the state."""
        if self._hit(self._dispatch_windows, attempt):
            self.counters["dispatch_failures"] += 1
            raise InjectedDispatchError(
                f"injected train-step dispatch failure at attempt {attempt}")

    def on_checkpoint_saved(self, checkpoint_dir: str, tag: str) -> None:
        """After ``tag``'s save: a scheduled ``corrupt_checkpoint`` deletes
        its marker; a scheduled shard flip xors one byte in the middle of
        its largest payload file. A save whose commit has not landed yet
        (async) leaves the schedule armed."""
        shard_hit = self._hit(self._flip_shard_windows, self._saves_seen)
        if tag not in self._corrupt_tags and not shard_hit:
            self._saves_seen += 1
            return
        from neuronx_distributed_tpu_torch.trainer.checkpoint import (
            _ITEMS_DIRNAME,
            DONE_MARKER,
            create_checkpoint_storage,
        )

        storage = create_checkpoint_storage(checkpoint_dir)
        marker = os.path.join(tag, DONE_MARKER)
        if not storage.file_exists(marker):
            return
        self._saves_seen += 1
        if tag in self._corrupt_tags:
            self._corrupt_tags.discard(tag)
            storage.remove_file(marker)
            self.counters["corrupted_checkpoints"] += 1
        if shard_hit:
            items = os.path.join(tag, _ITEMS_DIRNAME)
            files = storage.list_files(items)
            if files:
                victim = os.path.join(items, max(
                    files, key=lambda f: storage.file_size(os.path.join(items, f))))
                storage.flip_byte(victim, storage.file_size(victim) // 2)
                self.counters["bit_flips"] += 1
