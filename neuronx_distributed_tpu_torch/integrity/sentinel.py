"""The trainer's silent-data-corruption sentinel (counterpart of
``neuronx_distributed_tpu/integrity/sentinel.py``: ``SentinelConfig``,
``SentinelVerdict``, ``TrainerSentinel`` with ``is_check_step``,
``wants_pre_copy``, ``set_baseline``, ``snapshot_states``,
``can_rollback``, ``rollback``, ``pre_dispatch``, ``post_dispatch`` and
``judge``).

The port trains on one device, so the sentinel runs JAX's **canary** mode
(``mode="auto"`` resolves to it; the dp vote is multi-GPU work). At a check
step the same step runs twice on the same data and the two outcomes'
fingerprints must agree: any divergence is corruption (a compute fault at
the check step, or memory corruption of the state between the dispatch and
the fingerprint). Corruption striking between checks and carried quietly
into the next check's pre-step state is outside the canary's reach, as in
JAX.

**The check with in-place state.** JAX holds the pre-step copy and both
outcomes at once. The port's step updates the state in place, and only the
first outcome's fingerprint is needed:

1. copy the live state into the scratch snapshot (:meth:`pre_dispatch`);
2. the loop runs the step; fingerprint the result (A);
3. copy the scratch snapshot back in place;
4. run the step again on the same batch and fingerprint again (B);
5. copy the live state (B) into the scratch snapshot: the candidate.

Equal fingerprints let the live state (B) carry on and make the candidate
the known-good point (the two buffers swap roles; nothing is copied). A
rollback copies the known-good buffer into the live tensors in place. So
the sentinel holds two state-sized buffers, as JAX's ``snapshot_states()``
does, and the fingerprint table (TF over params, ``mu``, ``nu``, the count
and the guard carry, :class:`~neuronx_distributed_tpu_torch.kernels.
tree_fingerprint.TreeFingerprint`) is built once: no address ever moves.

**The re-run's randomness.** A MoE step draws its router jitter and token
permutation from a generator. The re-run must draw what the first run drew,
or every check of a healthy card disagrees and the run rolls back forever:
the train step makes its generator afresh from (seed, ``state.step``)
(``trainer/trainer.py step_generator``), and :meth:`post_dispatch` puts
``state.step`` back before the re-run, so both runs start from one state.

The sentinel never reads the device: :meth:`post_dispatch` returns the two
fingerprints as device scalars, which ride the loop's one deferred host
read a step, and :meth:`judge` receives host integers."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from neuronx_distributed_tpu_torch.integrity.voting import VoteVerdict

__all__ = ["SentinelConfig", "SentinelVerdict", "TrainerSentinel"]


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """The sentinel's settings (``Trainer.integrity``; None = off).
    ``check_every``: steps between checks, which bounds detection latency
    and cost (a canary check is one extra train step and three state
    copies). ``mode``: ``auto`` resolves to ``canary`` on one device."""

    check_every: int = 16
    mode: str = "auto"  # auto | canary (vote: multi-GPU)


@dataclasses.dataclass(frozen=True)
class SentinelVerdict:
    """One check's outcome, judged from host integers."""

    step: int
    mode: str
    clean: bool
    convicted_devices: Tuple[int, ...] = ()
    localized: bool = True
    values: Dict = dataclasses.field(default_factory=dict)

    @property
    def detected(self) -> bool:
        return not self.clean


def _copy(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]) -> None:
    with torch.no_grad():
        torch._foreach_copy_(list(dst), list(src))


class TrainerSentinel:
    """Host-side sentinel state machine driven by ``Trainer.fit`` over a
    fixed list of the state's tensors (``leaves``). ``fingerprint_fn()``
    fingerprints the live leaves (TF, ledgered as ``integrity_fingerprint``)
    and ``copy_fn(dst, src)`` copies leaf lists (ledgered as
    ``integrity_copy``)."""

    def __init__(self, config: SentinelConfig, *, leaves: Sequence[torch.Tensor],
                 fingerprint_fn: Callable[[], torch.Tensor], copy_fn: Callable = _copy):
        if config.check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {config.check_every}")
        if config.mode not in ("auto", "vote", "canary"):
            raise ValueError(f"unknown sentinel mode {config.mode!r}")
        if config.mode == "vote":
            raise NotImplementedError(
                "the sentinel's dp vote needs replicas on several GPUs (ROADMAP item 9); one "
                "device runs mode='canary'")
        self.config = config
        self.mode = "canary"
        self.leaves = list(leaves)
        self._fp = fingerprint_fn
        self._copy = copy_fn
        self._known_good: Optional[List[torch.Tensor]] = None  # buffer K
        self._scratch: Optional[List[torch.Tensor]] = None  # buffer S
        self._kg_meta: Optional[dict] = None
        self._cand_meta: Optional[dict] = None
        self._canary_batch = None
        self._pre: Optional[List[torch.Tensor]] = None  # the buffer holding the pre-step state
        self._pending: Optional[Tuple[str, None, int]] = None
        self.quarantined_devices: list = []
        self.counters: Dict[str, int] = {
            "integrity_checks": 0,
            "sdc_detected": 0,
            "sdc_unlocalized": 0,
            "sdc_rollbacks": 0,
        }

    def _buffer(self) -> List[torch.Tensor]:
        return [torch.empty_like(t) for t in self.leaves]

    # --- scheduling -------------------------------------------------------------

    def is_check_step(self, step_index: int) -> bool:
        """True when 0-based step ``step_index`` closes a check window."""
        return (step_index + 1) % self.config.check_every == 0

    def wants_pre_copy(self, step_index: int) -> bool:
        return self.is_check_step(step_index)

    # --- snapshots ---------------------------------------------------------------

    def set_baseline(self, step: int, data_state, tokens_seen: int) -> None:
        """The first known-good point: the live state fit() starts or
        resumes from (a restore is verified upstream). Allocates the two
        buffers on first use."""
        if self._known_good is None:
            self._known_good, self._scratch = self._buffer(), self._buffer()
        self._copy(self._known_good, self.leaves)
        self._kg_meta = {"step": step, "data_state": data_state, "tokens_seen": tokens_seen}
        self._cand_meta = None
        self._pending = None
        self._canary_batch = self._pre = None

    def snapshot_states(self) -> List[List[torch.Tensor]]:
        """The live snapshot buffers (the HBM ledger's resident)."""
        return [b for b in (self._known_good, self._scratch) if b is not None]

    def can_rollback(self) -> bool:
        return self._kg_meta is not None

    def rollback(self) -> dict:
        """Copy the known-good state into the live tensors (in place) and
        hand the loop its ``step``, ``data_state`` and ``tokens_seen``. The
        known-good buffer survives, so a second conviction can roll back
        again."""
        if self._kg_meta is None:
            raise RuntimeError("no known-good snapshot to roll back to")
        self._cand_meta = None
        self._canary_batch = self._pre = None
        self._pending = None
        self.counters["sdc_rollbacks"] += 1
        self._copy(self.leaves, self._known_good)
        return dict(self._kg_meta)

    # --- the check -----------------------------------------------------------------

    def pre_dispatch(self, prepared) -> None:
        """At a check step, before the dispatch: the pre-step state into the
        scratch buffer, and the prepared batch kept for the re-run. (With
        ``check_every=1`` the previous check's candidate still waits in the
        scratch buffer; it equals the live state, and if the judge makes it
        the known-good buffer, that buffer holds the pre-step state.)"""
        self._copy(self._scratch, self.leaves)
        self._pre = self._scratch
        self._canary_batch = prepared

    def post_dispatch(self, train_step, state, step: int, data_state,
                      tokens_seen: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """At a check step, after the dispatch and any chaos hook: steps 2-5
        of the check. ``state`` is the live TrainState (``state.step``
        already counts this step). Returns the two fingerprints, device
        scalars for the loop's deferred read; :meth:`judge` gets their host
        values."""
        if self._canary_batch is None:
            raise RuntimeError("canary check without pre_dispatch — loop wiring bug")
        self.counters["integrity_checks"] += 1
        prepared, self._canary_batch = self._canary_batch, None
        pre, self._pre = self._pre, None
        fp_a = self._fp()
        self._copy(self.leaves, pre)
        state.step -= 1  # the re-run is the same step, with the same step generator
        train_step(state, prepared)
        fp_b = self._fp()
        self._copy(self._scratch, self.leaves)
        self._cand_meta = {"step": step, "data_state": data_state, "tokens_seen": tokens_seen}
        self._pending = ("canary", None, step)
        return fp_a, fp_b

    def judge(self, host_values) -> Optional[SentinelVerdict]:
        """Judge the pending check from its two host fingerprints. Clean:
        the candidate becomes the known-good point. A detection discards the
        candidate; the previous known-good point stays for :meth:`rollback`."""
        if self._pending is None:
            return None
        kind, _, step = self._pending
        self._pending = None
        a, b = (int(x) for x in host_values)
        v = (VoteVerdict(clean=True, quorum_value=a) if a == b else
             VoteVerdict(clean=False, localized=False, values={"state": a, "canary": b}))
        if v.clean:
            if self._cand_meta is not None:
                self._known_good, self._scratch = self._scratch, self._known_good
                self._kg_meta, self._cand_meta = self._cand_meta, None
            return SentinelVerdict(step=step, mode=kind, clean=True)
        self._cand_meta = None
        self.counters["sdc_detected"] += 1
        self.counters["sdc_unlocalized"] += 1  # a canary blames no device
        return SentinelVerdict(step=step, mode=kind, clean=False, localized=False,
                               values=dict(v.values))
