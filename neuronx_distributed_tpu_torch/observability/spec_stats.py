"""Speculative-decoding acceptance statistics (counterpart of
``neuronx_distributed_tpu/observability/spec_stats.py``).

One recorder serves both speculation consumers, the serving engine's
draft-verify rounds and solo ``speculative_generate``, with the JAX
snapshot's keys. One ``record_round`` observation is ONE row's accepted
draft length in ONE round, ``0..gamma``: the histogram feeds
``spec_accept_len_p50/p95``, the counters ``spec_accept_rate`` (accepted /
drafted) and ``draft_tokens_wasted`` (drafted - consumed). A sampled row of
a speculative engine accepts nothing by construction, so its rounds count
as wasted draft work: acceptance measures the draft's utility, not
correctness.

The metrics live in a :class:`~neuronx_distributed_tpu_torch.observability.
registry.MetricsRegistry` (a private one when none is given); a
label-scoped ``view=`` resolves each as that view's family child, so two
engine-labelled engines on one registry never merge their acceptance.
"""

from __future__ import annotations

from typing import Optional

from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry, MetricsView


class SpecStats:
    """The acceptance recorder (see the module docstring)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None, prefix: str = "spec",
                 view: Optional[MetricsView] = None):
        if view is None:
            view = MetricsView(registry if registry is not None else MetricsRegistry())
        self.registry = view.registry
        histogram, counter = view.histogram, view.counter
        self.accept_len = histogram(
            f"{prefix}_accept_len",
            help="per-slot accepted draft length per speculative round (0..gamma)")
        self.drafted = counter(f"{prefix}_draft_tokens", help="draft tokens proposed")
        self.accepted = counter(f"{prefix}_accepted_tokens",
                                help="draft tokens the target accepted")
        self.wasted = counter(f"{prefix}_draft_tokens_wasted",
                              help="draft tokens rejected (drafted - accepted)")
        self.rounds = counter(f"{prefix}_rounds", help="per-slot speculative rounds executed")
        # chunks decoded non-speculatively after a failed speculative
        # dispatch (the engine's fallback to the plain step)
        self.fallbacks = counter(f"{prefix}_fallbacks",
                                 help="chunks decoded non-speculatively after a failed "
                                      "speculative dispatch")

    def record_fallback(self) -> None:
        """A speculative dispatch failed and its chunk was decoded with the
        plain step instead (streams unaffected)."""
        self.fallbacks.inc()

    def record_round(self, accepted: int, gamma: int, consumed: Optional[int] = None) -> None:
        """One row's acceptance in one round: ``accepted`` of ``gamma``
        drafts survived verification; ``consumed`` (default ``accepted``)
        of them advanced the stream. The solo batch-min schedule consumes
        only up to the batch minimum and re-drafts the rest, so its waste
        exceeds ``gamma - accepted``; the engine consumes all it accepts."""
        accepted = int(accepted)
        consumed = accepted if consumed is None else int(consumed)
        self.accept_len.observe(accepted)
        self.drafted.inc(gamma)
        self.accepted.inc(accepted)
        self.wasted.inc(gamma - consumed)
        self.rounds.inc()

    @property
    def accept_rate(self) -> float:
        d = self.drafted.value
        return float(self.accepted.value) / d if d else 0.0

    def snapshot(self) -> dict:
        """The spec keys the engine's and the solo path's snapshots share."""
        return {
            "spec_rounds": int(self.rounds.value),
            "spec_draft_tokens": int(self.drafted.value),
            "spec_accepted_tokens": int(self.accepted.value),
            "draft_tokens_wasted": int(self.wasted.value),
            "spec_accept_rate": self.accept_rate,
            "spec_accept_len_p50": self.accept_len.percentile(0.50),
            "spec_accept_len_p95": self.accept_len.percentile(0.95),
            "spec_fallbacks": int(self.fallbacks.value),
        }
