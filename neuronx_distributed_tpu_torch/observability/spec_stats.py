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

The JAX recorder keeps its metrics in the ``MetricsRegistry``; the port has
no registry yet, so the counters here are plain numbers and the histogram
is a copy of the registry's log-bucketed one (``registry.py``, growth 1.05,
a zero bucket, nearest-rank quantiles reported as the bucket's upper edge
capped at the exact maximum), so the two snapshots compare key for key.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

GROWTH = 1.05  # the JAX registry's DEFAULT_GROWTH


class LogHistogram:
    """Sparse log-bucketed histogram with exact-to-bucket quantiles (the JAX
    registry's ``Histogram``)."""

    def __init__(self, growth: float = GROWTH):
        self.growth = growth
        self._log_growth = math.log(growth)
        self._buckets: Dict[int, int] = {}
        self._zero = 0  # observations <= 0
        self.count = 0
        self.max = -math.inf

    def observe(self, value: float) -> None:
        self.count += 1
        self.max = max(self.max, value)
        if value <= 0.0:
            self._zero += 1
            return
        i = math.floor(math.log(value) / self._log_growth)
        self._buckets[i] = self._buckets.get(i, 0) + 1

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding the rank ``ceil(q * count)``
        sample, never above the maximum; 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = self._zero
        if rank <= seen:
            return 0.0
        for i in sorted(self._buckets):
            seen += self._buckets[i]
            if rank <= seen:
                return min(self.growth ** (i + 1), self.max)
        return self.max


class SpecStats:
    """The acceptance recorder (see the module docstring)."""

    def __init__(self):
        self.accept_len = LogHistogram()
        self.rounds = self.drafted = self.accepted = self.wasted = 0
        # chunks decoded non-speculatively after a failed speculative
        # dispatch (the engine's fallback to the plain step)
        self.fallbacks = 0

    def record_fallback(self) -> None:
        """A speculative dispatch failed and its chunk was decoded with the
        plain step instead (streams unaffected)."""
        self.fallbacks += 1

    def record_round(self, accepted: int, gamma: int, consumed: Optional[int] = None) -> None:
        """One row's acceptance in one round: ``accepted`` of ``gamma``
        drafts survived verification; ``consumed`` (default ``accepted``)
        of them advanced the stream. The solo batch-min schedule consumes
        only up to the batch minimum and re-drafts the rest, so its waste
        exceeds ``gamma - accepted``; the engine consumes all it accepts."""
        accepted = int(accepted)
        consumed = accepted if consumed is None else int(consumed)
        self.accept_len.observe(accepted)
        self.drafted += gamma
        self.accepted += accepted
        self.wasted += gamma - consumed
        self.rounds += 1

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    def snapshot(self) -> dict:
        """The spec keys the engine's and the solo path's snapshots share."""
        return {
            "spec_rounds": self.rounds,
            "spec_draft_tokens": self.drafted,
            "spec_accepted_tokens": self.accepted,
            "draft_tokens_wasted": self.wasted,
            "spec_accept_rate": self.accept_rate,
            "spec_accept_len_p50": self.accept_len.percentile(0.50),
            "spec_accept_len_p95": self.accept_len.percentile(0.95),
            "spec_fallbacks": self.fallbacks,
        }
