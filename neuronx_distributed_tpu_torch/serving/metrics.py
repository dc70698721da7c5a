"""Serving metrics (counterpart of
``neuronx_distributed_tpu/serving/metrics.py``, the subset the engine's core
records): TTFT, queue wait, decode tokens/s, chunk counts, slot
occupancy (mean and peak), for a paged engine the peak of pages mapped, the
decode program's captures, capture wall and graph replays, the prefix
cache's counters (JAX ``metrics.py:85-93``, ``:494-524``), the prefill
wall by kind (``"full"`` or ``"suffix"``) and the speculative acceptance
statistics (``observability/spec_stats.py``, JAX ``metrics.py:590-622``,
all zero without a draft model), the fault counters (sheds, time-outs,
failures, slot and page quarantines, dispatch retries, recoveries, prefill
failures, speculative fallbacks; JAX ``metrics.py:429-513``) and the
engine's health, as plain host numbers in ``snapshot()``
(the JAX snapshot's key names, plus ``peak_occupancy``,
``peak_pages_mapped``, ``decode_captures``, ``capture_s`` and
``graph_replays``). Recording costs no device read: every sample is a host
scalar the engine already holds."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from neuronx_distributed_tpu_torch.observability.spec_stats import SpecStats


def _mean(xs: List[float]) -> float:
    return float(np.mean(xs)) if xs else 0.0


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(xs, q)) if xs else 0.0


class ServingMetrics:
    def __init__(self, num_slots: int = 0):
        self.num_slots = num_slots
        self._requests: Dict[int, dict] = {}
        self.steps = self.executed_steps = self.chunks = self.decode_tokens = 0
        self.occupied_slot_steps = self.peak_occupancy = self.peak_pages_mapped = 0
        self.prefills = self.completed = self.cancelled = 0
        self.preemptions = self.rejects = 0
        self.sheds = self.timed_out = self.failed = self.prefill_failures = 0
        self.quarantines = self.page_quarantines = self.dispatch_retries = self.recoveries = 0
        self.health = "ok"  # the engine's mirror of ServingEngine.health()
        self.cursor_high_water = 0
        self.decode_dispatch_s = self.decode_readback_s = 0.0
        self.graph_replays = self.decode_captures = 0
        self.capture_s = 0.0
        self.prefill_walls: List[float] = []
        self.prefill_walls_by_kind: Dict[str, List[float]] = {"full": [], "suffix": []}
        self.prefix_hits = self.prefix_misses = self.prefix_tokens_reused = 0
        self.prefix_evictions = self.prefix_validation_failures = self.prefix_pages_shared = 0
        self.spec = SpecStats()

    def record_submit(self, req, now: float) -> None:
        self._requests[req.rid] = {
            "rid": req.rid, "prompt_len": int(len(req.prompt)), "submit_time": now,
        }

    def record_admit(self, req, now: float) -> None:
        r = self._requests[req.rid]
        # re-admissions after preemption keep the first queue wait
        if "queue_wait" not in r:
            r["admit_time"] = now
            r["queue_wait"] = now - r["submit_time"]
        self.prefills += 1

    def record_prefill_wall(self, seconds: float, kind: str = "full") -> None:
        """Wall time of one prefill, ``kind`` ``"full"`` or ``"suffix"`` (a
        prefix hit's)."""
        self.prefill_walls.append(seconds)
        self.prefill_walls_by_kind[kind].append(seconds)

    # --- prefix cache -------------------------------------------------------

    def record_prefix_hit(self, matched: int) -> None:
        """An admission reused ``matched`` stored prefix tokens (only the
        tail was prefilled)."""
        self.prefix_hits += 1
        self.prefix_tokens_reused += matched

    def record_prefix_miss(self) -> None:
        self.prefix_misses += 1

    def record_prefix_eviction(self, n: int = 1) -> None:
        self.prefix_evictions += n

    def record_prefix_validation_failure(self) -> None:
        """A stored entry failed its reuse-time validation: it was evicted
        and the admission fell back to a full prefill."""
        self.prefix_validation_failures += 1

    def record_prefix_pages_shared(self, n: int) -> None:
        """A paged hit mapped ``n`` pool pages copy-on-write into the
        admitted slot's block table (zero KV bytes copied)."""
        self.prefix_pages_shared += n

    def record_first_token(self, req, now: float) -> None:
        r = self._requests[req.rid]
        r["first_token_time"] = now
        r["ttft"] = now - r["submit_time"]

    def record_finish(self, req, now: float) -> None:
        r = self._requests[req.rid]
        r["finish_time"] = now
        r["latency"] = now - r["submit_time"]
        r["tokens"] = len(req.tokens)
        span = now - r.get("first_token_time", now)
        # tokens after the first are decode-step products
        r["decode_tokens_per_sec"] = (len(req.tokens) - 1) / span if span > 0 else 0.0
        r["preemptions"] = req.preemptions
        self.completed += 1

    def record_cancel(self, req, now: float) -> None:
        r = self._requests.get(req.rid)
        if r is not None:
            r["cancel_time"] = now
        self.cancelled += 1

    def record_preemption(self) -> None:
        self.preemptions += 1

    def record_reject(self) -> None:
        self.rejects += 1

    # --- faults -------------------------------------------------------------

    def record_shed(self, req, now: float, where: str) -> None:
        """A request timed out: ``where`` is ``"queue"`` (shed before any
        prefill) or ``"inflight"`` (its deadline hit at a chunk boundary)."""
        r = self._requests.get(req.rid)
        if r is not None:
            r["finish_time"] = now
            r["timed_out"] = True
            r["shed_where"] = where
            r["tokens"] = len(req.tokens)
        self.sheds += 1
        self.timed_out += 1

    def record_failed(self, req, now: float, kind: str = "engine") -> None:
        """A request the engine failed for cause (``req.error`` says why):
        ``kind`` is ``"prefill"`` or ``"quarantine"``."""
        r = self._requests.get(req.rid)
        if r is not None:
            r["finish_time"] = now
            r["failed"] = True
            r["failed_kind"] = kind
        self.failed += 1
        if kind == "prefill":
            self.prefill_failures += 1

    def record_quarantine(self) -> None:
        self.quarantines += 1

    def record_page_quarantine(self) -> None:
        """A poisoned pool page was retired (its holders requeued)."""
        self.page_quarantines += 1

    def record_dispatch_retry(self) -> None:
        self.dispatch_retries += 1

    def record_recovery(self) -> None:
        self.recoveries += 1

    def record_spec_fallback(self) -> None:
        """A speculative dispatch failed and its chunk was decoded with the
        plain step instead."""
        self.spec.record_fallback()

    def request_snapshot(self, rid: int) -> dict:
        """One request's recorded fields."""
        return dict(self._requests.get(rid, {}))

    def record_decode_chunk(self, tokens: int, steps: int, executed: int, cursor: int,
                            active_slots: int, dispatch_s: float = 0.0,
                            readback_s: float = 0.0, replays: int = 0,
                            spec_accepts=None, gamma: int = 0) -> None:
        """One decode chunk: ``tokens`` delivered across ``steps`` used
        steps (those with a live slot, the JAX count) by ``active_slots``
        slots held at dispatch; ``executed`` counts the model steps that ran,
        the masked no-ops after every slot froze included; ``dispatch_s``/
        ``readback_s`` split its wall time around the one host read (a
        capture's wall is recorded apart, :meth:`record_capture`);
        ``replays`` counts the decode-program replays among its steps.
        A speculative chunk (``steps``/``executed`` count ROUNDS) also passes
        ``spec_accepts``, one accepted draft length per (live round, slot),
        and ``gamma``: they feed :attr:`spec`."""
        self.chunks += 1
        self.steps += steps
        self.executed_steps += executed
        self.decode_tokens += tokens
        self.occupied_slot_steps += active_slots * steps
        self.peak_occupancy = max(self.peak_occupancy, active_slots)
        self.cursor_high_water = max(self.cursor_high_water, cursor)
        self.decode_dispatch_s += dispatch_s
        self.decode_readback_s += readback_s
        self.graph_replays += replays
        for a in spec_accepts or ():
            self.spec.record_round(a, gamma)

    def record_capture(self, seconds: float) -> None:
        """A decode-program capture and its wall (warm-up included), kept
        out of the chunk walls."""
        self.decode_captures += 1
        self.capture_s += seconds

    def record_pages_mapped(self, pages: int) -> None:
        """Pool pages mapped at a paged chunk's dispatch."""
        self.peak_pages_mapped = max(self.peak_pages_mapped, pages)

    @property
    def mean_occupancy(self) -> float:
        return self.occupied_slot_steps / self.steps if self.steps else 0.0

    def snapshot(self) -> dict:
        reqs = self._requests.values()
        done = [r for r in reqs if "latency" in r]
        ttfts = [r["ttft"] for r in reqs if "ttft" in r]
        waits = [r["queue_wait"] for r in reqs if "queue_wait" in r]
        wall = self.decode_dispatch_s + self.decode_readback_s
        return {
            "num_slots": self.num_slots,
            "steps": self.steps,
            "executed_steps": self.executed_steps,
            "chunks": self.chunks,
            "decode_dispatch_s": self.decode_dispatch_s,
            "decode_readback_s": self.decode_readback_s,
            "decode_captures": self.decode_captures,
            "capture_s": self.capture_s,
            "graph_replays": self.graph_replays,
            "chunk_tokens_per_sec": self.decode_tokens / wall if wall > 0 else 0.0,
            "prefills": self.prefills,
            "decode_tokens": self.decode_tokens,
            "completed": self.completed,
            "cancelled": self.cancelled,
            "preemptions": self.preemptions,
            "rejects": self.rejects,
            "sheds": self.sheds,
            "timed_out": self.timed_out,
            "failed": self.failed,
            "quarantines": self.quarantines,
            "page_quarantines": self.page_quarantines,
            "dispatch_retries": self.dispatch_retries,
            "recoveries": self.recoveries,
            "prefill_failures": self.prefill_failures,
            "health": self.health,
            "prefill_count": len(self.prefill_walls),
            "prefill_wall_s": float(sum(self.prefill_walls)),
            "prefill_mean_s": _mean(self.prefill_walls),
            "prefill_full_wall_s": float(sum(self.prefill_walls_by_kind["full"])),
            "prefill_suffix_wall_s": float(sum(self.prefill_walls_by_kind["suffix"])),
            "prefill_full_count": len(self.prefill_walls_by_kind["full"]),
            "prefill_suffix_count": len(self.prefill_walls_by_kind["suffix"]),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_rate": (self.prefix_hits / (self.prefix_hits + self.prefix_misses)
                                if self.prefix_hits + self.prefix_misses else 0.0),
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "prefix_evictions": self.prefix_evictions,
            "prefix_validation_failures": self.prefix_validation_failures,
            "prefix_pages_shared": self.prefix_pages_shared,
            "cursor_high_water": self.cursor_high_water,
            "mean_occupancy": self.mean_occupancy,
            "peak_occupancy": self.peak_occupancy,
            "peak_pages_mapped": self.peak_pages_mapped,
            "mean_ttft": _mean(ttfts),
            "max_ttft": max(ttfts) if ttfts else 0.0,
            "ttft_p50_s": _pct(ttfts, 50),
            "ttft_p95_s": _pct(ttfts, 95),
            "mean_queue_wait": _mean(waits),
            "mean_latency": _mean([r["latency"] for r in done]),
            "mean_decode_tokens_per_sec": _mean([r["decode_tokens_per_sec"] for r in done]),
            **self.spec.snapshot(),
        }
