"""Serving metrics (counterpart of
``neuronx_distributed_tpu/serving/metrics.py``, the subset the engine's core
records): TTFT, queue wait, decode tokens/s, chunk counts and slot
occupancy, as plain host numbers in ``snapshot()`` (same key names as the
JAX snapshot). Recording costs no device read: every sample is a host scalar
the engine already holds."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _mean(xs: List[float]) -> float:
    return float(np.mean(xs)) if xs else 0.0


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(xs, q)) if xs else 0.0


class ServingMetrics:
    def __init__(self, num_slots: int = 0):
        self.num_slots = num_slots
        self._requests: Dict[int, dict] = {}
        self.steps = self.executed_steps = self.chunks = self.decode_tokens = 0
        self.occupied_slot_steps = 0
        self.prefills = self.completed = self.cancelled = 0
        self.preemptions = self.rejects = 0
        self.cursor_high_water = 0
        self.decode_dispatch_s = self.decode_readback_s = 0.0
        self.prefill_walls: List[float] = []

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

    def record_prefill_wall(self, seconds: float) -> None:
        self.prefill_walls.append(seconds)

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

    def record_decode_chunk(self, tokens: int, steps: int, executed: int, cursor: int,
                            active_slots: int, dispatch_s: float = 0.0,
                            readback_s: float = 0.0) -> None:
        """One decode chunk: ``tokens`` delivered across ``steps`` used
        steps (those with a live slot, the JAX count) by ``active_slots``
        slots held at dispatch; ``executed`` counts the model steps that ran,
        the masked no-ops after every slot froze included; ``dispatch_s``/
        ``readback_s`` split its wall time around the one host read."""
        self.chunks += 1
        self.steps += steps
        self.executed_steps += executed
        self.decode_tokens += tokens
        self.occupied_slot_steps += active_slots * steps
        self.cursor_high_water = max(self.cursor_high_water, cursor)
        self.decode_dispatch_s += dispatch_s
        self.decode_readback_s += readback_s

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
            "chunk_tokens_per_sec": self.decode_tokens / wall if wall > 0 else 0.0,
            "prefills": self.prefills,
            "decode_tokens": self.decode_tokens,
            "completed": self.completed,
            "cancelled": self.cancelled,
            "preemptions": self.preemptions,
            "rejects": self.rejects,
            "prefill_count": len(self.prefill_walls),
            "prefill_wall_s": float(sum(self.prefill_walls)),
            "prefill_mean_s": _mean(self.prefill_walls),
            "cursor_high_water": self.cursor_high_water,
            "mean_occupancy": self.mean_occupancy,
            "mean_ttft": _mean(ttfts),
            "max_ttft": max(ttfts) if ttfts else 0.0,
            "ttft_p50_s": _pct(ttfts, 50),
            "ttft_p95_s": _pct(ttfts, 95),
            "mean_queue_wait": _mean(waits),
            "mean_latency": _mean([r["latency"] for r in done]),
            "mean_decode_tokens_per_sec": _mean([r["decode_tokens_per_sec"] for r in done]),
        }
