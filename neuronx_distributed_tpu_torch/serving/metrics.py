"""Serving metrics (counterpart of ``neuronx_distributed_tpu/serving/metrics.py``):
per-request latencies and the engine's counters, kept in a
:class:`~neuronx_distributed_tpu_torch.observability.registry.MetricsRegistry`
(``registry=`` shares one; ``metrics.registry.prometheus_text()`` is the
scrape payload) and exported as plain host numbers by ``snapshot()``.

* Counters read through as attributes (``metrics.steps``): steps, chunks,
  prefills, tokens, completions, the fault counters (sheds, time-outs,
  failures, slot and page quarantines, dispatch retries, recoveries,
  prefill failures; JAX ``metrics.py:69-114``), the prefix cache's, the
  prefill and decode walls, and the port's own: ``executed_steps`` (masked
  no-op steps included), ``decode_captures``, ``capture_s`` and
  ``graph_replays`` of the decode program, ``peak_occupancy`` and, for a
  paged engine, ``peak_pages_mapped``.
* Latencies are log-bucketed histograms (exact to the bucket, fixed memory):
  TTFT, TPOT (a request's mean time per token after its first), queue wait
  and the prefill wall, so the snapshot's ``ttft_p50_s``..``tpot_p99_s``,
  ``queue_wait_p95_s`` and ``prefill_p95_s`` equal the JAX engine's for
  the same stream.
* Tenants: each request's TTFT, TPOT and queue wait also land in per-tenant
  labelled families (``serving_tenant_ttft_s{tenant="..."}``), and
  submissions, completions, tokens, sheds, time-outs, rejects and failures
  in per-tenant counters: the snapshot's ``tenants`` breakdown.
* ``slo=`` (an ``SLOSpec`` or ``{tenant: SLOSpec}``) attaches an
  :class:`~neuronx_distributed_tpu_torch.observability.slo.SLOTracker`:
  each request is classified once at its terminal state, goodput counts
  the attaining requests' tokens; the snapshot's ``slo`` block.
* ``engine_label=``: every metric registers as a child of an
  ``engine``-labelled family, so labelled engines share one registry
  without merging a counter; a second UNLABELLED engine on a registry is
  refused.

* The host page tier (``kv_host_pages=``; JAX ``metrics.py:94-106``,
  ``:528-565``): spill and prefetch pages and bytes, late and wasted
  prefetches, spill and prefetch failures, poisoned host pages, the batch
  sizes of each transfer, and prefix hits by the tier their entry lived in
  (``serving_prefix_hit_tier{tier=}``, the snapshot's ``prefix_hit_tier``).
* Warm restart (JAX ``metrics.py:328-360``): adopted and restored requests
  keyed to their original submit time (``record_adopt``), the ``restored``
  counter and the restore-downtime histogram (``record_restore``; the
  snapshot's ``restored`` and ``restore_downtime_p95_s``).
* ``snapshot()["hbm"]`` is the engine's HBM ledger
  (``observability/hbm.py``), attached weakly.

The speculative acceptance statistics ride the same registry
(``observability/spec_stats.py``). Recording costs no device read: every
sample is a host scalar the engine already holds.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional

from neuronx_distributed_tpu_torch.observability.registry import (
    MetricFamily,
    MetricsRegistry,
    MetricsView,
)
from neuronx_distributed_tpu_torch.observability.slo import SLOTracker
from neuronx_distributed_tpu_torch.observability.spec_stats import SpecStats


def _mean(xs):
    return sum(xs) / len(xs) if xs else 0.0


# (attribute, registry metric name, int-valued): the counter surface; the
# JAX engine's names, then the port's own (the decode program's counts and
# the prefill counts by kind)
_COUNTERS = (
    ("steps", "serving_steps", True),
    ("chunks", "serving_chunks", True),
    ("prefills", "serving_prefills", True),
    ("decode_tokens", "serving_decode_tokens", True),
    ("completed", "serving_completed", True),
    ("cancelled", "serving_cancelled", True),
    ("preemptions", "serving_preemptions", True),
    ("sheds", "serving_sheds", True),
    ("rejects", "serving_rejects", True),
    ("quarantines", "serving_quarantines", True),
    ("dispatch_retries", "serving_dispatch_retries", True),
    ("recoveries", "serving_recoveries", True),
    ("prefill_failures", "serving_prefill_failures", True),
    ("failed", "serving_failed", True),
    ("timed_out", "serving_timed_out", True),
    ("prefix_hits", "serving_prefix_hits", True),
    ("prefix_misses", "serving_prefix_misses", True),
    ("prefix_tokens_reused", "serving_prefix_tokens_reused", True),
    ("prefix_evictions", "serving_prefix_evictions", True),
    ("prefix_validation_failures", "serving_prefix_validation_failures", True),
    ("page_quarantines", "serving_page_quarantines", True),
    ("prefix_pages_shared", "serving_prefix_pages_shared", True),
    # the host page tier: its traffic and failure modes (JAX's names). late =
    # a prefetch at rebind time instead of the queue pre-pass; wasted =
    # prefetched pages whose entry was evicted before any request used them
    ("kv_pages_spilled", "serving_kv_spill_pages", True),
    ("kv_spill_bytes", "serving_kv_spill_bytes", True),
    ("kv_spill_failures", "serving_kv_spill_failures", True),
    ("kv_pages_prefetched", "serving_kv_spill_prefetch_pages", True),
    ("kv_prefetch_bytes", "serving_kv_spill_prefetch_bytes", True),
    ("kv_prefetch_late", "serving_kv_spill_prefetch_late", True),
    ("kv_prefetch_wasted", "serving_kv_spill_prefetch_wasted", True),
    ("kv_prefetch_failures", "serving_kv_spill_prefetch_failures", True),
    ("kv_host_poisoned", "serving_kv_spill_host_poisoned", True),
    # requests brought back by a warm restart
    ("restored", "serving_restored_requests", True),
    ("occupied_slot_steps", "serving_occupied_slot_steps", True),
    ("prefill_full_wall_s", "serving_prefill_full_wall_s", False),
    ("prefill_suffix_wall_s", "serving_prefill_suffix_wall_s", False),
    ("decode_dispatch_s", "serving_decode_dispatch_s", False),
    ("decode_readback_s", "serving_decode_readback_s", False),
    ("executed_steps", "serving_executed_steps", True),
    ("graph_replays", "serving_graph_replays", True),
    ("decode_captures", "serving_decode_captures", True),
    ("capture_s", "serving_capture_s", False),
    ("prefill_full_count", "serving_prefill_full_count", True),
    ("prefill_suffix_count", "serving_prefill_suffix_count", True),
)

_HEALTH_CODES = {"ok": 0, "degraded": 1, "draining": 2, "halted": 3}

# per-tenant attribution counters: attribute suffix -> family name
_TENANT_COUNTERS = (
    ("submitted", "serving_tenant_submitted"),
    ("completed", "serving_tenant_completed"),
    ("decode_tokens", "serving_tenant_decode_tokens"),
    ("sheds", "serving_tenant_sheds"),
    ("timed_out", "serving_tenant_timed_out"),
    ("rejects", "serving_tenant_rejects"),
    ("failed", "serving_tenant_failed"),
)


class ServingMetrics:
    """The engine's request lifecycle events aggregated into a registry."""

    def __init__(self, num_slots: int = 0, registry: Optional[MetricsRegistry] = None,
                 engine_label: Optional[str] = None, slo=None):
        self.num_slots = num_slots
        self.engine_label = engine_label
        if registry is not None:
            existing = registry.get(_COUNTERS[0][1])
            # a second unlabelled engine would merge its counters into the
            # first's; labelled engines each own a child of every family
            if existing is not None and not (
                    engine_label is not None and isinstance(existing, MetricFamily)
                    and existing.label_names == ("engine",)
                    and not existing.has_child(engine_label)):
                raise ValueError("registry already holds serving metrics (another "
                                 "ServingEngine registered into it) — pass a distinct "
                                 "engine_label= on every engine to share one registry via "
                                 "labeled families, or a distinct MetricsRegistry per engine")
        self.registry = registry if registry is not None else MetricsRegistry()
        self.view = (MetricsView(self.registry, ("engine",), (engine_label,))
                     if engine_label is not None else MetricsView(self.registry))
        view = self.view
        self._c = {attr: (view.counter(name), is_int) for attr, name, is_int in _COUNTERS}
        self._h_prefill = view.histogram("serving_prefill_latency_s",
                                         help="wall time of one successful prefill dispatch (s)")
        self._h_ttft = view.histogram("serving_ttft_s", help="submit -> first token (s)")
        self._h_tpot = view.histogram(
            "serving_tpot_s", help="per-request mean time per output token after the first (s)")
        self._h_queue_wait = view.histogram("serving_queue_wait_s",
                                            help="submit -> first admission (s)")
        self._h_restore_downtime = view.histogram(
            "serving_restore_downtime_s",
            help="snapshot -> restore_serving_state clock gap (s): how long a warm-restarted "
                 "replica's work was dark")
        self._h_spill_batch = view.histogram("serving_kv_spill_batch_pages",
                                             help="pages moved device->host per spill event")
        self._h_prefetch_batch = view.histogram(
            "serving_kv_spill_prefetch_batch_pages",
            help="pages moved host->device per prefetch event")
        self._f_hit_tier = view.family("counter", "serving_prefix_hit_tier", labels=("tier",),
                                       help="prefix hits by residency tier of the matched entry")
        self._hbm_ref = None
        self._programs_ref = None
        self._g_cursor = view.gauge("serving_cursor_high_water",
                                    help="highest shared cache cursor seen")
        self._g_peak_occupancy = view.gauge("serving_peak_occupancy",
                                            help="most slots held at one chunk's dispatch")
        self._g_peak_pages = view.gauge("serving_peak_pages_mapped",
                                        help="most pool pages mapped at one chunk's dispatch")
        self._g_health = view.gauge("serving_health", help="0=ok 1=degraded 2=draining 3=halted")
        self._g_health.set_fn(lambda: _HEALTH_CODES.get(self.health, -1))
        # per-tenant families (engine + tenant labels on a labelled engine);
        # children appear per tenant at first use
        self._tc: Dict[str, MetricFamily] = {attr: view.family("counter", name)
                                             for attr, name in _TENANT_COUNTERS}
        self._th_ttft = view.family("histogram", "serving_tenant_ttft_s",
                                    help="submit -> first token per tenant (s)")
        self._th_tpot = view.family("histogram", "serving_tenant_tpot_s",
                                    help="per-request mean time per output token per tenant (s)")
        self._th_queue_wait = view.family("histogram", "serving_tenant_queue_wait_s",
                                          help="submit -> first admission per tenant (s)")
        self._tenants_seen = set()
        if slo is not None and not isinstance(slo, SLOTracker):
            slo = SLOTracker(slo, registry=self.registry, prefix="serving_slo", view=view)
        self.slo: Optional[SLOTracker] = slo
        self.spec = SpecStats(self.registry, prefix="spec", view=view)
        view.gauge("serving_num_slots").set(num_slots)
        self.health = "ok"  # the engine's mirror of ServingEngine.health()
        self.cursor_high_water = self.peak_occupancy = self.peak_pages_mapped = 0
        self._requests: Dict[int, dict] = {}

    def __getattr__(self, name):
        # counter attributes (``metrics.steps``) read through to the
        # registry; consulted only when no instance attribute exists
        c = self.__dict__.get("_c")
        if c is not None and name in c:
            counter, is_int = c[name]
            return int(counter.value) if is_int else float(counter.value)
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def _inc(self, attr: str, n=1) -> None:
        self._c[attr][0].inc(n)

    def _tenant_inc(self, attr: str, tenant: str, n=1) -> None:
        self._tenants_seen.add(tenant)
        self.view.child(self._tc[attr], tenant).inc(n)

    def _tenant_observe(self, family: MetricFamily, tenant: str, value: float) -> None:
        self._tenants_seen.add(tenant)
        self.view.child(family, tenant).observe(value)

    # --- request lifecycle --------------------------------------------------

    def record_submit(self, req, now: float) -> None:
        tenant = req.tenant
        self._requests[req.rid] = {
            "rid": req.rid, "prompt_len": int(len(req.prompt)), "submit_time": now,
            "tenant": tenant, "priority": req.priority,
        }
        self._tenant_inc("submitted", tenant)
        if self.slo is not None:
            # goodput's span starts at the first submit
            self.slo.touch(now)

    def record_adopt(self, req, now: float) -> None:
        """A request taken over from another engine (``adopt``, or
        ``restore_serving_state`` for each request; JAX ``record_adopt``,
        ``metrics.py:328``): bookkeeping only, keyed to its ORIGINAL submit
        time so its latencies span its whole life (the submit was counted
        where it happened); a first token streamed there keeps its TTFT out
        of this engine's histograms but times the decode span here."""
        self._requests[req.rid] = {
            "rid": req.rid, "prompt_len": int(len(req.prompt)),
            "submit_time": req.submit_time if req.submit_time is not None else now,
            "tenant": req.tenant, "priority": req.priority,
        }
        if req.first_token_time is not None:
            self._requests[req.rid]["first_token_time"] = req.first_token_time
        if self.slo is not None:
            self.slo.touch(now)

    def record_restore(self, n_requests: int, downtime_s: float) -> None:
        """A warm restart (JAX ``record_restore``): how many requests
        ``restore_serving_state`` brought back and how long they were dark."""
        if n_requests:
            self._inc("restored", n_requests)
        self._h_restore_downtime.observe(float(downtime_s))

    def record_admit(self, req, now: float) -> None:
        r = self._requests[req.rid]
        # re-admissions after preemption keep the first queue wait
        r.setdefault("admit_time", now)
        if "queue_wait" not in r:
            r["queue_wait"] = now - r["submit_time"]
            self._h_queue_wait.observe(r["queue_wait"])
            self._tenant_observe(self._th_queue_wait, req.tenant, r["queue_wait"])
        self._inc("prefills")

    def record_first_token(self, req, now: float) -> None:
        r = self._requests[req.rid]
        r["first_token_time"] = now
        r["ttft"] = now - r["submit_time"]
        self._h_ttft.observe(r["ttft"])
        self._tenant_observe(self._th_ttft, req.tenant, r["ttft"])

    def record_finish(self, req, now: float) -> None:
        r = self._requests[req.rid]
        tenant = req.tenant
        r["finish_time"] = now
        r["latency"] = now - r["submit_time"]
        r["tokens"] = len(req.tokens)
        span = now - r.get("first_token_time", now)
        # tokens after the first are decode-step products
        r["decode_tokens_per_sec"] = (len(req.tokens) - 1) / span if span > 0 else 0.0
        # TPOT is undefined for a one-token request (an SLO TPOT bound then
        # passes); a zero span under a virtual clock observes 0
        tpot = span / (len(req.tokens) - 1) if len(req.tokens) > 1 else None
        if tpot is not None:
            self._h_tpot.observe(tpot)
            self._tenant_observe(self._th_tpot, tenant, tpot)
        r["preemptions"] = req.preemptions
        self._inc("completed")
        self._tenant_inc("completed", tenant)
        self._tenant_inc("decode_tokens", tenant, len(req.tokens))
        if self.slo is not None:
            # the one classification: requeued requests re-admit but never
            # re-finish
            r["slo_attained"] = self.slo.record_finish(tenant, r.get("ttft"), tpot,
                                                       len(req.tokens), now)

    def record_cancel(self, req, now: float) -> None:
        # a cancellation is neither attained nor violated
        r = self._requests.get(req.rid)
        if r is not None:
            r["cancel_time"] = now
        self._inc("cancelled")

    def record_preemption(self) -> None:
        self._inc("preemptions")

    def record_reject(self, queue_depth: int, reason: str, tenant: str = "default",
                      now: Optional[float] = None) -> None:
        """A submission refused at the door (queue full, draining, halted,
        or unplaceable): no Request exists, so the tenant and the clock come
        in directly. A reject is an SLO violation: shedding a tenant's load
        must not read as improving its attainment."""
        self._inc("rejects")
        self._tenant_inc("rejects", tenant)
        if self.slo is not None:
            self.slo.record_violation(tenant, now, reason="reject")

    # --- faults -------------------------------------------------------------

    def record_shed(self, req, now: float, where: str) -> None:
        """A request timed out: ``where`` is ``"queue"`` (shed before any
        prefill) or ``"inflight"`` (its deadline hit at a chunk boundary)."""
        tenant = req.tenant
        r = self._requests.get(req.rid)
        if r is not None:
            r["finish_time"] = now
            r["timed_out"] = True
            r["shed_where"] = where
            r["tokens"] = len(req.tokens)
        self._inc("sheds")
        self._inc("timed_out")
        self._tenant_inc("sheds", tenant)
        self._tenant_inc("timed_out", tenant)
        if self.slo is not None:
            # tokens a shed request streamed are wasted work, never goodput
            self.slo.record_violation(tenant, now, reason=f"shed_{where}",
                                      tokens=len(req.tokens))

    def record_failed(self, req, now: float, kind: str = "engine") -> None:
        """A request the engine failed for cause (``req.error`` says why):
        ``kind`` is ``"prefill"`` or ``"quarantine"``."""
        tenant = req.tenant
        r = self._requests.get(req.rid)
        if r is not None:
            r["finish_time"] = now
            r["failed"] = True
            r["failed_kind"] = kind
        self._inc("failed")
        self._tenant_inc("failed", tenant)
        if kind == "prefill":
            self._inc("prefill_failures")
        if self.slo is not None:
            self.slo.record_violation(tenant, now, reason=f"failed_{kind}",
                                      tokens=len(req.tokens))

    def record_quarantine(self) -> None:
        self._inc("quarantines")

    def record_page_quarantine(self) -> None:
        """A poisoned pool page was retired (its holders requeued)."""
        self._inc("page_quarantines")

    def record_dispatch_retry(self) -> None:
        self._inc("dispatch_retries")

    def record_recovery(self) -> None:
        self._inc("recoveries")

    def record_spec_fallback(self) -> None:
        """A speculative dispatch failed and its chunk was decoded with the
        plain step instead."""
        self.spec.record_fallback()

    # --- prefix cache -------------------------------------------------------

    def record_prefix_hit(self, matched: int, tier: str = "device") -> None:
        """An admission reused ``matched`` stored prefix tokens (only the
        tail was prefilled); ``tier`` is where the entry's pages lived when
        the hit was planned: ``"device"`` or ``"host"`` (spilled and
        prefetched back)."""
        self._inc("prefix_hits")
        self._inc("prefix_tokens_reused", matched)
        self.view.child(self._f_hit_tier, tier).inc()

    def record_prefix_miss(self) -> None:
        self._inc("prefix_misses")

    def record_prefix_eviction(self, n: int = 1) -> None:
        self._inc("prefix_evictions", n)

    def record_prefix_validation_failure(self) -> None:
        """A stored entry failed its reuse-time validation: it was evicted
        and the admission fell back to a full prefill."""
        self._inc("prefix_validation_failures")

    def record_prefix_pages_shared(self, n: int) -> None:
        """A paged hit mapped ``n`` pool pages copy-on-write into the
        admitted slot's block table (zero KV bytes copied)."""
        self._inc("prefix_pages_shared", n)

    # --- the host page tier -------------------------------------------------

    def record_spill(self, pages: int, nbytes: int) -> None:
        """The reclaim valve moved a cold entry's ``pages`` pages
        (``nbytes``) to the host tier in one batched copy."""
        self._inc("kv_pages_spilled", pages)
        self._inc("kv_spill_bytes", nbytes)
        self._h_spill_batch.observe(float(pages))

    def record_spill_failure(self) -> None:
        """A spill failed: the entry degraded to plain eviction."""
        self._inc("kv_spill_failures")

    def record_prefetch(self, pages: int, nbytes: int, late: bool = False) -> None:
        """``pages`` host pages were written back to the pool; ``late``: at
        the admission itself, the queue pre-pass having missed it."""
        self._inc("kv_pages_prefetched", pages)
        self._inc("kv_prefetch_bytes", nbytes)
        if late:
            self._inc("kv_prefetch_late")
        self._h_prefetch_batch.observe(float(pages))

    def record_prefetch_failure(self) -> None:
        """A prefetch failed: the entry was dropped, the admission fell back
        to a full prefill."""
        self._inc("kv_prefetch_failures")

    def record_prefetch_wasted(self, pages: int) -> None:
        """``pages`` prefetched pages were evicted before any request used
        them."""
        self._inc("kv_prefetch_wasted", pages)

    def record_host_page_poisoned(self, n: int = 1) -> None:
        """A host-tier fetch was rejected: a page failed its CRC."""
        self._inc("kv_host_poisoned", n)

    def attach_programs(self, programs) -> None:
        """Wire the engine's program ledger into ``snapshot()["programs"]``
        (JAX ``attach_device_efficiency``, ``metrics.py:281``; a weak
        reference: kept metrics never pin a retired engine)."""
        self._programs_ref = weakref.ref(programs) if programs is not None else None

    def attach_hbm(self, hbm) -> None:
        """Wire the engine's HBM ledger into ``snapshot()["hbm"]`` (a weak
        reference: kept metrics never pin a retired engine)."""
        self._hbm_ref = weakref.ref(hbm) if hbm is not None else None

    def record_prefill_wall(self, seconds: float, kind: str = "full") -> None:
        """Wall time of one prefill, ``kind`` ``"full"`` or ``"suffix"`` (a
        prefix hit's)."""
        self._h_prefill.observe(seconds)
        self._inc(f"prefill_{kind}_wall_s", seconds)
        self._inc(f"prefill_{kind}_count")

    # --- decode -------------------------------------------------------------

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
        self._inc("chunks")
        self._inc("steps", steps)
        self._inc("executed_steps", executed)
        self._inc("decode_tokens", tokens)
        self._inc("occupied_slot_steps", active_slots * steps)
        if active_slots > self.peak_occupancy:
            self.peak_occupancy = active_slots
            self._g_peak_occupancy.set(active_slots)
        if cursor > self.cursor_high_water:
            self.cursor_high_water = cursor
            self._g_cursor.set(cursor)
        self._inc("decode_dispatch_s", dispatch_s)
        self._inc("decode_readback_s", readback_s)
        self._inc("graph_replays", replays)
        for a in spec_accepts or ():
            self.spec.record_round(a, gamma)

    def record_capture(self, seconds: float) -> None:
        """A decode-program capture and its wall (warm-up included), kept
        out of the chunk walls."""
        self._inc("decode_captures")
        self._inc("capture_s", seconds)

    def record_pages_mapped(self, pages: int) -> None:
        """Pool pages mapped at a paged chunk's dispatch."""
        if pages > self.peak_pages_mapped:
            self.peak_pages_mapped = pages
            self._g_peak_pages.set(pages)

    # --- export -------------------------------------------------------------

    @property
    def prefill_count(self) -> int:
        """Successful prefills (full and suffix)."""
        return self._h_prefill.count

    @property
    def prefill_wall_s(self) -> float:
        return float(self._h_prefill.sum)

    @property
    def mean_occupancy(self) -> float:
        """Mean slots held a used decode step."""
        return self.occupied_slot_steps / self.steps if self.steps else 0.0

    def request_snapshot(self, rid: int) -> dict:
        """One request's recorded fields."""
        return dict(self._requests.get(rid, {}))

    def _tenant_child_value(self, attr: str, tenant: str) -> int:
        fam = self._tc[attr]
        return int(self.view.child(fam, tenant).value) if self.view.has_child(fam, tenant) else 0

    def _tenant_hist(self, family: MetricFamily, tenant: str):
        """A tenant's histogram child, or None (never created by a read)."""
        return self.view.child(family, tenant) if self.view.has_child(family, tenant) else None

    def tenant_latency(self, kind: str, tenant: str, q: float) -> float:
        """One tenant's live latency quantile (``kind`` ``"ttft"``,
        ``"tpot"`` or ``"queue_wait"``): the SLO policy's early warning, host
        arithmetic over bucket counts; 0.0 for a tenant with no sample."""
        fam = {"ttft": self._th_ttft, "tpot": self._th_tpot,
               "queue_wait": self._th_queue_wait}[kind]
        h = self._tenant_hist(fam, tenant)
        return float(h.percentile(q)) if h is not None else 0.0

    def tenant_snapshot(self) -> Dict[str, dict]:
        """Per-tenant attribution counters and latency percentiles,
        tenant-sorted; creates no empty series."""
        out: Dict[str, dict] = {}
        for tenant in sorted(self._tenants_seen):
            row = {attr: self._tenant_child_value(attr, tenant) for attr, _ in _TENANT_COUNTERS}
            for key, fam in (("ttft", self._th_ttft), ("tpot", self._th_tpot)):
                h = self._tenant_hist(fam, tenant)
                for q in (50, 95, 99):
                    row[f"{key}_p{q}_s"] = h.percentile(q / 100.0) if h is not None else 0.0
            h = self._tenant_hist(self._th_queue_wait, tenant)
            row["queue_wait_p95_s"] = h.percentile(0.95) if h is not None else 0.0
            out[tenant] = row
        return out

    def snapshot(self) -> dict:
        reqs = self._requests.values()
        done = [r for r in reqs if "latency" in r]
        ttfts = [r["ttft"] for r in reqs if "ttft" in r]
        waits = [r["queue_wait"] for r in reqs if "queue_wait" in r]
        wall = self.decode_dispatch_s + self.decode_readback_s
        hits, misses = self.prefix_hits, self.prefix_misses
        hbm = self._hbm_ref() if self._hbm_ref is not None else None
        programs = self._programs_ref() if self._programs_ref is not None else None
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
            "restored": self.restored,
            "restore_downtime_p95_s": self._h_restore_downtime.percentile(0.95),
            "quarantines": self.quarantines,
            "page_quarantines": self.page_quarantines,
            "dispatch_retries": self.dispatch_retries,
            "recoveries": self.recoveries,
            "prefill_failures": self.prefill_failures,
            "health": self.health,
            "prefill_count": self.prefill_count,
            "prefill_wall_s": self.prefill_wall_s,
            "prefill_mean_s": self._h_prefill.mean,
            "prefill_p95_s": self._h_prefill.percentile(0.95),
            "prefill_full_wall_s": self.prefill_full_wall_s,
            "prefill_suffix_wall_s": self.prefill_suffix_wall_s,
            "prefill_full_count": self.prefill_full_count,
            "prefill_suffix_count": self.prefill_suffix_count,
            "prefix_hits": hits,
            "prefix_misses": misses,
            "prefix_hit_rate": hits / (hits + misses) if hits + misses else 0.0,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "prefix_evictions": self.prefix_evictions,
            "prefix_validation_failures": self.prefix_validation_failures,
            "prefix_pages_shared": self.prefix_pages_shared,
            "kv_pages_spilled": self.kv_pages_spilled,
            "kv_spill_bytes": self.kv_spill_bytes,
            "kv_spill_failures": self.kv_spill_failures,
            "kv_pages_prefetched": self.kv_pages_prefetched,
            "kv_prefetch_bytes": self.kv_prefetch_bytes,
            "kv_prefetch_late": self.kv_prefetch_late,
            "kv_prefetch_wasted": self.kv_prefetch_wasted,
            "kv_prefetch_failures": self.kv_prefetch_failures,
            "kv_host_poisoned": self.kv_host_poisoned,
            "prefix_hit_tier": {tier: int(self.view.child(self._f_hit_tier, tier).value)
                                for tier in ("device", "host")
                                if self.view.has_child(self._f_hit_tier, tier)},
            "cursor_high_water": self.cursor_high_water,
            "mean_occupancy": self.mean_occupancy,
            "peak_occupancy": self.peak_occupancy,
            "peak_pages_mapped": self.peak_pages_mapped,
            "mean_ttft": _mean(ttfts),
            "max_ttft": max(ttfts) if ttfts else 0.0,
            "mean_queue_wait": _mean(waits),
            "mean_latency": _mean([r["latency"] for r in done]),
            "mean_decode_tokens_per_sec": _mean([r["decode_tokens_per_sec"] for r in done]),
            "ttft_p50_s": self._h_ttft.percentile(0.50),
            "ttft_p95_s": self._h_ttft.percentile(0.95),
            "ttft_p99_s": self._h_ttft.percentile(0.99),
            "tpot_p50_s": self._h_tpot.percentile(0.50),
            "tpot_p95_s": self._h_tpot.percentile(0.95),
            "tpot_p99_s": self._h_tpot.percentile(0.99),
            "queue_wait_p95_s": self._h_queue_wait.percentile(0.95),
            "tenants": self.tenant_snapshot(),
            # the program ledger (dispatches, compiles, metered cost, walls)
            # and the HBM ledger: {} when no engine attached them
            "programs": programs.snapshot() if programs is not None else {},
            "hbm": hbm.snapshot() if hbm is not None else {},
            **({"slo": self.slo.snapshot()} if self.slo is not None else {}),
            **self.spec.snapshot(),
        }
