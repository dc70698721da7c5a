"""Disaggregated prefill and decode (counterpart of
``neuronx_distributed_tpu/serving/disagg.py``: ``PrefillWorker`` and
``DisaggregatedServer``).

A coupled engine runs prefill inside its serving loop: at a chunk boundary
it admits a whole selection round and pays every prefill before the next
decode chunk dispatches, so under bursty arrivals the decoding requests
stall behind a queue of prompt prefills. Here the two phases split:

* :class:`PrefillWorker` runs the prefills of the decode engine's model, a
  fault domain of its own. It runs them eagerly over the served module (the
  prefill kernel, K1, on the card), as the coupled engine does; there is no
  per-bucket program, and ``prefill_compilations`` counts the distinct
  padded lengths it has run, as the JAX worker's jit cache does.
* :class:`DisaggregatedServer` fronts a PAGED decode engine
  (``engine.external_prefill = True``: the engine never admits from its
  queue): it takes queued requests, prefills them on the workers (at most
  ``prefills_per_step`` a step, the bound on prefill time between two
  decode chunks) and hands each context to the engine as a PAGE-TABLE
  handoff.

On a shared pool the worker stages the context's pages directly in the
decode engine's pool (``PagedCacheManager.stage_context``, through a
scratch block-table row of the worker's own) and ``engine.admit_staged``
binds them to a slot by mapping alone: no KV byte moves,
``PageAllocator.copy_bytes`` stays 0. With DISTINCT pools the worker stages
in a pool of its own and ``export_pages``/``import_pages`` copy the pages
across, charged to ``copy_bytes``.

Faults: a worker whose prefill raises leaves the rotation and its request
falls back to a COUPLED prefill on the decode engine (with no worker left
the engine admits by itself again); a failed handoff
(``FaultInjector.fail_handoff``, a message the transport gave up on, a
staged context voided by recovery) releases the staged pages and falls back
the same way. A CUDA or kernel error is not a worker fault: it raises out of
``step()``. With ``transport=`` every prefill-to-decode interaction (the
handoff, the page export and import) is a message on the fabric's seam,
retried and deduplicated by ``(rid, seq)``. The server speaks the router's
replica surface, so it can stand behind a ``ReplicaRouter``."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from neuronx_distributed_tpu_torch.inference.generate import pack_padded_prompt, serving_clones
from neuronx_distributed_tpu_torch.inference.utils import unwrap_logits
from neuronx_distributed_tpu_torch.serving.engine import _FATAL, ServingEngine, _bucket
from neuronx_distributed_tpu_torch.serving.paging import PagedCacheManager, StagedContext
from neuronx_distributed_tpu_torch.serving.scheduler import Request, RequestState


class PrefillWorker:
    """One prefill worker over the decode engine's model, staging results in
    ``pool`` (the decode engine's pool on the shared-pool path, the worker's
    own on the distinct-pool path)."""

    def __init__(self, model, pool: PagedCacheManager, label: str = "prefill0",
                 fault_injector=None):
        self.label = label
        self._prefill_model, _ = serving_clones(model)
        self.pool = pool
        self._faults = fault_injector
        self._row = None  # the scratch block-table row, made at the first prefill
        self._lengths: set = set()
        self.calls = 0

    @torch.no_grad()
    def prefill(self, req: Request, max_seq_len: int):
        """Prefill ``req``'s context at its bucket and stage it in
        ``pool``. Returns ``(staged, logits)``: the handoff unit and the
        last-token logits the decode side samples the first token from.
        Raises whatever the prefill raises (the server's worker-failure
        path), the staged pages released."""
        call = self.calls
        self.calls += 1
        if self._faults is not None:
            self._faults.on_prefill(call)
        ctx = req.context_ids
        p = len(ctx)
        padded = _bucket(p, max_seq_len, req.remaining_new_tokens)
        if self._row is None:
            self._row = self.pool.staging_row()
        staged, view = self.pool.stage_context(self._row, p, padded)
        try:
            ids, mask = pack_padded_prompt(ctx, padded)
            dev = self.pool.cache.k.device
            logits = unwrap_logits(self._prefill_model(
                torch.from_numpy(ids).to(dev, torch.int64), cache=view,
                padding_mask=torch.from_numpy(mask).to(dev), last_only=True))[0, -1]
        except BaseException:
            self.pool.release_staged(staged)
            raise
        self._lengths.add(padded)
        return staged, logits

    @property
    def prefill_compilations(self) -> int:
        """Distinct padded lengths prefilled (JAX: the bucketed programs
        compiled)."""
        return len(self._lengths)


class DisaggregatedServer:
    """Prefill/decode disaggregation over one paged decode engine, with the
    engine's ``submit``/``step``/``run`` surface (and ``metrics``,
    ``scheduler``, ``_clock`` for the traffic replay), so a coupled and a
    disaggregated run swap one object."""

    def __init__(self, engine: ServingEngine, n_workers: int = 1, prefills_per_step: int = 1,
                 shared_pool: bool = True, fault_injector=None, transport=None):
        if engine._page_size is None:
            raise ValueError("disaggregation needs a PAGED decode engine (kv_page_size=) — the "
                             "handoff is a block-table operation")
        if engine.draft_model is not None:
            raise ValueError("disaggregation does not speak speculative engines yet (the draft "
                             "cache would need its own handoff)")
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if prefills_per_step < 1:
            raise ValueError(f"prefills_per_step must be >= 1, got {prefills_per_step}")
        self.engine = engine
        self.shared_pool = shared_pool
        self.prefills_per_step = prefills_per_step
        self._faults = fault_injector
        self.transport = transport
        engine.external_prefill = True
        kv_quant = "int8" if engine.cache.cache.quantized else None
        self.workers: List[PrefillWorker] = []
        for i in range(n_workers):
            pool = engine.cache if shared_pool else PagedCacheManager.for_model(
                engine.model, 1, engine._page_size, engine.cache.alloc.num_pages,
                kv_quant=kv_quant)
            self.workers.append(PrefillWorker(engine.model, pool, label=f"prefill{i}",
                                              fault_injector=fault_injector))
        self._rotation = 0
        # completed prefills awaiting a handoff: (request, staged, logits)
        self._pending: List[tuple] = []
        self._handoff_attempts = 0
        self.stats: Dict[str, int] = dict.fromkeys((
            "prefills", "handoffs", "handoff_failures", "worker_failures", "coupled_fallbacks",
            "imported_contexts"), 0)

    # --- the engine's surface (traffic replay) ------------------------------

    @property
    def metrics(self):
        return self.engine.metrics

    @property
    def scheduler(self):
        return self.engine.scheduler

    @property
    def _clock(self):
        return self.engine._clock

    def health(self):
        return self.engine.health()

    def submit(self, *args, **kwargs) -> Request:
        return self.engine.submit(*args, **kwargs)

    @property
    def has_work(self) -> bool:
        return bool(self._pending) or self.engine.has_work

    # --- the router's replica surface ---------------------------------------

    @property
    def prefix(self):
        return self.engine.prefix

    @property
    def flight(self):
        return self.engine.flight

    @property
    def _on_token(self):
        return self.engine._on_token

    @property
    def _next_rid(self):
        return self.engine._next_rid

    def load_score(self, tenant: Optional[str] = None) -> float:
        return self.engine.load_score(tenant=tenant)

    def page_pressure(self) -> float:
        return self.engine.page_pressure()

    def adopt(self, req: Request, on_token=None) -> Request:
        return self.engine.adopt(req, on_token=on_token)

    def release_queued(self, rid: int):
        return self.engine.release_queued(rid)

    def drain(self) -> None:
        self.engine.drain()

    def resume(self) -> None:
        self.engine.resume()

    def fence(self, reason: str = "fenced") -> None:
        """The engine's kill switch, handoff-aware: contexts prefilled but
        not yet admitted release their staged pages and their requests
        rejoin the queue first, so the fenced queue (what a router re-homes)
        holds every unfinished request."""
        pending, self._pending = self._pending, []
        for req, staged, _ in pending:
            self._release(staged, self.engine.cache)
            if not req.finished:
                self.engine.scheduler.requeue_front([req])
        self.engine.fence(reason)

    # --- the transport seam -------------------------------------------------

    def _send(self, target: str, op: str, fn, rid: int = -1):
        """One prefill/decode interaction over the transport (retries and
        ``(rid, seq)`` dedup), or a direct call without one."""
        if self.transport is None:
            return fn()
        return self.transport.call(target, op, fn, rid=rid)

    # --- the serving loop ---------------------------------------------------

    def _coupled_fallback(self, req: Request, now: float) -> None:
        """Prefill ``req`` on the DECODE engine's own coupled path, the
        program a coupled engine runs; with no free slot it requeues."""
        self.stats["coupled_fallbacks"] += 1
        if req.finished:
            return
        if self.engine.cache.free_slots == 0:
            self.engine.scheduler.requeue_front([req])
            return
        self.engine._prefill_into_slot(req, self.engine.cache.acquire(), now)

    @staticmethod
    def _release(staged: Optional[StagedContext], pool) -> None:
        if staged is not None and staged.page_ids:
            pool.release_staged(staged)

    def _try_handoffs(self, now: float) -> None:
        still: List[tuple] = []
        for req, staged, logits in self._pending:
            if req.finished:  # cancelled or shed while pending
                self._release(staged, self.engine.cache)
                continue
            if req.deadline is not None and now >= req.deadline:
                self._release(staged, self.engine.cache)
                req.state = RequestState.TIMED_OUT
                req.error = "deadline exceeded awaiting handoff"
                req.finish_time = now
                self.engine.metrics.record_shed(req, now, where="queue")
                self.engine.tracer.end(req.rid, "shed",
                                       args={"where": "handoff", "tenant": req.tenant})
                continue
            attempt = self._handoff_attempts
            self._handoff_attempts += 1
            try:
                if self._faults is not None:
                    self._faults.on_handoff(attempt)
                admitted = self._send(
                    "decode", "handoff",
                    lambda r=req, s=staged, lg=logits: self.engine.admit_staged(r, s, lg, now),
                    rid=req.rid)
            except _FATAL:
                raise
            except Exception:
                # an injected handoff failure, a message the transport gave
                # up on, or a staging voided by recovery: nothing is
                # half-mapped; release the pages and prefill coupled
                self.stats["handoff_failures"] += 1
                self._release(staged, self.engine.cache)
                self._coupled_fallback(req, now)
                continue
            if admitted:
                self.stats["handoffs"] += 1
            else:
                still.append((req, staged, logits))
        self._pending = still

    def _run_prefills(self, now: float) -> None:
        if not self.workers:
            return
        budget = self.prefills_per_step
        while budget > 0 and self.engine.scheduler.queued > 0:
            pending_tokens = sum(r.token_footprint for r, _, _ in self._pending)
            selected = self.engine.scheduler.select(
                1, self.engine._in_flight_tokens() + pending_tokens, fits=None)
            if not selected:
                break
            req = selected[0]
            budget -= 1
            worker = self.workers[self._rotation % len(self.workers)]
            self._rotation += 1
            try:
                staged, logits = worker.prefill(req, self.engine.max_seq_len)
            except _FATAL:
                raise
            except Exception:
                # the worker leaves the rotation and this request prefills
                # coupled; losing the last worker makes the engine admit by
                # itself again: a coupled engine, never an outage
                self.stats["worker_failures"] += 1
                self.workers.remove(worker)
                if not self.workers:
                    self.engine.external_prefill = False
                self._coupled_fallback(req, now)
                continue
            if not self.shared_pool:
                # distinct pools: an explicit copy, charged to the decode
                # pool's copy_bytes; a failed transfer is a HANDOFF failure
                # (the worker is healthy) and the request prefills coupled
                try:
                    exported = self._send("prefill", "page_export",
                                          lambda w=worker, s=staged: w.pool.export_pages(s),
                                          rid=req.rid)
                except _FATAL:
                    raise
                except Exception:
                    self._release(staged, worker.pool)
                    self.stats["handoff_failures"] += 1
                    self._coupled_fallback(req, now)
                    continue
                self._release(staged, worker.pool)
                try:
                    staged = self._send("decode", "page_import",
                                        lambda e=exported: self.engine.cache.import_pages(e),
                                        rid=req.rid)
                except _FATAL:
                    raise
                except Exception:
                    self.stats["handoff_failures"] += 1
                    self._coupled_fallback(req, now)
                    continue
                self.stats["imported_contexts"] += 1
            self.stats["prefills"] += 1
            self._pending.append((req, staged, logits))

    def step(self) -> bool:
        """One iteration: bind the completed handoffs (page-table writes),
        run the decode engine's step (its chunk never waits for a prefill),
        then at most ``prefills_per_step`` worker prefills."""
        now = self.engine._now()
        self._try_handoffs(now)
        self.engine.step()
        self._run_prefills(self.engine._now())
        return self.has_work

    def run(self, max_steps: int = 1_000_000) -> Dict[int, Request]:
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        return dict(self.engine.scheduler.requests)

    def snapshot(self) -> dict:
        return {
            "disagg": {**self.stats, "workers_live": len(self.workers),
                       "pending_handoffs": len(self._pending),
                       "copy_bytes": self.engine.cache.alloc.copy_bytes},
            "engine": self.engine.metrics.snapshot(),
        }
