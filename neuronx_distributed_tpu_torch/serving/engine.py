"""Continuous-batching serving engine (counterpart of
``neuronx_distributed_tpu/serving/engine.py``, its core: row-per-slot cache,
FIFO scheduling, conservative or eager admission).

A host loop interleaves prefill of admitted requests with fused decode
chunks over all ``num_slots`` slots:

* Per-slot decode state (pending token, request seed, tokens emitted, active
  mask, sampling sentinels, remaining budget, EOS id) lives on the device in
  ``self._state`` and is updated in place; the host writes a slot's row only
  at admission and release.
* The KV cache is one :class:`KVCache` of ``(num_slots, max_seq_len)`` rows,
  updated in place (the JAX engine donates it to the same effect).
* ``decode_chunk_size`` decode steps run between two host reads
  (:func:`~neuronx_distributed_tpu_torch.inference.generate.
  chunked_decode_step`): EOS/budget freezing happens on the device and the
  host pays ONE read per steady chunk — the (chunk, slots) token block with
  the per-slot counts. Every device→host read goes through
  :meth:`ServingEngine._host_read`, which counts them (``host_reads``):
  one per admitted fresh request (its first token), one per chunk.

Token-stream fidelity: a request served here yields exactly the tokens of a
solo ``generate(prompt, seed=...)`` — the same prefill math (left padding),
the same per-token sampling stream (counter-based on the request seed and
token index), for every chunk size and across preemption and resume.

Cache capacity: slots share one write cursor (``serving/cache_manager.py``)
that advances each decode step while any slot is active.
``admission="conservative"`` admits a request only when its whole remaining
generation fits under the cursor; ``"eager"`` admits whenever the prefill
fits and, at the wall, preempts every active request (keeping its tokens),
rewinds the cache and resumes them by re-prefilling their context.

Left out of this slice (not accepted, not silently ignored): paging, the
prefix cache, speculation, quantization, tp/mesh, fault injection, SLO
scheduling, ledgers and profiling.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.inference.generate import (
    GenerationConfig,
    chunked_decode_step,
    pack_padded_prompt,
    serving_clones,
    validate_generate_args,
)
from neuronx_distributed_tpu_torch.inference.utils import unwrap_logits
from neuronx_distributed_tpu_torch.serving.cache_manager import SlotCacheManager
from neuronx_distributed_tpu_torch.serving.metrics import ServingMetrics
from neuronx_distributed_tpu_torch.serving.scheduler import (
    Request,
    RequestState,
    Scheduler,
)
from neuronx_distributed_tpu_torch.utils.sampling import sample_row


class RejectedError(RuntimeError):
    """A submission refused by the bounded queue; ``queue_depth`` is the
    occupancy at rejection time."""

    def __init__(self, message: str, queue_depth: int = 0):
        super().__init__(message)
        self.queue_depth = queue_depth


def _config_sentinels(cfg: GenerationConfig):
    """(temperature, top_k, top_p) with the per-row sampler's sentinels:
    top_k <= 0 and top_p >= 1 disable the filters."""
    return (
        float(cfg.temperature),
        int(cfg.top_k if cfg.top_k is not None else 0),
        float(cfg.top_p if cfg.top_p is not None else 1.0),
    )


def _bucket(p: int, max_seq_len: int, remaining: int, floor: int = 8) -> int:
    """Padded prefill length for a p-token context: next power of two,
    clamped so the padded prompt still leaves room for the remaining
    generation (falling back to the exact length)."""
    b = max(floor, 1 << max(p - 1, 0).bit_length())
    b = min(b, max_seq_len)
    if b < p or b + remaining > max_seq_len:
        b = p
    return b


class ServingEngine:
    """Slot-based continuous batching over a causal LM whose weights live on
    its device (``model.device``); every tensor the engine makes lives there
    too."""

    def __init__(
        self,
        model,
        num_slots: int,
        max_tokens_in_flight: Optional[int] = None,
        admission: str = "conservative",
        scheduling: str = "fifo",
        decode_chunk_size: int = 8,
        max_queue: Optional[int] = None,
    ):
        if admission not in ("conservative", "eager"):
            raise ValueError(f"unknown admission policy {admission!r}")
        # kept to match the JAX signature; this port has one policy
        if scheduling != "fifo":
            raise ValueError(f"unknown scheduling policy {scheduling!r} (this port has 'fifo')")
        if decode_chunk_size < 1:
            raise ValueError(f"decode_chunk_size must be >= 1, got {decode_chunk_size}")
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.max_seq_len = model.config.max_seq_len
        self.admission = admission
        self.decode_chunk_size = decode_chunk_size
        self.max_queue = max_queue
        self._prefill_model, self._decode_model = serving_clones(model)
        self.scheduler = Scheduler(max_tokens_in_flight)
        self.cache = SlotCacheManager(num_slots, model.new_cache(num_slots))
        self.metrics = ServingMetrics(num_slots)
        self._active = np.zeros((num_slots,), bool)
        self._slot_req: List[Optional[Request]] = [None] * num_slots
        self._next_rid = 0
        self._state = self._fresh_slot_state()
        self._decode_chunk = chunked_decode_step(
            self._decode_model, decode_chunk_size, self.max_seq_len
        )
        self.host_reads = 0

    def _fresh_slot_state(self):
        b, dev = self.num_slots, self.device
        z = lambda dt, v=0: torch.full((b,), v, dtype=dt, device=dev)  # noqa: E731
        return {
            "tok": z(torch.int64), "seed": z(torch.int64), "ntok": z(torch.int64),
            "active": z(torch.bool, False), "remaining": z(torch.int64),
            "temp": z(torch.float32, 1.0), "topk": z(torch.int64),
            "topp": z(torch.float32, 1.0), "eos": z(torch.int64, -1),
        }

    def _host_read(self, t: torch.Tensor) -> np.ndarray:
        """THE device→host read of the engine (the ``jax.device_get`` of the
        JAX engine): every host view of device data goes through here, so
        ``host_reads`` counts them."""
        self.host_reads += 1
        return t.cpu().numpy()

    # --- public API ---------------------------------------------------------

    def submit(self, prompt_ids, config: GenerationConfig = GenerationConfig(),
               seed: Optional[int] = None) -> Request:
        """Enqueue one request; returns its live ``Request``. ``seed``
        (default: the request id) selects its sampling stream — pass the
        seed you would give ``generate`` to reproduce its stream. Raises
        :class:`RejectedError` when the bounded queue is full and
        ``ValueError`` for a request that could never be placed."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if config.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        validate_generate_args(self.model, prompt[None], config.max_new_tokens, None)
        budget = self.scheduler.max_tokens_in_flight
        if budget is not None and prompt.size + config.max_new_tokens > budget:
            raise ValueError(
                f"request footprint ({prompt.size + config.max_new_tokens}) "
                f"exceeds max_tokens_in_flight ({budget}); it could never be admitted"
            )
        depth = self.scheduler.queued
        if self.max_queue is not None and depth >= self.max_queue:
            self.metrics.record_reject()
            raise RejectedError(f"queue full ({depth} >= max_queue {self.max_queue})",
                                queue_depth=depth)
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, config=config,
                      seed=rid if seed is None else int(seed))
        req.submit_time = time.monotonic()
        self.scheduler.submit(req)
        self.metrics.record_submit(req, req.submit_time)
        return req

    def cancel(self, rid: int) -> bool:
        """Cancel a request. Queued: dropped now; running: its slot is
        reaped at the next step."""
        req = self.scheduler.get(rid)
        if req is None or req.finished:
            return False
        was_queued = req.slot is None
        ok = self.scheduler.cancel(rid)
        if ok and was_queued:
            self.metrics.record_cancel(req, time.monotonic())
        return ok

    @property
    def has_work(self) -> bool:
        return self.scheduler.queued > 0 or bool(self._active.any())

    def step(self) -> bool:
        """One iteration: reap cancellations → preempt/rewind if the cursor
        is out of room → admit+prefill → one decode chunk → retire finished
        slots. Returns whether work remains."""
        now = time.monotonic()
        self._reap_cancelled(now)
        if self._active.any() and self.cache.cursor + 1 > self.max_seq_len:
            self._preempt_all()
        if not self._active.any() and self.cache.cursor > 0:
            self.cache.reset()  # drained: the next wave starts at column 0
        self._admit(now)
        if self._active.any():
            self._decode_plain()
        return self.has_work

    def run(self, max_steps: int = 1_000_000) -> Dict[int, Request]:
        """Step until idle; returns every request this engine has seen."""
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        return dict(self.scheduler.requests)

    # --- admission ----------------------------------------------------------

    def _in_flight_tokens(self) -> int:
        return sum(r.token_footprint for r in self._slot_req if r is not None)

    def _admit(self, now: float) -> None:
        if self.cache.free_slots == 0 or self.scheduler.queued == 0:
            return
        proj = self.cache.cursor
        maxrem = max((r.remaining_new_tokens for r in self._slot_req if r is not None),
                     default=0)

        def fits(req: Request) -> bool:
            nonlocal proj, maxrem
            p = len(req.context_ids)
            target = max(proj, _bucket(p, self.max_seq_len, req.remaining_new_tokens))
            if self.admission == "conservative":
                # every slot steps together: the cursor ends at the admission
                # cursor plus the LONGEST remaining generation in flight
                if target + max(maxrem, req.remaining_new_tokens) > self.max_seq_len:
                    return False
            elif target + 1 > self.max_seq_len:
                return False  # eager: the prefill plus one decode step
            proj = target
            maxrem = max(maxrem, req.remaining_new_tokens)
            return True

        for req in self.scheduler.select(self.cache.free_slots,
                                         self._in_flight_tokens(), fits):
            self._prefill_into_slot(req, self.cache.acquire(), now)

    def _prefill_into_slot(self, req: Request, slot: int, now: float) -> None:
        ctx = req.context_ids
        padded = _bucket(len(ctx), self.max_seq_len, req.remaining_new_tokens)
        ids, mask = pack_padded_prompt(ctx, padded)
        t0 = time.monotonic()
        row = self.cache.admit(slot, padded)
        out = self._prefill_model(
            torch.from_numpy(ids).to(self.device, torch.int64), cache=row,
            padding_mask=torch.from_numpy(mask).to(self.device), last_only=True,
        )
        self.metrics.record_prefill_wall(time.monotonic() - t0)
        self._bind_slot(req, slot, unwrap_logits(out)[0, -1], now)

    def _bind_slot(self, req: Request, slot: int, logits: torch.Tensor, now: float) -> None:
        """Record the admission, sample a fresh request's first token (one
        host read) and activate the slot's device state."""
        self.metrics.record_admit(req, now)
        if req.admit_time is None:
            req.admit_time = now
        temp, topk, topp = _config_sentinels(req.config)
        if not req.tokens:
            tok0 = int(self._host_read(sample_row(logits, req.seed, 0, temp, topk, topp)))
            self._emit_token(req, tok0, time.monotonic(), first=True)
        req.state = RequestState.DECODE
        req.slot = slot
        self._slot_req[slot] = req
        eos = req.config.eos_token_id
        row = dict(tok=req.tokens[-1], seed=req.seed, ntok=len(req.tokens), active=True,
                   remaining=req.remaining_new_tokens, temp=temp, topk=topk, topp=topp,
                   eos=eos if eos is not None else -1)
        for name, value in row.items():
            self._state[name][slot] = value
        self._active[slot] = True
        # born finished: max_new_tokens == 1, or EOS as the first token
        self._maybe_finish(req, now)

    # --- decode -------------------------------------------------------------

    def _decode_plain(self) -> None:
        """One fused decode chunk, then ONE host read of the token block."""
        active_at_dispatch = int(self._active.sum())
        start = self.cache.cursor
        t0 = time.monotonic()
        toks, counts, executed = self._decode_chunk(self.cache.cache, self._state)
        t1 = time.monotonic()
        block = self._host_read(torch.cat([toks, counts[None]], dim=0))
        t2 = time.monotonic()
        toks, counts = block[:-1], block[-1]
        # steps that ran with at least one live slot; the rest were no-ops,
        # so the cursor lands where the JAX chunk's lax.cond leaves it
        used = int(counts.max())
        self.cache.update_after_decode(start, used)
        now = time.monotonic()
        delivered = 0
        for slot in np.flatnonzero(self._active):
            req = self._slot_req[slot]
            for tok in toks[: int(counts[slot]), slot]:
                self._emit_token(req, int(tok), now)
                delivered += 1
                self._maybe_finish(req, now)
                if req.finished:
                    break  # EOS or budget: the rest of its block is discarded
        self.metrics.record_decode_chunk(delivered, used, executed, self.cache.cursor,
                                         active_at_dispatch, dispatch_s=t1 - t0,
                                         readback_s=t2 - t1)

    # --- lifecycle ----------------------------------------------------------

    def _emit_token(self, req: Request, tok: int, now: float, first: bool = False) -> None:
        req.tokens.append(tok)
        if first:
            req.first_token_time = now
            self.metrics.record_first_token(req, now)

    def _maybe_finish(self, req: Request, now: float) -> None:
        eos = req.config.eos_token_id
        hit_eos = eos is not None and req.tokens and req.tokens[-1] == eos
        if hit_eos or len(req.tokens) >= req.config.max_new_tokens:
            req.state = RequestState.DONE
            req.finish_time = now
            self.metrics.record_finish(req, now)
            self._release_slot(req)

    def _release_slot(self, req: Request) -> None:
        slot = req.slot
        if slot is None:
            return
        req.slot = None
        self._slot_req[slot] = None
        self._active[slot] = False
        self._state["active"][slot] = False
        self.cache.free(slot)

    def _reap_cancelled(self, now: float) -> None:
        for req in self._slot_req:
            if req is not None and req.state is RequestState.CANCELLED:
                self.metrics.record_cancel(req, now)
                req.finish_time = now
                self._release_slot(req)

    def _preempt_all(self) -> None:
        """Out of cache columns: requeue every active request (keeping its
        tokens), rewind the cache, and let admission re-prefill them."""
        preempted = [r for r in self._slot_req if r is not None]
        for req in preempted:
            self._slot_req[req.slot] = None
            req.slot = None
            req.preemptions += 1
            self.metrics.record_preemption()
        self._active[:] = False
        self.scheduler.requeue_front(preempted)
        self.cache.release_all_slots()
        self.cache.reset()
        self._state = self._fresh_slot_state()
