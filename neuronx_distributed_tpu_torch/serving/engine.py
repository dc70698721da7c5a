"""Continuous-batching serving engine (counterpart of
``neuronx_distributed_tpu/serving/engine.py``, its core: row-per-slot or
paged cache, FIFO scheduling, conservative or eager admission, the prefix
cache).

A host loop interleaves prefill of admitted requests with fused decode
chunks over all ``num_slots`` slots:

* Per-slot decode state (pending token, request seed, tokens emitted, active
  mask, sampling sentinels, remaining budget, EOS id) lives on the device in
  ``self._state`` and is updated in place; the host writes a slot's row only
  at admission and release.
* The KV cache is one :class:`KVCache` of ``(num_slots, max_seq_len)`` rows,
  updated in place (the JAX engine donates it to the same effect), or with
  ``kv_page_size=`` a :class:`PagedKVCache`: a pool of ``kv_num_pages``
  pages behind per-slot block tables (``serving/paging.py``), which packs
  device memory under mixed-length traffic; decode attends straight from
  the pool pages (K5).
* ``decode_chunk_size`` decode steps run between two host reads
  (:class:`~neuronx_distributed_tpu_torch.inference.generate.
  ChunkedDecode`): EOS/budget freezing happens on the device and the
  host pays ONE read per steady chunk — the (chunk, slots, columns) token
  block with each step's emitted counts. Every device→host read goes through
  :meth:`ServingEngine._host_read`, which counts them (``host_reads``):
  one per admitted fresh request (its first token), one per chunk.
* On the card the decode step is ONE CUDA graph per engine
  (``inference/graphs.py``), the counterpart of the JAX engine's one jitted
  decode program: captured at the engine's first decode chunk (or by
  :meth:`ServingEngine.prewarm`) and replayed for every step after, on
  buffers that live as long as the engine — the slot state, the cache and
  its device write cursor, the token blocks. So the engine updates them in
  place and never rebinds them. On the CPU the same step runs eagerly.

Token-stream fidelity: a request served here yields exactly the tokens of a
solo ``generate(prompt, seed=...)`` — the same prefill math (left padding),
the same per-token sampling stream (counter-based on the request seed and
token index), for every chunk size and across preemption and resume.

Cache capacity: slots share one write cursor (``serving/cache_manager.py``)
that advances each decode step while any slot is active.
``admission="conservative"`` admits a request only when its whole remaining
generation fits under the cursor; ``"eager"`` admits whenever the prefill
fits and, at the wall, preempts every active request (keeping its tokens),
rewinds the cache and resumes them by re-prefilling their context. A paged
engine also counts pages: conservative admission charges every in-flight
context's worst-case page span, eager admission this round's context pages
plus every slot's first decode window, and a pool that cannot back the next
window is a wall like the cursor's (preempt and rewind).

Prefix cache (``prefix_cache="auto"``, the default, as in JAX): at
admission the longest stored prefix of the context (a :class:`PrefixCache`
trie lookup, capped at ``context - 1``) is reused and only the uncached
tail is prefilled, through the decode-mode model in one multi-token step
(``suffix_prefill_step``: K4 or K5 with group x chunk rows per kv-head, not
K1). Row engine: each miss stores a compact COPY of its context's K/V
(``extract_cache_prefix``) and a hit seeds the slot from it
(``seed_cache_prefix``), after validating the copy's shapes and
fingerprint (one host read). Paged engine: an entry PINS the whole context
pages of the slot that inserted it and a hit maps them copy-on-write into
its own block table (zero KV bytes move; the match floors to whole pages);
under page pressure the LRU unpinned entry is evicted. Admission orders a
round by the EFFECTIVE prefill (context less its reusable prefix).
Streams equal the cache-off engine's.

Speculative decoding (``draft_model=``, ``gamma=``; JAX ``engine.py:628-661``):
each decode chunk runs ``decode_chunk_size`` draft-verify ROUNDS
(``inference/spec_decode.py``), one captured program on the card, each
emitting 1..gamma tokens a slot, still ONE host read a chunk. A second cache
(a ``SlotCacheManager``, or a ``PagedCacheManager`` of the same geometry
with its own pool) mirrors the target's slot lifecycle one for one; the draft
always full-prefills (prefix entries hold target KV only). A round costs
``gamma`` columns, so every cursor and page computation counts in
``self.gamma`` columns an iteration (JAX ``_round_cols``; 1 without a
draft). Greedy streams equal the spec-off engine's; sampled slots emit one
token a round, the plain step's draw. ``draft_model=None`` is the engine
without speculation, unchanged.

Quantized serving (``quantize=QuantConfig(weights=, kv=)``; JAX
``engine.py:514-557``): ``weights="int8"``/``"fp8"`` serves a quantized
copy of the model, made once at construction (``quantize_model``: every
linear's weight as codes and per-channel scales; the embedding and norms
shared with the caller's model), whose products dequantize their weight
(DQ) before the GEMM; ``kv="int8"`` (needs ``kv_page_size=``) makes the page
pool int8 with a scale per (page, kv-head), attended by K5q. A prefix hit
on an int8 pool reads its shared pages into a float batch-1 row, prefills
the suffix there (K4) and quantizes only the suffix's own pages into the
slot's pages (JAX ``_seed_from_pages``): shared pages, codes and scales,
are never written. The correctness contract is the JAX package's logit
budget against the float model, not bit identity with it; within the port
the quantized engines' streams equal solo ``generate`` on the quantized
model. ``draft_model=`` with ``quantize=`` raises: the early-exit draft
shares the target's tensors, which quantization replaces.

Left out of this slice (not accepted, not silently ignored): the host page
tier (spill and prefetch of prefix entries), page content fingerprints,
a weight swap, tp/mesh, fault injection (and with it the speculative
dispatch's fallback to a plain chunk: a failed capture or replay raises),
SLO scheduling, ledgers, tracing and profiling.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.inference.generate import (
    GenerationConfig,
    decode_chunk,
    pack_padded_prompt,
    serving_clones,
    suffix_prefill_step,
    validate_generate_args,
)
from neuronx_distributed_tpu_torch.inference.spec_decode import speculative_chunk
from neuronx_distributed_tpu_torch.inference.speculative import validate_spec_room
from neuronx_distributed_tpu_torch.inference.utils import unwrap_logits
from neuronx_distributed_tpu_torch.models.llama import quantize_model
from neuronx_distributed_tpu_torch.modules.attention import (
    extract_cache_prefix,
    seed_cache_prefix,
)
from neuronx_distributed_tpu_torch.serving.cache_manager import (
    PrefixCache,
    PrefixEntry,
    SlotCacheManager,
    prefix_leaves,
)
from neuronx_distributed_tpu_torch.serving.metrics import ServingMetrics
from neuronx_distributed_tpu_torch.serving.paging import PagedCacheManager, PageExhausted
from neuronx_distributed_tpu_torch.serving.scheduler import (
    Request,
    RequestState,
    Scheduler,
)
from neuronx_distributed_tpu_torch.utils.fingerprint import cache_fingerprint
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


# per-slot decode state: dtype and the value of a free slot
_SLOT_DEFAULTS = {
    "tok": (torch.int64, 0), "seed": (torch.int64, 0), "ntok": (torch.int64, 0),
    "active": (torch.bool, False), "remaining": (torch.int64, 0),
    "temp": (torch.float32, 1.0), "topk": (torch.int64, 0),
    "topp": (torch.float32, 1.0), "eos": (torch.int64, -1),
}


def _bucket(p: int, max_seq_len: int, remaining: int, floor: int = 8) -> int:
    """Padded prefill length for a p-token context: next power of two,
    clamped so the padded prompt still leaves room for the remaining
    generation (falling back to the exact length)."""
    b = max(floor, 1 << max(p - 1, 0).bit_length())
    b = min(b, max_seq_len)
    if b < p or b + remaining > max_seq_len:
        b = p
    return b


def _suffix_bucket(s: int, end: int, max_seq_len: int) -> int:
    """Padded chunk length of an s-token suffix prefill (JAX
    ``_suffix_bucket``, ``engine.py:329``): the next power of two, or the
    exact length where the padded chunk's writes, which start at the reused
    prefix's end ``end - s``, would run past the cache row. The JAX chunk
    writes a fresh row that the admission rolls into the slot, so its bound
    is the padded length; the port's writes land in the slot itself, so
    ``end`` is the context's end column there (the cursor, >= padded)."""
    b = max(1, 1 << max(s - 1, 0).bit_length())
    if end - s + b > max_seq_len:
        b = s
    return b


def _prefix_bucket(p: int, max_seq_len: int) -> int:
    """Storage bucket of a p-token prefix entry (JAX ``_prefix_bucket``,
    ``engine.py:344``): the next power of two, clamped to the cache
    length."""
    return min(max(1, 1 << max(p - 1, 0).bit_length()), max_seq_len)


class ServingEngine:
    """Slot-based continuous batching over a causal LM whose weights live on
    its device (``model.device``); every tensor the engine makes lives there
    too. ``draft_model`` (a causal LM on the same device, with the target's
    vocabulary and ``max_seq_len``) turns decode into speculative rounds of
    ``gamma`` draft tokens; the port's modules carry their own weights, so
    there is no ``draft_params`` (the draft of
    :func:`~neuronx_distributed_tpu_torch.models.llama.early_exit_draft`
    shares the target's tensors)."""

    def __init__(
        self,
        model,
        num_slots: int,
        max_tokens_in_flight: Optional[int] = None,
        admission: str = "conservative",
        scheduling: str = "fifo",
        decode_chunk_size: int = 8,
        max_queue: Optional[int] = None,
        kv_page_size: Optional[int] = None,
        kv_num_pages: Optional[int] = None,
        prefix_cache="auto",
        draft_model=None,
        gamma: int = 4,
        quantize=None,
    ):
        if admission not in ("conservative", "eager"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if kv_page_size is None and kv_num_pages is not None:
            raise ValueError("kv_num_pages needs kv_page_size")
        # kept to match the JAX signature; this port has one policy
        if scheduling != "fifo":
            raise ValueError(f"unknown scheduling policy {scheduling!r} (this port has 'fifo')")
        if decode_chunk_size < 1:
            raise ValueError(f"decode_chunk_size must be >= 1, got {decode_chunk_size}")
        if draft_model is not None:
            if gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
            d_cfg, t_cfg = draft_model.config, model.config
            if d_cfg.max_seq_len != t_cfg.max_seq_len:
                raise ValueError(f"draft_model.config.max_seq_len ({d_cfg.max_seq_len}) must equal "
                                 f"the target's ({t_cfg.max_seq_len}): both caches share the "
                                 "slot row length")
            if d_cfg.vocab_size != t_cfg.vocab_size:
                raise ValueError(f"draft and target models must share a vocabulary "
                                 f"({d_cfg.vocab_size} != {t_cfg.vocab_size})")
            if draft_model.device != model.device:
                raise ValueError(f"draft_model lives on {draft_model.device}, the target on "
                                 f"{model.device}")
        if quantize is not None:
            model = self._quantized(model, quantize, kv_page_size, draft_model)
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.max_seq_len = model.config.max_seq_len
        self.draft_model = draft_model
        # columns one decode iteration consumes (JAX ``_round_cols``): gamma
        # a speculative round, 1 a plain step; the unit of every cursor and
        # page computation
        self.gamma = gamma if draft_model is not None else 1
        self.admission = admission
        self.decode_chunk_size = decode_chunk_size
        self.max_queue = max_queue
        self._prefill_model, self._decode_model = serving_clones(model)
        self.scheduler = Scheduler(max_tokens_in_flight)
        self._page_size = kv_page_size
        if kv_page_size is None:
            self.cache = SlotCacheManager(num_slots, model.new_cache(num_slots))
        else:
            self.cache = PagedCacheManager.for_model(
                model, num_slots, kv_page_size, kv_num_pages,
                kv_quant=quantize.kv if quantize is not None else None)
        self.metrics = ServingMetrics(num_slots)
        # prefix cache: "auto" builds the standard store, an int sizes it (0
        # disables), None or a disabled store keeps the full-prefill path
        if isinstance(prefix_cache, str):
            if prefix_cache != "auto":
                raise ValueError(f"unknown prefix_cache {prefix_cache!r}")
            prefix_cache = PrefixCache()
        elif isinstance(prefix_cache, int):
            prefix_cache = PrefixCache(max_entries=prefix_cache) if prefix_cache > 0 else None
        elif prefix_cache is not None and not isinstance(prefix_cache, PrefixCache):
            raise TypeError(f"prefix_cache takes 'auto', None, an int or a PrefixCache, "
                            f"got {type(prefix_cache).__name__}")
        if prefix_cache is not None and not prefix_cache.enabled:
            prefix_cache = None
        self.prefix = prefix_cache
        if prefix_cache is not None:
            # paged entries hold pool pages: whatever drops one releases them
            prefix_cache.on_evict = self._on_prefix_evict
            if kv_page_size is not None:
                self.cache.reclaim = self._reclaim_prefix_entry
        self._active = np.zeros((num_slots,), bool)
        self._slot_req: List[Optional[Request]] = [None] * num_slots
        self._next_rid = 0
        self._state = {name: torch.full((num_slots,), v, dtype=dt, device=self.device)
                       for name, (dt, v) in _SLOT_DEFAULTS.items()}
        # the draft twin: its own cache, slot for slot the target's
        self.draft_cache = None
        if draft_model is None:
            self._chunk = decode_chunk(self._decode_model, decode_chunk_size, self.max_seq_len,
                                       self.cache.cache, self._state)
        else:
            self._draft_prefill_model, draft_decode = serving_clones(draft_model)
            if kv_page_size is None:
                self.draft_cache = SlotCacheManager(num_slots, draft_model.new_cache(num_slots))
            else:
                self.draft_cache = PagedCacheManager.for_model(draft_model, num_slots,
                                                               kv_page_size, kv_num_pages)
            self._chunk = speculative_chunk(
                self._decode_model, draft_decode, decode_chunk_size, self.gamma,
                self.max_seq_len, self.cache.cache, self.draft_cache.cache, self._state)
        self.host_reads = 0

    @staticmethod
    def _quantized(model, quantize, kv_page_size, draft_model):
        """The model the engine serves under ``quantize`` (JAX
        ``engine.py:528-557``, with its validation): ``model`` itself for
        KV-only quantization, else its quantized copy."""
        if quantize.kv is not None and kv_page_size is None:
            raise ValueError("quantize.kv needs kv_page_size= (quantized KV is page-granular "
                             "— the row layout stays float)")
        if draft_model is not None:
            raise ValueError("quantize= with draft_model= is not served yet: the early-exit "
                             "draft shares the target's tensors, which quantization replaces")
        qcfg = quantize.weight_qconfig()
        if qcfg is None:
            return model
        cfg = getattr(model, "config", None)
        if not hasattr(cfg, "quantization"):
            raise ValueError("quantize.weights needs a model whose config carries a "
                             f"'quantization' field (Llama); got {type(cfg).__name__}")
        if cfg.quantization is not None:
            raise ValueError("model already carries a quantization config — pass the float "
                             "model (the engine quantizes) or drop quantize=")
        return quantize_model(model, qcfg)

    def _reset_caches(self) -> None:
        """Rewind the cache and the draft twin in lockstep: every slot free,
        every validity row clear, cursors at column 0."""
        for mgr in self._managers:
            mgr.release_all_slots()
            mgr.reset()

    @property
    def _managers(self):
        """The cache managers, the target's first: with a draft model its
        twin too, admitted, freed, reset and rewound slot for slot."""
        return (self.cache,) if self.draft_cache is None else (self.cache, self.draft_cache)

    def _reset_slot_state(self) -> None:
        """Every slot's device state back to its defaults, IN PLACE: the
        captured decode step reads these very buffers."""
        for name, (_, v) in _SLOT_DEFAULTS.items():
            self._state[name].fill_(v)

    @property
    def decode_program(self):
        """The engine's decode program (``inference/graphs.DecodeProgram``):
        the plain step, or with a draft model the speculative round."""
        return self._chunk.program

    @property
    def decode_compilations(self) -> int:
        """Decode programs captured: 1 on the card from the first decode
        chunk on, whatever the churn, preemption or cancellation (the JAX
        engine's ``decode_compilations``, one jitted chunk per engine, the
        ``spec_decode_chunk`` with a draft model); 0 on the CPU, where the
        step runs eagerly and nothing is captured."""
        return self.decode_program.captures

    def prewarm(self) -> float:
        """Capture the decode program now, on an idle engine, so that no
        request waits for it (the counterpart of ``aot.prewarm_programs``):
        the capture's warm-up runs one masked no-op step at the rewound
        cursor and leaves no trace. Returns the capture's wall seconds (0 on
        the CPU or when already captured), also recorded in the metrics."""
        if self._active.any():
            raise ValueError("prewarm captures on an idle engine; slots are active")
        if self.cache.cursor > 0:
            self._reset_caches()
        seconds = self.decode_program.capture()
        if seconds:
            self.metrics.record_capture(seconds)
        return seconds

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
        if self.draft_model is not None:
            # the last round's gamma-token verify window must fit the row even
            # at context prompt + max_new - 1, or the final token could never
            # be emitted (preempt and re-admit would livelock)
            validate_spec_room((self.model,), prompt.size, config.max_new_tokens, self.gamma)
        budget = self.scheduler.max_tokens_in_flight
        if budget is not None and prompt.size + config.max_new_tokens > budget:
            raise ValueError(
                f"request footprint ({prompt.size + config.max_new_tokens}) "
                f"exceeds max_tokens_in_flight ({budget}); it could never be admitted"
            )
        if self._page_size is not None:
            # the request's worst-case page footprint ALONE (empty engine,
            # cursor rewound) must fit the pool, or no admission round could
            # ever select it: fail at the door, not livelocked at the head
            rem = config.max_new_tokens + self.gamma - 1
            _, t0 = self._paged_layout(prompt.size, rem, 0)
            span0 = self.cache.page_span(t0 - prompt.size, min(self.max_seq_len, t0 + rem))
            if span0 > self.cache.alloc.capacity:
                raise ValueError(
                    f"request needs {span0} KV pages even alone; the pool holds "
                    f"{self.cache.alloc.capacity} usable pages — it could never be placed"
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

    @torch.no_grad()
    def step(self) -> bool:
        """One iteration: reap cancellations → preempt/rewind if the cursor
        is out of room → admit+prefill → one decode chunk → retire finished
        slots. Returns whether work remains. Runs under ``no_grad``: serving
        never differentiates (as the JAX engine), so a trainable model
        records no autograd graph here."""
        now = time.monotonic()
        self._reap_cancelled(now)
        # one more decode iteration needs gamma columns; speculation
        # spends columns faster than tokens (rejected drafts leave gaps), so
        # its wall can come before the token-based admission projected it
        if self._active.any() and self.cache.cursor + self.gamma > self.max_seq_len:
            self._preempt_all()
        if not self._active.any() and self.cache.cursor > 0:
            self._reset_caches()  # drained: the next wave starts at column 0
        self._admit(now)
        if self._active.any():
            self._decode()
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

        extra = self.gamma - 1  # the last round's window past its token

        def fits(req: Request) -> bool:
            nonlocal proj, maxrem
            p = len(req.context_ids)
            target = max(proj, _bucket(p, self.max_seq_len, req.remaining_new_tokens + extra))
            if self.admission == "conservative":
                # every slot steps together: the cursor ends at the admission
                # cursor plus the LONGEST remaining generation in flight
                # (speculation is token-optimistic here: a column costs a
                # token only when accepted, and the wall recovers the rest)
                if target + max(maxrem, req.remaining_new_tokens) + extra > self.max_seq_len:
                    return False
            elif target + self.gamma > self.max_seq_len:
                return False  # eager: the prefill plus one decode iteration
            proj = target
            maxrem = max(maxrem, req.remaining_new_tokens)
            return True

        if self._page_size is not None:
            fits = self._paged_fits(maxrem)
        cost = None
        if self.prefix is not None:
            # longest EFFECTIVE prefill first: a long shared context whose
            # prefix is stored is a cheap suffix (a read-only peek)
            def cost(req: Request) -> int:
                return len(req.context_ids) - self.prefix.match_len(req.context_ids)

        for req in self.scheduler.select(self.cache.free_slots, self._in_flight_tokens(),
                                         fits, prefill_cost=cost):
            slot = self.cache.acquire()
            if self.draft_cache is not None and self.draft_cache.acquire() != slot:
                # the twin's free list mirrors the target's: a divergence would
                # land one request's draft KV under another slot's bookkeeping
                raise RuntimeError(f"the draft cache's free slots diverged from the target's "
                                   f"(slot {slot})")
            self._prefill_into_slot(req, slot, now)

    def _paged_fits(self, maxrem: int):
        """The paged admission predicate for one round (JAX ``fits``,
        ``engine.py:2385-2494``, with the round laid out as admission will
        lay it out). ``select`` hands the round back longest-first and each
        admission page-aligns the cursor, so the round's final cursor
        depends on that order; the JAX projection walks the queue in
        arrival order instead and can fall short of it. Conservative: every
        in-flight and selected context's pages through the final cursor plus
        the longest remaining generation fit the pool (no wall is ever hit).
        Eager: this round's context pages plus the first decode window at
        the final cursor, for every selected and in-flight slot, at the
        width :meth:`_ensure_decode_pages` will ask for, fit the free pages.
        The JAX engine charges each request's window at its own target and
        leaves the in-flight slots out, which can re-admit the same
        over-committed wave after every page-pressure preemption and
        livelock; this count backs the next chunk, so every round makes
        progress."""
        cache, L, extra = self.cache, self.max_seq_len, self.gamma - 1
        cursor0, starts = cache.cursor, cache.active_spans()
        in_flight = np.flatnonzero(self._active)
        selected = []  # (context length, remaining tokens), queue order
        # the draft twin's pool maps the same columns without sharing prefix
        # pages: eager admission must fit both pools
        pools = self._managers

        def layout(reqs):
            cur, ctx = cursor0, []
            for p, rem in sorted(reqs, key=lambda r: r[0], reverse=True):
                target = self._paged_layout(p, rem + extra, cur)[1]
                ctx.append((target - p, p))
                cur = target
            return ctx, cur

        def fits(req: Request) -> bool:
            nonlocal maxrem
            p, rem = len(req.context_ids), req.remaining_new_tokens
            ctx, target = layout(selected + [(p, rem)])
            most = max(maxrem, rem)
            if self.admission == "conservative":
                # shared pages counted once a slot: this bounds the draft's
                # unshared pool too
                t_end = target + most + extra
                if t_end > L or (sum(cache.page_span(s, t_end) for s in starts)
                                 + sum(cache.page_span(st, t_end) for st, _ in ctx)
                                 > cache.alloc.capacity):
                    return False
            else:
                if target + self.gamma > L:
                    return False
                hi = min(L, target + min(self.decode_chunk_size, max(most, 1)) * self.gamma)
                for pool in pools:
                    need = (sum(pool.unmapped_pages(int(s), target, hi) for s in in_flight)
                            + sum(pool.context_pages(st, n, target, hi) for st, n in ctx))
                    if need > pool.available_pages():
                        return False
            selected.append((p, rem))
            maxrem = most
            return True

        return fits

    def _paged_layout(self, p: int, rem: int, proj: int):
        """(padded, cursor target) for a paged admission at projected cursor
        ``proj``: the padded bucket as ever, with the target bumped (fewer
        than page_size gap columns) so the context START lands on a page
        boundary. When the bump would push the request past the row end that
        the exact-length bucket avoids, fall back to ``padded = p``."""
        padded = _bucket(p, self.max_seq_len, rem)
        target = self.cache.aligned_target(max(proj, padded), p)
        if padded > p and target + rem > self.max_seq_len:
            padded = p
            target = self.cache.aligned_target(max(proj, p), p)
        return padded, target

    def _prefill_into_slot(self, req: Request, slot: int, now: float) -> None:
        """Admit ``req`` into ``slot``: a full prefill of its context, or on
        a prefix hit the stored prefix seeded into the slot and a suffix
        prefill of the rest; then store the context's prefix (a miss, or a
        hit whose tail is long enough) and sample the first token."""
        ctx = req.context_ids
        p = len(ctx)
        t0 = time.monotonic()
        rem = req.remaining_new_tokens + self.gamma - 1
        if self._page_size is None:
            padded = _bucket(p, self.max_seq_len, rem)
            target = max(self.cache.cursor, padded)
        else:
            padded, target = self._paged_layout(p, rem, self.cache.cursor)
        plan = self._plan_prefix_reuse(ctx, p, target)
        try:
            if self._page_size is None:
                row = self.cache.admit(slot, padded, cursor=target)
                if self.draft_cache is not None:
                    d_row = self.draft_cache.admit(slot, padded, cursor=target)
                m_shared = 0
            else:
                m_shared = plan[1] if plan is not None else 0
                shared = plan[0].page_ids[:m_shared // self._page_size] if plan else ()
                try:
                    row = self.cache.admit(slot, padded, cursor=target, p=p,
                                           shared_ids=shared, m_shared=m_shared)
                    if self.draft_cache is not None:
                        # the draft maps its own pages under the same columns
                        d_row = self.draft_cache.admit(slot, padded, cursor=target, p=p)
                except PageExhausted:
                    # page pressure between fits() and the admission: nothing
                    # stays mapped — return the slot, requeue the untouched request
                    self.cache.free(slot)
                    if self.draft_cache is not None:
                        self.draft_cache.free(slot)
                    self.scheduler.requeue_front([req])
                    return
            if plan is None:
                ids, mask = pack_padded_prompt(ctx, padded)
                logits = unwrap_logits(self._prefill_model(
                    torch.from_numpy(ids).to(self.device, torch.int64), cache=row,
                    padding_mask=torch.from_numpy(mask).to(self.device), last_only=True,
                ))[0, -1]
            else:
                entry, m_use, chunk = plan
                start = padded - p  # the context's first column in the view
                seed_cache_prefix(row, entry.tree, m_use, start)
                if self._page_size is not None:
                    # the suffix chunk writes past the shared pages, never on one
                    c0 = target - p + m_use
                    self.cache.assert_writable([slot], c0, c0 + chunk)
                ids, _ = pack_padded_prompt(ctx[m_use:], chunk, pad_side="right")
                ids = torch.from_numpy(ids).to(self.device, torch.int64)
                if self._page_size is not None and self.cache.cache.quantized:
                    logits = self._suffix_prefill_dequantized(row, entry, m_use, chunk, ids,
                                                              p, start)
                else:
                    logits = suffix_prefill_step(self._decode_model, row, ids, p - m_use)
            if self.draft_cache is not None:
                # the draft context always full-prefills, on a prefix hit too:
                # prefix entries hold target KV only
                ids, mask = pack_padded_prompt(ctx, padded)
                self._draft_prefill_model(
                    torch.from_numpy(ids).to(self.device, torch.int64), cache=d_row,
                    padding_mask=torch.from_numpy(mask).to(self.device), last_only=True)
        finally:
            if plan is not None:
                self.prefix.release(plan[0])
        self.metrics.record_prefill_wall(time.monotonic() - t0,
                                         kind="full" if plan is None else "suffix")
        matched = plan[1] if plan is not None else 0
        if self._page_size is None:
            self._remember_prefix(ctx, p, padded, row, matched)
        else:
            if m_shared:
                self.metrics.record_prefix_pages_shared(m_shared // self._page_size)
            self._remember_prefix_paged(ctx, p, slot, m_shared)
        self._bind_slot(req, slot, logits, now)

    def _suffix_prefill_dequantized(self, row, entry, m_use: int, chunk: int, ids, p: int,
                                    start: int) -> torch.Tensor:
        """A prefix hit's suffix prefill on an int8 pool (JAX
        ``_seed_from_pages`` and the admission roll-in,
        ``paging.py:277-369``): the hit's shared pages dequantized into a
        float batch-1 row of ``m_use + chunk`` columns, the suffix prefilled
        there (the decode kernels over a row: K4, multi-row above 32 rows),
        then its ``p - m_use`` real columns written through the slot's view
        ``row`` at ``start + m_use``, which quantizes the slot's own pages
        alone. Returns the next-token logits."""
        ps = self._page_size
        frow = self.cache.cache.dequantized_row(entry.page_ids[:m_use // ps], m_use,
                                                m_use + chunk)
        logits = suffix_prefill_step(self._decode_model, frow, ids, p - m_use)
        n = p - m_use
        tail = row.view(slice(None), start + m_use)
        tail._address(tail._cols[:n])
        for layer in range(frow.k.shape[0]):
            tail.decode_write(layer, frow.k[layer, :, m_use:p], frow.v[layer, :, m_use:p])
        row.valid[:, start + m_use:start + p] = True
        return logits

    # --- prefix reuse -------------------------------------------------------

    def _plan_prefix_reuse(self, ctx, p: int, end: int):
        """Admission-time prefix lookup (JAX ``_plan_prefix_reuse``,
        ``engine.py:2879-2982``): ``(entry, m_use, chunk)`` for a validated
        hit, the entry PINNED (the caller releases it when the suffix
        prefill settles, success or failure), or None for a miss, a match
        below ``min_match`` or an entry that failed its reuse-time
        validation (evicted on the spot: the admission falls back to a full
        prefill, so bad KV never reaches a slot). A paged match floors to
        whole pages. ``end`` is the context's end column in the slot."""
        if self.prefix is None:
            return None
        hit = self.prefix.lookup(ctx)
        if hit is not None and self._page_size is not None:
            # copy-on-write reuse is page-granular: the unaligned tail of
            # the match re-prefills as part of the suffix
            ps = self._page_size
            entry, m_use = hit
            m_use = min(m_use // ps, len(entry.page_ids or ())) * ps
            hit = (entry, m_use) if m_use >= self.prefix.min_match else None
        if hit is None:
            self.metrics.record_prefix_miss()
            return None
        entry, m_use = hit
        if self._page_size is not None:
            valid = self.cache.pages_live(entry.page_ids[:m_use // self._page_size])
        else:
            valid = self._validate_prefix(entry)
        if not valid:
            self.prefix.evict_entry(entry)
            self.metrics.record_prefix_validation_failure()
            self.metrics.record_prefix_eviction()
            self.metrics.record_prefix_miss()
            return None
        self.prefix.pin(entry)
        self.metrics.record_prefix_hit(m_use)
        return entry, m_use, _suffix_bucket(p - m_use, end, self.max_seq_len)

    def _validate_prefix(self, entry: PrefixEntry) -> bool:
        """Reuse-time check of a stored copy (JAX ``_validate_prefix``,
        ``engine.py:2984``): leaf shapes against the insert-time record, then
        the fingerprint recomputed and compared with the stored one bit for
        bit. Both scalars ride one host read."""
        if tuple(tuple(t.shape) for t in prefix_leaves(entry.tree)) != entry.shapes:
            return False
        now, stored = self._host_read(torch.stack([cache_fingerprint(entry.tree),
                                                   entry.fingerprint]))
        return bool(now == stored)

    def _remember_prefix(self, ctx, p: int, padded: int, row, matched: int) -> None:
        """Insert-on-miss (JAX ``_remember_prefix``, ``engine.py:3057``):
        copy the admitted context's K/V columns out of the slot into a
        compact block keyed by its tokens. Skipped for contexts too short to
        reuse, contexts a stored entry already covers, and hits whose tail
        adds fewer than ``min_match`` tokens. The fingerprint stays on the
        device: the first reuse reads it."""
        if self.prefix is None or p < self.prefix.min_match:
            return
        if matched and p - matched < self.prefix.min_match:
            return
        key = tuple(int(t) for t in ctx)
        if self.prefix.covers(key):
            return
        bucket = _prefix_bucket(p, self.max_seq_len)
        tree = extract_cache_prefix(row, padded - p, p, bucket)
        _, evicted = self.prefix.insert(key, tree, cache_fingerprint(tree), bucket)
        if evicted:
            self.metrics.record_prefix_eviction(evicted)

    def _remember_prefix_paged(self, ctx, p: int, slot: int, matched: int) -> None:
        """Paged insert-on-miss (JAX ``_remember_prefix_paged``,
        ``engine.py:3096-3135``): PIN the slot's whole context pages instead
        of copying, zero device work. Decode writes land past the aligned
        context, so a still-decoding donor never touches them. Same skip
        rules as the copy path, on the page-floored length."""
        if self.prefix is None:
            return
        ps = self._page_size
        m_ins = (p // ps) * ps
        if m_ins < self.prefix.min_match or (matched and m_ins - matched < self.prefix.min_match):
            return
        key = tuple(int(t) for t in ctx[:m_ins])
        if self.prefix.covers(key):
            return
        ids = self.cache.slot_context_pages(slot, m_ins // ps)
        self.cache.pin_pages(ids)
        entry, evicted = self.prefix.insert(key, None, None, bucket=m_ins)
        if entry is None:
            self.cache.unpin_pages(ids)
        else:
            entry.page_ids = tuple(ids)
        if evicted:
            self.metrics.record_prefix_eviction(evicted)

    def _on_prefix_evict(self, entry: PrefixEntry) -> None:
        """The store's eviction hook (JAX ``_on_prefix_evict``,
        ``engine.py:1071``): a paged entry leaving the store releases its
        page pins; pages a decoding slot still maps survive through its own
        references."""
        if entry.page_ids:
            self.cache.unpin_pages(entry.page_ids)
            entry.page_ids = None

    def _reclaim_prefix_entry(self) -> bool:
        """The page-pressure valve (JAX ``_reclaim_prefix_entry``,
        ``engine.py:1091``): evict the least-recently-used unpinned paged
        entry so its pages can serve an admission. Never frees a page a slot
        still maps: eviction only drops the entry's references."""
        for e in self.prefix.entries:  # LRU first
            if e.refs == 0 and e.page_ids:
                self.prefix.evict_entry(e)
                self.metrics.record_prefix_eviction()
                return True
        return False

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

    def _chunk_width_cols(self, active) -> int:
        """Columns the next chunk can actually WRITE: a slot freezes when
        its budget runs out, so no more than the largest remaining
        generation among active slots ever executes (steps, or rounds of
        gamma columns). Clamping the page demand to it keeps the window
        consistent with the admission and door accounting, which size
        requests by their remaining tokens."""
        max_rem = max((self._slot_req[s].remaining_new_tokens for s in active
                       if self._slot_req[s] is not None), default=self.decode_chunk_size)
        return min(self.decode_chunk_size, max(max_rem, 1)) * self.gamma

    def _ensure_decode_pages(self) -> bool:
        """Map pool pages under every active slot's next write window, in
        both caches of a speculative engine (each round's whole
        gamma-column window is mapped before the chunk). False = the
        page-pressure wall."""
        active = np.flatnonzero(self._active)
        width = self._chunk_width_cols(active)
        return all(mgr.ensure_decode_window(active, width) for mgr in self._managers)

    def _decode(self) -> None:
        if self._page_size is not None and not self._ensure_decode_pages():
            # page-pressure wall: the pool cannot back every active slot's
            # next write window — preempt and rewind, the cursor wall's
            # remedy (frees every mapping; re-admission repacks from column 0)
            self._preempt_all()
            return
        if self._page_size is not None:
            self.metrics.record_pages_mapped(self.cache.pages_mapped)
        # one fused chunk (JAX ``_decode_plain``, or with a draft model
        # ``_decode_spec``, ``engine.py:3204``): ``decode_chunk_size``
        # iterations of the decode program (captured at the first chunk on
        # the card), plain steps or draft-verify rounds, then ONE host read of
        # the token block with each iteration's emitted counts (and a round's
        # accepted lengths); a capture's wall is recorded apart
        chunk, g = self._chunk, self.gamma
        active_at_dispatch = int(self._active.sum())
        start = self.cache.cursor
        prog = chunk.program
        captured, replays = prog.captures, prog.replays
        t0 = time.monotonic()
        executed = chunk()
        t1 = time.monotonic()
        capture_s = prog.capture_s if prog.captures > captured else 0.0
        if capture_s:
            self.metrics.record_capture(capture_s)
        block = self._host_read(chunk.readout())
        t2 = time.monotonic()
        toks, counts = block[..., :g], block[..., g]
        accepts = block[..., g + 1] if chunk.accepts is not None else None
        # iterations that ran with at least one live slot; the rest were
        # no-ops, so the cursors land where the JAX chunk's lax.cond leaves them
        used = int((counts.sum(1) > 0).sum())
        for mgr in self._managers:
            mgr.update_after_decode(start, used * g)
        now = time.monotonic()
        delivered, spec_accepts = 0, None if accepts is None else []
        for slot in np.flatnonzero(self._active):
            req = self._slot_req[slot]
            # the slot's live iterations: those in which it emitted (a live
            # slot emits at least one token each)
            live = np.flatnonzero(counts[:, slot])
            if accepts is not None:
                spec_accepts.extend(int(a) for a in accepts[live, slot])
            for r in live:
                for tok in toks[r, slot, :counts[r, slot]]:
                    self._emit_token(req, int(tok), now)
                    delivered += 1
                    self._maybe_finish(req, now)
                    if req.finished:
                        break  # EOS or budget: the rest of its block is discarded
                if req.finished:
                    break
        self.metrics.record_decode_chunk(delivered, used, executed, self.cache.cursor,
                                         active_at_dispatch, dispatch_s=t1 - t0 - capture_s,
                                         readback_s=t2 - t1, replays=prog.replays - replays,
                                         spec_accepts=spec_accepts, gamma=g)

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
        for mgr in self._managers:
            mgr.free(slot)

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
        self._reset_caches()
        self._reset_slot_state()
        if self.prefix is not None:
            # no suffix prefill survives a preemption, so no pin may either;
            # the entries stay valid (row copies, or pinned pages whose
            # content the reset keeps)
            self.prefix.release_all()
