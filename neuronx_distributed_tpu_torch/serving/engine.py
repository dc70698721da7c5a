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
model. ``draft_model=`` with ``quantize=`` needs a draft that shares no
tensor with the target (``draft_params=``): the early-exit draft shares
the target's tensors, which quantization replaces.

Fault tolerance (JAX ``engine.py:109-137``, the contract that makes the
captured hot path safe to run unattended; chaos-tested against the JAX
engine in ``tests/test_torch_faults.py`` and
``tests/test_torch_paged_faults.py``):

* **Deadlines and shedding**: ``submit(deadline_s=, queue_timeout_s=)``
  sets absolute deadlines on the engine clock (``time_fn``, skewed by the
  fault injector's ``now``); a queue-expired request is shed (TIMED_OUT)
  before any prefill runs, an in-flight deadline at a chunk boundary, and a
  shed request keeps the tokens it streamed.
* **Dispatch recovery**: a failed decode chunk no longer escapes ``step()``.
  Every in-flight request is requeued with its host-current tokens (streams
  resume bit-identically), the caches and the slot state are reset IN PLACE
  (the captured program keeps its buffers: nothing is reallocated, so
  ``decode_compilations`` stays 1), the engine waits ``dispatch_retry``'s
  jittered time (``sleep_fn``) and retries at the next step.
  ``max_attempts`` CONSECUTIVE failures halt it (HALTED) with the work
  requeued, never lost. The JAX engine tells donated buffers that survived
  from consumed ones; the port donates nothing, so it tells a failure before
  the chunk's first step (storage untouched) from one after steps ran
  (caches and cursors advanced in place: reset, and a paged prefix store
  cleared, as JAX clears it when its pool is consumed). A CUDA runtime error
  (``torch.AcceleratorError``) or a kernel's build or launch error
  (``KernelError``) is NOT recovered: it is sticky, leaves the context
  unusable, and retrying would hide a kernel fault; it raises out of
  ``step()``.
* **Readback validation and quarantine**: the token block the chunk's one
  host read brings back is checked on the host (counts in range, tokens in
  the vocabulary) before a token reaches a stream. A poisoned slot leaves
  the rotation for good (its device ``active`` flag cleared in place, no
  recapture), its request requeued from the last chunk boundary
  (``quarantine_policy="requeue"``) or failed (``"fail"``); neighbours are
  untouched. Paged engines quarantine by PAGE: a poisoned pool page
  retires, every request mapping it is requeued and the prefix entries
  pinning it are evicted. Losing every slot or page halts.
* **Prefill faults**: a failed prefill fails that one request (FAILED),
  releases its slot and its prefix pin; ``max_attempts`` consecutive
  failures halt.
* **Speculative fallback**: a failed speculative dispatch that ran no step
  decodes the chunk with the plain step on the same buffers (its own
  program, captured lazily at the first fallback), then preempts every slot
  so that both caches re-prefill in lockstep.
* **Page fingerprints**: a paged prefix entry records its pages' content
  fingerprints at insert (``utils/fingerprint.pool_pages_fingerprint``, PF
  on the card) and every hit recomputes and compares them, stacked with
  the stored vector into its one host read: a flipped bit in a shared page
  evicts the entry and the admission falls back to a full prefill.
* **Health, drain, flight recorder**: ``health()`` is OK, DEGRADED (slots
  or pages quarantined, or a dispatch failure within the last
  ``degraded_cooldown_chunks`` chunks), DRAINING (``drain()``: finish the
  admitted work, admit nothing new, reject submissions) or HALTED
  (``halt_reason``); ``flight_recorder="auto"`` keeps a ring of the fault
  events and dumps it as a post-mortem at a halt (to ``flight_dir`` if
  given). Every fault is counted in ``metrics.snapshot()``; none costs a
  host read: an idle injector and the recorder leave ``host_reads`` as in
  a bare engine.
* **Fault injection**: every path above is driven deterministically through
  :class:`~neuronx_distributed_tpu_torch.serving.faults.FaultInjector`.

SLO-aware multi-tenant serving (JAX ``engine.py:701-708``, ``:769-785``):

* ``submit(tenant=, priority=)`` attributes each request (defaults
  ``"default"`` and ``"standard"``); a reject at the door is attributed to
  its tenant.
* ``scheduling=`` is ``"fifo"`` (the default, the pre-policy scheduler
  decision for decision), ``"slo"`` (priority tiers with aging, DWRR token
  fairness, and admission and preemption fed back from the live SLO
  measurements; ``serving/sched/``) or a ``SchedulingPolicy``. Before each
  admission the policy may nominate victims: only their slots are vacated
  (``_preempt_victims``; the device ``active`` flag cleared in place, a
  paged victim's exclusive pages returned at once, the shared cursor NOT
  rewound), and they rejoin the queue's front with their tokens and seed,
  so a resume re-prefills and continues bit-identically; the freed slots
  admit in the same ``step()``, on the same captured program. Every
  delivered token is charged to its tenant (``policy.on_tokens``).
* ``registry=``/``engine_label=`` put the metrics in a shared
  ``MetricsRegistry``; ``slo=`` (an ``SLOSpec`` or ``{tenant: SLOSpec}``)
  classifies each request once, at its terminal state.
* ``timeline=`` (``utils/timeline.Timeline``) records the scheduling view
  (prefill and decode spans, occupancy and queue-depth counters, fault
  instants) and, through ``self.tracer``, one connected Perfetto flow per
  request; it is saved at a halt.

Every policy, SLO and tracer decision runs on host state: ``host_reads``
equals a bare engine's for the same traffic.

The host page tier (``kv_host_pages=N`` beside ``kv_page_size=``; JAX
``engine.py:725-738``, ``:1071-1219``): a bounded host store of N pages
(``serving/tiering.py HostPageStore``, in pinned memory on the card,
allocated once here) behind the pool. Under page pressure the reclaim valve
SPILLS the least-recently-used unpinned prefix entry there instead of
evicting it (its pages gathered out of the pool, copied to the host with one
sync, CRC-32 a page; the entry stays in the trie, host-resident); a full
store or a failed spill degrades to plain eviction. Before each admission
round the pre-pass peeks the queue (``Scheduler.upcoming``) and PREFETCHES
the spilled entries that queued requests match: the CRCs checked, fresh
pages allocated, the bytes copied back on the pool's tier stream, which
overlaps the main stream; the pages are held for the queued request, so the
valve cannot spill them again and the fit math credits them. A hit whose
entry is still host-resident prefetches late at its admission. A host-tier
hit maps the prefetched pages copy-on-write like any hit, without a PF
check (the CRC has just checked those bytes), and counts in
``prefix_hit_tier["host"]``. A corrupted host page rejects the whole fetch
and the admission falls back to a full prefill. Streams equal the untiered
engine's bit for bit. ``self.hbm`` (``observability/hbm.py HBMLedger``)
accounts the engine's residents per tier (the host pages with
``tier="host"``) against the card's memory; ``metrics.snapshot()["hbm"]``.

Weights that change (JAX ``engine.py:1336-1394``). The captured decode
program and the speculative round bake in the weights' addresses, so every
weight change writes IN PLACE (``copy_`` on the main stream, between steps):
no tensor is rebound, every ``data_ptr`` stays, ``decode_compilations``
does not move.

* ``engine.params`` is the served model's state dict; assigning a state
  dict in the port's names (``models/convert.py flax_to_torch``) checks
  every key, shape and dtype before it writes one tensor (a refused swap
  leaves the model bit for bit as it was), copies the values in and clears
  the prefix store (every entry counted as an eviction, its pins and host
  pages released): its K/V was computed under the old weights. Under
  ``quantize=`` a float dict is quantized once (``quantize_state_dict``)
  into the engine's own codes and scales and a pre-quantized dict binds as
  is; the engine's quantized model owns its embedding and norms, so the
  caller's float model never changes. A float engine serves the caller's
  module itself (``engine.model is model``): a swap writes into it.
* ``draft_params=`` beside ``draft_model=`` binds the draft's weights into
  a draft module of the engine's own (never ``draft_model`` itself, which
  may be the target); no draft tensor shares storage with the target's.
  Such a draft serves beside a quantized target (``quantize=``), takes
  ``engine.draft_params = ...`` in place and can be poisoned
  (``FaultInjector.poison_draft``: the corrupted values written in before
  the hit dispatch, the clean ones copied back after it). Without it the
  engine serves ``draft_model`` as given: a separate draft module takes the
  same three, and a draft swap writes into the caller's module, as a float
  engine's ``params`` swap does; an early-exit draft
  (``models/llama.py early_exit_draft``) shares the target's tensors and
  refuses all three (a ``poison_draft`` scheduled after construction is
  refused at the dispatch, before any write).

Fence, adopt and warm restart (JAX ``engine.py:1630-1843``, ``:1909``):
``fence(reason)`` halts the engine through the halt contract (the work
requeued with its host-current tokens); ``adopt(req)`` takes over a live
request of another engine, and ``snapshot_serving_state()`` /
``restore_serving_state(snap)`` carry the host-current serving state
(queue, tokens, seeds, deadlines, attribution, the prefix index, the SLO
counters; JSON-safe, no device tensor) to a fresh engine, every absolute
time shifted by the clock delta. Each continuation is the preemption
resume: the context re-prefilled, sampling continued at (seed, token
index). On the CPU the stream continues bit for bit; on the card the
re-prefill (K1) rounds otherwise than the decode steps it replaces (K4),
so a near-tie of a random bf16 model may go the other way.

Replicas and disaggregation (JAX ``engine.py:1577-1690``, ``:2800``):
``rid_base=`` starts the engine's request ids there, so that the replicas
of one router mint from disjoint ranges (``RID_STRIDE`` apart) and a
re-homed request keeps its rid; ``page_pressure()`` and
``load_score(tenant=)`` are the router's balancing and overcommit signals;
``release_queued(rid)`` hands a never-admitted request to another replica;
``submit(on_token=)`` streams a request's tokens. With
``external_prefill = True`` the engine never admits from its queue: a
``serving/disagg.py DisaggregatedServer`` prefills on its workers and hands
each context in with ``admit_staged``, a page-table mapping written in
place into the tensors the captured step reads.

Integrity and program observability (JAX ``engine.py:795-808``, ``:1847``,
``:2073``, ``:2153``, ``:3140-3162``): ``integrity_fingerprint()`` is TF
over ``integrity_leaves()`` (every tensor the engine serves), the router's
vote evidence, one 8-byte read a probe; ``FaultInjector.flip_bits("params")``
flips one of those bits in place at a ``step()``. Every program the engine
dispatches is wrapped in a program ledger (``self.programs``;
``program_ledger=`` shares one): ``decode_chunk`` or ``spec_decode_chunk``
(a dispatch a step or round; the capture is its compile), ``prefill[N]``
and ``draft_prefill[N]`` by padded length, ``suffix_prefill``,
``first_token``, ``slot_write``, ``slot_clear``, ``prefix_extract``,
``prefix_seed``, ``prefix_fingerprint``, ``pages_fingerprint`` and
``integrity_fingerprint``; each chunk feeds its wall
(``observe_wall``), and ``metrics.snapshot()["programs"]`` and a halt's
post-mortem carry it. ``profile_dir=`` opens a ``torch.profiler`` window
over decode chunks [2, 5). ``manifest()``, ``save_aot(dir)`` and
``prewarm(manifest=, cache_dir=)`` carry the programs and the kernel
libraries to a replica spawned later. None of it reads the device: host
reads stay a chunk's one and a fresh request's first token.

Not served: tp/mesh (``ROADMAP.md`` item 9).
"""

from __future__ import annotations

import enum
import gc
import os
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

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
from neuronx_distributed_tpu_torch.kernels._build import KernelError
from neuronx_distributed_tpu_torch.models.llama import (
    copy_state_dict_, quantize_model, shares_storage, storage_ptrs)
from neuronx_distributed_tpu_torch.modules.attention import (
    extract_cache_prefix,
    seed_cache_prefix,
)
from neuronx_distributed_tpu_torch.observability.flight_recorder import FlightRecorder
from neuronx_distributed_tpu_torch.observability.hbm import HBMLedger, tree_nbytes
from neuronx_distributed_tpu_torch.observability.programs import ProgramLedger, weak_reader
from neuronx_distributed_tpu_torch.observability.tracing import RequestTracer
from neuronx_distributed_tpu_torch.quantization.utils import (
    is_quantized_state_dict,
    quantize_state_dict,
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
from neuronx_distributed_tpu_torch.serving.tiering import HostPageStore
from neuronx_distributed_tpu_torch.utils.fingerprint import (
    cache_fingerprint,
    pool_pages_fingerprint,
)
from neuronx_distributed_tpu_torch.utils.retry import RetryPolicy
from neuronx_distributed_tpu_torch.utils.sampling import sample_row


class EngineHealth(enum.Enum):
    """The engine's health (``ServingEngine.health()``, JAX ``engine.py:268``).

    ``OK``: serving normally. ``DEGRADED``: serving, but a recent dispatch
    failure was recovered from or quarantines shrank the capacity.
    ``DRAINING``: finishing in-flight work, admitting nothing new.
    ``HALTED``: consecutive failures (or the loss of every slot or page)
    exhausted the retry budget; the in-flight work is requeued and the loop
    makes no progress until an operator steps in."""

    OK = "ok"
    DEGRADED = "degraded"
    DRAINING = "draining"
    HALTED = "halted"


class RejectedError(RuntimeError):
    """A submission the engine refused (a full bounded queue, draining or
    halted); ``queue_depth`` is the queue's occupancy at rejection time."""

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


# the width of each replica's request-id range (``rid_base`` multiples):
# re-homed requests keep their rid on the replica that adopts them
RID_STRIDE = 1_000_000_000

# errors the engine never recovers from: a CUDA runtime error is sticky
# (the context is unusable after it) and a kernel's build or launch error is
# a fault of the program or the card; retrying either would hide it
_FATAL = (torch.AcceleratorError, KernelError)


def _validate_readback(toks, counts, chunk_size: int, vocab: int, slots) -> Dict[int, str]:
    """Host check of a plain chunk's readback (JAX ``_validate_readback``,
    ``engine.py:350``): ``{slot: reason}`` for every active slot whose count
    leaves [0, chunk] or whose emitted tokens leave [0, vocab)."""
    bad: Dict[int, str] = {}
    for slot in slots:
        slot = int(slot)
        c = int(counts[slot])
        if c < 0 or c > chunk_size:
            bad[slot] = f"token count {c} outside [0, {chunk_size}]"
            continue
        col = np.asarray(toks[:c, slot])
        out = (col < 0) | (col >= vocab)
        if out.any():
            bad[slot] = f"token {int(col[out][0])} outside vocab [0, {vocab})"
    return bad


def _validate_spec_readback(toks, counts, gamma: int, vocab: int, slots) -> Dict[int, str]:
    """:func:`_validate_readback` for a speculative chunk (JAX
    ``_validate_spec_readback``, ``engine.py:377``): the block is (rounds,
    slots, gamma), ragged by each round's count."""
    bad: Dict[int, str] = {}
    for slot in slots:
        slot = int(slot)
        for r in range(counts.shape[0]):
            c = int(counts[r, slot])
            if c < 0 or c > gamma:
                bad[slot] = f"round {r} token count {c} outside [0, {gamma}]"
                break
            col = np.asarray(toks[r, slot, :c])
            out = (col < 0) | (col >= vocab)
            if out.any():
                bad[slot] = f"round {r} token {int(col[out][0])} outside vocab [0, {vocab})"
                break
    return bad


def _module_nbytes(module, exclude=None) -> int:
    """Bytes of a module's weights (its state dict: parameters, and a
    quantized model's codes and scales), each tensor once (a tied or shared
    weight is one resident); ``exclude`` (a module) leaves out the tensors
    whose storage is one of its own (a draft counts the bytes it owns)."""
    skip = storage_ptrs(exclude) if exclude is not None else set()
    seen = {}
    for t in module.state_dict().values():
        if t.untyped_storage().data_ptr() not in skip:
            seen.setdefault((t.data_ptr(), t.numel()), t)
    return sum(t.numel() * t.element_size() for t in seen.values())


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


def _weight_leaves(model) -> List[torch.Tensor]:
    """A model's state-dict tensors, each storage once (a tied weight
    appears under two names), in state-dict order."""
    seen, out = set(), []
    for t in model.state_dict().values():
        key = (t.untyped_storage().data_ptr(), t.storage_offset(), t.numel())
        if key not in seen:
            seen.add(key)
            out.append(t)
    return out


def weight_storages(model) -> set:
    """The storage addresses behind a model's served weights (its
    state-dict tensors; non-persistent buffers such as the RoPE table,
    which a quantized copy shares with its float source, are no weights)."""
    return {t.untyped_storage().data_ptr() for t in _weight_leaves(model)
            if t.untyped_storage().nbytes()}


def _weak(method):
    """A bound method as a function that holds its object weakly: the
    engine's ledgered programs must not put the engine in a reference cycle,
    or a dropped engine's pool waits for the cycle collector."""
    ref = weakref.WeakMethod(method)

    def call(*args, **kwargs):
        return ref()(*args, **kwargs)

    call.__name__ = method.__name__
    return call


# the live engines serving each module (weak on both sides): a params flip
# is refused where another engine serves the same weights
_SERVING: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _claim_weights(engine, injector) -> None:
    """Register ``engine`` as serving its model; refuse (``ValueError``) a
    ``flip_bits("params")`` schedule on weights another live engine serves,
    and a second engine over weights a params-flipping engine serves: the
    flip would corrupt every engine at once, so no vote could see it."""
    engines = _SERVING.setdefault(engine.model, weakref.WeakSet())
    flips = injector is not None and injector.flips_params

    def conflict() -> bool:
        others = [e for e in engines if not e._halted]
        return bool(others) and (flips or any(e._faults is not None and e._faults.flips_params
                                              for e in others))

    if conflict():
        gc.collect()  # the conflict may be an engine gone but waiting in a reference cycle
        if conflict():
            raise ValueError("flip_bits('params') needs an engine whose weights no other live "
                             "engine serves (the flip lands in place and would corrupt them "
                             "all): give each engine its own module (copy.deepcopy), or "
                             "quantize=, which owns its tensors")
    engines.add(engine)


class ServingEngine:
    """Slot-based continuous batching over a causal LM whose weights live on
    its device (``model.device``); every tensor the engine makes lives there
    too. ``draft_model`` (a causal LM on the same device, with the target's
    vocabulary and ``max_seq_len``) turns decode into speculative rounds of
    ``gamma`` draft tokens. The port's modules carry their own weights:
    without ``draft_params`` the engine serves ``draft_model`` as given (the
    draft of
    :func:`~neuronx_distributed_tpu_torch.models.llama.early_exit_draft`
    shares the target's tensors); ``draft_params`` (a state dict of
    ``draft_model``'s names) gives the engine a draft module of its own
    that holds those values."""

    def __init__(
        self,
        model,
        num_slots: int,
        max_tokens_in_flight: Optional[int] = None,
        admission: str = "conservative",
        scheduling="fifo",
        decode_chunk_size: int = 8,
        max_queue: Optional[int] = None,
        kv_page_size: Optional[int] = None,
        kv_num_pages: Optional[int] = None,
        kv_host_pages: Optional[int] = None,
        prefix_cache="auto",
        draft_model=None,
        gamma: int = 4,
        quantize=None,
        dispatch_retry: Optional[RetryPolicy] = None,
        degraded_cooldown_chunks: int = 8,
        quarantine_policy: str = "requeue",
        fault_injector=None,
        flight_recorder="auto",
        flight_dir: Optional[str] = None,
        time_fn: Callable[[], float] = time.monotonic,
        sleep_fn: Callable[[float], None] = time.sleep,
        timeline=None,
        registry=None,
        engine_label: Optional[str] = None,
        slo=None,
        draft_params=None,
        program_ledger=None,
        profile_dir: Optional[str] = None,
        rid_base: int = 0,
    ):
        if rid_base < 0:
            raise ValueError(f"rid_base must be >= 0, got {rid_base}")
        if admission not in ("conservative", "eager"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if quarantine_policy not in ("requeue", "fail"):
            raise ValueError(f"unknown quarantine policy {quarantine_policy!r}")
        if kv_page_size is None and kv_num_pages is not None:
            raise ValueError("kv_num_pages needs kv_page_size")
        if kv_page_size is None and kv_host_pages is not None:
            raise ValueError("kv_host_pages needs kv_page_size")
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
            if draft_params is not None:
                draft_model = self._own_draft(draft_model, draft_params)
        elif draft_params is not None:
            raise ValueError("draft_params needs draft_model")
        if quantize is not None:
            model = self._quantized(model, quantize, kv_page_size, draft_model)
        # a float state dict assigned to ``params`` is quantized with this
        self._weight_qcfg = quantize.weight_qconfig() if quantize is not None else None
        # a draft that shares tensors with the target can take no weights of
        # its own (the draft_params setter, a poisoned draft)
        self._draft_aliases = draft_model is not None and shares_storage(draft_model, model)
        if (fault_injector is not None and self._draft_aliases
                and fault_injector.poisons_draft):
            raise ValueError(self._alias_refusal("poison_draft"))
        self._draft_clean = None  # a poisoned dispatch's clean copy of the draft
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
        self._clock, self._sleep = time_fn, sleep_fn
        self.timeline = timeline
        self._vocab = model.config.vocab_size
        # dispatch recovery: bounded consecutive failures, waits from the
        # shared decrementing-jitter schedule (JAX's defaults, engine.py:674)
        self._dispatch_retry = dispatch_retry or RetryPolicy(max_attempts=3, first_wait=0.05,
                                                             min_wait=0.01)
        self._degraded_cooldown = degraded_cooldown_chunks
        self._quarantine_policy = quarantine_policy
        self._faults = fault_injector
        if flight_recorder == "auto":
            flight_recorder = FlightRecorder(dump_dir=flight_dir, subsystem="serving")
        self.flight = flight_recorder  # None disables
        # the fault-tolerance state machine (JAX engine.py:826-837)
        self._halted = False
        self._halt_reason: Optional[str] = None
        self._draining = False
        self._consecutive_dispatch_failures = 0
        self._had_dispatch_failure = False
        self._chunks_since_failure = 0
        self._dispatch_attempts = 0  # failed attempts included (the hook index)
        self._readbacks = 0  # successful readbacks (the poison hooks' index)
        self._prefill_calls = 0  # prefill attempts (the prefill hook's index)
        self._consecutive_prefill_failures = 0
        self._prefix_reuses = 0  # prefix reuse attempts (the prefix hook's index)
        self._last_health = EngineHealth.OK
        self._prefill_model, self._decode_model = serving_clones(model)
        # the policy owns queue order and victim choice; every mechanism it
        # rides (requeue and resume, slot release) is the engine's own
        self.scheduler = Scheduler(max_tokens_in_flight, policy=scheduling)
        self.policy = self.scheduler.policy
        self._page_size = kv_page_size
        if kv_page_size is None:
            self.cache = SlotCacheManager(num_slots, model.new_cache(num_slots))
        else:
            self.cache = PagedCacheManager.for_model(
                model, num_slots, kv_page_size, kv_num_pages,
                kv_quant=quantize.kv if quantize is not None else None)
        # the host page tier behind the pool (None: the single-tier engine);
        # its arena is allocated here, once, before any capture
        self.tier = (HostPageStore(kv_host_pages, layout=self.cache.page_layout(),
                                   pin_memory=self.device.type == "cuda")
                     if kv_host_pages is not None else None)
        self._spill_index = 0     # spill attempts (the chaos hook's index)
        self._prefetch_index = 0  # prefetch attempts (the chaos hook's index)
        self.metrics = ServingMetrics(num_slots, registry=registry, engine_label=engine_label,
                                      slo=slo)
        # every program the engine dispatches registers in a program ledger
        # (JAX engine.py:795-808): dispatches, compiles (new signatures and
        # graph captures), cost per variant (metered at a capture or a
        # prewarm replay, never inside a request), walls; pass
        # program_ledger= to share one, else one rides the engine's view
        self.programs = (program_ledger if program_ledger is not None else ProgramLedger(
            view=self.metrics.view, prefix="serving", subsystem="serving", timeline=timeline,
            device=self.device))
        self.metrics.attach_programs(self.programs)
        self._prefill_fns: Dict[int, Any] = {}
        self._draft_prefill_fns: Dict[int, Any] = {}
        self._suffix_fn = self.programs.wrap("suffix_prefill", _weak(self._suffix_call))
        self._first_token = self.programs.wrap("first_token", sample_row)
        self._slot_write = self.programs.wrap("slot_write", _weak(self._write_slot_row))
        self._slot_clear = self.programs.wrap("slot_clear", _weak(self._clear_slot_row))
        self._extract_fn = self.programs.wrap("prefix_extract", extract_cache_prefix)
        self._seed_fn = self.programs.wrap("prefix_seed", seed_cache_prefix)
        self._fingerprint_fn = self.programs.wrap("prefix_fingerprint", cache_fingerprint)
        self._pages_fp_fn = self.programs.wrap("pages_fingerprint", _weak(self._pages_fp_call))
        # profile_dir= profiles decode chunks [2, 5) (JAX engine.py:3140-3162)
        self._profile_dir = profile_dir
        self._profiler = None
        # the SLO policy reads the metrics, the prefix store and the cache's
        # host tables (FIFO ignores the engine)
        self.policy.bind(self)
        # one connected flow per request on the timeline (a no-op without one)
        self.tracer = RequestTracer(timeline)
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
        # rid_base namespaces request ids across engines: the replica router
        # moves live requests between replicas, which mint from disjoint
        # ranges of RID_STRIDE ids (JAX engine.py:815-818)
        self._rid_base = int(rid_base)
        self._next_rid = int(rid_base)
        # disaggregated serving: True leaves ALL prefill work to external
        # workers; step() keeps decoding but never admits from the queue,
        # and the DisaggregatedServer hands contexts in through admit_staged
        self.external_prefill = False
        # streaming callbacks of adopted and restored requests: cb(req, tok)
        self._on_token: Dict[int, Callable[[Request, int], None]] = {}
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
        self._chunk.program = self.programs.wrap(self._chunk_name, self._chunk.program)
        # a speculative engine's plain step, built at its first fallback
        self._plain_chunk = None
        self.host_reads = 0
        self._steps_seen = 0  # step() calls (the params-flip hook's index)
        self.last_prewarm = None  # the report of the last manifest prewarm
        self._integrity_fp = None  # TF over integrity_leaves(), built at the first probe
        _claim_weights(self, fault_injector)
        self.hbm = self._ledger()

    def _ledger(self) -> HBMLedger:
        """The engine's HBM ledger (JAX ``engine.py:930-972``): its residents
        as weak reads over live tensors, sized in KV pages (paged; host
        pages in the host tier) or slot rows; ``metrics.snapshot()["hbm"]``.
        With a host tier, its occupancy and bytes are registry gauges too."""
        hbm = HBMLedger(device=self.device, view=self.metrics.view)

        def res(fn):
            return weak_reader(self, fn)

        hbm.add_resident("params", res(lambda e: _module_nbytes(e.model)))
        hbm.add_resident("slot_state", res(lambda e: tree_nbytes(e._state)))
        if self._page_size is not None:
            hbm.add_resident("kv_pages", res(lambda e: e.cache.nbytes),
                             unit_bytes=res(lambda e: e.cache.page_nbytes),
                             count=res(lambda e: e.cache.alloc.capacity), unit="page")
            if self.tier is not None:
                hbm.add_resident("kv_host_pages", res(lambda e: e.tier.nbytes),
                                 unit_bytes=res(lambda e: e.cache.page_nbytes),
                                 count=res(lambda e: e.tier.used_pages), unit="page",
                                 tier="host")
                view = self.metrics.view
                view.gauge("serving_kv_host_pages_used",
                           help="spilled KV pages resident in the host tier").set_fn(
                    weak_reader(self, lambda e: e.tier.used_pages, -1))
                view.gauge("serving_kv_host_bytes",
                           help="host-RAM bytes held by spilled KV pages").set_fn(
                    weak_reader(self, lambda e: e.tier.nbytes, -1))
        else:
            hbm.add_resident("kv_cache", res(lambda e: e.cache.nbytes),
                             unit_bytes=res(lambda e: e.cache.slot_nbytes),
                             count=self.num_slots, unit="slot")
        if self.draft_model is not None:
            # the bytes the draft owns: an early-exit draft's are the target's
            hbm.add_resident("draft_params",
                             res(lambda e: _module_nbytes(e.draft_model, exclude=e.model)))
            hbm.add_resident("draft_kv", res(lambda e: e.draft_cache.nbytes))
        if self.prefix is not None:
            hbm.add_resident("prefix_cache",
                             res(lambda e: e.prefix.nbytes if e.prefix is not None else 0))
        self.metrics.attach_hbm(hbm)
        return hbm

    @staticmethod
    def _quantized(model, quantize, kv_page_size, draft_model):
        """The model the engine serves under ``quantize`` (JAX
        ``engine.py:528-557``, with its validation): ``model`` itself for
        KV-only quantization, else its quantized copy, which owns every
        tensor a weight swap writes (the caller's float model never
        changes). A draft stays float and must share no tensor with
        ``model``; beside an int8 target pool (``quantize.kv``) its pool
        stays float too (JAX ``engine.py:514-527``)."""
        if quantize.kv is not None and kv_page_size is None:
            raise ValueError("quantize.kv needs kv_page_size= (quantized KV is page-granular "
                             "— the row layout stays float)")
        if draft_model is not None and shares_storage(draft_model, model):
            raise ValueError("quantize= with draft_model= is not served for a draft that shares "
                             "the target's tensors (the early-exit draft), which quantization "
                             "replaces; pass draft_params= to give the draft tensors of its own")
        qcfg = quantize.weight_qconfig()
        if qcfg is None:
            return model
        cfg = getattr(model, "config", None)
        if not hasattr(cfg, "quantization"):
            raise ValueError("quantize.weights needs a model whose config carries a "
                             f"'quantization' field (Llama, Mixtral, DBRX); got "
                             f"{type(cfg).__name__}")
        if cfg.quantization is not None:
            raise ValueError("model already carries a quantization config — pass the float "
                             "model (the engine quantizes) or drop quantize=")
        return quantize_model(model, qcfg)

    @staticmethod
    def _own_draft(draft_model, draft_params):
        """A draft module of the engine's own, of ``draft_model``'s class
        and configuration, holding ``draft_params`` (JAX binds
        ``draft_params`` into ``draft_model``'s program, ``engine.py:749``):
        never ``draft_model`` itself, which may be the target."""
        own = type(draft_model)(draft_model.config, device=draft_model.device,
                                trainable=getattr(draft_model, "trainable", False))
        copy_state_dict_(own, draft_params, "draft_params")
        return own

    @staticmethod
    def _alias_refusal(what: str) -> str:
        return (f"{what} needs a draft with tensors of its own: this draft shares the target's "
                "tensors (the early-exit draft), so writing it would write the target; pass "
                "draft_params= to give the draft tensors of its own")

    def _reset_caches(self, recovery: bool = False) -> None:
        """Rewind the cache and the draft twin in lockstep, in place: every
        slot but the quarantined ones free, every validity row clear,
        cursors at column 0. ``recovery`` (a failed dispatch) also voids the
        pool's prefetch holds, as JAX's ``recover`` does; a drain, a
        preemption or a halt keeps them (JAX ``reset``)."""
        for mgr in self._managers:
            if recovery:
                mgr.recover()
            else:
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
        chunk on, whatever the churn, preemption, cancellation, dispatch
        recovery or quarantine (the JAX engine's ``decode_compilations``,
        one jitted chunk per engine, the ``spec_decode_chunk`` with a draft
        model); a speculative engine that fell back to the plain step
        counts that program too, as JAX does; 0 on the CPU, where the step
        runs eagerly and nothing is captured."""
        plain = self._plain_chunk.program.captures if self._plain_chunk is not None else 0
        return self.decode_program.captures + plain

    def _plain_step_chunk(self):
        """A speculative engine's plain decode chunk over the target cache
        and the same slot state (JAX ``_nonspec_chunk``, ``engine.py:3188``):
        the program a spec-off engine runs, built (and on the card captured)
        at the first fallback."""
        if self._plain_chunk is None:
            self._plain_chunk = decode_chunk(self._decode_model, self.decode_chunk_size,
                                             self.max_seq_len, self.cache.cache, self._state)
            self._plain_chunk.program = self.programs.wrap("decode_chunk",
                                                           self._plain_chunk.program)
        return self._plain_chunk

    @property
    def _chunk_name(self) -> str:
        """The decode program's ledger name (JAX's)."""
        return "decode_chunk" if self.draft_model is None else "spec_decode_chunk"

    def _prefill_fn(self, padded: int, draft: bool = False):
        """The ledgered eager prefill at padded length ``padded`` (JAX
        ``prefill[N]`` and ``draft_prefill[N]``): ``(ids, row, mask) ->
        logits`` of the last position."""
        fns = self._draft_prefill_fns if draft else self._prefill_fns
        fn = fns.get(padded)
        if fn is None:
            model = self._draft_prefill_model if draft else self._prefill_model

            def prefill(ids, row, mask):
                return model(ids, cache=row, padding_mask=mask, last_only=True)

            fn = fns[padded] = self.programs.wrap(
                f"{'draft_' if draft else ''}prefill[{padded}]", prefill)
        return fn

    def _suffix_call(self, row, ids, n):
        return suffix_prefill_step(self._decode_model, row, ids, n)

    def _write_slot_row(self, slot, tok, seed, ntok, active, remaining, temp, topk, topp, eos):
        """A slot's device state written at admission (JAX ``slot_write``):
        in place, the captured step reads these buffers."""
        for name, value in (("tok", tok), ("seed", seed), ("ntok", ntok), ("active", active),
                            ("remaining", remaining), ("temp", temp), ("topk", topk),
                            ("topp", topp), ("eos", eos)):
            self._state[name][slot] = value

    def _clear_slot_row(self, slot):
        """A released slot's device ``active`` flag cleared in place (JAX
        ``slot_clear``)."""
        self._state["active"][slot] = False

    def _pages_fp_call(self, page_ids):
        return pool_pages_fingerprint(self.cache.cache, page_ids)

    def prewarm(self, manifest=None, cache_dir: Optional[str] = None):
        """With no argument: capture the decode program now, on an idle
        engine, so that no request waits for it; the capture's warm-up runs
        one masked no-op step at the rewound cursor and leaves no trace.
        Returns the capture's wall seconds (0 on the CPU or when already
        captured), also recorded in the metrics.

        With ``manifest`` (a :class:`~neuronx_distributed_tpu_torch.
        inference.aot.ProgramManifest`, or a path) or ``cache_dir`` (a
        directory holding ``manifest.json`` and kernel libraries,
        :meth:`save_aot`), JAX's ``prewarm`` (``engine.py:2153``): the
        manifest's kernel libraries loaded from ``cache_dir`` (or built;
        ``SkewError`` when their source hash is not this tree's), then every
        manifest program replayed once on dummies under the ledger's
        ``prewarming()``: the decode step captured, each prefill bucket and
        the other programs dispatched at their recorded signatures. The
        caches and the slot state are reset after. Returns (and keeps as
        ``last_prewarm``) the report of
        ``inference/aot.prewarm_programs`` (``deserialized`` always empty:
        a CUDA graph cannot be serialized). JAX's ``mode=`` has no
        counterpart: replaying is the port's one rung."""
        if self._active.any():
            raise ValueError("prewarm runs on an idle engine; slots are active")
        if manifest is None and cache_dir is None:
            if self.cache.cursor > 0:
                self._reset_caches()
            seconds = self.decode_program.capture()
            if seconds:
                self.metrics.record_capture(seconds)
            return seconds
        from neuronx_distributed_tpu_torch.inference import aot

        if manifest is None:
            manifest = aot.ProgramManifest.load(cache_dir)
        elif isinstance(manifest, (str, os.PathLike)):
            manifest = aot.ProgramManifest.load(os.fspath(manifest))
        self._reset_caches()
        try:
            report = aot.prewarm_programs(manifest, self._aot_resolve, ledger=self.programs,
                                          cache_dir=cache_dir, flight=self.flight,
                                          device=self.device)
        finally:
            self._reset_caches()
            self._reset_slot_state()
        self.last_prewarm = report
        captured = self.decode_program.capture_s if self.decode_compilations else 0.0
        if captured and "decode_chunk" in report["compiled"] + report["replayed"]:
            self.metrics.record_capture(captured)
        return report

    def manifest(self):
        """The :class:`~neuronx_distributed_tpu_torch.inference.aot.
        ProgramManifest` of every program this engine has dispatched (JAX
        ``manifest``, ``engine.py:2073``): the prewarm input of a replica
        spawned later."""
        return self.programs.manifest()

    def save_aot(self, cache_dir: str) -> dict:
        """Write this engine's warm-spawn bundle into ``cache_dir``: its
        ``manifest.json`` and the kernel libraries the process loaded.
        Returns ``{"manifest": path, "kernels": [file names]}``."""
        from neuronx_distributed_tpu_torch.inference import aot

        os.makedirs(cache_dir, exist_ok=True)
        return {"manifest": self.manifest().save(cache_dir), "kernels": aot.save_kernels(cache_dir)}

    def _aot_resolve(self, name: str):
        """The replay callable of a manifest program, None when this engine
        has no such program: the ledger proxy itself where the recorded
        arguments are tensors and scalars, a replayer that admits a scratch
        slot for one with a cache view (the prefills), the capture for the
        decode programs. Prefix extract, seed and fingerprint take a stored
        entry and are not replayed (``UnportableError``)."""
        import re

        from neuronx_distributed_tpu_torch.inference.aot import UnportableError

        if name in ("prefix_extract", "prefix_seed", "prefix_fingerprint"):
            raise UnportableError("runs on a stored prefix entry: first dispatched at the first hit")

        if name == self._chunk_name:
            prog = self._chunk.program
        elif name == "decode_chunk" and self.draft_model is not None:
            prog = self._plain_step_chunk().program
        else:
            prog = None
        if prog is not None:
            def capture(*args, **kwargs):
                prog.capture()

            capture._record = prog._record
            return capture
        m = re.fullmatch(r"(draft_)?prefill\[(\d+)\]", name)
        if m is not None:
            draft, padded = bool(m.group(1)), int(m.group(2))
            if draft and self.draft_model is None:
                return None
            fn = self._prefill_fn(padded, draft=draft)
            mgr = self.draft_cache if draft else self.cache
            return self._scratch_replayer(fn, mgr, padded)
        if name == "suffix_prefill":
            def suffix(row, ids, n):
                self._scratch_replayer(self._suffix_fn, self.cache, ids.shape[1])(row, ids, n)

            suffix._record = self._suffix_fn._record
            return suffix
        fixed = {"first_token": self._first_token, "slot_write": self._slot_write,
                 "slot_clear": self._slot_clear, "pages_fingerprint": self._pages_fp_fn}
        if name in fixed:
            return fixed[name]
        if name == "integrity_fingerprint":
            return self._integrity_program()
        return None

    def _scratch_replayer(self, fn, mgr, padded: int):
        """A replayer of ``fn`` whose recorded row argument was a cache view:
        slot 0 admitted at ``padded`` columns, ``fn`` called with the view
        in place of the stand-in, the slot freed (the caller resets the
        caches)."""

        def replay(*args):
            kw = {} if self._page_size is None else {"p": padded}
            row = mgr.admit(0, padded, cursor=padded if self._page_size is None else None, **kw)
            try:
                fn(*[row if type(a).__name__ == "Opaque" else a for a in args])
            finally:
                mgr.free(0)

        replay._record = fn._record
        return replay

    def _host_read(self, t: torch.Tensor) -> np.ndarray:
        """THE device→host read of the engine (the ``jax.device_get`` of the
        JAX engine): every host view of device data goes through here, so
        ``host_reads`` counts them."""
        self.host_reads += 1
        return t.cpu().numpy()

    def _now(self) -> float:
        """The engine's scheduling clock: ``time_fn``, skewed by the fault
        injector when one is set (JAX ``_now``, ``engine.py:1396``)."""
        now = self._clock()
        if self._faults is not None:
            now = self._faults.now(now)
        return now

    # --- health -------------------------------------------------------------

    def health(self) -> EngineHealth:
        """The current health (JAX ``health``, ``engine.py:1873``)."""
        if self._halted:
            return EngineHealth.HALTED
        if self._draining:
            return EngineHealth.DRAINING
        if (self.cache.usable_slots < self.num_slots or getattr(self.cache, "degraded", False)
                or (self._had_dispatch_failure
                    and self._chunks_since_failure < self._degraded_cooldown)):
            return EngineHealth.DEGRADED
        return EngineHealth.OK

    @property
    def halt_reason(self) -> Optional[str]:
        return self._halt_reason

    def drain(self) -> None:
        """Stop admitting NEW work: submissions are rejected, never-admitted
        queued requests stay queued (and stop counting as work), requests
        already admitted (in a slot, or preempted back to the queue) run to
        completion; ``run()`` returns once they finish."""
        self._draining = True
        if self.timeline is not None:
            self.timeline.instant("drain", "serving")
        self._sync_health()

    def resume(self) -> None:
        """Leave DRAINING and accept work again (no effect while HALTED)."""
        self._draining = False
        self._sync_health()

    def _halt(self, reason: str) -> None:
        """The HALTED contract (JAX ``_halt``, ``engine.py:1921``): in-flight
        work is REQUEUED with its host-current tokens, never stranded; the
        caches and slot state are reset in place; no prefix pin survives;
        the flight recorder dumps its post-mortem."""
        requeued = self._vacate_active()
        if requeued:
            self.scheduler.requeue_front(requeued)
            self._reset_caches()
            self._reset_slot_state()
        if self.prefix is not None:
            self.prefix.release_all()
        self._stop_profile()
        self._halted = True
        self._halt_reason = reason
        if self.timeline is not None:
            self.timeline.instant("halted", "serving", args={"reason": reason})
        self._sync_health()
        if self.flight is not None:
            self.flight.record("halt", reason=reason)
            # who was waiting when the engine halted (after the requeue, so
            # the in-flight work counts) and the SLO state, flat enough for
            # the recorder's depth-capped redaction (JAX engine.py:1957-1988)
            # the ledger rides as flat scalars (the recorder's depth-capped
            # redaction keeps them), not nested in the metrics snapshot
            snap = self.metrics.snapshot()
            snap.pop("hbm", None)
            snap.pop("programs", None)
            extra = {"requeued": len(requeued), "metrics": snap,
                     "tenant_queue_depths": self.scheduler.queued_by_tenant(),
                     "hbm": self.hbm.halt_summary(),
                     "programs": self.programs.halt_summary()}
            if self.tier is not None:
                # where the spill tier stood (JAX engine.py:1982-1985)
                extra["kv_host_tier"] = self.tier.summary()
            if self.metrics.slo is not None:
                extra["slo"] = self.metrics.slo.per_tenant()
                extra["slo_totals"] = self.metrics.slo.totals()
            self.flight.dump(reason, extra=extra)
        if self.timeline is not None:
            self.timeline.save()

    def _sync_health(self) -> None:
        h = self.health()
        self.metrics.health = h.value
        if h is not self._last_health:
            if self.timeline is not None:
                self.timeline.instant(f"health {h.value}", "serving")
            if self.flight is not None:
                self.flight.record("health", value=h.value, was=self._last_health.value)
            self._last_health = h

    # --- public API ---------------------------------------------------------

    def submit(self, prompt_ids, config: GenerationConfig = GenerationConfig(),
               seed: Optional[int] = None, deadline_s: Optional[float] = None,
               queue_timeout_s: Optional[float] = None, tenant: Optional[str] = None,
               priority: Optional[str] = None,
               on_token: Optional[Callable[[Request, int], None]] = None) -> Request:
        """Enqueue one request; returns its live ``Request``. ``seed``
        (default: the request id) selects its sampling stream — pass the
        seed you would give ``generate`` to reproduce its stream.
        ``on_token(req, tok)`` streams each of its tokens as it is emitted.

        ``tenant`` (default ``"default"``) and ``priority`` (a tier of
        ``serving/sched/priority.py``, default ``"standard"``) attribute the
        request: per-tenant latencies and counters, SLO classification,
        trace flows and flight events; the SLO policy orders by them. Host
        strings only.

        ``deadline_s`` bounds the request end to end (it is shed, TIMED_OUT,
        at the next chunk boundary past it, keeping the tokens it streamed);
        ``queue_timeout_s`` sheds it if it is not admitted in time; both
        count from submission on the engine clock. The queue timeout governs
        FIRST admission only: a request requeued by preemption or recovery
        answers to ``deadline_s`` alone.

        Raises :class:`RejectedError` when the engine is draining or halted
        or the bounded queue is full, and ``ValueError`` for a request that
        could never be placed (it fails at the door instead of livelocking
        ``run()`` at the queue's head)."""
        tenant = str(tenant) if tenant is not None else "default"
        priority = str(priority) if priority is not None else "standard"
        health = self.health()
        if health in (EngineHealth.DRAINING, EngineHealth.HALTED):
            depth = self.scheduler.queued
            self.metrics.record_reject(depth, health.value, tenant=tenant, now=self._now())
            raise RejectedError(f"engine is {health.value}; not accepting new requests",
                                queue_depth=depth)
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if config.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if queue_timeout_s is not None and queue_timeout_s <= 0:
            raise ValueError(f"queue_timeout_s must be > 0, got {queue_timeout_s}")
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
            self.metrics.record_reject(depth, "queue full", tenant=tenant, now=self._now())
            if self.timeline is not None:
                self.timeline.instant("reject", "serving",
                                      args={"queue_depth": depth, "tenant": tenant})
            raise RejectedError(f"queue full ({depth} >= max_queue {self.max_queue})",
                                queue_depth=depth)
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, config=config,
                      seed=rid if seed is None else int(seed), tenant=tenant, priority=priority)
        req.submit_time = self._now()
        if deadline_s is not None:
            req.deadline = req.submit_time + deadline_s
        if queue_timeout_s is not None:
            req.queue_deadline = req.submit_time + queue_timeout_s
        self.scheduler.submit(req)
        if on_token is not None:
            self._on_token[rid] = on_token
        self.metrics.record_submit(req, req.submit_time)
        if self.timeline is not None:
            self.timeline.instant(f"submit r{rid}", "serving")
        # the request's flow opens here, tagged with its tenant and priority
        self.tracer.begin(rid, args={"prompt_len": int(prompt.size), "tenant": tenant,
                                     "priority": priority})
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
            self.metrics.record_cancel(req, self._now())
            self._on_token.pop(rid, None)
            self.tracer.end(rid, "cancelled", args={"where": "queued"})
        return ok

    # --- weights that change ------------------------------------------------

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The served model's state dict (its tensors, by reference)."""
        return self.model.state_dict()

    @params.setter
    def params(self, value: Dict[str, torch.Tensor]) -> None:
        """A weight swap (JAX ``engine.py:1344-1375``), between steps: the
        new values written IN PLACE into the served model's tensors (every
        key, shape and dtype checked first; a refused dict writes nothing),
        so the captured programs read them at their next replay with no
        recapture. Under ``quantize=`` a float dict is quantized once
        (``quantize_state_dict``) and a pre-quantized one binds as is. A
        float engine serves the caller's module, which the swap writes. The
        prefix store is cleared: its K/V was computed under the old
        weights. Slots still decoding keep the K/V they have."""
        if self._weight_qcfg is not None and not is_quantized_state_dict(value):
            value = quantize_state_dict(value, self._weight_qcfg)
        copy_state_dict_(self.model, value, "params")
        if self.flight is not None:
            self.flight.record("params_swap")
        if self.prefix is not None:
            dropped = self.prefix.clear()  # releases the pins and the host pages
            if dropped:
                self.metrics.record_prefix_eviction(dropped)
                if self.timeline is not None:
                    self.timeline.instant("prefix_evict", "serving", args={"evicted": dropped})

    @property
    def draft_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The draft model's state dict (speculative engines; None
        without a draft)."""
        return self.draft_model.state_dict() if self.draft_model is not None else None

    @draft_params.setter
    def draft_params(self, value: Dict[str, torch.Tensor]) -> None:
        """A draft swap (JAX ``engine.py:1387-1394``), in place like
        ``params``; safe mid-flight (the emitted streams never depend on the
        draft), slots admitted under the old draft keep its K/V. A
        ``draft_model`` served as given (no ``draft_params=``) is the
        caller's module, which the swap writes."""
        if value is None:
            raise ValueError("draft_params cannot be unset on a live engine")
        if self.draft_model is None:
            raise ValueError("draft_params needs an engine with a draft_model")
        if self._draft_aliases:
            raise ValueError(self._alias_refusal("assigning draft_params"))
        copy_state_dict_(self.draft_model, value, "draft_params")

    def _draft_floats(self) -> List[torch.Tensor]:
        """The draft's floating-point tensors, each storage once."""
        seen = {}
        for t in self.draft_model.state_dict().values():
            if t.is_floating_point():
                seen.setdefault((t.data_ptr(), t.numel()), t)
        return list(seen.values())

    def _poison_draft(self) -> None:
        """A poisoned dispatch's draft (JAX ``on_spec_params``,
        ``faults.py:461-480``, which corrupts a copy): the clean values
        kept, every float tensor made ``-w + 3.7`` in place, the addresses
        the captured round reads."""
        floats = self._draft_floats()
        if self._draft_clean is None:
            self._draft_clean = [torch.empty_like(t) for t in floats]
        for t, clean in zip(floats, self._draft_clean):
            clean.copy_(t)
            t.neg_().add_(3.7)

    def _heal_draft(self) -> None:
        """The clean values back after the poisoned dispatch, on the main
        stream (after the round's replays)."""
        for t, clean in zip(self._draft_floats(), self._draft_clean):
            t.copy_(clean)

    # --- integrity ------------------------------------------------------------

    def integrity_leaves(self) -> List[torch.Tensor]:
        """Every tensor the engine serves, each storage once, in the served
        model's state-dict order: a quantized engine's codes, scales,
        embedding and norms, a float engine's parameters (the caller's
        module). The fingerprint's and the params flip's fixed order."""
        return _weight_leaves(self.model)

    def integrity_fingerprint(self) -> int:
        """The uint32 fingerprint of the served weights (JAX
        ``integrity_fingerprint``, ``engine.py:1847``), the router's
        cross-replica evidence: weights only (the K/V and slot state differ
        with each replica's traffic). TF over :meth:`integrity_leaves`,
        launched on the engine's stream between chunks (never inside the
        captured step), its tables built at the first probe; one 8-byte
        host read a probe, counted in ``host_reads``. Registered in the
        program ledger as ``integrity_fingerprint``."""
        return int(self._host_read(self._integrity_program()()))

    def _integrity_program(self):
        """The ledgered TF over :meth:`integrity_leaves`, built once."""
        if self._integrity_fp is None:
            from neuronx_distributed_tpu_torch.kernels.tree_fingerprint import TreeFingerprint

            self._integrity_fp = self.programs.wrap(
                "integrity_fingerprint", TreeFingerprint(self.integrity_leaves()))
        return self._integrity_fp

    # --- fence, adopt, warm restart -----------------------------------------

    def fence(self, reason: str = "fenced") -> None:
        """The operator's or watchdog's kill switch (JAX ``fence``,
        ``engine.py:1909``): HALTED now, through the halt contract (the
        in-flight work requeued with its host-current tokens, the
        post-mortem written); a halted engine ignores it."""
        if self._halted:
            return
        self._halt(f"fenced: {reason}")

    def adopt(self, req: Request, on_token=None) -> Request:
        """Take over a live request of ANOTHER engine (JAX ``adopt``,
        ``engine.py:1630``): it keeps its rid, its streamed tokens and its
        seed, and the admission re-prefills its context and continues at
        (seed, token index), the preemption resume, so the stream continues
        bit for bit. ``on_token(req, tok)`` streams its next tokens. Raises
        :class:`RejectedError` while DRAINING or HALTED and ``ValueError``
        for a rid this engine knows. A rid of this engine's own range
        (``rid_base`` up to ``rid_base + RID_STRIDE``) moves its later
        submissions above it, so that they never reuse it; a rid of another
        range (a re-homed request of another replica) leaves the minting as
        it was, so the ranges stay disjoint."""
        health = self.health()
        if health in (EngineHealth.DRAINING, EngineHealth.HALTED):
            raise RejectedError(f"engine is {health.value}; cannot adopt re-homed work",
                                queue_depth=self.scheduler.queued)
        if req.rid in self.scheduler.requests:
            raise ValueError(f"rid {req.rid} already known to this engine")
        req.slot = None
        self.scheduler.submit(req)
        if self._rid_base <= req.rid < self._rid_base + RID_STRIDE:
            self._next_rid = max(self._next_rid, req.rid + 1)
        self.metrics.record_adopt(req, self._now())
        if on_token is not None:
            self._on_token[req.rid] = on_token
        self.tracer.begin(req.rid, args={"prompt_len": int(len(req.prompt)),
                                         "tenant": req.tenant, "priority": req.priority,
                                         "rehomed": True, "tokens_streamed": len(req.tokens)})
        return req

    def snapshot_serving_state(self) -> Dict[str, Any]:
        """The host-current serving state (JAX ``snapshot_serving_state``,
        ``engine.py:1690``): the queue (the active requests first, by rid,
        as a halt requeues them), each unfinished request's prompt, tokens,
        seed, sampling config, attribution, preemptions and absolute
        times, the prefix store's token index (which prefixes were hot, not
        their K/V) and the SLO tracker's counters. JSON-safe; no device
        tensor. The seed stands where JAX keeps the request's PRNG key: the
        port's sampling noise is counter-based on (seed, token index), so
        the seed and the tokens are the whole sampling state."""
        active = sorted((r for r in self._slot_req if r is not None and not r.finished),
                        key=lambda r: r.rid)
        seen = {r.rid for r in active}
        ordered = active + [r for r in self.scheduler.queued_requests if r.rid not in seen]
        reqs = []
        for req in ordered:
            cfg = req.config
            reqs.append({
                "rid": int(req.rid),
                "prompt": [int(x) for x in req.prompt],
                "tokens": [int(t) for t in req.tokens],
                "seed": int(req.seed),
                "config": {
                    "max_new_tokens": int(cfg.max_new_tokens),
                    "temperature": float(cfg.temperature),
                    "top_k": None if cfg.top_k is None else int(cfg.top_k),
                    "top_p": None if cfg.top_p is None else float(cfg.top_p),
                    "eos_token_id": None if cfg.eos_token_id is None else int(cfg.eos_token_id),
                },
                "tenant": req.tenant,
                "priority": req.priority,
                "preemptions": int(req.preemptions),
                "deadline": req.deadline,
                "queue_deadline": req.queue_deadline,
                "submit_time": req.submit_time,
                "admit_time": req.admit_time,
                "first_token_time": req.first_token_time,
            })
        snap: Dict[str, Any] = {
            "version": 1,
            "now": self._now(),
            "next_rid": int(self._next_rid),
            "halted": self._halted,
            "halt_reason": self._halt_reason,
            "requests": reqs,
            "prefix_index": ([[int(t) for t in e.tokens] for e in self.prefix.entries]
                             if self.prefix is not None and self.prefix.enabled else None),
            "tenant_queue_depths": self.scheduler.queued_by_tenant(),
            "slo": self.metrics.slo.state() if self.metrics.slo is not None else None,
        }
        if self.flight is not None:
            self.flight.record("snapshot", requests=len(reqs))
        return snap

    def restore_serving_state(self, snap: Dict[str, Any], on_token=None) -> Dict[str, Any]:
        """Bring a fresh engine back WARM from
        :meth:`snapshot_serving_state` (JAX ``restore_serving_state``,
        ``engine.py:1760``): every unfinished request rejoins the queue in
        snapshot order with its tokens and seed (the resume continues each
        stream bit for bit), every absolute time shifted by the clock delta
        (a request with 4 s of deadline left at the snapshot has 4 s here),
        the SLO counters merged. ``on_token`` streams every restored
        request. Raises ``ValueError`` for an unknown version or a rid this
        engine knows (a snapshot restores exactly once) and
        :class:`RejectedError` on a halted engine. Returns ``{"restored",
        "downtime_s", "rid_floor"}``."""
        if snap.get("version") != 1:
            raise ValueError(f"unknown serving-state snapshot version {snap.get('version')!r}")
        if self._halted:
            raise RejectedError("engine is halted; cannot restore work")
        now = self._now()
        delta = now - float(snap["now"])
        for r in snap["requests"]:
            if int(r["rid"]) in self.scheduler.requests:
                raise ValueError(f"rid {r['rid']} already known to this engine — a serving-state "
                                 "snapshot restores exactly once")

        def shift(t):
            return None if t is None else t + delta

        for r in snap["requests"]:
            req = Request(rid=int(r["rid"]), prompt=np.asarray(r["prompt"], np.int32),
                          config=GenerationConfig(**r["config"]), seed=int(r["seed"]),
                          tenant=r.get("tenant", "default"),
                          priority=r.get("priority", "standard"))
            req.tokens = [int(t) for t in r["tokens"]]
            req.preemptions = int(r.get("preemptions", 0))
            for name in ("deadline", "queue_deadline", "submit_time", "admit_time",
                         "first_token_time"):
                setattr(req, name, shift(r.get(name)))
            self.scheduler.submit(req)
            self.metrics.record_adopt(req, now)
            if on_token is not None:
                self._on_token[req.rid] = on_token
            self.tracer.begin(req.rid, args={"prompt_len": int(len(req.prompt)),
                                             "tenant": req.tenant, "priority": req.priority,
                                             "restored": True,
                                             "tokens_streamed": len(req.tokens)})
        restored = len(snap["requests"])
        self._next_rid = max(self._next_rid, int(snap["next_rid"]))
        if snap.get("slo") and self.metrics.slo is not None:
            self.metrics.slo.restore_state(snap["slo"], shift_s=delta)
        downtime = max(delta, 0.0)
        self.metrics.record_restore(restored, downtime)
        if self.flight is not None:
            self.flight.record("restore", requests=restored, downtime_s=downtime)
        if self.timeline is not None:
            self.timeline.instant("restore", "serving", args={"requests": restored})
        self._sync_health()
        return {"restored": restored, "downtime_s": downtime, "rid_floor": int(self._next_rid)}

    # --- the replica router's and disaggregation's surface -----------------

    def page_pressure(self) -> float:
        """Projected page demand of every admitted and queued request over
        the pool's capacity (JAX ``page_pressure``, ``engine.py:1577``; 0.0
        on a row engine): the router's overcommit signal. Worst case: each
        request's page span over its whole generation plus one page of
        alignment gap, sharing ignored; >= 1.0 means the backlog cannot
        coexist. A host tier adds the pages its free room could take off
        the pool by spilling cold prefix entries."""
        if self._page_size is None:
            return 0.0
        cap = self.cache.alloc.capacity
        if self.tier is not None:
            cap += min(self.tier.free_pages, self.cache.reclaimable_pages())
        cap = max(cap, 1)
        span = 0
        live = [r for r in self._slot_req if r is not None] + self.scheduler.queued_requests
        for r in live:
            cols = len(r.prompt) + len(r.tokens) + r.remaining_new_tokens + self.gamma - 1
            span += self.cache.page_span(0, min(cols, self.max_seq_len)) + 1
        return span / cap

    def load_score(self, tenant: Optional[str] = None) -> float:
        """The router's balancing signal (JAX ``load_score``,
        ``engine.py:1610``): active slots plus queued requests plus the page
        pressure in slot units; with ``tenant=`` the policy's attainment
        bias for that tenant, also in slot units (FIFO's is 0.0)."""
        score = float(int(self._active.sum()) + self.scheduler.queued) \
            + self.page_pressure() * self.num_slots
        if tenant is not None:
            score += self.policy.route_bias(tenant) * self.num_slots
        return score

    def release_queued(self, rid: int):
        """Withdraw a never-admitted QUEUED request so that another replica
        can :meth:`adopt` it (JAX ``release_queued``, ``engine.py:1667``:
        the router's live-join rebalancing and drain-out). Returns
        ``(request, on_token)``, both now the caller's, or ``(None, None)``
        for a rid that is unknown, finished or was ever admitted (in-flight
        work stays here until it halts or finishes)."""
        req = self.scheduler.get(rid)
        if req is None or req.admit_time is not None:
            return None, None
        released = self.scheduler.release(rid)
        if released is None:
            return None, None
        cb = self._on_token.pop(rid, None)
        self.tracer.end(rid, "released", args={"rehomed_away": True})
        if self.flight is not None:
            self.flight.record("release", rid=rid, tenant=released.tenant)
        return released, cb

    def admit_staged(self, req: Request, staged, logits: torch.Tensor,
                     now: Optional[float] = None) -> bool:
        """The disaggregated handoff (JAX ``admit_staged``,
        ``engine.py:2800-2874``): bind an EXTERNALLY prefilled context to a
        slot as a page-table operation. ``staged`` is a
        :class:`~neuronx_distributed_tpu_torch.serving.paging.StagedContext`
        whose pages live in THIS engine's pool (a shared-pool worker staged
        them there: no KV byte moves; a distinct-pool worker's context came
        in through ``import_pages``); ``logits`` the prefill's last-token
        logits, from which a fresh request's first token is sampled exactly
        as a coupled admission samples it (:meth:`_bind_slot`). The slot's
        block table, validity and cursor are written in place, into the
        tensors the captured decode step reads.

        False (the staged context intact, the request untouched) when the
        slot, cursor or page accounting cannot place it now; the caller
        retries at a later step. ``ValueError`` when the staged pages were
        voided (pool recovery, page quarantine): the caller re-prefills."""
        if self._page_size is None:
            raise ValueError("admit_staged needs a paged engine (kv_page_size=) — the handoff "
                             "is a block-table operation")
        if self._halted:
            return False
        if not self.cache.staged_live(staged):
            raise ValueError("staged context is no longer live (pool recovery or page "
                             "quarantine voided it) — re-prefill")
        if self.cache.free_slots == 0:
            return False
        now = self._now() if now is None else now
        p = staged.p
        maxrem = max((r.remaining_new_tokens for r in self._slot_req if r is not None),
                     default=0)
        target = self.cache.aligned_target(max(self.cache.cursor, p), p)
        end = target + max(maxrem, req.remaining_new_tokens) + self.gamma - 1
        if end > self.max_seq_len:
            return False
        # the coupled conservative projection: every in-flight context's
        # span and the staged one's through the final cursor fit the pool
        t_end = min(self.max_seq_len, end)
        spans = self.cache.page_span(target - p, t_end) + sum(
            self.cache.page_span(st, t_end) for st in self.cache.active_spans())
        if spans > self.cache.alloc.capacity:
            return False
        slot = self.cache.acquire()
        try:
            self.cache.map_staged(slot, staged, cursor=target)
        except Exception:
            # nothing mapped: the slot rejoins the rotation
            self.cache.free(slot)
            raise
        self.tracer.step(req.rid, "admission",
                         args={"slot": slot, "handoff": "page_table",
                               "pages": len(self.cache.slot_pages(slot))})
        if self.timeline is not None:
            self.timeline.instant(f"handoff r{req.rid}", "serving",
                                  args={"slot": slot, "pages": len(self.cache.slot_pages(slot))})
        self._bind_slot(req, slot, logits, now)
        return True

    @property
    def has_work(self) -> bool:
        if self._halted:
            # requeued work stays queued for inspection or handoff, but a
            # halted engine makes no progress: run() must return
            return False
        if self._draining:
            return bool(self._active.any()) or any(
                r.admit_time is not None for r in self.scheduler.queued_requests)
        return self.scheduler.queued > 0 or bool(self._active.any())

    @torch.no_grad()
    def step(self) -> bool:
        """One iteration: reap cancellations → shed expired deadlines →
        preempt/rewind if the cursor is out of room → the policy's victims
        → admit+prefill → one decode chunk (with recovery) → retire finished
        slots. Returns whether work remains. Runs under ``no_grad``: serving
        never differentiates (as the JAX engine), so a trainable model
        records no autograd graph here."""
        if self._halted:
            return self.has_work
        if self._faults is not None and self._faults.flips_params:
            # chaos: a scheduled silent bit flip lands in the served weights
            # here, in place (JAX engine.py:2253-2262): every program after
            # this step reads the corrupted tensor, as real HBM rot, until the
            # router's fingerprint vote fences the replica
            self._faults.on_engine_params(self._steps_seen, self.integrity_leaves)
        self._steps_seen += 1
        now = self._now()
        self._reap_cancelled(now)
        self._shed_expired(now)
        # one more decode iteration needs gamma columns; speculation
        # spends columns faster than tokens (rejected drafts leave gaps), so
        # its wall can come before the token-based admission projected it
        if self._active.any() and self.cache.cursor + self.gamma > self.max_seq_len:
            self._preempt_all()
        if not self._active.any() and self.cache.cursor > 0:
            self._reset_caches()  # drained: the next wave starts at column 0
        # selective preemption (JAX engine.py:2283-2290): with every slot
        # held and a pressured tenant waiting, the policy may nominate
        # victims (FIFO never does); their slots admit below, this step
        victims = self.policy.victims(now)
        if victims:
            self._preempt_victims(victims, now)
        self._admit(now)
        if not self._halted and self._active.any():
            self._decode()
        if self.timeline is not None:
            self.timeline.counter("slots_active", int(self._active.sum()), "serving")
            self.timeline.counter("queue_depth", self.scheduler.queued, "serving")
        self._sync_health()
        if self._profiler is not None and not self.has_work:
            self._stop_profile()  # idle before chunk 5: close the window with what it saw
        return self.has_work

    def run(self, max_steps: int = 1_000_000) -> Dict[int, Request]:
        """Step until idle (or HALTED); returns every request this engine
        has seen."""
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        return dict(self.scheduler.requests)

    # --- deadlines ----------------------------------------------------------

    def _shed_expired(self, now: float) -> None:
        """Queue timeouts shed BEFORE any prefill; in-flight deadlines at
        the chunk boundary, the request keeping what it streamed (JAX
        ``_shed_expired``, ``engine.py:2315``)."""
        for req, reason in self.scheduler.expire(now):
            req.state = RequestState.TIMED_OUT
            req.error = reason
            req.finish_time = now
            self.metrics.record_shed(req, now, where="queue")
            self._on_token.pop(req.rid, None)
            if self.timeline is not None:
                self.timeline.instant(f"shed r{req.rid}", "serving",
                                      args={"where": "queue", "reason": reason})
            self.tracer.end(req.rid, "shed", args={"where": "queue", "tenant": req.tenant})
            if self.flight is not None:
                self.flight.record("shed", rid=req.rid, where="queue", reason=reason,
                                   tenant=req.tenant)
        for req in list(self._slot_req):
            if req is None or req.deadline is None or now < req.deadline:
                continue
            req.state = RequestState.TIMED_OUT
            req.error = "deadline exceeded mid-generation"
            req.finish_time = now
            self.metrics.record_shed(req, now, where="inflight")
            if self.timeline is not None:
                self.timeline.instant(f"shed r{req.rid}", "serving",
                                      args={"where": "inflight", "tokens": len(req.tokens)})
            self.tracer.end(req.rid, "shed", args={"where": "inflight",
                                                   "tokens": len(req.tokens),
                                                   "tenant": req.tenant})
            if self.flight is not None:
                self.flight.record("shed", rid=req.rid, where="inflight", tokens=len(req.tokens),
                                   tenant=req.tenant)
            self._release_slot(req)

    # --- admission ----------------------------------------------------------

    def _in_flight_tokens(self) -> int:
        return sum(r.token_footprint for r in self._slot_req if r is not None)

    def _admit(self, now: float) -> None:
        if self.external_prefill:
            return  # the disaggregated server owns admission
        if self.cache.free_slots == 0 or self.scheduler.queued == 0:
            return
        # the host tier: queued hits start their prefetch before selection;
        # their holds keep the fit math honest (JAX engine.py:2373-2378)
        self._prefetch_for_queue()
        proj = self.cache.cursor
        maxrem = max((r.remaining_new_tokens for r in self._slot_req if r is not None),
                     default=0)

        extra = self.gamma - 1  # the last round's window past its token

        def fits(req: Request) -> bool:
            nonlocal proj, maxrem
            if self._draining and req.admit_time is None:
                return False  # draining admits only work admitted once already
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

        selected = self.scheduler.select(self.cache.free_slots, self._in_flight_tokens(),
                                         fits, prefill_cost=cost, now=now)
        for i, req in enumerate(selected):
            slot = self.cache.acquire()
            if self.draft_cache is not None and self.draft_cache.acquire() != slot:
                # the twin's free list mirrors the target's: a divergence would
                # land one request's draft KV under another slot's bookkeeping
                raise RuntimeError(f"the draft cache's free slots diverged from the target's "
                                   f"(slot {slot})")
            self._prefill_into_slot(req, slot, now)
            if self._halted:
                # a prefill-failure halt mid-round: the rest of the round left
                # the queue already; put it back intact
                if selected[i + 1:]:
                    self.scheduler.requeue_front(selected[i + 1:])
                break

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
        progress. Pages a prefetch holds for the round's own hits are
        counted in their context pages but excluded from
        ``available_pages()``: they are credited back (JAX
        ``engine.py:2468-2487``), or a tight pool livelocks."""
        cache, L, extra = self.cache, self.max_seq_len, self.gamma - 1
        cursor0, starts = cache.cursor, cache.active_spans()
        in_flight = np.flatnonzero(self._active)
        selected = []  # (context length, remaining tokens), queue order
        held: set = set()  # prefetch-held pages the round's hits will map
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
            nonlocal maxrem, held
            if self._draining and req.admit_time is None:
                return False  # draining admits only work admitted once already
            p, rem = len(req.context_ids), req.remaining_new_tokens
            mine = held | self._held_pages(req)
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
                    credit = len(mine) if pool is cache else 0
                    if need > pool.available_pages() + credit:
                        return False
            selected.append((p, rem))
            maxrem, held = most, mine
            return True

        return fits

    def _held_pages(self, req: Request) -> set:
        """The prefetch-held pages of the entry ``req`` would hit (a peek)."""
        if self.tier is None or self.prefix is None:
            return set()
        hit = self.prefix.peek(req.context_ids)
        if hit is None or not hit[0].page_ids or not self.cache.prefetch_held(hit[0].page_ids):
            return set()
        return set(hit[0].page_ids)

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
        t0 = self._clock()
        rem = req.remaining_new_tokens + self.gamma - 1
        if self._page_size is None:
            padded = _bucket(p, self.max_seq_len, rem)
            target = max(self.cache.cursor, padded)
        else:
            padded, target = self._paged_layout(p, rem, self.cache.cursor)
        self.tracer.step(req.rid, "admission", args={"slot": slot})
        plan = self._plan_prefix_reuse(ctx, p, target)
        matched = plan[1] if plan is not None else 0
        self.tracer.step(req.rid, "prefix_lookup", args={"matched": matched})
        if self.timeline is not None:
            self.timeline.mark_event_start("prefill", "serving")
        call = self._prefill_calls
        self._prefill_calls += 1
        cursors = [mgr.cursor for mgr in self._managers]
        try:
            try:
                logits, m_shared, row = self._admit_and_prefill(req, slot, call, ctx, p, padded,
                                                                target, plan)
            finally:
                if plan is not None:
                    self.prefix.release(plan[0])
        except _FATAL:
            raise
        except Exception as e:
            self._fail_prefill(req, slot, cursors, e, now)
            return
        if logits is None:
            # page pressure between fits() and the admission: requeued
            # untouched, no prefill ran
            if self.timeline is not None:
                self.timeline.mark_event_end("prefill", "serving",
                                             args={"rid": req.rid, "requeued": True})
            return
        self._consecutive_prefill_failures = 0
        self.metrics.record_prefill_wall(self._clock() - t0,
                                         kind="full" if plan is None else "suffix")
        if self.timeline is not None:
            self.timeline.mark_event_end("prefill", "serving",
                                         args={"rid": req.rid, "padded": padded,
                                               "reused": matched})
        self.tracer.step(req.rid, "suffix_prefill" if plan is not None else "full_prefill",
                         args={"padded": padded, "reused": matched})
        if self._page_size is None:
            self._remember_prefix(ctx, p, padded, row, matched)
        else:
            if m_shared:
                self.metrics.record_prefix_pages_shared(m_shared // self._page_size)
            self._remember_prefix_paged(ctx, p, slot, m_shared)
        self._bind_slot(req, slot, logits, now)

    def _fail_prefill(self, req: Request, slot: int, cursors, exc: Exception,
                      now: float) -> None:
        """A prefill fault fails ONE request for cause instead of the loop
        (JAX ``engine.py:2640-2669``): the slot returns to the rotation (its
        validity and pages released), the cursors go back to where the
        admission found them, and ``dispatch_retry.max_attempts``
        consecutive failures halt: a prefill that fails every admission must
        not fail all traffic while ``health()`` reads OK."""
        for mgr, cursor in zip(self._managers, cursors):
            mgr.free(slot)
            mgr.cache.index = cursor
        if self.timeline is not None:
            self.timeline.mark_event_end("prefill", "serving",
                                         args={"rid": req.rid, "error": str(exc)})
            self.timeline.instant(f"prefill_failure r{req.rid}", "serving",
                                  args={"error": str(exc)[:200]})
        req.state = RequestState.FAILED
        req.error = f"prefill failed: {exc}"
        req.finish_time = now
        self._on_token.pop(req.rid, None)
        self.metrics.record_failed(req, now, kind="prefill")
        self.tracer.end(req.rid, "failed", args={"kind": "prefill"})
        if self.flight is not None:
            self.flight.record("prefill_failure", rid=req.rid, error=str(exc), tenant=req.tenant)
        self._consecutive_prefill_failures += 1
        if self._consecutive_prefill_failures >= self._dispatch_retry.max_attempts:
            self._halt(f"{self._consecutive_prefill_failures} consecutive prefill failures "
                       f"(last: {type(exc).__name__}: {exc})")

    def _admit_and_prefill(self, req: Request, slot: int, call: int, ctx, p: int, padded: int,
                           target: int, plan):
        """Map ``slot`` for the context and prefill it (full, or the suffix
        of a prefix hit), the draft twin too. Returns ``(logits, m_shared,
        row)``; logits None when page pressure sent the request back to the
        queue untouched. The prefill hook fires after the slot is mapped,
        so an injected fault takes the cleanup path a real one takes."""
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
                if self.flight is not None:
                    self.flight.record("page_exhausted", rid=req.rid)
                return None, 0, None
        if self._faults is not None:
            self._faults.on_prefill(call)
        if plan is None:
            ids, mask = pack_padded_prompt(ctx, padded)
            logits = unwrap_logits(self._prefill_fn(padded)(
                torch.from_numpy(ids).to(self.device, torch.int64), row,
                torch.from_numpy(mask).to(self.device)))[0, -1]
        else:
            entry, m_use, chunk = plan
            start = padded - p  # the context's first column in the view
            self._seed_fn(row, entry.tree, m_use, start)
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
                logits = self._suffix_fn(row, ids, p - m_use)
        if self.draft_cache is not None:
            # the draft context always full-prefills, on a prefix hit too:
            # prefix entries hold target KV only
            ids, mask = pack_padded_prompt(ctx, padded)
            self._prefill_fn(padded, draft=True)(
                torch.from_numpy(ids).to(self.device, torch.int64), d_row,
                torch.from_numpy(mask).to(self.device))
        return logits, m_shared, row

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
        logits = self._suffix_fn(frow, ids, p - m_use)
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
        if (hit is not None and self._page_size is not None and hit[0].page_ids is None
                and hit[0].host_ids):
            # still host-resident (the pre-pass missed it, or the pool was
            # short then): one LATE prefetch now; a failure leaves page_ids
            # None, and the floor below makes this a miss (JAX :2895-2915)
            self._prefetch_entry(hit[0], late=True)
        if hit is not None and self._page_size is not None:
            # copy-on-write reuse is page-granular: the unaligned tail of
            # the match re-prefills as part of the suffix
            ps = self._page_size
            entry, m_use = hit
            m_use = min(m_use // ps, len(entry.page_ids or ())) * ps
            hit = (entry, m_use) if m_use >= self.prefix.min_match else None
        if hit is None:
            self.metrics.record_prefix_miss()
            if self.timeline is not None:
                self.timeline.instant("prefix_miss", "serving", args={"prompt": p})
            return None
        entry, m_use = hit
        reuse = self._prefix_reuses
        self._prefix_reuses += 1
        if self._page_size is not None:
            # a prefetched entry's pages: the main stream waits for their copy
            self.cache.sync_tier(entry.page_ids)
        if self._faults is not None:
            self._faults.on_prefix_reuse(reuse, entry,
                                         cache=self.cache if self._page_size is not None else None)
        if self._page_size is not None:
            # the accounting first (pages still allocated, pinned, not
            # quarantined), then the CONTENT: a bit flip leaves the
            # accounting healthy, only the fingerprints see it. A host-tier
            # hit's bytes were CRC-checked at its prefetch: no PF for it
            # (JAX :2940-2955)
            used = entry.page_ids[:m_use // self._page_size]
            valid = self.cache.pages_live(used)
            if valid and entry.page_fp is not None and entry.hit_tier != "host":
                valid = self._validate_pages(entry, len(used))
        else:
            valid = self._validate_prefix(entry)
        if not valid:
            self.prefix.evict_entry(entry)
            self.metrics.record_prefix_validation_failure()
            self.metrics.record_prefix_eviction()
            self.metrics.record_prefix_miss()
            if self.timeline is not None:
                self.timeline.instant("prefix_poisoned", "serving",
                                      args={"matched": m_use, "prompt": p})
            return None
        self.prefix.pin(entry)
        tier = entry.hit_tier
        if self._page_size is not None:
            # consumed: the pin protects the entry now, so a prefetch hold
            # has done its job (holds are claims for QUEUED work only)
            self.cache.release_prefetched(entry.page_ids)
            entry.hit_tier = "device"  # resident again: later hits are device
        self.metrics.record_prefix_hit(m_use, tier=tier)
        if self.timeline is not None:
            self.timeline.instant("prefix_hit", "serving",
                                  args={"matched": m_use, "prompt": p, "tier": tier})
        return entry, m_use, _suffix_bucket(p - m_use, end, self.max_seq_len)

    def _validate_prefix(self, entry: PrefixEntry) -> bool:
        """Reuse-time check of a stored copy (JAX ``_validate_prefix``,
        ``engine.py:2984``): leaf shapes against the insert-time record, then
        the fingerprint recomputed and compared with the stored one bit for
        bit. Both scalars ride one host read."""
        if tuple(tuple(t.shape) for t in prefix_leaves(entry.tree)) != entry.shapes:
            return False
        now, stored = self._host_read(torch.stack([self._fingerprint_fn(entry.tree),
                                                   entry.fingerprint]))
        return bool(now == stored)

    def _validate_pages(self, entry: PrefixEntry, n_pages: int) -> bool:
        """Reuse-time CONTENT check of a paged entry's first ``n_pages``
        pages (JAX ``_validate_pages``, ``engine.py:3038``): their
        fingerprints recomputed (PF on the card) and compared bit for bit
        with the insert-time record; the two vectors ride one host read."""
        now = self._pages_fp_fn(list(entry.page_ids[:n_pages]))
        cur, stored = self._host_read(torch.stack([now, entry.page_fp[:n_pages]]))
        return bool(np.array_equal(cur, stored))

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
        tree = self._extract_fn(row, padded - p, p, bucket)
        _, evicted = self.prefix.insert(key, tree, self._fingerprint_fn(tree), bucket)
        if evicted:
            self.metrics.record_prefix_eviction(evicted)
            if self.timeline is not None:
                self.timeline.instant("prefix_evict", "serving", args={"evicted": evicted})

    def _remember_prefix_paged(self, ctx, p: int, slot: int, matched: int) -> None:
        """Paged insert-on-miss (JAX ``_remember_prefix_paged``,
        ``engine.py:3096-3135``): PIN the slot's whole context pages instead
        of copying, and record their fingerprints (one PF launch, no read).
        Decode writes land past the aligned context, so a still-decoding
        donor never touches them. Same skip rules as the copy path, on the
        page-floored length."""
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
            # the pages' content at insert, on the device, read at a hit
            entry.page_fp = self._pages_fp_fn(list(ids))
        if evicted:
            self.metrics.record_prefix_eviction(evicted)
            if self.timeline is not None:
                self.timeline.instant("prefix_evict", "serving", args={"evicted": evicted})

    def _on_prefix_evict(self, entry: PrefixEntry) -> None:
        """The store's eviction hook (JAX ``_on_prefix_evict``,
        ``engine.py:1071-1089``): a paged entry leaving the store releases
        its page pins (pages a decoding slot still maps survive through its
        own references); a prefetched entry no request used counts its pages
        as wasted prefetch work first; a host-resident entry drops its host
        pages."""
        if entry.page_ids:
            if self.cache.prefetch_held(entry.page_ids):
                self.metrics.record_prefetch_wasted(len(entry.page_ids))
                self.cache.release_prefetched(entry.page_ids)
            self.cache.unpin_pages(entry.page_ids)
            entry.page_ids = None
        if entry.host_ids and self.tier is not None:
            self.tier.drop(entry.host_ids)
            entry.host_ids = None

    def _reclaim_prefix_entry(self) -> bool:
        """The page-pressure valve (JAX ``_reclaim_prefix_entry``,
        ``engine.py:1091-1112``): free the pages of the least-recently-used
        unpinned paged entry so they can serve an admission. With a host
        tier the entry is SPILLED there first and stays in the trie,
        host-resident; a full store or a failed spill degrades to plain
        eviction. Entries whose pages a queued request's prefetch holds are
        skipped. Never frees a page a slot still maps."""
        for e in self.prefix.entries:  # LRU first
            if e.refs == 0 and e.page_ids:
                if self.cache.prefetch_held(e.page_ids):
                    continue
                if self._spill_entry(e):
                    return True
                self.prefix.evict_entry(e)
                self.metrics.record_prefix_eviction()
                return True
        return False

    def _spill_entry(self, entry: PrefixEntry) -> bool:
        """Move one cold entry's pages to the host tier (JAX
        ``_spill_entry``, ``engine.py:1114-1145``): the pages gathered out
        of the pool and copied into the store with one sync (one host read),
        then unpinned. True when the entry is host-resident now; False (no
        tier, no room, a spill fault) leaves its pins intact for the caller's
        plain eviction: a failed spill never leaks."""
        if self.tier is None or not entry.page_ids:
            return False
        n = len(entry.page_ids)
        if n > self.tier.free_pages:
            return False
        attempt = self._spill_index
        self._spill_index += 1
        try:
            if self._faults is not None:
                self._faults.on_spill(attempt)
            items, nbytes = self.cache.spill_pages(entry.page_ids)
            host_ids = self.tier.put(entry.page_ids, items)
            self.host_reads += 1  # the store's copy ended in the spill's one sync
        except _FATAL:
            raise
        except Exception:
            self.metrics.record_spill_failure()
            return False
        self.cache.unpin_pages(entry.page_ids)
        entry.page_ids = None
        entry.host_ids = host_ids
        entry.hit_tier = "host"
        self.metrics.record_spill(n, nbytes)
        if self.timeline is not None:
            self.timeline.instant("kv_spill", "serving", args={"pages": n, "bytes": nbytes})
        return True

    def _prefetch_entry(self, entry: PrefixEntry, late: bool = False) -> bool:
        """Bring one host-resident entry's pages back to the pool (JAX
        ``_prefetch_entry``, ``engine.py:1147-1199``): the CRCs checked on
        the host, fresh pages allocated, the bytes copied back on the pool's
        tier stream (no host read; it overlaps the main stream's work) and
        the pages held for the queued request. True when the entry is
        device-resident after the call. A CRC mismatch or a prefetch fault
        evicts the entry (the admission falls back to a full prefill); a
        pool too short leaves it host-resident for a later pass. The arena
        rows stay fenced until the copy's event has completed."""
        if self.tier is None or not entry.host_ids:
            return entry.page_ids is not None
        host_ids = entry.host_ids
        n = len(host_ids)
        attempt = self._prefetch_index
        self._prefetch_index += 1
        try:
            if self._faults is not None:
                self._faults.on_prefetch(attempt, store=self.tier, host_ids=host_ids)
            if not self.tier.verify(host_ids):
                # a corrupted host copy: reject the WHOLE fetch, drop the entry
                self.metrics.record_host_page_poisoned()
                self.metrics.record_prefix_validation_failure()
                if self.timeline is not None:
                    self.timeline.instant("kv_host_poisoned", "serving", args={"pages": n})
                self.prefix.evict_entry(entry)
                self.metrics.record_prefix_eviction()
                return False
            rows, nbytes = self.tier.fetch(host_ids)
            ids, done = self.cache.prefetch_pages(rows, n)
        except PageExhausted:
            return False  # stays host-resident; a later pass retries
        except _FATAL:
            raise
        except Exception:
            self.metrics.record_prefetch_failure()
            self.prefix.evict_entry(entry)
            self.metrics.record_prefix_eviction()
            return False
        self.cache.hold_prefetched(ids)
        entry.page_ids = tuple(ids)
        entry.host_ids = None
        entry.hit_tier = "host"
        self.tier.drop(host_ids, after=done)
        self.metrics.record_prefetch(n, nbytes, late=late)
        if self.timeline is not None:
            self.timeline.instant("kv_prefetch", "serving",
                                  args={"pages": n, "bytes": nbytes, "late": late})
        return True

    def _prefetch_for_queue(self) -> None:
        """The admission pre-pass (JAX ``_prefetch_for_queue``,
        ``engine.py:1201-1219``): for the first queued requests (as many as
        free slots, at least one) whose prefix match is host-resident, start
        the prefetch before the round is selected. Policy-blind and
        LRU-neutral (``peek``); a prefetch for a request admitted later is
        merely early."""
        if self.tier is None or self.prefix is None:
            return
        for req in self.scheduler.upcoming(max(self.cache.free_slots, 1)):
            hit = self.prefix.peek(req.context_ids)
            if hit is not None and hit[0].host_ids and hit[1] > 0:
                self._prefetch_entry(hit[0])

    def _bind_slot(self, req: Request, slot: int, logits: torch.Tensor, now: float) -> None:
        """Record the admission, sample a fresh request's first token (one
        host read) and activate the slot's device state."""
        self.metrics.record_admit(req, now)
        if req.admit_time is None:
            req.admit_time = now
        temp, topk, topp = _config_sentinels(req.config)
        if not req.tokens:
            tok0 = int(self._host_read(self._first_token(logits, req.seed, 0, temp, topk, topp)))
            self.tracer.step(req.rid, "first_token")
            self._emit_token(req, tok0, self._now(), first=True)
            if req.state is RequestState.CANCELLED:
                # its on_token callback cancelled it at the first token (cancel()
                # recorded it): the slot was mapped but is never bound
                req.finish_time = now
                for mgr in self._managers:
                    mgr.free(slot)
                self._on_token.pop(req.rid, None)
                return
        req.state = RequestState.DECODE
        req.slot = slot
        self._slot_req[slot] = req
        eos = req.config.eos_token_id
        self._slot_write(slot, req.tokens[-1], req.seed, len(req.tokens), True,
                         req.remaining_new_tokens, temp, topk, topp,
                         eos if eos is not None else -1)
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
        requests by their remaining tokens. A quarantined slot is inactive,
        so it claims nothing."""
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
        self._decode_chunk(self._chunk)

    def _decode_chunk(self, chunk) -> None:
        """One fused chunk (JAX ``_decode_plain``, or with a draft model
        ``_decode_spec``, ``engine.py:3204-3511``): ``decode_chunk_size``
        iterations of ``chunk``'s program (captured at its first call on the
        card), plain steps or draft-verify rounds, then ONE host read of the
        token block with each iteration's emitted counts (and a round's
        accepted lengths); a capture's wall is recorded apart. A failed
        dispatch routes through recovery (a speculative one through the
        fallback to the plain step) instead of escaping ``step()``; the
        block is validated on the host before any token reaches a stream."""
        g = chunk.cols
        spec = chunk.accepts is not None
        if spec and self._draft_aliases and self._faults is not None and self._faults.poisons_draft:
            # scheduled after construction: poisoning this draft would write the target
            raise ValueError(self._alias_refusal("poison_draft"))
        # the plain fallback of a speculative engine moves the target alone
        managers = self._managers if chunk is self._chunk else (self.cache,)
        active_at_dispatch = int(self._active.sum())
        start = self.cache.cursor
        prog = chunk.program
        captured, replays, started = prog.captures, prog.replays, chunk.iterations
        compiles = prog._record.compiles
        self._maybe_profile()
        attempt = self._dispatch_attempts
        self._dispatch_attempts += 1
        tl = self.timeline
        if tl is not None:
            tl.mark_event_start("decode_dispatch", "serving")
        t0 = self._clock()
        w0 = time.perf_counter()
        poisoned = False
        try:
            try:
                if self._faults is not None:
                    self._faults.on_dispatch(attempt)
                    if spec:
                        self._faults.on_spec_dispatch(attempt)
                        poisoned = self._faults.on_spec_params(attempt)
                if poisoned:
                    self._poison_draft()
                executed = chunk()
                t1 = self._clock()
                if tl is not None:
                    tl.mark_event_end("decode_dispatch", "serving")
                    tl.mark_event_start("decode_readback", "serving")
                block = self._host_read(chunk.readout())
                wall = time.perf_counter() - w0
            finally:
                if poisoned:
                    self._heal_draft()
        except _FATAL:
            raise
        except Exception as e:
            if tl is not None:
                tl.mark_event_end("decode_dispatch", "serving")
            # untouched: no step started, so the caches, cursors and slot
            # state are as the last chunk left them (JAX's surviving buffers)
            untouched = chunk.iterations == started
            if spec:
                self._spec_fallback(e, untouched)
            else:
                self._recover_dispatch(e, untouched)
            return
        t2 = self._clock()
        if executed and prog._record.compiles == compiles:
            # the roofline feed (JAX engine.py:3342, :3511): the chunk's
            # dispatch-and-read wall a step or round; a compiling chunk's
            # wall would pollute it
            self.programs.observe_wall(prog._record.name, wall, dispatches=executed)
        self._consecutive_dispatch_failures = 0
        self._chunks_since_failure += 1
        capture_s = prog.capture_s if prog.captures > captured else 0.0
        if capture_s:
            self.metrics.record_capture(capture_s)
        readback = self._readbacks
        self._readbacks += 1
        toks, counts = block[..., :g], block[..., g]
        # iterations that ran with at least one live slot; the rest were
        # no-ops, so the cursors land where the JAX chunk's lax.cond leaves
        # them (from the block as read: a poisoned copy never moves them)
        used = int((counts.sum(1) > 0).sum())
        for mgr in managers:
            mgr.update_after_decode(start, used * g)
        live = np.flatnonzero(self._active)
        if spec:
            accepts = block[..., g + 1]
            if self._faults is not None:
                toks, counts = self._faults.on_spec_readback(readback, toks, counts, self._active)
            bad = _validate_spec_readback(toks, counts, g, self._vocab, live)
        else:
            # a plain step's block as JAX's: (chunk, slots) tokens and each
            # slot's emitted count (its emissions are a prefix of the chunk)
            toks, counts = toks[..., 0], counts.sum(0)
            if self._faults is not None:
                toks, counts = self._faults.on_readback(readback, toks, counts, self._active)
            bad = _validate_readback(toks, counts, self.decode_chunk_size, self._vocab, live)
        # paged: a poisoned PAGE's holders leave self._active here, so the
        # loop below never touches their (discarded) columns
        self._apply_page_poison(readback)
        if tl is not None:
            live_ok = [s for s in np.flatnonzero(self._active) if int(s) not in bad]
            emitted_n = int(sum(int(counts[:, s].sum()) if spec else int(counts[s])
                                for s in live_ok))
            tl.mark_event_end("decode_readback", "serving",
                              args={"tokens": emitted_n, ("rounds" if spec else "steps"): used})
        now = self._now()
        delivered, spec_accepts = 0, [] if spec else None
        for slot in np.flatnonzero(self._active):
            req = self._slot_req[slot]
            if int(slot) in bad:
                self._quarantine_slot(int(slot), req, bad[int(slot)], now)
                continue
            if spec:
                rounds = np.flatnonzero(counts[:, slot] > 0)
                spec_accepts.extend(int(a) for a in accepts[rounds, slot])
                emitted = [tok for r in rounds for tok in toks[r, slot, :counts[r, slot]]]
                self.tracer.step(req.rid, "decode_chunk",
                                 args={"tokens": int(counts[:, slot].sum()), "rounds": used,
                                       "accepted": int(accepts[:, slot].sum())})
            else:
                emitted = toks[:counts[slot], slot]
                self.tracer.step(req.rid, "decode_chunk",
                                 args={"tokens": int(counts[slot]), "steps": used})
            for tok in emitted:
                self._emit_token(req, int(tok), now)
                delivered += 1
                self._maybe_finish(req, now)
                if req.finished:
                    break  # EOS or budget: the rest of its block is discarded
        if tl is not None:
            tl.counter("chunk_tokens", delivered, "serving")
            if spec:
                tl.instant("spec_accept", "serving",
                           args={"accepted": int(sum(spec_accepts)),
                                 "drafted": g * len(spec_accepts), "rounds": used,
                                 "tokens": delivered})
        self.metrics.record_decode_chunk(delivered, used, executed, self.cache.cursor,
                                         active_at_dispatch, dispatch_s=t1 - t0 - capture_s,
                                         readback_s=t2 - t1, replays=prog.replays - replays,
                                         spec_accepts=spec_accepts, gamma=g)

    # --- faults -------------------------------------------------------------

    def _maybe_profile(self) -> None:
        """``profile_dir=``: a ``torch.profiler`` window over decode chunks
        [2, 5) (JAX ``_maybe_profile``, ``engine.py:3140-3162``): past the
        capture, bounded so an unattended server never grows a trace. A
        window that cannot start (another one live, an unwritable
        directory) records ``profile_start_failed`` and disables profiling;
        it never fails a request."""
        if self._profile_dir is None:
            return
        chunks = self.metrics.chunks
        if self._profiler is None and chunks == 2:
            from neuronx_distributed_tpu_torch.observability.profiler import ProfileWindow

            window = ProfileWindow(self._profile_dir)
            try:
                window.start()
            except (RuntimeError, OSError) as e:
                self._profile_dir = None
                if self.flight is not None:
                    self.flight.record("profile_start_failed", error=str(e))
                return
            self._profiler = window
        elif self._profiler is not None and chunks >= 5:
            self._stop_profile()

    def _stop_profile(self) -> None:
        window, self._profiler = self._profiler, None
        if window is not None:
            window.stop()

    def _recover_dispatch(self, exc: Exception, untouched: bool) -> None:
        """A decode dispatch FAILED (JAX ``_recover_dispatch``,
        ``engine.py:3513``). Recovery is the preemption machinery: every
        in-flight request goes back to the queue's front with its
        host-current tokens (exact as of the last chunk boundary), the
        caches and slot state are reset IN PLACE (cursors at 0, every slot
        free; the captured program keeps its buffers), and the next step
        re-prefills and retries after the retry policy's wait. When steps
        of the failed chunk ran, a paged prefix store is cleared as JAX
        clears it when its pool is consumed (its pinned pages are dropped).
        ``dispatch_retry.max_attempts`` CONSECUTIVE failures halt."""
        n = self._consecutive_dispatch_failures + 1
        self._consecutive_dispatch_failures = n
        self._had_dispatch_failure = True
        self._chunks_since_failure = 0
        self.metrics.record_dispatch_retry()
        if self.timeline is not None:
            self.timeline.instant("dispatch_failure", "serving",
                                  args={"error": str(exc)[:200], "consecutive": n})
        if self.flight is not None:
            self.flight.record("dispatch_failure", error=str(exc), consecutive=n)
        requeued = self._vacate_active()
        for r in requeued:
            self.tracer.step(r.rid, "recovery_requeue", args={"tokens": len(r.tokens)})
        self.scheduler.requeue_front(requeued)
        self._reset_caches(recovery=True)
        if self._page_size is not None and not untouched and self.prefix is not None:
            dropped = self.prefix.clear()
            if dropped:
                self.metrics.record_prefix_eviction(dropped)
        self._reset_slot_state()
        if self.prefix is not None:
            self.prefix.release_all()  # no suffix prefill survives, so no pin may
        if n >= self._dispatch_retry.max_attempts:
            self._halt(f"{n} consecutive dispatch failures (last: {type(exc).__name__}: {exc})")
            return
        self.metrics.record_recovery()
        if self.timeline is not None:
            self.timeline.instant("recovery", "serving", args={"requeued": len(requeued)})
        if self.flight is not None:
            self.flight.record("recovery", requeued=len(requeued), consecutive=n)
        self._sleep(self._dispatch_retry.wait(n - 1))
        self._sync_health()

    def _spec_fallback(self, exc: Exception, untouched: bool) -> None:
        """A SPECULATIVE dispatch failed (JAX ``_spec_fallback``,
        ``engine.py:3344``). When no step ran, decode THIS chunk with the
        plain step on the same buffers (the program a spec-off engine runs,
        so the streams continue and no token is lost), then preempt every
        slot: the plain chunk advanced the target cache without the draft's,
        and re-prefilling both restores lockstep. When steps ran, there is
        nothing to fall back onto: full dispatch recovery."""
        if not untouched:
            self._recover_dispatch(exc, untouched)
            return
        # DEGRADED until the cooldown; not a consecutive failure: the plain
        # chunk makes progress, and ITS failure is what escalates
        self._had_dispatch_failure = True
        self._chunks_since_failure = 0
        self._decode_chunk(self._plain_step_chunk())
        if self._consecutive_dispatch_failures == 0:
            # the plain chunk really decoded: THIS is a fallback
            self.metrics.record_spec_fallback()
            if self.timeline is not None:
                self.timeline.instant("spec_fallback", "serving", args={"error": str(exc)[:200]})
            if self.flight is not None:
                self.flight.record("spec_fallback", error=str(exc))
        if self._active.any():
            self._preempt_all()
        self._sync_health()

    def _quarantine_slot(self, slot: int, req: Request, reason: str, now: float) -> None:
        """Pull a poisoned slot out of the rotation before its chunk reaches
        a stream (JAX ``_quarantine_slot``, ``engine.py:3586``): its device
        ``active`` flag cleared in place (the captured program reads it), the
        slot out of the managers' rotation (a paged manager retires the
        slot's exclusive pages instead). The victim resumes from the last
        chunk boundary in another slot (``"requeue"``) or fails for cause
        (``"fail"``); neighbours are untouched; losing the last usable slot
        or page halts."""
        self.metrics.record_quarantine()
        if self.timeline is not None:
            self.timeline.instant(f"quarantine slot {slot}", "serving",
                                  args={"reason": reason, "rid": req.rid})
        if self.flight is not None:
            self.flight.record("quarantine", slot=slot, rid=req.rid, reason=reason,
                               tenant=req.tenant)
        for mgr in self._managers:
            mgr.quarantine(slot)
        self._release_slot(req)  # clears the row; a row slot never rejoins the rotation
        self._requeue_or_fail(req, slot, "quarantine", f"slot {slot} quarantined: {reason}",
                              now)
        if self.cache.usable_slots == 0:
            self._halt("all slots quarantined")
        elif self._page_size is not None and self.cache.alloc.capacity == 0:
            self._halt("all KV pages quarantined")

    def _requeue_or_fail(self, req: Request, slot: int, kind: str, error: str,
                         now: float) -> None:
        """A quarantine's victim under ``quarantine_policy``; ``kind`` is
        ``"quarantine"`` (a slot's) or ``"page_quarantine"``."""
        if self._quarantine_policy == "requeue" and not req.finished:
            self.tracer.step(req.rid, f"{kind}_requeue", args={"slot": slot})
            self.scheduler.requeue_front([req])
            return
        req.state = RequestState.FAILED
        req.error = error
        req.finish_time = now
        self._on_token.pop(req.rid, None)
        self.metrics.record_failed(req, now, kind="quarantine")
        self.tracer.end(req.rid, "failed", args={"kind": kind, "slot": slot})

    def _apply_page_poison(self, readback: int) -> None:
        """The injector's page poisons at this readback (paged engines; JAX
        ``_apply_page_poison``, ``engine.py:1269``): each page retires from
        the pool, every ACTIVE request whose table maps it is requeued from
        the last chunk boundary (its columns of this chunk discarded) and
        its slot freed back to the rotation; the prefix entries pinning the
        page are evicted (their shared content is suspect)."""
        if self._faults is None or self._page_size is None:
            return
        pages = self._faults.on_page_readback(readback, lambda s: self.cache.slot_pages(int(s)),
                                              self._active)
        if not pages:
            return
        now = self._now()
        victims: set = set()
        for page in pages:
            slots = self.cache.quarantine_page(int(page))
            self.metrics.record_page_quarantine()
            if self.timeline is not None:
                self.timeline.instant(f"quarantine page {int(page)}", "serving",
                                      args={"slots": [int(s) for s in slots]})
            if self.flight is not None:
                self.flight.record("page_quarantine", page=int(page),
                                   slots=[int(s) for s in slots])
            if self.prefix is not None:
                for e in list(self.prefix.entries):
                    if e.page_ids and int(page) in e.page_ids:
                        self.prefix.evict_entry(e)
                        self.metrics.record_prefix_eviction()
            victims.update(int(s) for s in slots if self._active[int(s)])
        requeue = []
        for slot in sorted(victims):
            req = self._slot_req[slot]
            self._release_slot(req)
            if self._quarantine_policy == "requeue" and not req.finished:
                self.tracer.step(req.rid, "page_quarantine_requeue", args={"slot": slot})
                requeue.append(req)
            else:
                self._requeue_or_fail(req, slot, "page_quarantine",
                                      f"slot {slot} mapped a poisoned KV page", now)
        if requeue:
            self.scheduler.requeue_front(requeue)
        if self.cache.alloc.capacity == 0:
            self._halt("all KV pages quarantined")

    # --- lifecycle ----------------------------------------------------------

    def _emit_token(self, req: Request, tok: int, now: float, first: bool = False) -> None:
        req.tokens.append(tok)
        # the tenant's fairness charge (host ints; FIFO's hook does nothing)
        self.policy.on_tokens(req.tenant, 1)
        if first:
            req.first_token_time = now
            self.metrics.record_first_token(req, now)
        cb = self._on_token.get(req.rid)
        if cb is not None:
            cb(req, tok)

    def _maybe_finish(self, req: Request, now: float) -> None:
        if req.state is RequestState.CANCELLED:
            # an on_token callback cancelled it this very step: the
            # cancellation wins; _reap_cancelled retires the slot next step
            return
        eos = req.config.eos_token_id
        hit_eos = eos is not None and req.tokens and req.tokens[-1] == eos
        if hit_eos or len(req.tokens) >= req.config.max_new_tokens:
            req.state = RequestState.DONE
            req.finish_time = now
            self.metrics.record_finish(req, now)
            self._release_slot(req)
            if self.timeline is not None:
                self.timeline.instant(f"done r{req.rid}", "serving")
            self.tracer.end(req.rid, "retire", args={"tokens": len(req.tokens),
                                                     "tenant": req.tenant})

    def _release_slot(self, req: Request) -> None:
        slot = req.slot
        if slot is None:
            return
        req.slot = None
        self._slot_req[slot] = None
        self._active[slot] = False
        self._slot_clear(slot)
        for mgr in self._managers:
            mgr.free(slot)
        if req.finished:
            self._on_token.pop(req.rid, None)

    def _reap_cancelled(self, now: float) -> None:
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.state is RequestState.CANCELLED:
                self.metrics.record_cancel(req, now)
                req.finish_time = now
                self.tracer.end(req.rid, "cancelled", args={"where": "slot", "slot": slot})
                self._release_slot(req)

    def _vacate_active(self) -> List[Request]:
        """Unbind every active request from its slot (host bookkeeping
        only) and return them in slot order: the shared first half of
        preemption, dispatch recovery and halting. Their tokens are
        host-current as of the last chunk boundary."""
        vacated = [r for r in self._slot_req if r is not None]
        for req in vacated:
            self._slot_req[req.slot] = None
            req.slot = None
        self._active[:] = False
        return vacated

    def _preempt_victims(self, victims: List[Request], now: float) -> None:
        """The policy's SELECTIVE preemption (JAX ``_preempt_victims``,
        ``engine.py:3705``): vacate just the nominated slots, as retirement
        does (the device ``active`` flag cleared in place, so the captured
        step skips the slot; a paged victim's exclusive pages back to the
        pool at once), and requeue the victims at the front with their
        host-current tokens and seed: a resume re-prefills ``context_ids``
        and continues bit-identically. The shared cursor is NOT rewound
        (the other slots keep decoding)."""
        for req in victims:
            slot = req.slot
            if slot is None or req.finished:
                continue  # retired or shed since it was nominated
            self._release_slot(req)
            req.preemptions += 1
            self.metrics.record_preemption()
            self.tracer.step(req.rid, "slo_preempt",
                             args={"slot": slot, "tokens": len(req.tokens),
                                   "tenant": req.tenant})
            if self.timeline is not None:
                self.timeline.instant(f"slo_preempt r{req.rid}", "serving",
                                      args={"slot": slot, "tenant": req.tenant})
            if self.flight is not None:
                self.flight.record("slo_preempt", rid=req.rid, slot=slot, tenant=req.tenant,
                                   tokens=len(req.tokens))
            self.scheduler.requeue_front([req])

    def _preempt_all(self) -> None:
        """Out of cache columns: requeue every active request (keeping its
        tokens), rewind the cache, and let admission re-prefill them."""
        preempted = self._vacate_active()
        for req in preempted:
            req.preemptions += 1
            self.metrics.record_preemption()
            self.tracer.step(req.rid, "preempt", args={"tokens": len(req.tokens)})
        self.scheduler.requeue_front(preempted)
        self._reset_caches()
        self._reset_slot_state()
        if self.prefix is not None:
            # no suffix prefill survives a preemption, so no pin may either;
            # the entries stay valid (row copies, or pinned pages whose
            # content the reset keeps)
            self.prefix.release_all()
        if self.timeline is not None:
            self.timeline.instant(f"preempt x{len(preempted)}", "serving")
