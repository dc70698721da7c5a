"""Paged serving under faults against the JAX engine (CPU, fp32,
tiny_llama): page-granular poison quarantine, page refs released on
recovery and halt, copy-on-write eviction safety, page-pressure reclaim,
the host-read budget with paging on, and the per-page content check of a
prefix hit (``flip_bits("kv_pool")``, PF's plain version). The counterpart
of ``tests/serving/test_paged_faults.py`` and of the paged engine's case of
``tests/serving/test_integrity.py``.

Both engines are built from one seed and given the same prompts and the
same ``FaultInjector`` schedule: equal terminal states, fault counters and
greedy streams across frameworks; within the port, streams equal the
fault-free port run bit for bit. Every port run checks the allocator's
invariant after every step (``PagedCacheManager.check``: each page free,
referenced or quarantined, never orphaned nor double-booked), as the JAX
suite's teardown fixture does."""

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import FaultInjector as JFaultInjector
from neuronx_distributed_tpu.serving import PrefixCache as JPrefixCache
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.kernels.page_fingerprint import pool_pages_fingerprint_fwd
from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from test_torch_llama import build_pair

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PS = 8


@pytest.fixture(scope="module")
def setup():
    return build_pair(seed=1)


def _jcfg(g):
    return JGenerationConfig(max_new_tokens=g.max_new_tokens, temperature=g.temperature,
                             top_k=g.top_k, top_p=g.top_p)


def _run_checked(engine, max_steps=10_000):
    """run(), with the allocator's invariant checked after every step."""
    steps = 0
    while engine.has_work and steps < max_steps:
        engine.step()
        engine.cache.check()
        steps += 1


def _serve(setup, prompts, gcfg, seeds, schedule=None, prefix=None, jax_too=True, **kw):
    """The same traffic through the port's and (optionally) the JAX paged
    engine under one fault schedule. Returns (engine, requests, injector,
    jax engine, jax requests, jax injector)."""
    jmodel, params, tmodel = setup
    inj = schedule(FaultInjector()) if schedule else None
    eng = ServingEngine(tmodel, kv_page_size=PS, fault_injector=inj, sleep_fn=lambda s: None,
                        prefix_cache=PrefixCache(**prefix) if prefix else None, **kw)
    reqs = [eng.submit(p, gcfg, seed=s) for p, s in zip(prompts, seeds)]
    _run_checked(eng)
    out = (eng, reqs, inj)
    if not jax_too:
        return out
    jinj = schedule(JFaultInjector()) if schedule else None
    jeng = JServingEngine(jmodel, params, kv_page_size=PS, fault_injector=jinj,
                          sleep_fn=lambda s: None,
                          prefix_cache=JPrefixCache(**prefix) if prefix else None, **kw)
    jreqs = [jeng.submit(p, _jcfg(gcfg), key=jax.random.PRNGKey(s)) for p, s in zip(prompts, seeds)]
    jeng.run()
    return out + (jeng, jreqs, jinj)


FAULT_KEYS = ("page_quarantines", "quarantines", "dispatch_retries", "recoveries", "completed",
              "prefix_hits", "prefix_validation_failures", "health")


def _alike(eng, reqs, inj, jeng, jreqs, jinj, greedy=True):
    assert [r.state.value for r in reqs] == [r.state.value for r in jreqs]
    snap, jsnap = eng.metrics.snapshot(), jeng.metrics.snapshot()
    assert {k: snap[k] for k in FAULT_KEYS} == {k: jsnap[k] for k in FAULT_KEYS}
    if inj is not None:
        assert inj.counters == jinj.counters
    assert eng.cache.alloc.pages_quarantined == jeng.cache.alloc.pages_quarantined
    if greedy:
        assert [r.tokens for r in reqs] == [[int(t) for t in r.tokens] for r in jreqs]


def test_poisoned_page_quarantines_only_mapping_requests(setup):
    """One poisoned page: its holder is requeued and resumes with its stream
    intact in fresh pages, the neighbour is untouched, the page retires
    (capacity - 1), the slot stays in the rotation."""
    prompts = [np.arange(1, 7, dtype=np.int32), np.arange(3, 12, dtype=np.int32)]
    gcfg = GenerationConfig(max_new_tokens=10, temperature=0.7, top_k=9)
    clean, creqs, _ = _serve(setup, prompts, gcfg, (0, 1), num_slots=2, decode_chunk_size=4,
                             jax_too=False)
    res = _serve(setup, prompts, gcfg, (0, 1), lambda i: i.poison_page(at=0, slot=0),
                 num_slots=2, decode_chunk_size=4)
    eng, reqs, inj = res[:3]
    assert inj.counters["poisoned_pages"] == 1
    assert [r.tokens for r in reqs] == [r.tokens for r in creqs]
    assert all(r.state is RequestState.DONE for r in reqs)
    snap = eng.metrics.snapshot()
    assert snap["page_quarantines"] == 1 and snap["quarantines"] == 0
    assert eng.cache.usable_slots == 2 and eng.cache.alloc.pages_quarantined == 1
    assert eng.cache.alloc.capacity == clean.cache.alloc.capacity - 1
    assert eng.health().value == "degraded"
    _alike(*res, greedy=False)


def test_poisoned_shared_page_requeues_all_cow_holders(setup):
    """A page shared copy-on-write by two decoding requests: both are
    requeued, the entry pinning it is evicted, the unsharing neighbour is
    untouched; every stream equals the fault-free run's."""
    sys_p = np.arange(1, 18, dtype=np.int32)
    prompts = [np.concatenate([sys_p, np.arange(50, 54, dtype=np.int32)]),
               np.concatenate([sys_p, np.arange(60, 66, dtype=np.int32)]),
               np.arange(70, 78, dtype=np.int32)]
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    kw = dict(num_slots=3, decode_chunk_size=4, prefix=dict(min_match=8))
    _, clean, _ = _serve(setup, prompts, gcfg, (20, 21, 22), jax_too=False, **kw)
    res = _serve(setup, prompts, gcfg, (20, 21, 22), lambda i: i.poison_page(at=1, slot=1), **kw)
    eng, reqs, inj = res[:3]
    assert inj.counters["poisoned_pages"] == 1
    assert [r.tokens for r in reqs] == [r.tokens for r in clean]
    snap = eng.metrics.snapshot()
    assert snap["page_quarantines"] == 1 and snap["prefix_hits"] >= 1
    assert all(not (e.page_ids and any(p in eng.cache.alloc._quarantined for p in e.page_ids))
               for e in eng.prefix.entries)
    _alike(*res)


def test_recovery_and_halt_release_all_page_refs(setup):
    """A dispatch failure releases every slot mapping and the stream is
    intact; an exhausted retry budget halts with the work requeued and no
    page mapped."""
    prompt = [np.arange(1, 9, dtype=np.int32)]
    gcfg = GenerationConfig(max_new_tokens=10, temperature=0.0)
    _, clean, _ = _serve(setup, prompt, gcfg, (0,), num_slots=2, decode_chunk_size=4,
                         jax_too=False)
    kw = dict(num_slots=2, decode_chunk_size=4, prefix=dict(min_match=4))
    res = _serve(setup, prompt, gcfg, (0,), lambda i: i.fail_dispatch(at=1, times=1), **kw)
    assert res[1][0].tokens == clean[0].tokens
    assert res[0].metrics.snapshot()["recoveries"] == 1
    _alike(*res)
    res = _serve(setup, prompt, gcfg, (0,), lambda i: i.fail_dispatch(at=0, times=None), **kw)
    eng, reqs = res[:2]
    assert eng.health().value == "halted"
    assert not reqs[0].finished and reqs[0].state is RequestState.QUEUED
    assert eng.cache.pages_mapped == 0
    _alike(*res)


def test_recovery_after_steps_ran_clears_the_paged_prefix_store(setup):
    """A paged chunk that fails after its steps ran: the caches reset in
    place (no buffer moves), and the prefix store is cleared, its pins
    released (JAX clears it when its pool is consumed); the stream is
    intact and no page leaks."""
    from test_torch_faults import _StepsThenFail

    tmodel = setup[2]
    prompt = np.arange(1, 19, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=10, temperature=0.0)
    eng = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                        prefix_cache=PrefixCache(min_match=4), sleep_fn=lambda s: None)
    ptrs = [t.data_ptr() for t in (eng.cache.cache.k, eng.cache.cache.v,
                                   eng.cache.cache.block_table, eng.cache.cache.valid)]
    req = eng.submit(prompt, gcfg, seed=0)
    eng.step()
    assert len(eng.prefix) == 1
    real = eng._chunk
    eng._chunk = _StepsThenFail(real, RuntimeError("fault after the steps ran"))
    eng.step()
    eng._chunk = real
    eng.cache.check()
    assert len(eng.prefix) == 0 and eng.cache.pages_mapped == 0
    assert eng.cache.alloc.free_pages == eng.cache.alloc.capacity
    _run_checked(eng)
    ref = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                        prefix_cache=None)
    rreq = ref.submit(prompt, gcfg, seed=0)
    ref.run()
    assert req.tokens == rreq.tokens
    assert ptrs == [t.data_ptr() for t in (eng.cache.cache.k, eng.cache.cache.v,
                                           eng.cache.cache.block_table, eng.cache.cache.valid)]


def test_cow_eviction_never_frees_still_mapped_page(setup):
    """Evicting an entry while a copy-on-write hitter still decodes off its
    pages drops only the ENTRY's refs; the hitter finishes with its stream
    intact."""
    tmodel = setup[2]
    sys_p = np.arange(1, 18, dtype=np.int32)
    donor = np.concatenate([sys_p, np.arange(40, 44, dtype=np.int32)])
    hitter = np.concatenate([sys_p, np.arange(50, 56, dtype=np.int32)])
    gcfg, long_cfg = GenerationConfig(4, temperature=0.0), GenerationConfig(16, temperature=0.0)
    ref = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                        prefix_cache=None)
    ref.submit(donor, gcfg, seed=1)
    r_ref = ref.submit(hitter, long_cfg, seed=2)
    ref.run()
    eng = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                        prefix_cache=PrefixCache(min_match=8))
    eng.submit(donor, gcfg, seed=1)
    r = eng.submit(hitter, long_cfg, seed=2)
    eng.step()
    assert eng.metrics.snapshot()["prefix_hits"] == 1
    entry = eng.prefix.entries[0]
    shared = entry.page_ids
    assert shared and not r.finished
    assert all(eng.cache.alloc.refcount(p) >= 2 for p in shared)
    eng.prefix.evict_entry(entry)
    assert all(eng.cache.alloc.refcount(p) >= 1 for p in shared)
    eng.cache.check()
    _run_checked(eng)
    assert r.state is RequestState.DONE and r.tokens == r_ref.tokens
    assert eng.cache.alloc.copy_bytes == 0


def test_page_pressure_reclaims_prefix_entries(setup):
    """A pool sized so that a later full prefill fits only if the retired
    entry's pinned pages are reclaimed: the admission evicts it and runs."""
    sys_p = np.arange(1, 18, dtype=np.int32)
    first = np.concatenate([sys_p, np.arange(40, 44, dtype=np.int32)])
    big = np.arange(60, 100, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    eng = ServingEngine(setup[2], num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                        prefix_cache=PrefixCache(min_match=8), kv_num_pages=7)
    r1 = eng.submit(first, gcfg, seed=0)
    _run_checked(eng)
    assert r1.state is RequestState.DONE and len(eng.prefix) == 1
    r2 = eng.submit(big, gcfg, seed=1)
    _run_checked(eng)
    assert r2.state is RequestState.DONE and len(r2.tokens) == 4
    assert eng.metrics.snapshot()["prefix_evictions"] >= 1
    assert eng.prefix.match_len(first) == 0 and eng.cache.alloc.copy_bytes == 0


def test_host_reads_with_paging_and_a_paged_hit(setup):
    """Paging keeps the budget (one read a fresh admission, one a steady
    chunk), and a paged prefix hit costs exactly one read more: its pages'
    fingerprints and the stored ones, stacked into one read."""
    prompt = np.arange(1, 19, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=12, temperature=0.0)
    eng = ServingEngine(setup[2], num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                        prefix_cache=PrefixCache(min_match=4))
    req = eng.submit(prompt, gcfg, seed=7)
    before = eng.host_reads
    eng.step()
    assert eng.host_reads - before == 2  # first token + the chunk
    before = eng.host_reads
    eng.step()
    assert eng.host_reads - before == 1  # a steady chunk
    eng.run()
    hit = eng.submit(prompt, gcfg, seed=7)
    before = eng.host_reads
    eng.step()
    assert eng.metrics.prefix_hits == 1
    assert eng.host_reads - before == 3  # the page check, the first token, the chunk
    eng.run()
    assert hit.tokens == req.tokens and len(req.tokens) == 12
    assert eng.host_reads == eng.metrics.chunks + 2 + eng.metrics.prefix_hits


def test_page_fingerprints_recorded_at_insert_checked_at_hit(setup):
    """Each paged insert records its pages' fingerprints (one PF call), and
    each hit recomputes them (another): the stored vector equals a fresh
    computation over the entry's pages, and the wrapper ran on the CPU
    without counting a launch."""
    from neuronx_distributed_tpu_torch.utils.fingerprint import pool_pages_fingerprint

    prompt = np.arange(1, 26, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    eng = ServingEngine(setup[2], num_slots=1, kv_page_size=PS,
                        prefix_cache=PrefixCache(min_match=4))
    before = pool_pages_fingerprint_fwd.launches
    eng.submit(prompt, gcfg)
    _run_checked(eng)
    entry = eng.prefix.entries[0]
    assert len(entry.page_ids) == 3 and entry.page_fp.shape == (3,)
    assert torch.equal(entry.page_fp, pool_pages_fingerprint(eng.cache.cache, entry.page_ids))
    eng.submit(prompt, gcfg)
    _run_checked(eng)
    assert eng.metrics.prefix_hits == 1
    assert pool_pages_fingerprint_fwd.launches == before


@pytest.mark.parametrize("kv", [None, "int8"], ids=["float_pool", "int8_pool"])
def test_kv_pool_bit_flip_rejected_falls_back_bit_identical(setup, kv):
    """One bit flipped in a pooled page before a hit maps it: the per-page
    fingerprints catch it, the entry is evicted, the request falls back to
    a full prefill with its stream intact, and the clean re-insert serves
    the next hit (the JAX engine counts the same, on the float pool). On an
    int8 pool the flip lands in the codes."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig

    prompt = np.arange(2, 18, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.8, top_k=13)
    quant = QuantConfig(weights=None, kv="int8") if kv else None
    inj = FaultInjector().flip_bits("kv_pool", at=0)
    eng = ServingEngine(setup[2], num_slots=1, kv_page_size=PS, fault_injector=inj,
                        prefix_cache=PrefixCache(max_entries=4, min_match=4), quantize=quant)
    reqs = []
    for _ in range(3):
        reqs.append(eng.submit(prompt, gcfg, seed=71))
        _run_checked(eng)
        if len(reqs) == 2:
            assert inj.counters["bit_flips"] == 1
            snap = eng.metrics.snapshot()
            assert snap["prefix_validation_failures"] == 1 and snap["prefix_hits"] == 0
    assert reqs[0].tokens == reqs[1].tokens == reqs[2].tokens
    assert eng.metrics.snapshot()["prefix_hits"] == 1
    if kv is None:
        jmodel, params = setup[:2]
        jinj = JFaultInjector().flip_bits("kv_pool", at=0)
        jeng = JServingEngine(jmodel, params, num_slots=1, kv_page_size=PS, fault_injector=jinj,
                              prefix_cache=JPrefixCache(max_entries=4, min_match=4))
        jreqs = []
        for _ in range(3):
            jreqs.append(jeng.submit(prompt, _jcfg(gcfg), key=jax.random.PRNGKey(71)))
            jeng.run()
        assert inj.counters == jinj.counters
        keys = ("prefix_hits", "prefix_misses", "prefix_validation_failures", "prefix_evictions")
        assert {k: eng.metrics.snapshot()[k] for k in keys} == \
            {k: jeng.metrics.snapshot()[k] for k in keys}
        assert [r.state.value for r in reqs] == [r.state.value for r in jreqs]


def test_not_ported_hooks_raise():
    """Every hook is ported now: ``flip_bits("params")`` schedules (item
    10c; it fires in ``tests/test_torch_integrity.py``), as do the fabric's
    schedules (the handoff and the five transport ones), which fire with
    JAX's counters; an unknown flip target still raises."""
    inj = FaultInjector()
    assert inj.flip_bits("params", at=2) is inj and inj.flips_params
    with pytest.raises(ValueError):
        inj.flip_bits("weights")
    for schedule in (lambda i: i.fail_handoff(), lambda i: i.drop_send(), lambda i: i.drop_ack(),
                     lambda i: i.dup_send(), lambda i: i.delay_send(by=0.5),
                     lambda i: i.partition(0)):
        assert schedule(inj) is inj
    jinj = (JFaultInjector().fail_handoff().drop_send().drop_ack().dup_send().delay_send(by=0.5)
            .partition(0))
    for i, target in enumerate((0, 1, 1, 1, 1)):
        assert inj.on_transport_send(i, target, "submit") == \
            jinj.on_transport_send(i, target, "submit")
    for attempt in range(2):
        outcomes = []
        for hook in (inj, jinj):
            try:
                hook.on_handoff(attempt)
                outcomes.append(None)
            except Exception as e:  # noqa: BLE001 - the class name is compared
                outcomes.append(type(e).__name__)
        assert outcomes[0] == outcomes[1] == (None if attempt else "InjectedHandoffError")
    assert inj.counters == jinj.counters


def test_allocator_quarantine_contract():
    """A quarantined page is neither free nor mappable: a free page leaves
    the free list at once, a referenced one when its last holder lets go;
    ``check()`` names a page that is both free and quarantined."""
    from neuronx_distributed_tpu_torch.serving.paging import PageAllocator, PagedCacheManager

    a = PageAllocator(6)
    ids = a.alloc(2)
    a.quarantine(ids[0])
    a.quarantine(5)
    assert a.pages_quarantined == 2 and a.capacity == 3 and 5 not in a._free
    a.deref(ids[0])
    assert ids[0] not in a._free and a.refcount(ids[0]) == 0
    assert sorted(a.alloc(a.free_pages)) == [3, 4]  # 1, 5 never come back
    a.release_all()
    assert sorted(a._free) == [ids[1], 3, 4]
    with pytest.raises(ValueError):
        a.quarantine(0)
    m = PagedCacheManager(2, 32, 8, num_pages=6)
    m.check()
    m.alloc.quarantine(2)
    m.check()
    m.alloc._free.append(2)
    with pytest.raises(AssertionError, match="page 2"):
        m.check()
