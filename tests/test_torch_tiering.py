"""The host page tier against the JAX package (CPU, fp32, tiny_llama): the
counterpart of ``tests/serving/test_tiered_kv.py`` and of the tiered case of
``tests/serving/test_host_sync.py``.

* ``HostPageStore``: JAX's store cases run on both stores with the same
  numpy-seeded pages (bytes round-trip exactly, host ids minted, capacity a
  hard bound, one corrupted page rejects the whole fetch), the pages'
  CRC-32s equal JAX's; ``page_fingerprint``/``bytes_fingerprint`` equal
  JAX's on bit-identical bf16, int8 and f32 blocks; ``check()`` catches a
  prefetch hold without a pin on both managers.
* Engines, JAX's ``_tiered_workload`` (four 17-token prefixes in waves
  0,1,2,3,0,1 through a pool of 8 usable pages, two slots, serial
  submits): with the tier off every revisit misses, with it on every hit is
  a host-tier hit; streams equal with the tier on and off, the port's greedy
  streams equal JAX's, the tier counters and the store's summary equal
  JAX's, ``copy_bytes`` 0, both tiers ``check()`` clean after every step.
  The chaos schedules (a failed spill, a failed prefetch, a poisoned host
  page) with counters equal to JAX's and streams equal to the tier off; two
  runs deterministic; sampled streams; the int8 pool (codes and scales
  spilled and prefetched); the untiered engine without a host surface; the
  host-read budget."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import FaultInjector as JFaultInjector
from neuronx_distributed_tpu.serving import HostPageStore as JHostPageStore
from neuronx_distributed_tpu.serving import PagedCacheManager as JPagedCacheManager
from neuronx_distributed_tpu.serving import PrefixCache as JPrefixCache
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu.utils import fingerprint as jfp
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
from neuronx_distributed_tpu_torch.serving.paging import PagedCacheManager
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from neuronx_distributed_tpu_torch.serving.tiering import HostPageStore
from neuronx_distributed_tpu_torch.utils import fingerprint as tfp
from neuronx_distributed_tpu_torch.utils.timeline import Timeline
from test_torch_llama import build_pair

torch.set_num_threads(1)

PS = 8
TIER_KEYS = ("prefix_hits", "prefix_misses", "prefix_evictions", "prefix_hit_tier",
             "prefix_validation_failures", "kv_pages_spilled", "kv_spill_bytes",
             "kv_pages_prefetched", "kv_prefetch_bytes", "kv_prefetch_late", "kv_prefetch_wasted",
             "kv_spill_failures", "kv_prefetch_failures", "kv_host_poisoned")


@pytest.fixture(scope="module")
def setup():
    # the JAX test's model: tiny_llama initialized from PRNGKey(1)
    return build_pair(seed=1)


# --- HostPageStore ------------------------------------------------------------


def _leaf_items(rng, n_pages, n_leaves=4, shape=(2, 4, 3)):
    """JAX's ``_leaf_items``: per-leaf numpy blocks, page axis 0 of size
    ``n_pages``; with the port's torch copies of the same bytes."""
    items = [((f"layer{j}", "k" if j % 2 == 0 else "v"),
              rng.standard_normal((n_pages,) + shape).astype(np.float32))
             for j in range(n_leaves)]
    return items, [(keys, torch.from_numpy(b.copy())) for keys, b in items]


def _stores(max_pages):
    return JHostPageStore(max_pages), HostPageStore(max_pages)


def test_store_put_get_roundtrip_bytes_exact():
    jitems, titems = _leaf_items(np.random.default_rng(0), 3)
    jst, st = _stores(4)
    jh, h = jst.put([11, 12, 13], jitems), st.put([11, 12, 13], titems)
    assert h == jh and st.used_pages == 3 and st.free_pages == 1
    assert st.contains(h) and st.verify(h) and jst.verify(jh)
    # the CRCs of the stored pages are JAX's
    assert [st._pages[i].fingerprint for i in h] == [jst._pages[i].fingerprint for i in jh]
    out, nbytes = st.get(h)
    assert nbytes == jst.get(jh)[1] == sum(int(b.nbytes) for _, b in jitems)
    for (ik, ib), (ok, ob) in zip(jitems, out):
        assert ik == ok
        np.testing.assert_array_equal(ob.numpy(), ib)
    # a partial fetch in another order: page rows follow the id order
    out2, _ = st.get([h[2], h[0]])
    jst.get([jh[2], jh[0]])
    for (_, ib), (_, ob) in zip(jitems, out2):
        np.testing.assert_array_equal(ob.numpy(), np.take(ib, [2, 0], axis=0))
    st.check()
    assert st.summary() == jst.summary()
    assert st.clear() == jst.clear() == 3 and st.used_pages == 0
    st.check()


def test_store_host_ids_are_minted_not_recycled_device_pids():
    jitems, titems = _leaf_items(np.random.default_rng(1), 1)
    for store, items in zip(_stores(4), (jitems, titems)):
        (a,) = store.put([5], items)
        store.drop([a])
        (b,) = store.put([5], items)
        assert a != b and not store.contains([a]) and store.contains([b])
        store.clear()


def test_store_capacity_is_a_hard_bound():
    jitems, titems = _leaf_items(np.random.default_rng(2), 3)
    for store, items in zip(_stores(2), (jitems, titems)):
        with pytest.raises(ValueError, match="full"):
            store.put([1, 2, 3], items)
        assert store.used_pages == 0  # rejected whole, nothing partial
    st = HostPageStore(2)
    st.put([1, 2], [(k, b[:2]) for k, b in titems])
    st.clear()
    with pytest.raises(ValueError, match="layout"):  # the arena's layout is fixed
        st.put([1], [(k, b[:1, :1]) for k, b in titems])


def test_store_corruption_rejects_the_whole_fetch():
    jitems, titems = _leaf_items(np.random.default_rng(3), 2)
    got = []
    for store, items in zip(_stores(4), (jitems, titems)):
        hids = store.put([1, 2], items)
        store.corrupt(hids[1])
        got.append((store.verify(hids), store.verify([hids[1]]), store.verify([hids[0]]),
                    store.verify_failures_total))
        store.clear()
        with pytest.raises(KeyError):
            store.get(hids)
    assert got[0] == got[1] == (False, False, True, 2)


def test_check_prefetch_hold_requires_pin():
    """JAX's case on both managers: a prefetch hold is an overlay on a
    PINNED page; ``check()`` catches a hold whose pin is gone."""
    for mgr in (JPagedCacheManager(num_slots=1, max_seq_len=32, page_size=PS),
                PagedCacheManager(1, 32, PS)):
        (pid,) = mgr.alloc.alloc(1)
        mgr._pins[pid] = mgr._pins.get(pid, 0) + 1
        assert mgr.reclaimable_pages() == 1    # pinned-only page: reclaimable
        mgr.hold_prefetched([pid])
        assert mgr.prefetch_held([pid])
        assert mgr.reclaimable_pages() == 0    # ...until a prefetch holds it
        mgr.check()
        mgr.release_prefetched([pid])
        assert not mgr.prefetch_held([pid])
        mgr.hold_prefetched([pid])
        del mgr._pins[pid]
        mgr.alloc.deref(pid)  # the pin's ref gone; the hold dangles
        with pytest.raises(AssertionError, match="hold"):
            mgr.check()
        mgr.release_prefetched([pid])


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_host_fingerprints_equal_jax(kind):
    """The same bytes hash the same: blocks built bit-identical in both
    frameworks from one numpy seed (bf16 from its 16-bit patterns)."""
    rng = np.random.default_rng({"bf16": 4, "int8": 5, "f32": 6}[kind])
    blocks_np, blocks_t = [], []
    for shape in ((2, 3, 8, 4, 8), (2, 3, 1, 4, 1)):
        if kind == "bf16":
            bits = rng.integers(0, 0x7F00, size=shape, dtype=np.uint16)  # finite patterns
            blocks_np.append(np.asarray(jnp.asarray(bits).view(jnp.bfloat16)))
            blocks_t.append(torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))
        elif kind == "int8":
            b = rng.integers(-128, 128, size=shape, dtype=np.int8)
            blocks_np.append(b)
            blocks_t.append(torch.from_numpy(b.copy()))
        else:
            b = rng.standard_normal(shape).astype(np.float32)
            blocks_np.append(b)
            blocks_t.append(torch.from_numpy(b.copy()))
    jitems = list(zip(("k", "v"), blocks_np))
    titems = list(zip(("k", "v"), blocks_t))
    assert tfp.page_fingerprint(titems) == jfp.page_fingerprint(jitems)
    assert tfp.page_fingerprint(titems[:1]) == jfp.page_fingerprint(jitems[:1])
    raw = blocks_np[0].tobytes()
    assert tfp.bytes_fingerprint(raw) == jfp.bytes_fingerprint(raw)
    assert tfp.bytes_fingerprint(raw[7:], tfp.bytes_fingerprint(raw[:7])) == \
        jfp.bytes_fingerprint(raw)
    # and the stores (page axis 1, ndim - 4) keep JAX's per-page CRCs
    jst, st = _stores(3)
    jh, h = jst.put([4, 5, 6], jitems), st.put([4, 5, 6], titems)
    assert [st._pages[i].fingerprint for i in h] == [jst._pages[i].fingerprint for i in jh]
    out, _ = st.get(h[1:])
    assert all(torch.equal(ob.view(torch.uint8) if kind == "bf16" else ob,
                           tb[:, 1:].contiguous().view(torch.uint8) if kind == "bf16"
                           else tb[:, 1:]) for (_, ob), (_, tb) in zip(out, titems))


# --- engines: the cliff becomes a slope -----------------------------------------


def _tiered_workload(vocab):
    """JAX's ``_tiered_workload``: four distinct 17-token system prefixes
    (two whole pages once floor-aligned to 16), waves 0,1,2,3,0,1."""
    sys_prefixes = [(np.arange(1 + 40 * j, 18 + 40 * j, dtype=np.int32) % (vocab - 1)) + 1
                    for j in range(4)]
    rng = np.random.RandomState(3)
    suffixes = [rng.randint(1, vocab, size=4).astype(np.int32) for _ in range(8)]
    return [np.concatenate([sys_prefixes[w], suffixes[i]])
            for i, w in enumerate([0, 1, 2, 3, 0, 1])]


def _run_tiered(tmodel, prompts, gcfg=None, schedule=None, **kw):
    """JAX's ``_run_tiered`` on the port: serial submits, ``check()`` of both
    tiers after every step. Returns (engine, streams, injector)."""
    gcfg = gcfg or GenerationConfig(max_new_tokens=4, temperature=0.0)
    inj = schedule(FaultInjector()) if schedule else None
    kw.setdefault("num_slots", 2)
    kw.setdefault("decode_chunk_size", 4)
    kw.setdefault("kv_page_size", PS)
    kw.setdefault("admission", "eager")
    eng = ServingEngine(tmodel, prefix_cache=PrefixCache(min_match=8), fault_injector=inj, **kw)
    reqs = []
    for i, p in enumerate(prompts):
        reqs.append(eng.submit(p, gcfg, seed=100 + i))
        while eng.has_work:
            eng.step()
            eng.cache.check()
            if eng.tier is not None:
                eng.tier.check()
    assert all(r.state is RequestState.DONE for r in reqs)
    return eng, [list(r.tokens) for r in reqs], inj


_JAX_RUNS = {}


def _jax_tiered(setup, schedule_name=None, **kw):
    """The JAX engine on the same workload (cached by configuration)."""
    key = (schedule_name, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        jmodel, params, tmodel = setup
        inj = None
        if schedule_name is not None:
            inj = getattr(JFaultInjector(), schedule_name)(at=0, times=2 if
                                                             schedule_name == "fail_spill" else 1)
        eng = JServingEngine(jmodel, params, num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                             admission="eager", prefix_cache=JPrefixCache(min_match=8),
                             fault_injector=inj, **kw)
        reqs = []
        for i, p in enumerate(_tiered_workload(tmodel.config.vocab_size)):
            reqs.append(eng.submit(p, JGenerationConfig(max_new_tokens=4, temperature=0.0),
                                   key=jax.random.PRNGKey(100 + i)))
            eng.run()
        assert all(r.state.value == "done" for r in reqs)
        snap = eng.metrics.snapshot()
        _JAX_RUNS[key] = dict(
            tokens=[[int(t) for t in r.tokens] for r in reqs],
            snap={k: snap[k] for k in TIER_KEYS},
            summary=eng.tier.summary() if eng.tier is not None else None,
            counters=dict(inj.counters) if inj is not None else None,
            residents={name: {k: v for k, v in e.items() if k != "bytes"}
                       for name, e in eng.hbm.snapshot()["residents"].items()})
    return _JAX_RUNS[key]


def _tier_snap(eng):
    snap = eng.metrics.snapshot()
    return {k: snap[k] for k in TIER_KEYS}


def test_cliff_becomes_slope_and_streams_bit_identical(setup):
    """THE acceptance pin: at a pool that holds ~half the working set, the
    tier off scores 0 hits (the cliff) and the tier on scores host-tier hits
    only (the slope), streams bit-identical, zero copies, both tiers clean;
    every counter, the store's summary and the greedy streams equal JAX's."""
    tmodel = setup[2]
    prompts = _tiered_workload(tmodel.config.vocab_size)
    off, off_toks, _ = _run_tiered(tmodel, prompts, kv_num_pages=9)
    m_off = off.metrics.snapshot()
    assert m_off["prefix_hits"] == 0 and m_off["prefix_evictions"] > 0
    on, on_toks, _ = _run_tiered(tmodel, prompts, kv_num_pages=9, kv_host_pages=16)
    m_on = on.metrics.snapshot()
    assert on_toks == off_toks
    assert m_on["prefix_hits"] >= 2
    assert m_on["prefix_hit_tier"].get("host", 0) == m_on["prefix_hits"]
    assert m_on["kv_pages_spilled"] >= 4 and m_on["kv_pages_prefetched"] >= 4
    assert m_on["kv_spill_bytes"] > 0 and m_on["kv_prefetch_bytes"] > 0
    assert m_on["kv_prefetch_late"] == 0
    assert on.cache.alloc.copy_bytes == 0
    snap = on.hbm.snapshot()
    assert snap["residents"]["kv_host_pages"]["tier"] == "host"
    assert snap["host_resident_bytes_total"] == on.tier.nbytes
    # against the JAX engine on the same workload and weights
    jon, joff = _jax_tiered(setup, kv_num_pages=9, kv_host_pages=16), \
        _jax_tiered(setup, kv_num_pages=9)
    assert on_toks == jon["tokens"] and off_toks == joff["tokens"]
    assert _tier_snap(on) == jon["snap"] and _tier_snap(off) == joff["snap"]
    assert on.tier.summary() == jon["summary"]
    # the ledger's residents and their units, as JAX's engine registers them
    assert {name: {k: v for k, v in e.items() if k != "bytes"}
            for name, e in snap["residents"].items()} == jon["residents"]
    # after the store is cleared every device page and every host page is free
    on.prefix.clear()
    on.cache.check()
    on.tier.check()
    assert on.cache.alloc.free_pages == on.cache.alloc.capacity and on.tier.used_pages == 0


def test_untiered_engine_has_no_host_tier_surface(setup):
    tmodel = setup[2]
    prompts = _tiered_workload(tmodel.config.vocab_size)[:2]
    eng, _, _ = _run_tiered(tmodel, prompts, kv_num_pages=17)
    assert eng.tier is None
    snap = eng.hbm.snapshot()
    assert "kv_host_pages" not in snap["residents"]
    assert "tier" not in snap["residents"]["kv_pages"]
    assert "serving_kv_host_pages_used" not in eng.metrics.registry.names()
    with pytest.raises(ValueError, match="kv_page_size"):
        ServingEngine(tmodel, num_slots=1, kv_host_pages=8)


def test_two_run_determinism_with_tiering_on(setup):
    tmodel = setup[2]
    prompts = _tiered_workload(tmodel.config.vocab_size)
    runs = []
    for _ in range(2):
        eng, toks, _ = _run_tiered(tmodel, prompts, kv_num_pages=9, kv_host_pages=16)
        runs.append((toks, _tier_snap(eng), eng.tier.summary()))
    assert runs[0] == runs[1]


def test_sampled_streams_bit_identical_with_tiering(setup):
    """Sampled decoding through the same spill and prefetch churn: the
    per-request seeds make the comparison exact."""
    tmodel = setup[2]
    prompts = _tiered_workload(tmodel.config.vocab_size)
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.9, top_k=17)
    _, off_toks, _ = _run_tiered(tmodel, prompts, gcfg, kv_num_pages=9)
    on, on_toks, _ = _run_tiered(tmodel, prompts, gcfg, kv_num_pages=9, kv_host_pages=16)
    assert on_toks == off_toks
    assert on.metrics.snapshot()["kv_pages_spilled"] > 0


# --- chaos ------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["fail_spill", "fail_prefetch", "poison_host_page"])
def test_tier_faults_against_jax(setup, schedule):
    """A failed spill degrades to plain eviction; a failed prefetch and a
    poisoned host page (rejected by the CRC) become full prefills: streams
    equal the tier off, counters and the injector's equal JAX's, no leak."""
    tmodel = setup[2]
    prompts = _tiered_workload(tmodel.config.vocab_size)
    _, base, _ = _run_tiered(tmodel, prompts, kv_num_pages=9)
    times = 2 if schedule == "fail_spill" else 1
    eng, toks, inj = _run_tiered(tmodel, prompts, kv_num_pages=9, kv_host_pages=16,
                                 schedule=lambda i: getattr(i, schedule)(at=0, times=times))
    m = eng.metrics.snapshot()
    assert toks == base
    if schedule == "fail_spill":
        assert m["kv_spill_failures"] == 2 == inj.counters["spill_failures"]
        assert m["prefix_evictions"] >= 2
    elif schedule == "fail_prefetch":
        assert m["kv_prefetch_failures"] == 1 == inj.counters["prefetch_failures"]
        assert m["prefix_hits"] <= 1
    else:
        assert m["kv_host_poisoned"] == 1 == inj.counters["poisoned_host_pages"]
        assert m["prefix_validation_failures"] >= 1
    assert eng.cache.alloc.copy_bytes == 0
    j = _jax_tiered(setup, schedule, kv_num_pages=9, kv_host_pages=16)
    assert _tier_snap(eng) == j["snap"]
    assert inj.counters == j["counters"]
    assert toks == j["tokens"] and eng.tier.summary() == j["summary"]


def test_timeline_marks_spills_prefetches_and_poison(setup, tmp_path):
    tmodel = setup[2]
    prompts = _tiered_workload(tmodel.config.vocab_size)
    tl = Timeline(str(tmp_path / "tier.json"))
    _run_tiered(tmodel, prompts, kv_num_pages=9, kv_host_pages=16, timeline=tl,
                schedule=lambda i: i.poison_host_page(at=1))
    names = [e["name"] for e in tl._events if e.get("ph") == "i"]
    assert {"kv_spill", "kv_prefetch", "kv_host_poisoned"} <= set(names)
    hits = [e["args"]["tier"] for e in tl._events if e.get("name") == "prefix_hit"]
    assert hits and set(hits) == {"host"}


def test_recovery_drops_host_resident_entries(setup):
    """A dispatch failure after steps ran clears the paged prefix store (as
    JAX's recovery does): host-resident entries drop their host pages
    through the eviction hook and the prefetch holds are void; both tiers
    stay clean and the streams equal the fault-free run's."""
    tmodel = setup[2]
    prompts = _tiered_workload(tmodel.config.vocab_size)
    _, base, _ = _run_tiered(tmodel, prompts, kv_num_pages=9, kv_host_pages=16)
    eng, toks, _ = _run_tiered(tmodel, prompts, kv_num_pages=9, kv_host_pages=16,
                               sleep_fn=lambda s: None)
    assert eng.tier.used_pages > 0
    chunk = eng._chunk

    class FailOnceAfterSteps:
        def __getattr__(self, name):
            return getattr(chunk, name)

        def __call__(self):
            chunk()
            eng._chunk = chunk
            raise RuntimeError("injected: the chunk's steps ran, then it failed")

    eng._chunk = FailOnceAfterSteps()
    req = eng.submit(prompts[2], GenerationConfig(max_new_tokens=4, temperature=0.0), seed=102)
    while eng.has_work:
        eng.step()
        eng.cache.check()
        eng.tier.check()
    assert eng.metrics.recoveries == 1 and req.state is RequestState.DONE
    assert eng.tier.used_pages == 0 and not eng.cache._prefetch_hold
    assert list(req.tokens) == base[2]


# --- the int8 pool ---------------------------------------------------------------


def test_int8_pool_spills_codes_and_scales(setup):
    """On an int8 pool a page is its K and V codes and their scales: the
    spill carries all four leaves, the prefetch restores them (the hit's
    pages equal what was spilled, bit for bit) and streams equal the tier
    off."""
    tmodel = setup[2]
    prompts = _tiered_workload(tmodel.config.vocab_size)
    q = QuantConfig(kv="int8")
    _, off_toks, _ = _run_tiered(tmodel, prompts, kv_num_pages=9, quantize=q)
    on = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                       kv_num_pages=9, kv_host_pages=16, admission="eager", quantize=q,
                       prefix_cache=PrefixCache(min_match=8))
    assert [n for n, _, _ in on.tier.layout.leaves] == ["k", "k_scale", "v", "v_scale"]
    spilled = {}
    put = on.tier.put

    def recording(pids, items):
        hids = put(pids, items)
        for i, h in enumerate(hids):
            spilled[h] = [b.select(1, i).clone() for _, b in items]
        return hids

    on.tier.put = recording
    restored = []
    prefetch = on.cache.prefetch_pages

    def checking(rows, n):
        ids, done = prefetch(rows, n)
        restored.append(ids)
        return ids, done

    on.cache.prefetch_pages = checking
    fetch = on.tier.fetch
    order = []
    on.tier.fetch = lambda hids: (order.append(list(hids)), fetch(hids))[1]
    toks = []
    for i, p in enumerate(prompts):
        r = on.submit(p, GenerationConfig(max_new_tokens=4, temperature=0.0), seed=100 + i)
        on.run()
        on.cache.check()
        on.tier.check()
        toks.append(list(r.tokens))
    assert toks == off_toks
    assert restored and len(restored) == len(order)
    c = on.cache.cache
    for hids, ids in zip(order, restored):
        for h, pid in zip(hids, ids):
            for leaf, want in zip((c.k, c.k_scale, c.v, c.v_scale), spilled[h]):
                if on.cache._pins.get(pid):  # still the entry's page
                    assert torch.equal(leaf[:, pid], want)


# --- the host-read budget --------------------------------------------------------


def test_host_reads_with_tiering(setup):
    """JAX's ``test_sync_budget_unchanged_with_tiering`` on the port's
    counted reads: a spilling admission costs one read more than a bare one
    (the spill's one sync), a prefetching admission none more (the copy to
    the card is a dispatch), a steady chunk one."""
    tmodel = setup[2]
    vocab = tmodel.config.vocab_size
    sys0 = (np.arange(1, 18, dtype=np.int32) % (vocab - 1)) + 1
    sys1 = (np.arange(41, 58, dtype=np.int32) % (vocab - 1)) + 1
    suf = np.arange(30, 34, dtype=np.int32)
    eng = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, kv_page_size=8, kv_num_pages=6,
                        kv_host_pages=16, admission="eager", prefix_cache=PrefixCache(min_match=8))
    g4 = GenerationConfig(max_new_tokens=4, temperature=0.0)
    g12 = GenerationConfig(max_new_tokens=12, temperature=0.0)
    eng.submit(np.concatenate([sys0, suf]), g4, seed=7)
    eng.run()
    # bare admission (first token + one chunk) = 2; spilling A to host = 3
    before = eng.host_reads
    rb = eng.submit(np.concatenate([sys1, suf]), g12, seed=8)
    assert eng.host_reads == before
    eng.step()
    assert eng.host_reads - before == 3
    assert eng.metrics.snapshot()["kv_pages_spilled"] == 2
    before = eng.host_reads
    eng.step()
    assert eng.host_reads - before == 1
    eng.run()
    assert rb.state is RequestState.DONE and len(rb.tokens) == 12
    # prefetching A back = the plain 2 (no PF read either: a host-tier hit)
    before = eng.host_reads
    rc = eng.submit(np.concatenate([sys0, suf + 9]), g4, seed=9)
    eng.step()
    assert eng.host_reads - before == 2
    eng.run()
    assert rc.state is RequestState.DONE and len(rc.tokens) == 4
    m = eng.metrics.snapshot()
    assert m["kv_pages_prefetched"] == 2 and m["kv_prefetch_late"] == 0
    assert m["prefix_hit_tier"] == {"host": 1}
    eng.cache.check()
    eng.tier.check()


def test_scheduler_upcoming_equals_jax():
    from neuronx_distributed_tpu.serving.scheduler import Request as JRequest
    from neuronx_distributed_tpu.serving.scheduler import Scheduler as JScheduler
    from neuronx_distributed_tpu_torch.serving.scheduler import Request, Scheduler

    got = []
    for sched, req, extra in ((JScheduler(), JRequest, {"key": None}),
                              (Scheduler(), Request, {"seed": 0})):
        for rid in range(5):
            sched.submit(req(rid=rid, prompt=np.arange(1, 4 + rid, dtype=np.int32),
                             config=None, **extra))
        sched.cancel(1)
        got.append([[r.rid for r in sched.upcoming(n)] for n in (0, 1, 3, 9)])
    assert got[0] == got[1] == [[], [0], [0, 2, 3], [0, 2, 3, 4]]
