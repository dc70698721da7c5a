"""The port's paged KV serving against the JAX package (CPU, fp32, tiny_llama).

* K5's plain version (``paged_flash_decode_plain``: gather through the block
  table, then the plain decode math) against the Pallas
  ``paged_flash_decode_attention`` in interpret mode, as the JAX package's
  own kernel tests run it: numpy-seeded q and pools, a scrambled block table
  whose unmapped entries point at null page 0 filled with garbage, and
  ``kv_valid`` with left padding and gaps, at page sizes 8 and 16.
  Tolerance 1e-5 absolute: both sides compute the same f32 softmax, in
  different summation orders (one page per grid step in Pallas, one pass
  here), ~1e-7 relative per sum over values O(1).
* The allocator and manager cases of ``tests/serving/test_paged_cache.py``
  re-pinned on the port.
* Engines: paged greedy streams equal the JAX paged engine's and the port's
  row engine's; sampled streams equal the row engine's and solo
  ``generate``; K5 on the pool equals K4 on the gathered view (the
  ``gathered_attention`` witness); page accounting (small
  pools, the door, page-pressure queueing and preemption); one host read
  per steady chunk; ``check()`` after every engine test."""

import contextlib
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd
from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, tiny_llama
from neuronx_distributed_tpu_torch.modules import attention as tattn
from neuronx_distributed_tpu_torch.modules.attention import PagedKVCache, gather_cache_pages
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.paging import (
    PageAllocator,
    PagedCacheManager,
    PageExhausted,
)
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from test_torch_llama import build_pair
from test_torch_serving import _run_staggered, _solo, _workload

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the JAX `kernels` package re-exports functions under the module's name
jfd = importlib.import_module("neuronx_distributed_tpu.kernels.flash_decode")

ATOL = 1e-5
PS = 8  # page size of the engine tests (as in the JAX paged-cache tests)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=21)


@contextlib.contextmanager
def gathered_attention():
    """Attend a paged cache by gathering its logical view and running the
    row-cache decode path (K4's wrapper) on it, in place of K5's: the
    witness the pool route is held to."""
    def gathered(q, k_pool, v_pool, block_table, q_pos, kv_valid=None, page_size=16):
        return tfd.flash_decode_attention(q, tfd.paged_gather_leaf(k_pool, block_table, page_size),
                                          tfd.paged_gather_leaf(v_pool, block_table, page_size),
                                          q_pos, kv_valid)

    saved, tattn.paged_flash_decode_attention = tattn.paged_flash_decode_attention, gathered
    try:
        yield
    finally:
        tattn.paged_flash_decode_attention = saved


# --- K5's plain version against the Pallas kernel ------------------------------

def _paged_inputs(rng, ps, s, h=8, hkv=2, d=16, b=3, n_log=6):
    """q, pools, a scrambled block table and kv_valid: slot i maps its first
    ``n_log - i`` logical pages to distinct random pool pages; the rest point
    at page 0, which holds large finite garbage; validity has left padding
    and random gaps, and stops at each slot's mapped columns."""
    n_pages = b * n_log + 3
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k_pool = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    v_pool = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    k_pool[0] = rng.normal(size=(ps, hkv, d)) * 1e3
    v_pool[0] = rng.normal(size=(ps, hkv, d)) * 1e3
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, n_log), np.int32)
    valid = np.zeros((b, n_log * ps), bool)
    for i in range(b):
        mapped = n_log - i
        bt[i, :mapped] = perm[i * n_log:i * n_log + mapped]
        valid[i, 3 * i + 1:mapped * ps] = True
    valid &= rng.random(valid.shape) > 0.2
    pos = (n_log * ps - s - 5 + np.arange(s)).astype(np.int32)
    return q, k_pool, v_pool, bt, valid, pos


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("s,h,hkv", [(1, 8, 2), (2, 8, 2), (1, 4, 4)])
def test_paged_plain_matches_pallas(ps, s, h, hkv):
    rng = np.random.default_rng(ps * 10 + s + h)
    q, kp, vp, bt, valid, pos = _paged_inputs(rng, ps, s, h, hkv)
    want = jfd.paged_flash_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), jnp.asarray(valid), page_size=ps, interpret=True)
    t = torch.from_numpy
    before = tfd.paged_flash_decode_fwd.launches
    got, lse = tfd.paged_flash_decode_fwd(t(q), t(kp), t(vp), t(bt), t(pos), t(valid), ps)
    assert tfd.paged_flash_decode_fwd.launches == before  # CPU: plain version, no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert got.shape == q.shape and lse.shape == (3, hkv, (h // hkv) * s)
    # the public name returns the output alone
    assert torch.equal(tfd.paged_flash_decode_attention(t(q), t(kp), t(vp), t(bt), t(pos),
                                                        t(valid), ps), got)


@pytest.mark.parametrize("ps", [8, 16])
def test_paged_gather_matches_jax_and_null_page_never_attends(ps):
    rng = np.random.default_rng(ps)
    q, kp, vp, bt, valid, pos = _paged_inputs(rng, ps, 1)
    t = torch.from_numpy
    got = tfd.paged_gather_leaf(t(kp), t(bt), ps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jfd.paged_gather_leaf(jnp.asarray(kp), jnp.asarray(bt), ps)))
    # leading (layer) axes ride along
    stacked = tfd.paged_gather_leaf(torch.stack([t(kp), t(vp)]), t(bt), ps)
    assert torch.equal(stacked[1], tfd.paged_gather_leaf(t(vp), t(bt), ps))
    out, lse = tfd.paged_flash_decode_fwd(t(q), t(kp), t(vp), t(bt), t(pos), t(valid), ps)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0] = rng.normal(size=kp2[0].shape) * -1e4
    vp2[0] = rng.normal(size=vp2[0].shape) * 1e4
    out2, lse2 = tfd.paged_flash_decode_fwd(t(q), t(kp2), t(vp2), t(bt), t(pos), t(valid), ps)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def test_paged_wrapper_checks_its_pools():
    q = torch.zeros(1, 1, 4, 16)
    pool = torch.zeros(3, 8, 2, 16)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="pools"):
        tfd.paged_flash_decode_fwd(q, pool, pool, bt, torch.tensor([3]), page_size=16)
    with pytest.raises(ValueError, match="multiple"):
        tfd.paged_flash_decode_fwd(torch.zeros(1, 1, 3, 16), pool, pool, bt, torch.tensor([3]),
                                   page_size=8)


# --- PageAllocator and PagedCacheManager ---------------------------------------

def test_allocator_alloc_deref_roundtrip():
    a = PageAllocator(8)  # pages 1..7 usable
    assert a.free_pages == 7 and a.capacity == 7
    ids = a.alloc(3)
    assert len(ids) == 3 and 0 not in ids
    assert a.free_pages == 4 and all(a.refcount(p) == 1 for p in ids)
    for p in ids:
        a.deref(p)
    assert a.free_pages == 7 and all(a.refcount(p) == 0 for p in ids)
    with pytest.raises(ValueError):
        a.alloc(-1)
    with pytest.raises(ValueError):
        PageAllocator(1)


def test_allocator_exhaustion():
    a = PageAllocator(4)
    ids = a.alloc(3)
    with pytest.raises(PageExhausted):
        a.alloc(1)
    assert a.free_pages == 0 and a.capacity == 3
    a.deref(ids[1])
    with pytest.raises(ValueError):
        a.deref(ids[1])  # no longer live
    assert a.alloc(1) == [ids[1]]  # the freed page comes back
    with pytest.raises(PageExhausted):
        a.alloc(1)


def test_allocator_reserved_null_page():
    a = PageAllocator(4)
    assert 0 not in a.alloc(3)
    with pytest.raises(ValueError):
        a.deref(0)  # never allocated, never freed
    assert a.free_pages == 0 and a.refcount(0) == 0


def test_manager_check_catches_leaks_and_double_maps():
    mgr = PagedCacheManager(num_slots=2, max_seq_len=32, page_size=PS)
    mgr.check()
    ids = mgr.alloc.alloc(2)
    with pytest.raises(AssertionError, match="refcount"):
        mgr.check()  # allocated but mapped nowhere = leak
    mgr._tables[0, 0], mgr._tables[0, 1] = ids
    mgr.check()
    mgr._tables[1, 0] = ids[0]  # second mapper without a ref
    with pytest.raises(AssertionError, match="refcount"):
        mgr.check()
    mgr.alloc._refs[ids[0]] += 1  # a shared page: one ref per mapper
    mgr.check()
    mgr._tables[1, 1] = ids[0]  # one slot, same page twice
    with pytest.raises(AssertionError, match="double-maps"):
        mgr.check()
    mgr._tables[:] = 0
    mgr.alloc.deref(ids[0])
    for p in ids:
        mgr.alloc.deref(p)
    mgr.check()
    mgr.alloc._free.append(mgr.alloc._free[0])
    with pytest.raises(AssertionError, match="duplicates"):
        mgr.check()


def test_manager_geometry_validation():
    with pytest.raises(ValueError, match="multiple"):
        PagedCacheManager(num_slots=2, max_seq_len=30, page_size=PS)
    with pytest.raises(ValueError):
        PagedCacheManager(num_slots=2, max_seq_len=32, page_size=0)
    m = PagedCacheManager(num_slots=2, max_seq_len=32, page_size=PS)
    assert m.pages_per_row == 4
    # default pool = row-equivalent memory + the reserved null page
    assert m.alloc.num_pages == 2 * 4 + 1
    assert m.aligned_target(10, 6) == 14  # (14-6) % 8 == 0
    assert m.aligned_target(8, 8) == 8
    assert m.page_span(0, 17) == 3 and m.page_span(8, 16) == 1 and m.page_span(9, 9) == 0
    assert m.nbytes == 0  # no cache bound


def test_manager_admission_maps_context_pages_and_pads_into_page_zero():
    model = init_params(LlamaForCausalLM(tiny_llama(max_seq_len=32), device="cpu"), seed=0)
    mgr = PagedCacheManager.for_model(model, num_slots=2, page_size=PS, num_pages=4)
    assert mgr.nbytes == 2 * 4 * 4 * PS * 4 * 8 * 4 + 2 * 4 * 4
    # a 5-token context in a bucket of 8: the start is aligned to column 8
    target = mgr.aligned_target(8, 5)
    assert target == 13
    row = mgr.admit(0, 8, cursor=target, p=5)
    assert mgr.cursor == 13 and mgr.active_spans() == [8] and mgr.pages_mapped == 1
    assert mgr.cache.block_table.tolist()[0] == [0, mgr._tables[0, 1], 0, 0]
    ids = torch.arange(8)[None] + 1
    mask = torch.tensor([[False] * 3 + [True] * 5])
    model(ids, mode="prefill", cache=row, padding_mask=mask, last_only=True)
    assert mgr.cache.valid[0].tolist() == [False] * 8 + [True] * 5 + [False] * 19
    k, _ = gather_cache_pages(mgr.cache, 0)
    assert float(k[0, 8:13].abs().sum()) > 0 and float(k[0, 13:16].abs().sum()) == 0
    with pytest.raises(ValueError, match="still maps"):
        mgr.admit(0, 8, cursor=target, p=5)
    with pytest.raises(ValueError, match="page-aligned"):
        mgr.admit(1, 8, cursor=14, p=5)
    with pytest.raises(PageExhausted):
        mgr.admit(1, 32, cursor=32, p=32)  # 4 pages, 2 free
    assert mgr.cursor == 13 and mgr.pages_mapped == 1  # nothing changed
    assert mgr.ensure_decode_window([0], 4)  # [13, 17) needs page 2
    assert mgr.pages_mapped == 2 and mgr.alloc.free_pages == 1
    # a second active row would need pages 1 and 2 of its own: the wall, and
    # nothing is mapped
    assert not mgr.ensure_decode_window([0, 1], 4)
    assert mgr.pages_mapped == 2 and mgr.alloc.free_pages == 1
    mgr.check()
    mgr.free(0)
    assert mgr.pages_mapped == 0 and not mgr.cache.valid.any() and mgr.free_slots == 2
    mgr.check()


def test_decode_writes_of_idle_rows_and_unmapped_columns_land_in_page_zero():
    """Masked no-op steps and idle slots write K/V, which must resolve to the
    row's own pages or to page 0 — never another slot's page."""
    cache = PagedKVCache.allocate(1, 2, 32, 1, 4, torch.float32, "cpu", num_pages=5,
                                  page_size=PS)
    cache.upload_table(np.array([[3, 1, 0, 0], [0, 0, 0, 0]], np.int32))
    cache.index = 14
    cache.decode_positions(4)  # columns 14..17: 14, 15 in page 1; 16, 17 unmapped
    k = torch.arange(1, 33, dtype=torch.float32).reshape(2, 4, 1, 4)
    cache.decode_write(0, k, -k)
    pool = cache.k[0]
    assert torch.equal(pool[1, 6:8], k[0, :2])
    for pid in (2, 3, 4):
        assert not pool[pid].any()  # untouched: slot 0's page 3 and the free pages
    assert pool[0].any()  # row 0's unmapped columns and idle row 1 went to page 0


# --- engines -------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_paged_greedy_streams(pair):
    jmodel, params, tmodel = pair
    prompts, gcfgs = _workload(tmodel)
    jcfgs = [JGenerationConfig(max_new_tokens=g.max_new_tokens, temperature=0.0,
                               eos_token_id=g.eos_token_id) for g in gcfgs]
    engine = JServingEngine(jmodel, params, num_slots=3, decode_chunk_size=3,
                            prefix_cache=None, kv_page_size=PS)
    reqs = _run_staggered(
        engine, prompts, jcfgs,
        lambda e, p, g, i: e.submit(p, g, key=jax.random.PRNGKey(i)),
    )
    engine.cache.check()
    return [list(r.tokens) for r in reqs]


@pytest.mark.parametrize("attention,chunk", [("gather", 3), ("fused", 3), ("fused", 8)])
def test_greedy_streams_match_jax_paged_engine_and_row_engine(pair, jax_paged_greedy_streams,
                                                              attention, chunk):
    _, _, tmodel = pair
    prompts, gcfgs = _workload(tmodel)
    submit = lambda e, p, g, i: e.submit(p, g, seed=i)  # noqa: E731
    row = _run_staggered(ServingEngine(tmodel, num_slots=3, decode_chunk_size=chunk),
                         prompts, gcfgs, submit)
    engine = ServingEngine(tmodel, num_slots=3, decode_chunk_size=chunk, kv_page_size=PS)
    with gathered_attention() if attention == "gather" else contextlib.nullcontext():
        reqs = _run_staggered(engine, prompts, gcfgs, submit)
    for i, req in enumerate(reqs):
        assert req.state is RequestState.DONE
        assert req.tokens == jax_paged_greedy_streams[i] == row[i].tokens, i
    assert len(reqs[2].tokens) == 6  # EOS fired
    assert engine.metrics.cursor_high_water >= 64  # the long prompt's jump
    assert engine.cache.free_slots == 3 and engine.cache.pages_mapped == 0
    engine.cache.check()


def test_sampled_streams_match_row_engine_and_solo_generate(pair):
    """The JAX paged suite's mixed-length sampled traffic: the paged streams
    (through the gathered view and from the pool) equal the row engine's and
    solo ``generate``."""
    _, _, tmodel = pair
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 256, size=n).astype(np.int32) for n in (5, 23, 9, 14, 3, 31)]
    gcfg = GenerationConfig(max_new_tokens=9, temperature=0.8, top_k=17)
    streams = []
    for kw, route in (({}, contextlib.nullcontext()), (dict(kv_page_size=PS), gathered_attention()),
                      (dict(kv_page_size=PS), contextlib.nullcontext())):
        engine = ServingEngine(tmodel, num_slots=3, decode_chunk_size=4, **kw)
        reqs = [engine.submit(p, gcfg, seed=40 + i) for i, p in enumerate(prompts)]
        with route:
            engine.run()
        if kw:
            engine.cache.check()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1] == streams[2]
    for i in (0, 5):
        assert streams[1][i] == _solo(tmodel, prompts[i], gcfg, 40 + i), i


def test_null_page_content_never_reaches_a_stream(pair):
    """Garbage written into page 0 before every step (idle slots and masked
    no-op steps write there too) changes no token."""
    _, _, tmodel = pair
    prompts, gcfgs = _workload(tmodel)
    submit = lambda e, p, g, i: e.submit(p, g, seed=i)  # noqa: E731
    want = _run_staggered(ServingEngine(tmodel, num_slots=3, decode_chunk_size=8,
                                        kv_page_size=PS), prompts, gcfgs, submit)
    engine = ServingEngine(tmodel, num_slots=3, decode_chunk_size=8, kv_page_size=PS)
    gen = torch.Generator().manual_seed(0)
    pools = engine.cache.cache.k, engine.cache.cache.v

    def poison_then_step():
        for pool in pools:
            pool[:, 0] = torch.randn(pool[:, 0].shape, generator=gen) * 1e3
        return real_step()

    real_step, engine.step = engine.step, poison_then_step
    reqs = _run_staggered(engine, prompts, gcfgs, submit)
    assert [r.tokens for r in reqs] == [r.tokens for r in want]
    engine.cache.check()


def test_small_pool_serves_more_slots_than_row_equivalent(pair):
    """A KV budget of ONE row-equivalent (16 pages = 128 columns) runs four
    short requests concurrently, where the row manager holds one slot."""
    _, _, tmodel = pair
    engine = ServingEngine(tmodel, num_slots=4, decode_chunk_size=4, kv_page_size=PS,
                           kv_num_pages=tmodel.config.max_seq_len // PS + 1)
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    reqs = [engine.submit(np.arange(1, 5 + i), gcfg, seed=i) for i in range(4)]
    engine.run()
    assert all(r.state is RequestState.DONE and len(r.tokens) == 8 for r in reqs)
    assert engine.metrics.snapshot()["mean_occupancy"] == 4.0
    for i, r in enumerate(reqs):
        assert r.tokens == _solo(tmodel, np.arange(1, 5 + i).astype(np.int32), gcfg, i)
    engine.cache.check()


def test_unplaceable_page_footprint_rejected_at_submit(pair):
    _, _, tmodel = pair
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                           kv_num_pages=5)  # 4 usable pages = 32 columns
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    with pytest.raises(ValueError, match="KV pages"):
        engine.submit(np.arange(1, 27), gcfg)  # 26 + 8 > 32
    r = engine.submit(np.arange(1, 24), gcfg)  # 23 + 8 = 31 <= 32: placeable
    engine.run()
    assert r.state is RequestState.DONE and len(r.tokens) == 8
    engine.cache.check()


@pytest.mark.parametrize("admission", ["conservative", "eager"])
def test_minimal_pool_short_tail_completes(pair, admission):
    """The per-chunk page window is clamped to the active slots' remaining
    work, so a request the door admits into a 2-page pool completes instead
    of livelocking at the page-pressure wall."""
    _, _, tmodel = pair
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=8, kv_page_size=4,
                           kv_num_pages=3, admission=admission)
    r = engine.submit(np.arange(1, 5), GenerationConfig(max_new_tokens=2, temperature=0.0))
    engine.run(max_steps=50)
    assert r.state is RequestState.DONE and len(r.tokens) == 2
    assert engine.metrics.snapshot()["preemptions"] == 0
    engine.cache.check()


def test_conservative_admission_queues_on_page_pressure(pair):
    _, _, tmodel = pair
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                           kv_num_pages=7)  # 6 usable pages = 48 columns
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    r1 = engine.submit(np.arange(1, 24), gcfg, seed=0)
    r2 = engine.submit(np.arange(1, 20), gcfg, seed=1)
    engine.step()
    assert r1.state is RequestState.DECODE
    assert r2.state is RequestState.QUEUED  # the pages would not cover both
    engine.run()
    assert r1.state is RequestState.DONE and r2.state is RequestState.DONE
    assert engine.metrics.snapshot()["preemptions"] == 0
    engine.cache.check()


def test_eager_page_pressure_preempts_and_resumes_streams(pair):
    """Eager admission over-commits a 64-column pool: the decode window
    runs out of pages (the cursor stays far from the row end), every slot
    is preempted and resumed, and the streams equal the row engine's."""
    _, _, tmodel = pair
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, 256, size=n).astype(np.int32) for n in (10, 7, 12)]
    gcfg = GenerationConfig(max_new_tokens=20, temperature=0.7, top_k=11)
    row = ServingEngine(tmodel, num_slots=3, decode_chunk_size=4, admission="eager")
    want = [row.submit(p, gcfg, seed=i) for i, p in enumerate(prompts)]
    row.run()
    engine = ServingEngine(tmodel, num_slots=3, decode_chunk_size=4, admission="eager",
                           kv_page_size=PS, kv_num_pages=9)
    reqs = [engine.submit(p, gcfg, seed=i) for i, p in enumerate(prompts)]
    engine.run(max_steps=200)  # the JAX accounting livelocks here (ROADMAP §3)
    assert all(r.state is RequestState.DONE for r in reqs)
    snap = engine.metrics.snapshot()
    assert snap["preemptions"] > 0 and row.metrics.preemptions == 0
    assert snap["cursor_high_water"] < tmodel.config.max_seq_len // 2
    assert [r.tokens for r in reqs] == [r.tokens for r in want]
    engine.cache.check()


def test_eager_cursor_wall_preempts_and_resumes_streams(pair):
    """The JAX paged suite's eager case on a 32-column row: alignment gaps
    spend columns faster, the wall hits, streams equal the row engine's."""
    _, _, tmodel = pair
    short = LlamaForCausalLM(dataclasses.replace(tmodel.config, max_seq_len=32), device="cpu")
    short.load_state_dict(tmodel.state_dict())
    prompts = [np.arange(1, 9), np.arange(2, 12)]
    gcfg = GenerationConfig(max_new_tokens=12, temperature=0.6, top_k=11)
    out = []
    for kw in ({}, dict(kv_page_size=PS)):
        engine = ServingEngine(short, num_slots=2, decode_chunk_size=4, admission="eager", **kw)
        reqs = [engine.submit(p, gcfg, seed=70 + i) for i, p in enumerate(prompts)]
        engine.run()
        out.append(([r.tokens for r in reqs], engine))
    (row_toks, _), (pg_toks, pg) = out
    assert pg_toks == row_toks
    assert pg.metrics.preemptions > 0
    pg.cache.check()


def test_page_exhausted_at_admission_requeues(pair):
    """A PageExhausted between fits() and the admission frees the slot and
    requeues the untouched request; it is served once pages are back."""
    _, _, tmodel = pair
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, kv_page_size=PS)
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    held = engine.cache.alloc.alloc(engine.cache.alloc.free_pages)
    req = engine.submit(np.arange(1, 9), gcfg, seed=3)
    engine._admit(0.0)
    assert req.state is RequestState.QUEUED and engine.cache.free_slots == 2
    assert engine.cache.pages_mapped == 0 and engine.cache.cursor == 0
    for pid in held:
        engine.cache.alloc.deref(pid)
    engine.run()
    assert req.tokens == _solo(tmodel, np.arange(1, 9).astype(np.int32), gcfg, 3)
    engine.cache.check()


def test_one_host_read_per_steady_paged_chunk(pair):
    _, _, tmodel = pair
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, kv_page_size=PS)
    gcfg = GenerationConfig(max_new_tokens=12, temperature=0.0)
    req = engine.submit(np.arange(1, 7), gcfg)
    engine.step()  # admission (first token) + one chunk
    assert engine.host_reads == 2
    for _ in range(2):  # steady chunks, one of them mapping a new page
        before = engine.host_reads
        engine.step()
        assert engine.host_reads - before == 1
    engine.run()
    assert req.tokens == _solo(tmodel, np.arange(1, 7).astype(np.int32), gcfg, req.seed)
    engine.cache.check()


def test_paged_engine_options_are_validated(pair):
    _, _, tmodel = pair
    for bad in (dict(kv_num_pages=9), dict(kv_page_size=12), dict(kv_page_size=PS, kv_num_pages=1)):
        with pytest.raises(ValueError):
            ServingEngine(tmodel, num_slots=1, **bad)
    with pytest.raises(TypeError):  # the host page tier is not ported
        ServingEngine(tmodel, num_slots=1, kv_page_size=PS, kv_host_pages=4)
    assert isinstance(ServingEngine(tmodel, num_slots=1, kv_page_size=PS).cache, PagedCacheManager)
