"""The port's prefix cache against the JAX package (CPU, fp32, tiny_llama).

* ``PrefixCache``: the same sequence of operations (insert, lookup, peek,
  pin, release, evict, covers, ``match_len``) on the port's store and the
  JAX one gives the same results: longest match and ``min_match``, LRU that
  respects pins, trie pruning, the disabled store inert.
* ``extract_cache_prefix`` / ``seed_cache_prefix`` equal the JAX functions
  exactly on the same numpy-seeded cache (they copy); ``cache_fingerprint``
  is within 1e-6 relative of JAX's (both sum ~10^4 f32 terms, in another
  order: ~1e-7 relative) and equal bit for bit port against port.
* ``suffix_prefill_step`` on the same seeded prefix: the last logits within
  2e-4 of JAX's (the tolerance of ``tests/test_torch_llama.py``: different
  summation orders and sin/cos over 4 layers) and the written K/V columns
  within 1e-5 (the first layer's outputs of the same f32 products).
* Engines, row and paged: prefix-on streams equal prefix-off streams (greedy
  and sampled, exactly), greedy streams equal the JAX engine's prefix-on
  streams, and hit, miss and reused-token counts equal the JAX engine's, on
  the JAX tests' workloads: hits, misses, partial and full matches; eviction
  then readmit; preemption and resume under eager admission. Paged: zero KV
  bytes copied, pages shared, insert pins and eviction releases, reclaim
  under page pressure, ``check()`` after every step. Host reads per hit
  admission against the JAX engine's. A hit admitted between decode chunks
  rebinds none of the decode step's buffers."""

import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.serving import PrefixCache as JPrefixCache
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu.utils.fingerprint import cache_fingerprint as jfingerprint
from neuronx_distributed_tpu_torch.inference.generate import (
    GenerationConfig,
    pack_padded_prompt,
    serving_clones,
    suffix_prefill_step,
)
from neuronx_distributed_tpu_torch.modules.attention import (
    KVCache,
    extract_cache_prefix,
    seed_cache_prefix,
)
from neuronx_distributed_tpu_torch.serving import PrefixCache
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from neuronx_distributed_tpu_torch.utils.fingerprint import cache_fingerprint
from test_torch_decode_program import _step_buffers
from test_torch_llama import build_pair

# the JAX packages re-export functions under their modules' names
jgen = importlib.import_module("neuronx_distributed_tpu.inference.generate")
jattn = importlib.import_module("neuronx_distributed_tpu.modules.attention")

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PS = 8  # page size of the paged engines (as the JAX paged-cache tests)
LAYOUTS = {"row": {}, "paged": dict(kv_page_size=PS)}

# the JAX prefix tests' workload, loaded from its file (tests/serving is not a package)
_spec = importlib.util.spec_from_file_location(
    "jax_prefix_tests", os.path.join(os.path.dirname(__file__), "serving", "test_prefix_cache.py"))
jpt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jpt)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=21)


@pytest.fixture(scope="module")
def short_pair():
    return build_pair(seed=21, max_seq_len=48)


# --- the store ---------------------------------------------------------------

def _tree_for(kind):
    """A stored block for each framework's store (its leaf shapes are all
    the store reads)."""
    if kind == "jax":
        return lambda m: jpt._dummy_tree(m)
    return lambda m: KVCache.allocate(1, 1, m, 1, 1, torch.float32, "cpu")


def _script_longest_match(pc, tree):
    toks = tuple(range(10, 20))
    out = [pc.insert(toks, tree(10), 1.0, 16)[1]]
    for q in (list(toks), list(toks) + [99, 98], list(toks[:5]) + [1, 2, 3],
              list(toks[:2]) + [7]):
        hit = pc.lookup(q)
        out.append(None if hit is None else (hit[0].tokens, hit[1]))
    peek = pc.peek(list(toks[:6]) + [0])
    out += [None if peek is None else peek[1], pc.match_len(list(toks[:2]) + [7]),
            pc.match_len(list(toks) + [99]), pc.covers(toks[:4]), pc.covers(toks + (1,))]
    again, evicted = pc.insert(toks[:6], tree(6), 2.0, 8)
    return out + [again, evicted, len(pc), pc.tokens_stored]


def _script_lru_pins(pc, tree):
    e1, _ = pc.insert((1, 2, 3), tree(3), 1.0, 4)
    e2, _ = pc.insert((4, 5, 6), tree(3), 2.0, 4)
    pc.pin(e1)
    out = [pc.insert((7, 8, 9), tree(3), 3.0, 4)[1], [e.tokens for e in pc.entries]]
    pc.release(e1)
    pc.lookup([7, 8, 9, 1])  # refresh: (1, 2, 3) is the LRU now
    out += [pc.insert((2, 4, 6), tree(3), 4.0, 4)[1], [e.tokens for e in pc.entries]]
    for e in pc.entries:
        pc.pin(e)
    e5, evicted = pc.insert((9, 9, 9), tree(3), 5.0, 4)
    out += [e5.tokens, evicted, len(pc), [e.refs for e in pc.entries]]
    pc.release_all()
    return out + [[e.refs for e in pc.entries]]


def _script_prune(pc, tree):
    e1, _ = pc.insert((1, 2, 3, 4), tree(4), 1.0, 4)
    e2, _ = pc.insert((1, 2, 9), tree(3), 2.0, 4)
    out = [pc.evict_entry(e1), pc.evict_entry(e1)]
    for q in ([1, 2, 9, 5], [1, 2, 3, 4, 5]):
        hit = pc.lookup(q)
        out.append(None if hit is None else (hit[0].tokens, hit[1]))
    out += [pc.evict_entry(e2), len(pc), pc.lookup([1, 2, 9, 5]), len(pc._root.children)]
    dropped = pc.insert((5, 6, 7), tree(3), 3.0, 4)[0] is not None
    return out + [dropped, pc.clear(), len(pc), pc.match_len([5, 6, 7, 8])]


def _script_disabled(pc, tree):
    return [pc.enabled, pc.insert(tuple(range(1, 9)), tree(8), 1.0, 8),
            pc.lookup(list(range(8))), pc.peek(list(range(8))), pc.match_len(list(range(8))),
            pc.covers((1, 2)), len(pc)]


SCRIPTS = {
    "longest_match": (_script_longest_match, dict(max_entries=8, min_match=3)),
    "lru_pins": (_script_lru_pins, dict(max_entries=2, min_match=2)),
    "prune": (_script_prune, dict(max_entries=8, min_match=2)),
    "disabled": (_script_disabled, dict(max_entries=0)),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_prefix_store_matches_jax(script):
    run, kw = SCRIPTS[script]
    assert run(PrefixCache(**kw), _tree_for("torch")) == run(JPrefixCache(**kw), _tree_for("jax"))


def test_store_reports_entry_bytes_and_evictions():
    pc = PrefixCache(max_entries=1, min_match=2)
    dropped = []
    pc.on_evict = dropped.append
    e1, _ = pc.insert((1, 2, 3), KVCache.allocate(2, 1, 4, 2, 8, torch.float32, "cpu"), 1.0, 4)
    assert pc.nbytes == 2 * (2 * 4 * 2 * 8 * 4) + 4  # K and V f32, validity bool
    e2, evicted = pc.insert((4, 5, 6), None, None, 3)
    assert evicted == 1 and dropped == [e1] and pc.nbytes == 0 and e2.shapes == ()


# --- extract, seed, fingerprint --------------------------------------------------

def _cache_arrays(rng, layers=3, b=1, L=32, hkv=2, d=4):
    k = rng.normal(size=(layers, b, L, hkv, d)).astype(np.float32)
    v = rng.normal(size=(layers, b, L, hkv, d)).astype(np.float32)
    valid = rng.random((b, L)) > 0.25
    return k, v, valid


def _jtree(k, v, valid, index):
    """The JAX cache collection (per-layer ``k``, ``v``, ``kv_valid``,
    ``index`` leaves) of the same arrays."""
    return {"model": {f"layers_{i}": {"attn": {
        "k": jnp.asarray(k[i]), "v": jnp.asarray(v[i]), "kv_valid": jnp.asarray(valid),
        "index": jnp.asarray(index, jnp.int32)}} for i in range(k.shape[0])}}


def _from_jtree(tree):
    layers = tree["model"]
    n = len(layers)
    at = [layers[f"layers_{i}"]["attn"] for i in range(n)]
    stack = lambda name: np.stack([np.asarray(a[name]) for a in at])  # noqa: E731
    return stack("k"), stack("v"), np.asarray(at[0]["kv_valid"]), int(at[0]["index"])


def _tcache(k, v, valid, index=0):
    return KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                   torch.from_numpy(valid.copy()), index)


@pytest.mark.parametrize("start,m,bucket", [(5, 12, 16), (0, 32, 32), (20, 9, 16)])
def test_extract_and_seed_equal_jax(start, m, bucket):
    rng = np.random.default_rng(start + m)
    k, v, valid = _cache_arrays(rng)
    want = _from_jtree(jattn.extract_cache_prefix(_jtree(k, v, valid, 7), start, m, bucket))
    block = extract_cache_prefix(_tcache(k, v, valid, 7), start, m, bucket)
    got = (block.k.numpy(), block.v.numpy(), block.valid.numpy(), block.index)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert block.k.data_ptr() != 0 and not np.shares_memory(block.k.numpy(), k)

    # seed the stored block into a zeroed 32-column row at column `at`
    at = 32 - m - 3 if m < 29 else 0
    L = k.shape[2]
    jrow = _from_jtree(jattn.seed_cache_prefix(_jtree(*want[:3], m), m, at, L))
    row = _tcache(np.zeros_like(k), np.zeros_like(v), rng.random((1, L)) > 0.5, 3)
    seed_cache_prefix(row, block, m, at)
    for a, b in zip((row.k.numpy(), row.v.numpy(), row.valid.numpy(), row.index), jrow):
        np.testing.assert_array_equal(a, b)
    assert int(row.cursor) == at + m


def test_fingerprint_matches_jax_and_is_bit_stable():
    rng = np.random.default_rng(3)
    k, v, valid = _cache_arrays(rng, layers=4, L=64, hkv=4, d=8)
    block = extract_cache_prefix(_tcache(k, v, valid), 10, 40, 64)
    jblock = jattn.extract_cache_prefix(_jtree(k, v, valid, 0), 10, 40, 64)
    want = float(jfingerprint(jblock))
    got = cache_fingerprint(block)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    again = cache_fingerprint(extract_cache_prefix(_tcache(k, v, valid), 10, 40, 64))
    assert torch.equal(got, again)
    block.k[2, 0, 5, 1, 3] += 1.0  # one corrupted element moves it
    assert not torch.equal(cache_fingerprint(block), got)


def test_suffix_prefill_step_matches_jax(pair):
    """Prefill a 20-token context in JAX, store its first 13 columns, seed
    the same block into a fresh row on both sides, and run the 7-token
    suffix (chunk 8, right padding) through each framework's decode-mode
    model."""
    jmodel, params, tmodel = pair
    rng = np.random.default_rng(4)
    ctx = rng.integers(1, 256, size=20).astype(np.int32)
    p, m, padded = 20, 13, 32
    jpre, jdec = jgen.serving_clones(jmodel)
    ids, mask = pack_padded_prompt(ctx, padded)
    _, var = jpre.apply(params, jnp.asarray(ids), padding_mask=jnp.asarray(mask),
                        mutable=["cache"])
    jblock = jattn.extract_cache_prefix(var["cache"], padded - p, m, 16)
    L = tmodel.config.max_seq_len
    jrow = jattn.seed_cache_prefix(jblock, m, padded - p, L)
    sfx, _ = pack_padded_prompt(ctx[m:], 8, pad_side="right")
    jlast, jcache = jgen.suffix_prefill_step(jdec)(params, jrow, jnp.asarray(sfx), p - m)

    k, v, valid, index = _from_jtree(jblock)
    row = tmodel.new_cache(1)
    seed_cache_prefix(row, _tcache(k, v, valid, index), m, padded - p)
    _, tdec = serving_clones(tmodel)
    with torch.no_grad():
        last = suffix_prefill_step(tdec, row, torch.from_numpy(sfx).long(), p - m)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=2e-4, rtol=0)
    jk, jv, jvalid, _ = _from_jtree(jcache)
    cols = slice(padded - p + m, padded - p + m + 8)  # the chunk's columns, pad tail included
    np.testing.assert_allclose(row.k[:, :, cols].numpy(), jk[:, :, cols], atol=1e-5, rtol=0)
    np.testing.assert_allclose(row.v[:, :, cols].numpy(), jv[:, :, cols], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(row.valid.numpy(), jvalid)
    assert int(row.cursor) == row.index == padded - p + m + 8
    # and it continues the context a full prefill of it would: the same next-token logits
    full = tmodel.new_cache(1)
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(ids).long(), mode="prefill", cache=full,
                     padding_mask=torch.from_numpy(mask), last_only=True)[0, -1]
    np.testing.assert_allclose(last.numpy(), ref.numpy(), atol=2e-4, rtol=0)


# --- engines ---------------------------------------------------------------------

def _port_cfg(g):
    return GenerationConfig(max_new_tokens=g.max_new_tokens, temperature=g.temperature,
                            top_k=g.top_k, top_p=g.top_p, eos_token_id=g.eos_token_id)


def _greedy(gcfgs):
    return [i for i, g in enumerate(gcfgs) if g.temperature == 0.0]


def _case_shared(cfg):
    prompts, gcfgs, _ = jpt._shared_workload(cfg)
    return [prompts], gcfgs, dict(num_slots=3), dict(max_entries=16, min_match=4)


def _case_evict_readmit(cfg):
    rng = np.random.RandomState(3)
    a = rng.randint(1, cfg.vocab_size, size=10).astype(np.int32)
    b = rng.randint(1, cfg.vocab_size, size=11).astype(np.int32)
    g = jgen.GenerationConfig(max_new_tokens=6, temperature=0.0)
    s = jgen.GenerationConfig(max_new_tokens=6, temperature=0.8, top_k=13)
    # three waves, each run to the end: A seeds, B evicts it, A misses and re-inserts
    return [[a], [b], [a]], [g, s, g], dict(num_slots=1), dict(max_entries=1, min_match=4)


def _case_preempt(cfg):
    # the JAX test's prompts, each grown to 12 tokens so that a paged entry
    # holds a whole page of 8 (4-token contexts store nothing paged)
    rng = np.random.RandomState(95)
    prompts = [np.concatenate([np.asarray(x, np.int32), rng.randint(1, 256, size=8)]).astype(
        np.int32) for x in ([3, 5, 7, 11], [13, 17, 19, 23], [29, 31, 37, 41])]
    gcfgs = [jgen.GenerationConfig(max_new_tokens=30, temperature=0.0),
             jgen.GenerationConfig(max_new_tokens=20, temperature=0.7, top_k=25),
             jgen.GenerationConfig(max_new_tokens=25, temperature=0.0)]
    return [prompts], gcfgs, dict(num_slots=2, admission="eager"), dict(max_entries=16,
                                                                       min_match=2)


CASES = {"shared": _case_shared, "evict_readmit": _case_evict_readmit,
         "preempt_resume": _case_preempt}


def _serve(engine, waves, gcfgs, submit, check=lambda e: None):
    """Submit each wave and run it to the end; ``check`` after every step."""
    reqs, i = [], 0
    for wave in waves:
        for p in wave:
            reqs.append(submit(engine, p, gcfgs[i], i))
            i += 1
        while engine.has_work:
            engine.step()
            check(engine)
    return reqs


def _port_run(tmodel, waves, gcfgs, engine_kw, prefix_cache, layout):
    engine = ServingEngine(tmodel, prefix_cache=prefix_cache, **engine_kw, **LAYOUTS[layout])
    check = (lambda e: e.cache.check()) if layout == "paged" else (lambda e: None)
    reqs = _serve(engine, waves, [_port_cfg(g) for g in gcfgs],
                  lambda e, p, g, i: e.submit(p, g, seed=700 + i), check)
    return engine, reqs


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_prefix_streams_and_counts_match_jax(pair, short_pair, case, layout):
    jmodel, params, tmodel = short_pair if case == "preempt_resume" else pair
    waves, gcfgs, engine_kw, store_kw = CASES[case](tmodel.config)
    jengine = JServingEngine(jmodel, params, prefix_cache=JPrefixCache(**store_kw), **engine_kw,
                             **LAYOUTS[layout])
    jreqs = _serve(jengine, waves, gcfgs,
                   lambda e, p, g, i: e.submit(p, g, key=jax.random.PRNGKey(700 + i)))
    on, on_reqs = _port_run(tmodel, waves, gcfgs, engine_kw, PrefixCache(**store_kw), layout)
    off, off_reqs = _port_run(tmodel, waves, gcfgs, engine_kw, None, layout)
    for i, (a, b) in enumerate(zip(on_reqs, off_reqs)):
        assert a.state is RequestState.DONE and b.state is RequestState.DONE, i
        assert a.tokens == b.tokens, f"request {i}: prefix-on stream differs from prefix-off"
    for i in _greedy(gcfgs):
        assert on_reqs[i].tokens == list(jreqs[i].tokens), f"request {i} differs from JAX"
    snap, jsnap = on.metrics.snapshot(), jengine.metrics.snapshot()
    keys = ("prefix_hits", "prefix_misses", "prefix_tokens_reused", "prefix_evictions")
    assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
    assert snap["prefix_hits"] > 0 or case == "evict_readmit"
    assert snap["prefix_validation_failures"] == 0
    assert snap["prefill_suffix_count"] == snap["prefix_hits"]
    assert snap["preemptions"] == jsnap["preemptions"]
    assert case != "preempt_resume" or snap["preemptions"] > 0
    off_snap = off.metrics.snapshot()
    assert off.prefix is None and off_snap["prefix_hits"] == off_snap["prefix_misses"] == 0
    assert off_snap["prefill_suffix_wall_s"] == 0.0
    if layout == "paged":
        assert on.cache.alloc.copy_bytes == 0
        assert snap["prefix_pages_shared"] == jsnap["prefix_pages_shared"]


@pytest.mark.parametrize("arg,enabled", [("auto", True), (None, False), (0, False), (3, True),
                                         (PrefixCache(max_entries=0), False)])
def test_prefix_cache_argument_as_jax(pair, arg, enabled):
    _, _, tmodel = pair
    engine = ServingEngine(tmodel, num_slots=1, prefix_cache=arg)
    assert (engine.prefix is not None) == enabled
    if arg == 3:
        assert engine.prefix.max_entries == 3
    with pytest.raises((ValueError, TypeError)):
        ServingEngine(tmodel, num_slots=1, prefix_cache="on")


def test_paged_hit_is_zero_copy_and_matches_row_engine(pair):
    """The JAX paged test's traffic: a 17-token system prompt (2 whole pages
    of 8) and 4 tails; hits map the entry's pages into the new slot
    (refcounts up), ``copy_bytes`` stays 0, streams equal the prefix-off
    paged engine, the row engine and the JAX paged engine."""
    jmodel, params, tmodel = pair
    sys_p = np.arange(1, 18, dtype=np.int32)
    rng = np.random.RandomState(3)
    prompts = [np.concatenate([sys_p, rng.randint(1, 256, size=4 + i).astype(np.int32)])
               for i in range(4)]
    gcfgs = [jgen.GenerationConfig(max_new_tokens=6, temperature=0.0)] * 4
    kw = dict(num_slots=2, decode_chunk_size=4)
    runs = {}
    for name, pc, lay in (("paged", PrefixCache(min_match=8), "paged"), ("off", None, "paged"),
                          ("row", PrefixCache(min_match=8), "row")):
        runs[name] = _port_run(tmodel, [prompts], gcfgs, kw, pc, lay)
    jengine = JServingEngine(jmodel, params, prefix_cache=JPrefixCache(min_match=8),
                             kv_page_size=PS, **kw)
    jreqs = _serve(jengine, [prompts], gcfgs,
                   lambda e, p, g, i: e.submit(p, g, key=jax.random.PRNGKey(80 + i)))
    toks = {name: [r.tokens for r in reqs] for name, (_, reqs) in runs.items()}
    assert toks["paged"] == toks["off"] == toks["row"] == [list(r.tokens) for r in jreqs]
    pg = runs["paged"][0]
    snap = pg.metrics.snapshot()
    assert snap["prefix_hits"] >= 3 and snap["prefix_pages_shared"] >= 2 * snap["prefix_hits"]
    assert snap["prefix_hits"] == jengine.metrics.snapshot()["prefix_hits"]
    assert pg.cache.alloc.copy_bytes == 0
    assert pg.cache.prefix_pages_shared_total == snap["prefix_pages_shared"] >= 6
    pg.cache.check()


def test_paged_insert_pins_pages_and_eviction_releases(pair):
    _, _, tmodel = pair
    eng = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                        prefix_cache=PrefixCache(max_entries=8, min_match=8))
    r = eng.submit(np.arange(1, 20, dtype=np.int32), GenerationConfig(4, temperature=0.0))
    eng.run()
    assert r.state is RequestState.DONE
    (entry,) = eng.prefix.entries
    pinned = entry.page_ids
    assert len(pinned) == 2 and entry.m == 16  # 19 tokens floor to 2 whole pages
    # the slot retired, the entry keeps its pages alive
    assert all(eng.cache.alloc.refcount(p) == 1 for p in pinned)
    assert eng.cache.reclaimable_pages() == 2
    assert eng.cache.available_pages() == eng.cache.alloc.capacity
    eng.cache.check()
    eng.prefix.evict_entry(entry)
    assert all(eng.cache.alloc.refcount(p) == 0 for p in pinned)
    assert entry.page_ids is None and eng.cache.alloc.free_pages == eng.cache.alloc.capacity
    eng.cache.check()


def test_paged_reclaim_lets_an_admission_through(pair):
    """A one-row pool (16 pages of 8): an entry pins 5 pages of a finished
    request; the next request needs 13 pages with 11 free. Admission counts
    the pinned pages as reclaimable, and the allocation evicts the LRU
    entry to take them; streams equal a prefix-off engine's."""
    _, _, tmodel = pair
    rng = np.random.default_rng(8)
    a = rng.integers(1, 256, size=40).astype(np.int32)
    b = rng.integers(1, 256, size=90).astype(np.int32)
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    out = {}
    for name, pc in (("on", PrefixCache(min_match=8)), ("off", None)):
        eng = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                            kv_num_pages=17, prefix_cache=pc)
        reqs = _serve(eng, [[a], [b]], [gcfg, gcfg],
                      lambda e, p, g, i: e.submit(p, g, seed=i), lambda e: e.cache.check())
        out[name] = (eng, [r.tokens for r in reqs])
        assert all(r.state is RequestState.DONE for r in reqs)
    eng = out["on"][0]
    assert out["on"][1] == out["off"][1]
    snap = eng.metrics.snapshot()
    assert snap["prefix_evictions"] >= 1  # a's entry went to make room
    assert [e.m for e in eng.prefix.entries] == [88]  # b's own entry, 11 pages
    eng.prefix.clear()
    eng.cache.check()
    assert eng.cache.alloc.free_pages == eng.cache.alloc.capacity


def test_pinned_pages_are_never_written(pair):
    """Every write window of a paged engine under shared-prefix traffic
    (each suffix chunk and decode window) holds no pinned page, and the
    entries' page contents are bitwise unchanged from insert to the end."""
    _, _, tmodel = pair
    prompts, gcfgs, _ = jpt._shared_workload(tmodel.config)
    eng = ServingEngine(tmodel, num_slots=3, kv_page_size=PS,
                        prefix_cache=PrefixCache(max_entries=16, min_match=4))
    seen = {}
    windows = []
    real = eng.cache.assert_writable

    def recording(slots, lo, hi):
        windows.append((tuple(int(s) for s in slots), lo, hi))
        real(slots, lo, hi)

    eng.cache.assert_writable = recording

    def check(e):
        e.cache.check()
        for entry in e.prefix.entries:
            for pid in entry.page_ids:
                page = (e.cache.cache.k[:, pid].clone(), e.cache.cache.v[:, pid].clone())
                if pid in seen:
                    assert torch.equal(seen[pid][0], page[0]) and torch.equal(seen[pid][1], page[1])
                seen.setdefault(pid, page)

    _serve(eng, [prompts], gcfgs, lambda e, p, g, i: e.submit(p, _port_cfg(g), seed=i), check)
    assert seen and windows and eng.metrics.prefix_hits > 0
    # a hit that decodes on: a write window over one of its shared pages raises
    eng.submit(prompts[0], GenerationConfig(max_new_tokens=40, temperature=0.0), seed=0)
    eng.step()
    pinned = {pid for e in eng.prefix.entries for pid in e.page_ids}
    slot, pid = next((s, int(p)) for s in range(eng.num_slots) for p in eng.cache._tables[s]
                     if int(p) in pinned)
    with pytest.raises(AssertionError, match=f"pinned page {pid}"):
        real([slot], 0, eng.max_seq_len)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_host_reads_per_hit_admission_as_jax(pair, layout, monkeypatch):
    """The admission step of a hit (its first token plus one chunk) costs the
    JAX engine's device_get count: the validation read (a row entry's
    fingerprint pair, or a paged entry's page fingerprints stacked with the
    stored ones), the first token and the chunk."""
    jmodel, params, tmodel = pair
    prompt = np.arange(3, 19, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    eng = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4,
                        prefix_cache=PrefixCache(min_match=4), **LAYOUTS[layout])
    eng.submit(prompt, gcfg)
    eng.run()
    eng.submit(prompt, gcfg)
    before = eng.host_reads
    eng.step()
    port_reads = eng.host_reads - before
    assert eng.metrics.prefix_hits == 1

    jeng = JServingEngine(jmodel, params, num_slots=2, decode_chunk_size=4,
                          prefix_cache=JPrefixCache(min_match=4), **LAYOUTS[layout])
    jcfg = jgen.GenerationConfig(max_new_tokens=8, temperature=0.0)
    jeng.submit(prompt, jcfg, key=jax.random.PRNGKey(0))
    jeng.run()
    jeng.submit(prompt, jcfg, key=jax.random.PRNGKey(0))
    calls = []
    real = jax.device_get
    monkeypatch.setattr(jax, "device_get", lambda x: calls.append(1) or real(x))
    jeng.step()
    monkeypatch.setattr(jax, "device_get", real)
    assert jeng.metrics.prefix_hits == 1
    assert len(calls) == 3 and port_reads == len(calls)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_hit_between_chunks_rebinds_no_decode_buffer(pair, layout):
    """A request decodes; a hit on its context is admitted between two of
    its chunks (the suffix prefill writes through the slot's view, outside
    the decode step): the decode step's buffers keep their data_ptr, the
    device cursor equals its mirror, and both streams equal the prefix-off
    engine's."""
    _, _, tmodel = pair
    rng = np.random.default_rng(12)
    base = rng.integers(1, 256, size=24).astype(np.int32)
    second = np.concatenate([base, rng.integers(1, 256, size=40).astype(np.int32)])
    gcfgs = [GenerationConfig(max_new_tokens=20, temperature=0.0),
             GenerationConfig(max_new_tokens=9, temperature=0.9, top_k=30)]
    out = {}
    for pc in ("auto", None):
        eng = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4, prefix_cache=pc,
                            **LAYOUTS[layout])
        first = eng.submit(base, gcfgs[0], seed=1)
        eng.step()
        ptrs = _step_buffers(eng)
        late = eng.submit(second, gcfgs[1], seed=2)
        while eng.has_work:
            eng.step()
            assert _step_buffers(eng) == ptrs
            assert int(eng.cache.cache.cursor) == eng.cache.cursor
        out[pc] = (eng, [first.tokens, late.tokens])
    assert out["auto"][1] == out[None][1]
    snap = out["auto"][0].metrics.snapshot()
    assert snap["prefix_hits"] == 1 and snap["prefix_tokens_reused"] == (24 if layout == "row"
                                                                         else 24 // PS * PS)
    assert out["auto"][0].decode_compilations == 0  # the CPU captures nothing

