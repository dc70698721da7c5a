"""Speculative decoding inside the port's ServingEngine (CPU, fp32,
tiny_llama): draft-verify rounds with per-slot variable advance, row and
paged, mirroring ``tests/serving/test_spec_decode.py``'s tier-1 cases on its
fixture (a tiny_llama target, a 2-layer draft from another seed).

Speculation is a transport for the target's own stream: greedy streams
equal the JAX speculative engine's and the port's spec-off engine's (and
solo ``speculative_generate``'s), sampled streams the spec-off engine's
(one plain-step draw a round), under staggered admission, EOS inside an
accepted window, preemption and resume, and prefix-cache hits. Cases the
JAX suite marks slow compare with the port's spec-off engine instead of
the JAX engine. The round on fixed buffers is held to an eager reference
built from solo greedy decoding, its masked warm-up to leaving no trace,
and its chunk to reading nothing from the device. Streams equal exactly;
acceptance counters equal the JAX engine's on the same traffic."""

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import ChunkedDecode, GenerationConfig
from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram
from neuronx_distributed_tpu_torch.inference.speculative import speculative_generate
from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, tiny_llama
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from test_torch_decode_program import no_host_reads
from test_torch_llama import build_pair
from test_torch_serving import _solo

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PS = 8  # page size of the paged engines
LAYOUTS = {"row": {}, "paged": dict(kv_page_size=PS)}
SPEC_KEYS = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
             "draft_tokens_wasted", "spec_accept_rate", "spec_accept_len_p50",
             "spec_accept_len_p95", "spec_fallbacks")


@pytest.fixture(scope="module")
def setup():
    """The JAX fixture: target from key 1, 2-layer draft from key 7."""
    jt, tp, tt = build_pair(seed=1)
    jd, dp, td = build_pair(seed=7, num_layers=2)
    return jt, tp, tt, jd, dp, td


def _workload(n=5, seed=31):
    """The JAX suite's mix: greedy, sampled with top-k, greedy with an EOS,
    greedy, sampled with top-p."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, 256, size=rng.randint(3, 14)).astype(np.int32) for _ in range(n)]
    gcfgs = [
        GenerationConfig(max_new_tokens=9, temperature=0.0),
        GenerationConfig(max_new_tokens=12, temperature=0.8, top_k=17),
        GenerationConfig(max_new_tokens=6, temperature=0.0, eos_token_id=5),
        GenerationConfig(max_new_tokens=11, temperature=0.0),
        GenerationConfig(max_new_tokens=8, temperature=1.1, top_p=0.9),
    ][:n]
    return prompts, gcfgs


def _serve(engine, prompts, gcfgs, submit, upfront=2):
    """Staggered open-loop run (admissions land at chunk boundaries)."""
    reqs = [submit(engine, prompts[i], gcfgs[i], i) for i in range(upfront)]
    i = upfront
    while engine.has_work or i < len(prompts):
        engine.step()
        if i < len(prompts):
            reqs.append(submit(engine, prompts[i], gcfgs[i], i))
            i += 1
    engine.run()
    return reqs


def _port(engine, prompts, gcfgs):
    return _serve(engine, prompts, gcfgs, lambda e, p, g, i: e.submit(p, g, seed=500 + i))


def _jcfg(g):
    return JGenerationConfig(max_new_tokens=g.max_new_tokens, temperature=g.temperature,
                             top_k=g.top_k, top_p=g.top_p, eos_token_id=g.eos_token_id)


@pytest.fixture(scope="module")
def jax_spec_runs(setup):
    """The JAX speculative engine (gamma 3, chunk 3, 2 slots) on the
    workload, row and paged: streams and snapshots."""
    jt, tp, _, jd, dp, _ = setup
    prompts, gcfgs = _workload()
    out = {}
    for layout, kw in LAYOUTS.items():
        engine = JServingEngine(jt, tp, num_slots=2, decode_chunk_size=3, prefix_cache=None,
                                draft_model=jd, draft_params=dp, gamma=3, **kw)
        reqs = _serve(engine, prompts, [_jcfg(g) for g in gcfgs],
                      lambda e, p, g, i: e.submit(p, g, key=jax.random.PRNGKey(500 + i)))
        out[layout] = ([list(r.tokens) for r in reqs], engine.metrics.snapshot())
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_streams_equal_jax_spec_engine_and_spec_off(setup, jax_spec_runs, layout):
    """Greedy streams: the JAX speculative engine's, the port's spec-off
    engine's and solo ``generate``'s; sampled streams: the spec-off
    engine's. The acceptance counters equal the JAX engine's on the same
    traffic (sampled slots accept nothing and emit a token a round in
    both)."""
    _, _, tt, _, _, td = setup
    prompts, gcfgs = _workload()
    kw = LAYOUTS[layout]
    off = _port(ServingEngine(tt, num_slots=2, decode_chunk_size=3, prefix_cache=None, **kw),
                prompts, gcfgs)
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=3, prefix_cache=None,
                           draft_model=td, gamma=3, **kw)
    on = _port(engine, prompts, gcfgs)
    jstreams, jsnap = jax_spec_runs[layout]
    for i, (a, b, g) in enumerate(zip(off, on, gcfgs)):
        assert a.state is RequestState.DONE and b.state is RequestState.DONE
        assert b.tokens == a.tokens, i
        if g.temperature == 0.0:
            assert b.tokens == jstreams[i], i
            assert b.tokens == _solo(tt, prompts[i], g, 0), i
    snap = engine.metrics.snapshot()
    assert {k: snap[k] for k in SPEC_KEYS} == {k: jsnap[k] for k in SPEC_KEYS}
    assert snap["spec_rounds"] > 0 and snap["spec_fallbacks"] == 0
    assert engine.decode_compilations == 0  # the CPU captures nothing
    if layout == "paged":
        engine.cache.check()
        engine.draft_cache.check()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_acceptance_metrics_equal_jax_engine_with_partial_acceptance(setup, layout):
    """An early-exit draft (the target's first layer, eps 0.5) on greedy
    traffic accepts part of its drafts: the engines' spec keys agree, and
    the streams equal the spec-off engine's."""
    from neuronx_distributed_tpu.models import llama as jllama
    from neuronx_distributed_tpu_torch.models.llama import early_exit_draft

    jt, tp, tt, _, _, _ = setup
    jtp, jdp = jllama.early_exit_draft_params(tp, 4, 1, 0.5)
    jd = jllama.LlamaForCausalLM(jllama.tiny_llama(num_layers=1), attention_impl="xla")
    target, draft = early_exit_draft(tt, 1, 0.5)
    prompts, _ = _workload()
    gcfgs = [GenerationConfig(max_new_tokens=n, temperature=0.0) for n in (12, 9, 14, 7, 10)]
    kw = LAYOUTS[layout]
    jengine = JServingEngine(jt, jtp, num_slots=3, decode_chunk_size=2, prefix_cache=None,
                             draft_model=jd, draft_params=jdp, gamma=4, **kw)
    jreqs = _serve(jengine, prompts, [_jcfg(g) for g in gcfgs],
                   lambda e, p, g, i: e.submit(p, g, key=jax.random.PRNGKey(i)), upfront=3)
    engine = ServingEngine(target, num_slots=3, decode_chunk_size=2, prefix_cache=None,
                           draft_model=draft, gamma=4, **kw)
    reqs = _serve(engine, prompts, gcfgs, lambda e, p, g, i: e.submit(p, g, seed=i), upfront=3)
    off = _serve(ServingEngine(target, num_slots=3, decode_chunk_size=2, prefix_cache=None, **kw),
                 prompts, gcfgs, lambda e, p, g, i: e.submit(p, g, seed=i), upfront=3)
    assert [r.tokens for r in reqs] == [list(r.tokens) for r in jreqs] == [r.tokens for r in off]
    snap, jsnap = engine.metrics.snapshot(), jengine.metrics.snapshot()
    assert {k: snap[k] for k in SPEC_KEYS} == {k: jsnap[k] for k in SPEC_KEYS}
    assert 0.0 < snap["spec_accept_rate"] < 1.0


def test_spec_engine_equals_solo_speculative_generate(setup):
    _, _, tt, _, _, td = setup
    prompt = np.random.RandomState(5).randint(1, 256, size=8).astype(np.int32)
    solo, _ = speculative_generate(tt, td, prompt[None], 12, gamma=3)
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=4, prefix_cache=None,
                           draft_model=td, gamma=3)
    req = engine.submit(prompt, GenerationConfig(max_new_tokens=12, temperature=0.0))
    engine.run()
    assert req.tokens == solo[0].tolist()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_eos_mid_accepted_window(setup, layout):
    """A perfect draft accepts gamma a round, so the EOS lands inside an
    accepted window: the stream stops exactly where the plain engine's
    does, nothing after the EOS leaks and nothing before it is lost."""
    _, _, tt, _, _, _ = setup
    prompt = np.random.RandomState(11).randint(1, 256, size=7).astype(np.int32)
    full = _solo(tt, prompt, GenerationConfig(max_new_tokens=10, temperature=0.0), 0)
    gcfg = GenerationConfig(max_new_tokens=10, temperature=0.0, eos_token_id=full[5])
    ref = _solo(tt, prompt, gcfg, 0)
    assert len(ref) < len(full)
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=2, prefix_cache=None,
                           draft_model=tt, gamma=4, **LAYOUTS[layout])
    req = engine.submit(prompt, gcfg)
    engine.run()
    assert req.tokens == ref
    assert engine.metrics.snapshot()["spec_accept_rate"] > 0.5


def test_draft_none_is_a_noop(setup):
    """No draft: no speculative program, no draft cache, the plain decode
    program, the spec counters flat zero."""
    _, _, tt, _, _, _ = setup
    engine = ServingEngine(tt, num_slots=2, prefix_cache=None)
    assert engine.draft_cache is None and engine._chunk.caches == (engine.cache.cache,)
    assert engine._chunk.accepts is None and engine._chunk.cols == engine.gamma == 1
    assert engine.decode_program is engine._chunk.program
    req = engine.submit(np.arange(1, 7), GenerationConfig(max_new_tokens=6, temperature=0.0))
    engine.run()
    assert req.state is RequestState.DONE and len(req.tokens) == 6
    snap = engine.metrics.snapshot()
    assert all(snap[k] == 0 for k in SPEC_KEYS)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_admission_refuses_a_diverged_draft_cache(setup, layout):
    """The draft twin must take the target's slot at every admission: a
    twin whose free list ran ahead raises instead of landing one request's
    draft KV under another slot's bookkeeping."""
    _, _, tt, _, _, td = setup
    engine = ServingEngine(tt, num_slots=2, prefix_cache=None, draft_model=td, gamma=2,
                           **LAYOUTS[layout])
    engine.draft_cache.acquire()  # the twin's free list now starts at slot 1
    engine.submit(np.arange(1, 7), GenerationConfig(max_new_tokens=3, temperature=0.0))
    with pytest.raises(RuntimeError, match="diverged"):
        engine.step()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prefix_hit_composes_with_speculation(setup, layout):
    """Prefix-cache hits feed the speculative rounds (the target prefills
    the tail, the draft its whole context): 3 hits and 1 miss, as the JAX
    engine counts them, and streams equal the cache-off spec-off engine's;
    the draft pins no page."""
    _, _, tt, _, _, td = setup
    rng = np.random.RandomState(23)
    shared = rng.randint(1, 256, size=16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(1, 256, size=3).astype(np.int32)])
               for _ in range(4)]
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    kw = LAYOUTS[layout]
    off = ServingEngine(tt, num_slots=2, decode_chunk_size=3, prefix_cache=None, **kw)
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=3, prefix_cache="auto",
                           draft_model=td, gamma=3, **kw)
    for e in (off, engine):
        reqs = []
        for i, p in enumerate(prompts):
            reqs.append(e.submit(p, gcfg, seed=i))
            e.run()  # serialized: later admissions hit the stored prefix
        e.streams = [r.tokens for r in reqs]
    assert engine.streams == off.streams
    snap = engine.metrics.snapshot()
    assert (snap["prefix_hits"], snap["prefix_misses"]) == (3, 1)
    assert snap["prefill_suffix_count"] == 3
    if layout == "paged":
        assert engine.metrics.prefix_pages_shared > 0
        engine.cache.check()
        engine.draft_cache.check()
        assert not engine.draft_cache._pins


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_preemption_and_resume_leave_streams_unchanged(setup, layout):
    """Eager admission against a 48-column cache: a round burns gamma
    columns, the wall preempts, both caches re-prefill; streams equal the
    spec-off engine's and solo ``generate``'s."""
    _, _, tt48 = build_pair(seed=1, max_seq_len=48)
    _, _, td48 = build_pair(seed=7, num_layers=2, max_seq_len=48)
    rng = np.random.RandomState(17)
    prompts = [rng.randint(1, 256, size=n).astype(np.int32) for n in (9, 12)]
    gcfgs = [GenerationConfig(max_new_tokens=18, temperature=0.0),
             GenerationConfig(max_new_tokens=16, temperature=0.9, top_k=30)]
    engine = ServingEngine(tt48, num_slots=2, admission="eager", decode_chunk_size=4,
                           prefix_cache=None, draft_model=td48, gamma=4, **LAYOUTS[layout])
    reqs = [engine.submit(p, c, seed=60 + i) for i, (p, c) in enumerate(zip(prompts, gcfgs))]
    engine.run(max_steps=500)
    assert engine.metrics.preemptions > 0
    for i, (req, p, c) in enumerate(zip(reqs, prompts, gcfgs)):
        assert req.state is RequestState.DONE
        assert req.tokens == _solo(tt48, p, c, 60 + i), i
    if layout == "paged":
        engine.cache.check()
        engine.draft_cache.check()


@pytest.mark.parametrize("admission", ["eager", "conservative"])
def test_tight_paged_pool_under_speculation(setup, admission):
    """A pool of 8 usable pages behind 3 slots (the reference's paged
    livelock case, ``tests/test_torch_paged.py``) with a draft twin of the
    same geometry: page-pressure walls preempt and resume, both pools stay
    consistent after every step, and the streams equal solo ``generate``'s
    (eager admission charges both pools)."""
    _, _, tt, _, _, td = setup
    rng = np.random.RandomState(31)
    prompts = [rng.randint(1, 256, size=n).astype(np.int32) for n in (10, 7, 12)]
    engine = ServingEngine(tt, num_slots=3, decode_chunk_size=4, kv_page_size=8, kv_num_pages=9,
                           prefix_cache=None, admission=admission, draft_model=td, gamma=3)
    reqs = [engine.submit(p, GenerationConfig(20, temperature=0.0), seed=i)
            for i, p in enumerate(prompts)]
    steps = 0
    while engine.has_work:
        engine.step()
        steps += 1
        assert steps < 100, "no progress"
        engine.cache.check()
        engine.draft_cache.check()
    assert engine.metrics.preemptions > 0
    for req, p in zip(reqs, prompts):
        assert req.state is RequestState.DONE and req.tokens == _solo(tt, p, req.config, 0)


def test_submit_rejects_missing_gamma_headroom(setup):
    _, _, tt, _, _, td = setup
    engine = ServingEngine(tt, num_slots=2, prefix_cache=None, draft_model=td, gamma=4)
    prompt = np.arange(1, 9, dtype=np.int32)
    L = tt.config.max_seq_len
    with pytest.raises(ValueError, match="gamma"):
        engine.submit(prompt, GenerationConfig(max_new_tokens=L - 8 - 2, temperature=0.0))
    engine.submit(prompt, GenerationConfig(max_new_tokens=L - 8 - 3, temperature=0.0))
    plain = ServingEngine(tt, num_slots=2, prefix_cache=None)  # no window: the plain room
    plain.submit(prompt, GenerationConfig(max_new_tokens=L - 8, temperature=0.0))


def test_draft_config_validation(setup):
    _, _, tt, _, _, td = setup
    short = LlamaForCausalLM(tiny_llama(num_layers=2, max_seq_len=64), device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        ServingEngine(tt, num_slots=2, draft_model=short)
    other_vocab = LlamaForCausalLM(tiny_llama(num_layers=2, vocab_size=300), device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        ServingEngine(tt, num_slots=2, draft_model=other_vocab)
    with pytest.raises(ValueError, match="gamma"):
        ServingEngine(tt, num_slots=2, draft_model=td, gamma=0)


def _admitted_engine(tt, draft, layout):
    """A speculative engine with three slots just admitted (one sampled,
    one with a budget of 2 after its first token, under gamma 3)."""
    engine = ServingEngine(tt, num_slots=4, decode_chunk_size=2, prefix_cache=None,
                           draft_model=draft, gamma=3, **LAYOUTS[layout])
    rng = np.random.RandomState(3)
    gcfgs = [GenerationConfig(max_new_tokens=20, temperature=0.0),
             GenerationConfig(max_new_tokens=20, temperature=0.7, top_k=10),
             GenerationConfig(max_new_tokens=3, temperature=0.0)]
    reqs = [engine.submit(rng.randint(1, 256, size=n), g, seed=i)
            for i, (n, g) in enumerate(zip((6, 13, 9), gcfgs))]
    engine._admit(0.0)
    assert all(r.slot is not None and len(r.tokens) == 1 for r in reqs)
    if layout == "paged":
        assert engine._ensure_decode_pages()  # what _decode maps before a chunk
    return engine, reqs


@pytest.mark.parametrize("draft", ["weak", "perfect"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_round_on_fixed_buffers_equals_eager_reference(setup, layout, draft):
    """One round of the fixed-buffer program against a reference built
    from solo decoding of each slot's context: a greedy slot accepts the
    leading drafts that equal the target's greedy continuation and emits
    that continuation up to the correction, clamped by its budget; a
    sampled slot emits exactly the plain step's draw. The state freezes as
    the plain step's would, and each live row keeps exactly ``emitted``
    fresh columns valid in both caches (the rest are gaps)."""
    _, _, tt, _, _, td = setup
    td = tt if draft == "perfect" else td
    engine, reqs = _admitted_engine(tt, td, layout)
    g, chunk = engine.gamma, engine._chunk
    # the context a round continues: the fed tokens and the pending one
    ctx = {r.slot: list(r.prompt) + r.tokens for r in reqs}
    remaining = {r.slot: r.remaining_new_tokens for r in reqs if r.slot is not None}
    c0 = engine.cache.cursor
    before = [m.cache.valid.clone() for m in (engine.cache, engine.draft_cache)]
    chunk.counts.zero_()
    chunk.step.zero_()
    chunk.program()
    toks, counts, accepts = chunk.toks[0], chunk.counts[0], chunk.accepts[0]
    for slot, req in ((r.slot, r) for r in reqs if r.slot is not None):
        prompt = np.asarray(ctx[slot])
        t_cont = _solo(tt, prompt, GenerationConfig(g, temperature=0.0), 0)
        d_cont = _solo(td, prompt, GenerationConfig(g, temperature=0.0), 0)
        if req.config.temperature == 0.0:
            n_acc = next((j for j in range(g) if d_cont[j] != t_cont[j]), g)
            want = t_cont[:min(n_acc + 1, g, remaining[slot])]
        else:
            n_acc = 0
            plain = GenerationConfig(len(req.tokens) + 1, temperature=req.config.temperature,
                                     top_k=req.config.top_k)
            want = _solo(tt, np.asarray(req.prompt), plain, req.seed)[-1:]
        n = int(counts[slot])
        assert toks[slot, :n].tolist() == want, slot
        assert int(accepts[slot]) == n_acc
        st = engine._state
        assert int(st["tok"][slot]) == want[-1] and int(st["ntok"][slot]) == len(req.tokens) + n
        assert int(st["remaining"][slot]) == remaining[slot] - n
        assert bool(st["active"][slot]) == (remaining[slot] > n)
        # a live row keeps its fed tokens that reach its stream; a row that
        # finished keeps its whole candidate prefix (JAX), columns its slot's
        # release clears
        keep = n if remaining[slot] > n else min(n_acc + 1, g)
        for mgr, old in zip((engine.cache, engine.draft_cache), before):
            fresh = mgr.cache.valid[slot, c0:c0 + g]
            assert fresh.tolist() == [True] * keep + [False] * (g - keep), slot
            assert torch.equal(mgr.cache.valid[slot, :c0], old[slot, :c0])
    assert int(engine.cache.cache.cursor) == int(engine.draft_cache.cache.cursor) == c0 + g


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_masked_warmup_leaves_no_trace(setup, layout, monkeypatch):
    """The masked round the card runs before capture, here run before
    EVERY round: slot state, both validity maps, both cursors (device and
    mirror), the round index and the counts are left bitwise as they were,
    so is every K/V entry a valid column holds; the streams are unchanged."""
    _, _, tt, _, _, td = setup
    real = DecodeProgram.__call__
    runs = []

    def warm_then_round(self):
        chunk = engine._chunk
        caches = chunk.caches

        def snap():
            kv = []
            for c in caches:
                k, v = (c.k, c.v) if layout == "row" else _gathered(c)
                live = c.valid[None, :, :, None, None]
                kv += [torch.where(live, k, 0), torch.where(live, v, 0)]
            return ([t.clone() for t in chunk.state.values()],
                    [(c.index, int(c.cursor), c.valid.clone()) for c in caches],
                    int(chunk.step), chunk.counts.clone(), kv)

        before = snap()
        self._warmup()
        after = snap()
        assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
        for (i0, c0, v0), (i1, c1, v1) in zip(before[1], after[1]):
            assert (i0, c0) == (i1, c1) and torch.equal(v0, v1)
        assert before[2] == after[2] and torch.equal(before[3], after[3])
        assert all(torch.equal(a, b) for a, b in zip(before[4], after[4]))
        runs.append(1)
        real(self)

    monkeypatch.setattr(DecodeProgram, "__call__", warm_then_round)
    prompts, gcfgs = _workload()
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=3, prefix_cache=None,
                           draft_model=td, gamma=3, **LAYOUTS[layout])
    reqs = _port(engine, prompts, gcfgs)
    assert len(runs) == engine.metrics.executed_steps
    off = _port(ServingEngine(tt, num_slots=2, decode_chunk_size=3, prefix_cache=None,
                              **LAYOUTS[layout]), prompts, gcfgs)
    assert [r.tokens for r in reqs] == [r.tokens for r in off]


def _gathered(cache):
    from neuronx_distributed_tpu_torch.modules.attention import gather_cache_pages

    kv = [gather_cache_pages(cache, layer) for layer in range(cache.k.shape[0])]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spec_chunk_reads_nothing_and_cursors_stay_in_lockstep(setup, layout, monkeypatch):
    """Every speculative chunk runs with host reads made to raise (the
    CPU's stand-in for capture-safe); after every engine step both device
    cursors equal their mirrors and each other, across eager preemption,
    and no buffer of the round is ever rebound."""
    _, _, tt48 = build_pair(seed=1, max_seq_len=48)
    _, _, td48 = build_pair(seed=7, num_layers=2, max_seq_len=48)
    real = ChunkedDecode.__call__
    chunks = []

    def guarded(self):
        with no_host_reads():
            out = real(self)
        chunks.append(out)
        return out

    monkeypatch.setattr(ChunkedDecode, "__call__", guarded)
    engine = ServingEngine(tt48, num_slots=2, admission="eager", decode_chunk_size=4,
                           prefix_cache=None, draft_model=td48, gamma=4, **LAYOUTS[layout])
    rng = np.random.RandomState(19)
    reqs = [engine.submit(rng.randint(1, 256, size=n), GenerationConfig(m, temperature=0.0),
                          seed=i) for i, (n, m) in enumerate(((10, 20), (14, 18), (5, 6)))]

    def buffers():
        c, d, ch = engine.cache.cache, engine.draft_cache.cache, engine._chunk
        return [t.data_ptr() for t in (c.k, c.v, c.valid, c.cursor, d.k, d.v, d.valid, d.cursor,
                                       ch.toks, ch.counts, ch.accepts, ch.step,
                                       *engine._state.values())]

    first = buffers()
    while engine.has_work:
        engine.step()
        t, d = engine.cache.cache, engine.draft_cache.cache
        assert int(t.cursor) == t.index == int(d.cursor) == d.index
        assert buffers() == first
    assert engine.metrics.preemptions > 0
    assert chunks and sum(chunks) == engine.metrics.executed_steps
    for i, (r, (n, m)) in enumerate(zip(reqs, ((10, 20), (14, 18), (5, 6)))):
        assert r.state is RequestState.DONE and len(r.tokens) == m
    assert engine.prewarm() == 0.0 and engine.decode_compilations == 0
