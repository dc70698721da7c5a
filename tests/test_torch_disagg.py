"""Disaggregated prefill against the JAX package (CPU, fp32, the JAX
suite's 2-layer tiny_llama; weights from one seed through
``flax_to_torch``): the 8 cases of ``tests/serving/test_disagg.py``, and
the staged pages held to a coupled prefill's bit for bit.

Prefill workers hand finished contexts to the decode engine as PAGE-TABLE
handoffs: zero KV bytes move on a shared pool (``copy_bytes == 0``), and a
charged copy of exactly the exported bytes moves them between distinct
pools. Greedy streams equal JAX's solo ``generate``, sampled ones the
port's solo ``generate`` with the same seed, through every topology and
every fallback; the shared-pool case also runs JAX's server on the same
workload (equal streams and counters). Every run ends with every page free
and ``check()`` clean."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference import generate as jgenerate
from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import DisaggregatedServer as JDisaggregatedServer
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, tiny_llama
from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
from neuronx_distributed_tpu_torch.serving.disagg import DisaggregatedServer
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from neuronx_distributed_tpu_torch.serving.traffic import VirtualClock
from test_torch_llama import build_pair
from test_torch_serving import _solo

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PS = 8


@pytest.fixture(scope="module")
def setup():
    """JAX ``setup``: tiny_llama with 2 layers, hidden 32, vocab 128."""
    return build_pair(seed=1, num_layers=2, hidden_size=32, intermediate_size=96,
                      vocab_size=128)


_REFS: dict = {}


def fabric_refs(setup, prompts, gcfgs, seeds):
    """The golden streams: JAX's solo ``generate`` for a greedy request,
    the port's solo ``generate`` with the same seed for a sampled one (the
    port's sampling stream is its own); cached across the module's cases."""
    jm, jp, tm = setup
    out = []
    for p, g, seed in zip(prompts, gcfgs, seeds):
        key = (tuple(int(t) for t in p), g.max_new_tokens, g.temperature, g.top_k, g.top_p, seed)
        if key not in _REFS:
            if g.temperature == 0.0:
                jc = JGenerationConfig(max_new_tokens=g.max_new_tokens, temperature=0.0)
                _REFS[key] = np.asarray(jgenerate(jm, jp, jnp.asarray(p)[None],
                                                      jax.random.PRNGKey(seed), jc))[0].tolist()
            else:
                _REFS[key] = _solo(tm, p, g, seed)
        out.append(_REFS[key])
    return out


def _engine(tm, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("decode_chunk_size", 2)
    kw.setdefault("prefix_cache", None)
    kw.setdefault("kv_page_size", PS)
    return ServingEngine(tm, **kw)


def _mixed_workload(vocab, n=5):
    """JAX's ``_mixed_workload``: even requests greedy, odd ones sampled."""
    rng = np.random.RandomState(13)
    prompts = [rng.randint(1, vocab, size=rng.randint(4, 14)).astype(np.int32)
               for _ in range(n)]
    gcfgs = [GenerationConfig(max_new_tokens=5 + (i % 3), temperature=0.0) if i % 2 == 0
             else GenerationConfig(max_new_tokens=6, temperature=0.9, top_k=19, top_p=0.95)
             for i in range(n)]
    return prompts, gcfgs, [900 + i for i in range(n)]


def _jcfg(g):
    return JGenerationConfig(max_new_tokens=g.max_new_tokens, temperature=g.temperature,
                             top_k=g.top_k, top_p=g.top_p)


def _run_checked(server, max_steps=10_000):
    steps = 0
    while server.has_work and steps < max_steps:
        server.step()
        server.engine.cache.check()
        steps += 1


def _all_free(engine):
    engine.cache.check()
    a = engine.cache.alloc
    assert a.free_pages == a.capacity and a.referenced_pages == 0
    assert engine.cache.free_slots == engine.num_slots


def test_shared_pool_handoff_zero_copy_bit_identical(setup):
    """JAX :79. Contexts move prefill -> decode by block-table mapping with
    ``copy_bytes == 0``; greedy and sampled streams equal solo; the decode
    engine never admits by itself; JAX's server on the same workload gives
    the same greedy streams and the same counters."""
    jm, jp, tm = setup
    prompts, gcfgs, seeds = _mixed_workload(tm.config.vocab_size)
    refs = fabric_refs(setup, prompts, gcfgs, seeds)
    engine = _engine(tm)
    server = DisaggregatedServer(engine, n_workers=2)
    reqs = [server.submit(p, g, seed=s) for p, g, s in zip(prompts, gcfgs, seeds)]
    _run_checked(server)
    for i, (req, ref) in enumerate(zip(reqs, refs)):
        assert req.state is RequestState.DONE
        assert req.tokens == ref, f"request {i} diverged through the handoff"
    assert server.stats["handoffs"] == len(prompts)
    assert server.stats["coupled_fallbacks"] == 0
    assert engine.cache.alloc.copy_bytes == 0
    assert engine.external_prefill
    assert engine.decode_compilations == 0  # the CPU captures nothing (the card: 1)
    assert sum(w.prefill_compilations for w in server.workers) >= 1
    _all_free(engine)
    snap = server.snapshot()
    assert snap["disagg"]["copy_bytes"] == 0 and snap["disagg"]["workers_live"] == 2

    jengine = JServingEngine(jm, jp, num_slots=2, decode_chunk_size=2, prefix_cache=None,
                             kv_page_size=PS)
    jserver = JDisaggregatedServer(jengine, n_workers=2)
    jreqs = [jserver.submit(p, _jcfg(g), key=jax.random.PRNGKey(s))
             for p, g, s in zip(prompts, gcfgs, seeds)]
    jserver.run()
    assert jserver.stats == server.stats
    for g, req, jreq in zip(gcfgs, reqs, jreqs):
        if g.temperature == 0.0:
            assert req.tokens == jreq.tokens


def test_distinct_pools_import_is_a_charged_copy(setup):
    """JAX :108 (slow there). Distinct pools: the export/import moves the
    context by an explicit copy; streams identical, ``copy_bytes`` equal to
    the exported bytes exactly (every context's pages, K, V)."""
    _, _, tm = setup
    prompts, gcfgs, seeds = _mixed_workload(tm.config.vocab_size, n=3)
    refs = fabric_refs(setup, prompts, gcfgs, seeds)
    engine = _engine(tm)
    server = DisaggregatedServer(engine, n_workers=1, shared_pool=False)
    assert server.workers[0].pool is not engine.cache
    reqs = [server.submit(p, g, seed=s) for p, g, s in zip(prompts, gcfgs, seeds)]
    _run_checked(server)
    for req, ref in zip(reqs, refs):
        assert req.state is RequestState.DONE and req.tokens == ref
    assert server.stats["imported_contexts"] == 3
    pages = sum(-(-len(p) // PS) for p in prompts)
    assert engine.cache.alloc.copy_bytes == pages * engine.cache.page_nbytes > 0
    _all_free(engine)
    server.workers[0].pool.check()
    assert server.workers[0].pool.alloc.referenced_pages == 0


def test_prefills_per_step_bounds_prefill_between_chunks(setup):
    """JAX :131 (slow there). With a backlog, one server step runs at most
    ``prefills_per_step`` worker prefills."""
    _, _, tm = setup
    prompts, gcfgs, seeds = _mixed_workload(tm.config.vocab_size, n=4)
    engine = _engine(tm, num_slots=4)
    server = DisaggregatedServer(engine, n_workers=1, prefills_per_step=1)
    for p, g, s in zip(prompts, gcfgs, seeds):
        server.submit(p, g, seed=s)
    server.step()
    assert server.stats["prefills"] == 1
    server.step()
    assert server.stats["prefills"] == 2
    server.run()
    assert server.stats["prefills"] == 4
    _all_free(engine)


def test_handoff_failure_falls_back_to_coupled_prefill(setup):
    """JAX :150 (slow there). ``fail_handoff``: the staged pages are
    released, the request prefills COUPLED on the decode engine, streams
    identical, zero tokens lost, no page leaked."""
    _, _, tm = setup
    prompts, gcfgs, seeds = _mixed_workload(tm.config.vocab_size, n=4)
    refs = fabric_refs(setup, prompts, gcfgs, seeds)
    inj = FaultInjector().fail_handoff(at=0, times=2)
    engine = _engine(tm)
    server = DisaggregatedServer(engine, n_workers=1, fault_injector=inj)
    reqs = [server.submit(p, g, seed=s) for p, g, s in zip(prompts, gcfgs, seeds)]
    _run_checked(server)
    assert inj.counters["handoff_failures"] == 2
    assert server.stats["handoff_failures"] == 2
    assert server.stats["coupled_fallbacks"] == 2
    assert sum(1 for req, ref in zip(reqs, refs) if req.tokens != ref) == 0
    assert all(r.state is RequestState.DONE for r in reqs)
    _all_free(engine)


def test_prefill_worker_death_degrades_to_coupled_engine(setup):
    """JAX :180 (slow there). A worker whose prefill fails leaves the
    rotation; losing the last one makes the engine admit by itself again."""
    _, _, tm = setup
    prompts, gcfgs, seeds = _mixed_workload(tm.config.vocab_size, n=4)
    refs = fabric_refs(setup, prompts, gcfgs, seeds)
    inj = FaultInjector().fail_prefill(at=0, times=None)
    engine = _engine(tm)
    server = DisaggregatedServer(engine, n_workers=1, fault_injector=inj)
    reqs = [server.submit(p, g, seed=s) for p, g, s in zip(prompts, gcfgs, seeds)]
    _run_checked(server)
    assert server.stats["worker_failures"] == 1 and inj.counters["prefill_failures"] == 1
    assert len(server.workers) == 0
    assert not engine.external_prefill
    for req, ref in zip(reqs, refs):
        assert req.state is RequestState.DONE and req.tokens == ref
    _all_free(engine)


def test_pending_handoff_respects_deadline(setup):
    """JAX :206 (slow there). A deadline passing while the prefilled
    context awaits its handoff sheds the request and releases its pages."""
    _, _, tm = setup
    clock = VirtualClock()
    engine = _engine(tm, time_fn=clock)
    server = DisaggregatedServer(engine, n_workers=1)
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    req = server.submit(np.arange(1, 9, dtype=np.int32), gcfg, seed=0, deadline_s=5.0)
    server._run_prefills(clock())
    assert len(server._pending) == 1
    assert engine.cache.alloc.referenced_pages == 1  # the staged page
    clock.advance_to(100.0)
    server.step()
    assert req.state is RequestState.TIMED_OUT and "handoff" in req.error
    assert not server._pending and not server.has_work
    _all_free(engine)


def test_recovery_voids_pending_handoff_without_leaks(setup):
    """JAX :233 (slow there). A dispatch failure's recovery VOIDS a staged
    context awaiting handoff: the next attempt neither derefs the voided
    pages twice nor leaks its slot, and falls back to coupled prefill;
    streams identical, slot count intact."""
    _, _, tm = setup
    prompts, gcfgs, seeds = _mixed_workload(tm.config.vocab_size, n=3)
    refs = fabric_refs(setup, prompts, gcfgs, seeds)
    inj = FaultInjector().fail_dispatch(at=1, times=1)
    engine = _engine(tm, num_slots=1, fault_injector=inj, sleep_fn=lambda s: None)
    server = DisaggregatedServer(engine, n_workers=1)
    reqs = [server.submit(p, g, seed=s) for p, g, s in zip(prompts, gcfgs, seeds)]
    _run_checked(server)
    assert inj.counters["dispatch_failures"] == 1
    assert server.stats["handoff_failures"] >= 1
    assert server.stats["coupled_fallbacks"] >= 1
    for req, ref in zip(reqs, refs):
        assert req.state is RequestState.DONE and req.tokens == ref
    _all_free(engine)


def test_disagg_validation(setup):
    """JAX :271: a row engine and a speculative engine are refused."""
    _, _, tm = setup
    with pytest.raises(ValueError, match="PAGED"):
        DisaggregatedServer(ServingEngine(tm, num_slots=2, prefix_cache=None))
    draft = init_params(LlamaForCausalLM(tiny_llama(num_layers=1, hidden_size=32,
                                                    intermediate_size=96, vocab_size=128),
                                         device="cpu"), seed=7)
    spec = ServingEngine(tm, num_slots=2, prefix_cache=None, kv_page_size=PS, draft_model=draft,
                         draft_params=draft.state_dict())
    with pytest.raises(ValueError, match="speculative"):
        DisaggregatedServer(spec)
    for kw in (dict(n_workers=0), dict(prefills_per_step=0)):
        with pytest.raises(ValueError):
            DisaggregatedServer(_engine(tm), **kw)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_staged_pages_equal_a_coupled_prefill(setup, kv):
    """For three prompts, the pages a worker stages hold the bytes a coupled
    prefill of the same prompt writes into its slot, bit for bit (an int8
    pool's codes and scales too); the handoff maps them under a page-aligned
    context ending at the cursor, valid there alone, and samples the first
    token the coupled admission samples."""
    _, _, tm = setup
    kw = dict(quantize=QuantConfig(kv="int8")) if kv else {}
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    for n in (5, 16, 27):
        prompt = (np.arange(n, dtype=np.int32) * 7) % 127 + 1
        coupled = _engine(tm, num_slots=1, **kw)
        creq = coupled.submit(prompt, gcfg, seed=3)
        coupled._admit(0.0)  # the admission alone: no decode step writes yet
        cids = coupled.cache.slot_pages(0)
        engine = _engine(tm, num_slots=1, **kw)
        server = DisaggregatedServer(engine, n_workers=1)
        req = server.submit(prompt, gcfg, seed=3)
        staged, logits = server.workers[0].prefill(req, engine.max_seq_len)
        sids = list(staged.page_ids)
        assert len(sids) == len(cids) == -(-n // PS)
        cc, sc = coupled.cache.cache, engine.cache.cache
        leaves = ("k", "v", "k_scale", "v_scale") if kv else ("k", "v")
        for name in leaves:
            a, b = getattr(cc, name)[:, cids], getattr(sc, name)[:, sids]
            assert torch.equal(a.view(torch.uint8) if kv and name in "kv" else a,
                               b.view(torch.uint8) if kv and name in "kv" else b), (n, name)
        assert engine.admit_staged(req, staged, logits, now=0.0)
        assert engine.cache.slot_pages(0) == sids
        # both place the context at a page boundary below the cursor (the
        # handoff at its own length, the coupled admission past its bucket)
        for mgr in (engine.cache, coupled.cache):
            cur = mgr.cursor
            assert (cur - n) % PS == 0
            want = torch.zeros_like(mgr.cache.valid[0])
            want[cur - n:cur] = True
            assert torch.equal(mgr.cache.valid[0], want)
        assert req.tokens == creq.tokens and len(req.tokens) == 1
        engine.cache.check()
