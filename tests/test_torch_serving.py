"""The port's ServingEngine: a scheduler around the same math as solo
``generate`` (CPU, fp32, tiny_llama).

Every request's stream through the engine must equal its solo port
``generate`` (greedy and sampled, same seed) exactly, and greedy streams must
equal the JAX ServingEngine's — under staggered admission, chunk sizes 1, 3
and 8, EOS mid-chunk, slot reuse, a long prompt that makes the shared cursor
jump, and eager-mode preemption. The host-read budget of the JAX engine's
decode loop (one read per steady chunk) is pinned too."""

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig, generate
from neuronx_distributed_tpu_torch.serving.engine import RejectedError, ServingEngine
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from test_torch_llama import build_pair

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=21)


def _solo(tmodel, prompt, gcfg, seed):
    """Port golden: solo generate(), truncated at EOS like the engine
    retires a slot (generate fills the tail with EOS instead)."""
    toks = generate(tmodel, prompt[None], gcfg, seed=seed)[0].tolist()
    if gcfg.eos_token_id is not None and gcfg.eos_token_id in toks:
        toks = toks[: toks.index(gcfg.eos_token_id) + 1]
    return toks


def _workload(tmodel):
    """Seven greedy requests: varied lengths, one long prompt (bucket 64)
    that lands after shorter ones and jumps the cursor, one EOS that fires
    mid-chunk."""
    rng = np.random.default_rng(5)
    lens = [5, 11, 3, 40, 7, 9, 4]
    news = [6, 9, 12, 5, 8, 7, 10]
    prompts = [rng.integers(1, 256, size=n).astype(np.int32) for n in lens]
    gcfgs = [GenerationConfig(max_new_tokens=m, temperature=0.0) for m in news]
    probe = _solo(tmodel, prompts[2], gcfgs[2], 0)
    gcfgs[2] = GenerationConfig(max_new_tokens=12, temperature=0.0, eos_token_id=probe[5])
    return prompts, gcfgs


def _run_staggered(engine, prompts, gcfgs, submit):
    """Three requests up front, the rest trickled in between steps."""
    reqs = [submit(engine, prompts[i], gcfgs[i], i) for i in range(3)]
    i = 3
    while engine.has_work or i < len(prompts):
        engine.step()
        if i < len(prompts):
            reqs.append(submit(engine, prompts[i], gcfgs[i], i))
            i += 1
    return reqs


@pytest.fixture(scope="module")
def jax_greedy_streams(pair):
    jmodel, params, tmodel = pair
    prompts, gcfgs = _workload(tmodel)
    jcfgs = [JGenerationConfig(max_new_tokens=g.max_new_tokens, temperature=0.0,
                               eos_token_id=g.eos_token_id) for g in gcfgs]
    engine = JServingEngine(jmodel, params, num_slots=3, decode_chunk_size=3,
                            prefix_cache=None)
    reqs = _run_staggered(
        engine, prompts, jcfgs,
        lambda e, p, g, i: e.submit(p, g, key=jax.random.PRNGKey(i)),
    )
    return [list(r.tokens) for r in reqs]


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_greedy_streams_match_solo_generate_and_jax_engine(pair, jax_greedy_streams, chunk):
    _, _, tmodel = pair
    prompts, gcfgs = _workload(tmodel)
    engine = ServingEngine(tmodel, num_slots=3, decode_chunk_size=chunk)
    reqs = _run_staggered(engine, prompts, gcfgs,
                          lambda e, p, g, i: e.submit(p, g, seed=i))
    assert engine.metrics.cursor_high_water >= 64  # the long prompt's jump
    for i, req in enumerate(reqs):
        assert req.state is RequestState.DONE
        assert req.tokens == _solo(tmodel, prompts[i], gcfgs[i], i), i
        assert req.tokens == jax_greedy_streams[i], i
    assert len(reqs[2].tokens) == 6  # EOS fired
    snap = engine.metrics.snapshot()
    assert snap["completed"] == len(prompts) and snap["decode_tokens"] > 0
    # executed steps include the masked no-ops after every slot froze; a
    # one-step chunk runs only while a slot is live, so it has none
    assert snap["executed_steps"] >= snap["steps"]
    assert chunk > 1 or snap["executed_steps"] == snap["steps"]
    assert engine.cache.free_slots == 3


def test_sampled_streams_match_solo_generate(pair):
    _, _, tmodel = pair
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 256, size=n).astype(np.int32) for n in (6, 13, 4, 9, 7)]
    gcfgs = [
        GenerationConfig(max_new_tokens=9, temperature=0.8, top_k=17),
        GenerationConfig(max_new_tokens=7, temperature=1.0, top_p=0.9),
        GenerationConfig(max_new_tokens=11, temperature=0.0),
        GenerationConfig(max_new_tokens=8, temperature=1.2),
        GenerationConfig(max_new_tokens=6, temperature=0.7, top_k=40, top_p=0.8),
    ]
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4)
    reqs = _run_staggered(engine, prompts, gcfgs,
                          lambda e, p, g, i: e.submit(p, g, seed=100 + i))
    for i, req in enumerate(reqs):
        assert req.tokens == _solo(tmodel, prompts[i], gcfgs[i], 100 + i), i


def test_eager_preemption_keeps_streams(pair):
    _, _, tmodel = pair
    # max_seq_len 128: the third request's prompt jumps the cursor to 64
    # while the first still needs ~73 columns, so eager admission hits the wall
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 256, size=n).astype(np.int32) for n in (30, 10, 40)]
    gcfgs = [GenerationConfig(max_new_tokens=m, temperature=0.0) for m in (90, 10, 30)]
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=8, admission="eager")
    reqs = [engine.submit(p, g, seed=i) for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    engine.run()
    assert engine.metrics.preemptions > 0
    for i, req in enumerate(reqs):
        assert req.tokens == _solo(tmodel, prompts[i], gcfgs[i], i), i


def test_one_host_read_per_steady_chunk(pair):
    _, _, tmodel = pair
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=4)
    gcfg = GenerationConfig(max_new_tokens=12, temperature=0.0)
    req = engine.submit(np.arange(1, 7), gcfg)
    assert engine.host_reads == 0  # no key to capture: seeds are host ints
    engine.step()  # admission (first token) + one chunk
    assert engine.host_reads == 2
    assert len(req.tokens) == 1 + 4
    before = engine.host_reads
    engine.step()  # steady state: the chunk's token block only
    assert engine.host_reads - before == 1
    engine.run()
    assert req.tokens == _solo(tmodel, np.arange(1, 7).astype(np.int32), gcfg, req.seed)


def test_cancel_and_queue_bounds(pair):
    _, _, tmodel = pair
    engine = ServingEngine(tmodel, num_slots=1, decode_chunk_size=2, max_queue=2)
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    a = engine.submit(np.arange(1, 5), gcfg)
    b = engine.submit(np.arange(1, 9), gcfg)
    with pytest.raises(RejectedError):
        engine.submit(np.arange(1, 3), gcfg)
    engine.step()
    assert engine.cancel(a.rid) and engine.cancel(b.rid)
    engine.run()
    assert a.state is RequestState.CANCELLED and b.state is RequestState.CANCELLED
    assert b.tokens == [] and engine.cache.free_slots == 1
    with pytest.raises(ValueError):
        engine.submit(np.arange(1, 125), gcfg)  # past max_seq_len: never placeable
    for bad in (dict(admission="greedy"), dict(scheduling="slo"), dict(decode_chunk_size=0)):
        with pytest.raises(ValueError):
            ServingEngine(tmodel, num_slots=1, **bad)


def test_token_budget_queues_without_changing_streams(pair):
    """``max_tokens_in_flight`` holds requests in the queue (FIFO, no
    overtaking) until in-flight work drains; streams are unaffected."""
    _, _, tmodel = pair
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, 256, size=n).astype(np.int32) for n in (12, 6, 20, 3)]
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    engine = ServingEngine(tmodel, num_slots=4, decode_chunk_size=4, max_tokens_in_flight=36)
    reqs = [engine.submit(p, gcfg, seed=i) for i, p in enumerate(prompts)]
    engine.step()
    # 20 + 14 fit the budget of 36; the 28-token third request waits (and the
    # fourth may not overtake it)
    assert [r.slot is not None for r in reqs] == [True, True, False, False]
    engine.run()
    for i, req in enumerate(reqs):
        assert req.tokens == _solo(tmodel, prompts[i], gcfg, i), i
    with pytest.raises(ValueError):
        engine.submit(np.arange(1, 40), gcfg)  # footprint 47 > 36: never placeable
