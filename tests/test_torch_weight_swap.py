"""Weight swaps on the serving engine against the JAX package (CPU, fp32,
tiny_llama; both packages' weights from one seed through ``flax_to_torch``).

``engine.params = sd`` writes the new values in place into the served
model's tensors (every ``data_ptr`` kept, the decode program untouched) and
clears the prefix store: the JAX tests' cases (``test_prefix_cache.py``
:243, ``test_paged_cache.py`` :312, ``test_quantized_engine.py`` :224) on
the port, held to the JAX engine's streams and counts. Greedy streams after
a swap equal JAX's solo ``generate`` under the new weights; the row, paged
and tiered stores end empty with no page referenced or host-resident; a
quantized engine's codes and scales after a float swap equal JAX's
``quantize_param_tree`` bit for bit in the same tensors, a pre-quantized
dict binds as is, and the caller's float model never changes; a refused
swap (a missing or extra key, a wrong shape or dtype) changes no bit."""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.quantization import config as jqc
from neuronx_distributed_tpu.quantization import utils as jqu
from neuronx_distributed_tpu.serving import PrefixCache as JPrefixCache
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig, generate
from neuronx_distributed_tpu_torch.models.convert import flax_to_torch
from neuronx_distributed_tpu_torch.models.llama import quantize_model
from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
from neuronx_distributed_tpu_torch.quantization.utils import quantize_state_dict
from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from test_torch_llama import _np_tree, build_pair

jgen = importlib.import_module("neuronx_distributed_tpu.inference.generate")

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PS = 8


@pytest.fixture(scope="module")
def setup():
    """W1 (key 1, the JAX suites' model) and W2 (key 7) in both packages:
    (jax model, params W1, params W2, port model on W1, port state dict W2)."""
    jm, jp1, tm = build_pair(seed=1)
    _, jp2, tm2 = build_pair(seed=7)
    return jm, jp1, jp2, tm, tm2.state_dict()


def _fresh(tm):
    """A port model of its own on the same weights (a float engine writes
    the module it serves)."""
    return copy.deepcopy(tm)


def _bits(sd):
    return {k: v.detach().clone() for k, v in sd.items()}


def _same_bits(a, b):
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k].view(torch.uint8) if a[k].dtype ==
                                                 torch.float8_e4m3fn else a[k],
                                                 b[k].view(torch.uint8) if b[k].dtype ==
                                                 torch.float8_e4m3fn else b[k])
        for k in a)


def _jsolo(jm, params, prompt, seed, gcfg):
    jc = JGenerationConfig(max_new_tokens=gcfg.max_new_tokens, temperature=gcfg.temperature)
    return np.asarray(jgen.generate(jm, params, jnp.asarray(prompt)[None],
                                    jax.random.PRNGKey(seed), jc))[0].tolist()


def test_params_swap_invalidates_row_prefix_store(setup):
    """JAX ``test_params_swap_invalidates_prefix_store``: the stored entry
    goes with the swap, and the stream after it equals JAX's solo
    ``generate`` under the new weights (no stale K/V); every parameter
    keeps its address and the decode program is the same object."""
    jm, jp1, jp2, tm, sd2 = setup
    model = _fresh(tm)
    prompt = np.arange(2, 16, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    engine = ServingEngine(model, num_slots=1, prefix_cache=PrefixCache(max_entries=4,
                                                                        min_match=4))
    r1 = engine.submit(prompt, gcfg, seed=9)
    engine.run()
    assert r1.tokens == _jsolo(jm, jp1, prompt, 9, gcfg)
    assert len(engine.prefix.entries) == 1
    ptrs = {k: t.data_ptr() for k, t in engine.params.items()}
    program = engine.decode_program
    engine.params = sd2
    assert len(engine.prefix.entries) == 0
    assert {k: t.data_ptr() for k, t in engine.params.items()} == ptrs
    assert engine.decode_program is program and engine.decode_compilations == 0
    assert engine.model is model and _same_bits(_bits(model.state_dict()), sd2)
    r2 = engine.submit(prompt, gcfg, seed=9)
    engine.run()
    ref2 = _jsolo(jm, jp2, prompt, 9, gcfg)
    assert r2.tokens == ref2 != r1.tokens
    assert engine.metrics.snapshot()["prefix_evictions"] >= 1
    # the JAX engine on the same calls: the same store length and evictions
    jeng = JServingEngine(jm, jp1, num_slots=1, prefix_cache=JPrefixCache(max_entries=4,
                                                                          min_match=4))
    jc = JGenerationConfig(max_new_tokens=6, temperature=0.0)
    jeng.submit(prompt, jc, key=jax.random.PRNGKey(9))
    jeng.run()
    jeng.params = jp2
    j2 = jeng.submit(prompt, jc, key=jax.random.PRNGKey(9))
    jeng.run()
    assert [int(t) for t in j2.tokens] == r2.tokens
    assert (jeng.metrics.snapshot()["prefix_evictions"]
            == engine.metrics.snapshot()["prefix_evictions"])


def test_weight_swap_clears_paged_entries_and_pins(setup):
    """JAX ``test_weight_swap_clears_paged_entries_and_pins``: the entry's
    pinned pages are released with it; no page is referenced after the
    swap and ``check()`` is clean."""
    jm, jp1, _, tm, _ = setup
    engine = ServingEngine(_fresh(tm), num_slots=2, decode_chunk_size=4,
                           prefix_cache=PrefixCache(min_match=8), kv_page_size=PS)
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    engine.submit(np.arange(1, 20, dtype=np.int32), gcfg, seed=0)
    engine.run()
    assert len(engine.prefix.entries) == 1 and engine.cache.alloc.referenced_pages > 0
    engine.params = engine.params  # the same values: the store still goes
    assert len(engine.prefix.entries) == 0
    assert engine.cache.alloc.referenced_pages == 0
    engine.cache.check()
    jeng = JServingEngine(jm, jp1, num_slots=2, decode_chunk_size=4,
                          prefix_cache=JPrefixCache(min_match=8), kv_page_size=PS)
    jeng.submit(np.arange(1, 20, dtype=np.int32), JGenerationConfig(max_new_tokens=4,
                                                                     temperature=0.0),
                key=jax.random.PRNGKey(0))
    jeng.run()
    jeng.params = jp1
    assert len(jeng.prefix) == 0 and jeng.cache.alloc.referenced_pages == 0
    assert (engine.metrics.snapshot()["prefix_evictions"]
            == jeng.metrics.snapshot()["prefix_evictions"])


def _tiered_workload(vocab):
    """JAX's ``_tiered_workload`` (``tests/test_torch_tiering.py``): four
    17-token prefixes in waves 0,1,2,3,0,1."""
    from test_torch_tiering import _tiered_workload as workload

    return workload(vocab)


def test_tiered_swap_drops_host_entries(setup):
    """A tiered engine with spilled entries: the swap drops the host-resident
    entries with the device ones (``PrefixCache.clear`` calls the eviction
    hook for each), so the host tier holds no page, no pool page is
    referenced and both tiers are clean; the summary and the evictions
    equal the JAX engine's after the same calls."""
    jm, jp1, _, tm, _ = setup
    prompts = _tiered_workload(tm.config.vocab_size)
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    engine = ServingEngine(_fresh(tm), num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                           kv_num_pages=9, kv_host_pages=16, admission="eager",
                           prefix_cache=PrefixCache(min_match=8))
    jeng = JServingEngine(jm, jp1, num_slots=2, decode_chunk_size=4, kv_page_size=PS,
                          kv_num_pages=9, kv_host_pages=16, admission="eager",
                          prefix_cache=JPrefixCache(min_match=8))
    for i, p in enumerate(prompts):
        engine.submit(p, gcfg, seed=100 + i)
        engine.run()
        jeng.submit(p, JGenerationConfig(max_new_tokens=4, temperature=0.0),
                    key=jax.random.PRNGKey(100 + i))
        jeng.run()
    assert engine.tier.used_pages > 0 and any(e.host_ids for e in engine.prefix.entries)
    engine.params = engine.params
    jeng.params = jp1
    assert len(engine.prefix.entries) == 0 == len(jeng.prefix)
    assert engine.tier.summary()["host_pages_used"] == 0 == engine.tier.used_pages
    assert engine.tier.summary() == jeng.tier.summary()
    assert engine.cache.alloc.referenced_pages == 0
    engine.cache.check()
    engine.tier.check()
    assert (engine.metrics.snapshot()["prefix_evictions"]
            == jeng.metrics.snapshot()["prefix_evictions"])


def test_quantized_swap_requantizes_bit_for_bit(setup):
    """JAX ``test_weight_swap_requantizes``: a float swap on an int8 engine
    is quantized once into the engine's own codes and scales, which equal
    JAX's ``quantize_param_tree`` of the same weights bit for bit, in the
    same tensors; a pre-quantized dict binds as is; the caller's float
    model (whose embedding and norms ``quantize_model`` would share) keeps
    every bit; the stream after the swap equals a fresh int8 engine's on
    the new weights."""
    jm, jp1, jp2, tm, sd2 = setup
    model = _fresh(tm)
    source = _bits(model.state_dict())
    engine = ServingEngine(model, num_slots=2, decode_chunk_size=4,
                           quantize=QuantConfig(weights="int8"))
    assert engine.model is not model
    ptrs = {k: t.data_ptr() for k, t in engine.params.items()}
    jq = jqc.QuantConfig(weights="int8").weight_qconfig()
    want = flax_to_torch(_np_tree(jqu.quantize_param_tree(jp2, jq)), tm.config)
    engine.params = sd2  # a float dict
    got = engine.params
    assert {k: t.data_ptr() for k, t in got.items()} == ptrs
    assert got["lm_head.weight"].dtype == torch.int8
    assert _same_bits(_bits(got), want)
    assert _same_bits(_bits(model.state_dict()), source)
    prompt = np.arange(1, 7, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    req = engine.submit(prompt, gcfg, seed=0)
    engine.run()
    fresh = ServingEngine(_fresh(tm), num_slots=2, decode_chunk_size=4,
                          quantize=QuantConfig(weights="int8"))
    fresh.params = sd2
    ref = fresh.submit(prompt, gcfg, seed=0)
    fresh.run()
    m2 = _fresh(tm)
    m2.load_state_dict(sd2)
    q2 = quantize_model(m2, engine._weight_qcfg)
    assert req.tokens == ref.tokens == generate(q2, prompt[None], gcfg, seed=0)[0].tolist()
    # a pre-quantized dict binds as is: a scale the quantizer would not
    # produce survives the assignment
    pre = quantize_state_dict(flax_to_torch(_np_tree(jp1), tm.config), engine._weight_qcfg)
    pre["lm_head.scale"] = pre["lm_head.scale"] * 2
    engine.params = pre
    assert _same_bits(_bits(engine.params), pre)
    assert {k: t.data_ptr() for k, t in engine.params.items()} == ptrs
    assert _same_bits(_bits(model.state_dict()), source)
    req = engine.submit(prompt, gcfg, seed=0)
    engine.run()
    assert req.state is RequestState.DONE


def _bad_dicts(sd):
    """Refused swaps, each wrong in its LAST key (``load_state_dict`` would
    have written every earlier one)."""
    last = list(sd)[-1]
    cases = {}
    d = dict(sd)
    del d[last]
    cases["missing"] = d
    cases["unexpected"] = {**sd, "model.extra.weight": torch.zeros(2)}
    cases["shape"] = {**sd, last: sd[last][:-1]}
    cases["dtype"] = {**sd, last: sd[last].to(torch.float64)}
    cases["not_a_tensor"] = {**sd, last: sd[last].numpy()}
    return cases


@pytest.mark.parametrize("case", ["missing", "unexpected", "shape", "dtype", "not_a_tensor"])
@pytest.mark.parametrize("quantized", [False, True])
def test_refused_swap_changes_no_bit(setup, case, quantized):
    """Every key, shape and dtype is checked before the first write: a
    refused swap raises and leaves the served model and the prefix store
    as they were."""
    _, _, _, tm, sd2 = setup
    model = _fresh(tm)
    kw = dict(quantize=QuantConfig(weights="int8")) if quantized else {}
    engine = ServingEngine(model, num_slots=1, prefix_cache=PrefixCache(min_match=4), **kw)
    engine.submit(np.arange(2, 16, dtype=np.int32), GenerationConfig(4, temperature=0.0))
    engine.run()
    before = _bits(engine.params)
    bad = _bad_dicts(quantize_state_dict(sd2, engine._weight_qcfg) if quantized else sd2)[case]
    with pytest.raises((ValueError, TypeError)):
        engine.params = bad
    assert _same_bits(_bits(engine.params), before)
    assert len(engine.prefix.entries) == 1
