"""``chip_smoke.py`` phase 5c's prefix-cache traffic on the CPU against the
JAX package (tiny_llama width, fp32): the hit and miss counts that phase
asserts on the card are the JAX engine's on the same traffic. In a file of
its own: the JAX engine's programs at a 2048-token bucket take most of a
minute to compile and run here."""

import importlib

import jax
import torch

import chip_smoke
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from test_torch_llama import build_pair
from test_torch_prefix import _greedy, _serve

jgen = importlib.import_module("neuronx_distributed_tpu.inference.generate")

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def test_chip_prefix_traffic_counts_match_jax():
    """``chip_smoke.py`` phase 5c's traffic (a 1600-token system prompt, 12
    requests) at tiny_llama width with its 8192-column cache: the JAX row
    engine counts 11 hits and 1 miss, and so do the port's row engine (8
    slots) and paged engine (16 slots, page 16, four rows' pages): the
    counts phase 5c asserts on the card. Greedy streams equal JAX's."""
    jmodel, params, tmodel = build_pair(seed=21, max_seq_len=8192)
    prompts, cfgs = chip_smoke.prefix_workload(tmodel.config.vocab_size)
    jcfgs = [jgen.GenerationConfig(max_new_tokens=c.max_new_tokens, temperature=c.temperature,
                                   top_k=c.top_k) for c in cfgs]
    jengine = JServingEngine(jmodel, params, num_slots=8, decode_chunk_size=8)
    jreqs = _serve(jengine, [prompts], jcfgs,
                   lambda e, p, g, i: e.submit(p, g, key=jax.random.PRNGKey(i)))
    jsnap = jengine.metrics.snapshot()
    assert (jsnap["prefix_hits"], jsnap["prefix_misses"]) == (11, 1)
    pages = 4 * 8192 // 16 + 1
    for kw in (dict(num_slots=8), dict(num_slots=16, kv_page_size=16, kv_num_pages=pages)):
        eng = ServingEngine(tmodel, decode_chunk_size=8, **kw)
        check = (lambda e: e.cache.check()) if "kv_page_size" in kw else (lambda e: None)
        reqs = _serve(eng, [prompts], cfgs, lambda e, p, g, i: e.submit(p, g, seed=i), check)
        snap = eng.metrics.snapshot()
        assert (snap["prefix_hits"], snap["prefix_misses"]) == (11, 1), kw
        for i in _greedy(cfgs):
            assert reqs[i].tokens == list(jreqs[i].tokens), (kw, i)


def test_chip_prefix_traffic_on_an_int8_pool():
    """``chip_smoke.py`` phase 5f(d): phase 5c's traffic through the paged
    engine with int8 weights and an int8 page pool (16 slots, page 16, the
    pool of phase 5c's bytes): 11 hits and 1 miss, as on the float pool;
    zero KV bytes copied, ``check()`` clean after every step, and each
    request's stream of its full length."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig

    _, _, tmodel = build_pair(seed=21, max_seq_len=8192)
    prompts, cfgs = chip_smoke.prefix_workload(tmodel.config.vocab_size)
    eng = ServingEngine(tmodel, decode_chunk_size=8, num_slots=16, kv_page_size=16,
                        kv_num_pages=2 * (4 * 8192 // 16 + 1),
                        quantize=QuantConfig(weights="int8", kv="int8"))
    reqs = _serve(eng, [prompts], cfgs, lambda e, p, g, i: e.submit(p, g, seed=i),
                  lambda e: e.cache.check())
    snap = eng.metrics.snapshot()
    assert (snap["prefix_hits"], snap["prefix_misses"]) == (11, 1)
    assert eng.cache.alloc.copy_bytes == 0
    assert all(len(r.tokens) == c.max_new_tokens for r, c in zip(reqs, cfgs))
