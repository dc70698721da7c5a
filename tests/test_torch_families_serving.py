"""Serving the other decoder families (GPT-NeoX, also at head_dim 96;
CodeGen; DBRX) through the port's ``ServingEngine`` on row and paged caches
against the JAX engine, and Mixtral speculative decoding (CPU, fp32, the
tiny presets).

Greedy streams must be IDENTICAL to the JAX engine's and to the port's solo
``generate`` (the logits agree to ~1e-5, ``test_torch_families.py``, far
inside the argmax margins of these seeded inputs); sampled streams equal
the port's solo ``generate`` with the same seed, bit for bit; prefix hits
equal misses. A Mixtral target with a 1-layer Mixtral draft: solo
``speculative_generate`` gives the target's greedy tokens (JAX
``test_moe_generate.py:94``), and the speculative engine
(``ServingEngine(draft_model=, gamma=3)``) gives solo
``speculative_generate``'s, row and paged."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.inference import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.models import mixtral as jmixtral
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig, generate
from neuronx_distributed_tpu_torch.inference.speculative import speculative_generate
from neuronx_distributed_tpu_torch.models import mixtral as tmixtral
from neuronx_distributed_tpu_torch.models.convert import mixtral_flax_to_torch
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from test_torch_families import build_pair, logits_of

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FAMILY_CASES = {
    "gpt_neox": ("gpt_neox", {}),
    "gpt_neox_d96": ("gpt_neox", dict(hidden_size=192, num_heads=2)),
    "codegen": ("codegen", {}),
    "dbrx": ("dbrx", {}),
}
PAGED = dict(kv_page_size=8, kv_num_pages=32)


@pytest.fixture(scope="module", params=sorted(FAMILY_CASES))
def pair(request):
    family, over = FAMILY_CASES[request.param]
    return build_pair(family, seed=13, **over)


def _workload():
    """Five requests (the tiny presets hold 64 columns): three greedy, two
    sampled."""
    rng = np.random.default_rng(3)
    lengths = (5, 23, 9, 40, 3)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in lengths]
    gcfgs = [GenerationConfig(max_new_tokens=n, temperature=t, top_k=k)
             for n, t, k in ((8, 0.0, None), (6, 0.8, 20), (7, 0.0, None), (5, 1.0, None),
                             (8, 0.0, None))]
    return prompts, gcfgs


def _serve(model, prompts, gcfgs, **kw):
    engine = ServingEngine(model, num_slots=3, decode_chunk_size=3, **kw)
    reqs = [engine.submit(p, g, seed=i) for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    engine.run()
    assert all(r.state is RequestState.DONE for r in reqs)
    if "kv_page_size" in kw:
        engine.cache.check()
    return [list(r.tokens) for r in reqs], engine


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_engine_greedy_streams_equal_the_jax_engine(pair, paged):
    """The JAX ``ServingEngine`` (row, or paged with the same pages) and the
    port's over the same weights: equal greedy streams."""
    jmodel, params, tmodel = pair
    prompts, gcfgs = _workload()
    greedy = [i for i, g in enumerate(gcfgs) if g.temperature == 0.0]
    kw = PAGED if paged else {}
    jeng = JServingEngine(jmodel, params, num_slots=3, decode_chunk_size=3, prefix_cache=None,
                          **kw)
    jreqs = [jeng.submit(prompts[i], JGenerationConfig(max_new_tokens=gcfgs[i].max_new_tokens,
                                                       temperature=0.0),
                         key=jax.random.PRNGKey(i)) for i in greedy]
    jeng.run()
    got, _ = _serve(tmodel, [prompts[i] for i in greedy], [gcfgs[i] for i in greedy],
                    prefix_cache=None, **kw)
    assert got == [list(r.tokens) for r in jreqs]


@pytest.fixture(scope="module")
def solo_streams(pair):
    _, _, tmodel = pair
    prompts, gcfgs = _workload()
    return [generate(tmodel, torch.tensor([p]), g, seed=i)[0].tolist()
            for i, (p, g) in enumerate(zip(prompts, gcfgs))]


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_engine_streams_equal_solo_generate(pair, solo_streams, paged):
    """Greedy and sampled streams through the row and the paged engine (the
    prefix cache on, its default) equal solo ``generate``'s bit for bit."""
    _, _, tmodel = pair
    prompts, gcfgs = _workload()
    got, _ = _serve(tmodel, prompts, gcfgs, **(PAGED if paged else {}))
    assert got == solo_streams


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_prefix_hit_equals_a_miss(pair, paged):
    """Two waves sharing a 24-token prefix: the second wave's hits (suffix
    prefills through the decode attention) continue the context a full
    prefill would; their greedy streams equal the prefix-off engine's."""
    _, _, tmodel = pair
    rng = np.random.default_rng(9)
    system = rng.integers(1, 256, size=24).tolist()
    tails = [rng.integers(1, 256, size=n).tolist() for n in (3, 11, 6)]
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    kw = dict(kv_page_size=8, kv_num_pages=48) if paged else {}
    streams = {}
    for prefix in ("auto", None):
        engine = ServingEngine(tmodel, num_slots=2, prefix_cache=prefix, **kw)
        waves = []
        for _ in range(2):
            reqs = [engine.submit(system + t, gcfg, seed=i) for i, t in enumerate(tails)]
            engine.run()
            waves.append([r.tokens for r in reqs])
        streams[prefix] = waves
        if prefix == "auto":
            assert engine.metrics.snapshot()["prefix_hits"] >= len(tails)
        if paged:
            engine.cache.check()
    assert streams["auto"] == streams[None]


def test_quantize_needs_a_quantization_field(pair):
    """``quantize=QuantConfig(weights=)`` serves DBRX (its config carries
    ``quantization``, as JAX's) and refuses GPT-NeoX and CodeGen, which
    JAX gives no such field."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig

    _, _, tmodel = pair
    prompts, gcfgs = _workload()
    qc = QuantConfig(weights="int8")
    if not hasattr(tmodel.config, "quantization"):
        with pytest.raises(ValueError, match="quantization"):
            ServingEngine(tmodel, num_slots=2, quantize=qc)
        return
    got, engine = _serve(tmodel, prompts[:2], gcfgs[:2], quantize=qc)
    qmodel = engine.model
    assert qmodel is not tmodel and qmodel.config.quantization is not None
    assert got == [generate(qmodel, torch.tensor([p]), g, seed=i)[0].tolist()
                   for i, (p, g) in enumerate(zip(prompts[:2], gcfgs[:2]))]


# --- Mixtral speculative decoding -----------------------------------------------------


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def mixtral_spec():
    """JAX ``test_mixtral_speculative_matches_target_greedy``'s pair: a
    ``tiny_mixtral(scan_layers=False)`` target (key 1) and its 1-layer
    draft (key 2), both carried into the port."""
    cfg = jmixtral.tiny_mixtral(scan_layers=False)
    ids = jax.random.randint(jax.random.PRNGKey(0), (1, 8), 0, cfg.vocab_size)
    out = {}
    for name, jcfg, key in (("target", cfg, 1), ("draft", dataclasses.replace(cfg, num_layers=1),
                                                  2)):
        jm = jmixtral.MixtralForCausalLM(jcfg, attention_impl="xla")
        params = nn.unbox(jm.init(jax.random.PRNGKey(key), ids))
        tcfg = tmixtral.tiny_mixtral(num_layers=jcfg.num_layers, max_seq_len=jcfg.max_seq_len)
        tm = tmixtral.MixtralForCausalLM(tcfg, device="cpu")
        tm.load_state_dict(mixtral_flax_to_torch(_np_tree(params), tcfg))
        out[name] = (jm, {"params": params["params"]}, tm)
    out["ids"] = np.array(ids)
    return out


def test_mixtral_speculative_matches_target_greedy(mixtral_spec):
    """Solo ``speculative_generate`` with the Mixtral pair, gamma 3: the
    target's greedy tokens, a full recompute of the JAX target."""
    jt, tparams, tt = mixtral_spec["target"]
    _, _, td = mixtral_spec["draft"]
    ids, new = mixtral_spec["ids"], 4
    cur, ref = jnp.asarray(ids), []
    for _ in range(new):
        nxt = jnp.argmax(logits_of(jt.apply(tparams, cur))[:, -1], -1).astype(jnp.int32)
        ref.append(nxt)
        cur = jnp.concatenate([cur, nxt[:, None]], axis=1)
    toks, acc = speculative_generate(tt, td, torch.from_numpy(ids).long(), new, gamma=3)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jnp.stack(ref, axis=1)))
    assert 0.0 <= acc <= 3.0  # draft tokens accepted a round


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
def test_mixtral_spec_engine_equals_solo_speculative(mixtral_spec, paged):
    """``ServingEngine(target, draft_model=, gamma=3)`` over the Mixtral
    pair: every greedy stream equals solo ``speculative_generate``'s (and
    so the target's greedy), bit for bit, on row and paged caches."""
    _, _, tt = mixtral_spec["target"]
    _, _, td = mixtral_spec["draft"]
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (8, 17, 5, 30)]
    news = (6, 9, 7, 5)
    kw = dict(kv_page_size=8, kv_num_pages=48) if paged else {}
    engine = ServingEngine(tt, num_slots=3, decode_chunk_size=2, draft_model=td, gamma=3,
                           prefix_cache=None, **kw)
    reqs = [engine.submit(p, GenerationConfig(max_new_tokens=n, temperature=0.0), seed=i)
            for i, (p, n) in enumerate(zip(prompts, news))]
    engine.run()
    for p, n, r in zip(prompts, news, reqs):
        assert r.state is RequestState.DONE
        solo, _ = speculative_generate(tt, td, torch.tensor([p]), n, gamma=3)
        assert list(r.tokens) == solo[0].tolist()
    if paged:
        engine.cache.check()
    assert engine.metrics.snapshot()["spec_rounds"] > 0
