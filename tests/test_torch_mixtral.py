"""The port's Mixtral against the JAX package (CPU, fp32, ``tiny_mixtral``).

Weights are the JAX model's init carried across by
``mixtral_flax_to_torch`` from either layer layout. Logits 2e-4 absolute and
the aux losses 1e-4 relative (the Llama tests' limits: XLA and PyTorch sum
the same fp32 products in other orders); greedy tokens exactly. Inside the
port, the serving engine's streams equal solo ``generate``'s bit for bit, on
row and paged caches, a prefix hit equal to a miss."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.inference import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.inference import generate as jgenerate
from neuronx_distributed_tpu.models import mixtral as jmixtral
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig, generate
from neuronx_distributed_tpu_torch.models import mixtral as tmixtral
from neuronx_distributed_tpu_torch.models.convert import mixtral_flax_to_torch
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 2e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def build_pair(scan_layers=False, seed=1, **over):
    """A JAX tiny_mixtral with initialized params and the port model
    carrying the same weights."""
    jcfg = jmixtral.tiny_mixtral(scan_layers=scan_layers, **over)
    jmodel = jmixtral.MixtralForCausalLM(jcfg, attention_impl="xla")
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32)))
    tcfg = tmixtral.tiny_mixtral(**over)
    tmodel = tmixtral.MixtralForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(mixtral_flax_to_torch(_np_tree(params), tcfg))
    return jmodel, {"params": params["params"]}, tmodel


@pytest.fixture(scope="module")
def pair():
    return build_pair(scan_layers=True)


def _ids(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_mixtral_flax_to_torch_layouts(scan_layers):
    """Both JAX layer layouts carry every leaf across: the router
    transposed to (E, H), the expert stacks to (E, out, in)."""
    jmodel, params, tmodel = build_pair(scan_layers)
    sd = mixtral_flax_to_torch(_np_tree(params), tmodel.config)
    assert sorted(sd) == sorted(tmodel.state_dict())
    p = params["params"]["model"]
    layer = p["layers"]["layer"] if scan_layers else p["layers_1"]
    pick = (lambda a: np.asarray(a)[1]) if scan_layers else np.asarray
    np.testing.assert_array_equal(sd["model.layers.1.moe.router.weight"].numpy(),
                                  pick(layer["moe"]["router"]["weight"]).T)
    np.testing.assert_array_equal(sd["model.layers.1.moe.experts.down_proj"].numpy(),
                                  np.swapaxes(pick(layer["moe"]["experts"]["down_proj"]), -1, -2))
    assert tuple(sd["model.layers.0.moe.experts.gate_proj"].shape) == (4, 96, 64)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_logits_and_aux_equal_jax(scan_layers):
    """``(logits, aux)`` of a train-mode forward, and of one with an
    expert strategy forced (blockwise, capacity factor)."""
    for over in ({}, {"expert_strategy": "blockwise"}, {"capacity_factor": 1.0}):
        jmodel, params, tmodel = build_pair(scan_layers, **over)
        ids = _ids(0, 2, 16)
        want, want_aux = jmodel.apply(params, ids)
        with torch.no_grad():
            got, aux = tmodel(torch.from_numpy(ids).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=str(over))
        for name in ("load_balancing_loss", "router_z_loss"):
            np.testing.assert_allclose(float(aux[name]), float(want_aux[name]), rtol=1e-4,
                                       err_msg=f"{over} {name}")


def test_serving_forwards_compute_no_aux_losses(pair, monkeypatch):
    """A prefill and a decode forward return zero router losses without
    computing them (no request reads them, and a captured decode step would
    run them), their logits those of a train-mode forward of the same
    tokens (which equal JAX's); a train-mode forward computes both losses
    in every layer."""
    from neuronx_distributed_tpu_torch.modules.moe import model as tmoe

    _, _, tmodel = pair
    ids = torch.from_numpy(_ids(4, 1, 12)).long()
    calls = []
    for name in ("load_balancing_loss_func", "router_z_loss_func"):
        real = getattr(tmoe, name)
        monkeypatch.setattr(tmoe, name, lambda *a, _r=real, **k: calls.append(1) or _r(*a, **k))
    with torch.no_grad():
        cache = tmodel.new_cache(1)
        pre, aux = tmodel(ids, mode="prefill", cache=cache, last_only=True)
        assert not calls and all(float(v) == 0.0 for v in aux.values())
        dec, aux = tmodel(torch.tensor([[7]]), mode="decode", cache=cache, last_only=True)
        assert not calls and all(float(v) == 0.0 for v in aux.values())
        full, aux = tmodel(torch.cat([ids, torch.tensor([[7]])], 1))
    assert len(calls) == 2 * tmodel.config.num_layers
    assert float(aux["router_z_loss"]) > 0.0
    np.testing.assert_allclose(pre[0, -1].numpy(), full[0, -2].numpy(), atol=ATOL)
    np.testing.assert_allclose(dec[0, -1].numpy(), full[0, -1].numpy(), atol=ATOL)


def test_loss_equals_jax(pair):
    """Cross entropy plus the weighted router losses, plain and packed
    (segment ids restart RoPE and isolate documents; a loss mask)."""
    jmodel, params, tmodel = pair
    jmodel = jmixtral.MixtralForCausalLM(dataclasses.replace(jmodel.config,
                                                             router_z_loss_coef=0.001),
                                         attention_impl="xla")
    tmodel.config = dataclasses.replace(tmodel.config, router_z_loss_coef=0.001)
    ids, labels = _ids(1, 2, 16), _ids(2, 2, 16)
    seg = np.array([[1] * 6 + [2] * 10, [1] * 16], np.int32)
    mask = (seg > 0).astype(np.float32)
    mask[0, 5] = 0.0
    try:
        for kw, tkw in (({}, {}), (dict(segment_ids=seg, loss_mask=mask),
                                   dict(segment_ids=torch.from_numpy(seg).long(),
                                        loss_mask=torch.from_numpy(mask)))):
            want = float(jmodel.loss(params, ids, labels, **kw))
            with torch.no_grad():
                got = float(tmodel.loss(torch.from_numpy(ids).long(),
                                        torch.from_numpy(labels).long(), **tkw))
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=str(list(kw)))
    finally:
        tmodel.config = dataclasses.replace(tmodel.config, router_z_loss_coef=0.0)


def _greedy_recompute(tmodel, ids, steps):
    cur = torch.from_numpy(ids).long()
    out = []
    with torch.no_grad():
        for _ in range(steps):
            nxt = tmodel(cur)[0][:, -1].argmax(-1)
            out.append(nxt)
            cur = torch.cat([cur, nxt[:, None]], 1)
    return torch.stack(out, 1).numpy()


def test_greedy_generate_equals_jax_and_full_recompute(pair):
    """JAX ``test_moe_generate.py:43``: the cached greedy tokens equal a
    full recompute's, and JAX's ``generate``'s (its decode steps take the
    selective route, its prefill the dense one: four experts)."""
    jmodel, params, tmodel = pair
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 8), 0, 256))
    want = np.asarray(jgenerate(jmodel, params, ids, jax.random.PRNGKey(2),
                                JGenerationConfig(max_new_tokens=6, temperature=0.0)))
    got = generate(tmodel, torch.from_numpy(ids).long(),
                   GenerationConfig(max_new_tokens=6, temperature=0.0)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _greedy_recompute(tmodel, ids, 6))


def _workload():
    rng = np.random.default_rng(3)
    lengths = (5, 23, 9, 40, 3)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in lengths]
    gcfgs = [GenerationConfig(max_new_tokens=n, temperature=t, top_k=k)
             for n, t, k in ((8, 0.0, None), (6, 0.8, 20), (10, 0.0, None), (5, 1.0, None),
                             (7, 0.0, None))]
    return prompts, gcfgs


def _solo(tmodel, prompt, gcfg, seed):
    return generate(tmodel, torch.tensor([prompt]), gcfg, seed=seed)[0].tolist()


@pytest.fixture(scope="module")
def solo_streams(pair):
    _, _, tmodel = pair
    prompts, gcfgs = _workload()
    return [_solo(tmodel, p, g, i) for i, (p, g) in enumerate(zip(prompts, gcfgs))]


@pytest.mark.parametrize("paged", [False, True])
def test_engine_streams_equal_solo_generate(pair, solo_streams, paged):
    """Greedy and sampled streams through the row and the paged engine
    (decode steps of 3 slots: the selective route) equal solo
    ``generate``'s bit for bit; the paged pool is clean after."""
    _, _, tmodel = pair
    prompts, gcfgs = _workload()
    kw = dict(kv_page_size=8, kv_num_pages=40) if paged else {}
    engine = ServingEngine(tmodel, num_slots=3, decode_chunk_size=3, **kw)
    reqs = [engine.submit(p, g, seed=i) for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    engine.run()
    for i, req in enumerate(reqs):
        assert req.state is RequestState.DONE
        assert req.tokens == solo_streams[i], i
    if paged:
        engine.cache.check()


def test_engine_sixteen_slots_take_the_blockwise_route():
    """At 16 slots a decode step has 16 tokens, above the selective
    threshold: with eight experts it takes the blockwise route (the
    paged serving phase's); the streams still equal solo ``generate``."""
    _, _, t8 = build_pair(scan_layers=True, num_experts=8)
    for e in ("selective", "blockwise"):
        assert t8.model.layers[0].moe.experts.resolve_strategy(16 if e == "blockwise" else 8) == e
    prompts, gcfgs = _workload()
    engine = ServingEngine(t8, num_slots=16, kv_page_size=8, kv_num_pages=64)
    reqs = [engine.submit(p, g, seed=i) for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    engine.run()
    for i, req in enumerate(reqs):
        assert req.tokens == _solo(t8, prompts[i], gcfgs[i], i), i
    engine.cache.check()


@pytest.mark.parametrize("paged", [False, True])
def test_prefix_hit_equals_a_miss(pair, paged):
    """Two waves of prompts sharing a 24-token prefix: the second wave's
    hits continue the context a full prefill of it would (its greedy
    streams equal the prefix-off engine's)."""
    _, _, tmodel = pair
    rng = np.random.default_rng(9)
    system = rng.integers(1, 256, size=24).tolist()
    tails = [rng.integers(1, 256, size=n).tolist() for n in (3, 11, 6)]
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    kw = dict(kv_page_size=8, kv_num_pages=48) if paged else {}
    streams = {}
    for prefix in ("auto", None):
        engine = ServingEngine(tmodel, num_slots=2, prefix_cache=prefix, **kw)
        out = []
        for wave in range(2):
            reqs = [engine.submit(system + t, gcfg, seed=i) for i, t in enumerate(tails)]
            engine.run()
            out.append([r.tokens for r in reqs])
        streams[prefix] = out
        if prefix == "auto":
            assert engine.metrics.snapshot()["prefix_hits"] >= len(tails)
        if paged:
            engine.cache.check()
    assert streams["auto"] == streams[None]
    assert streams["auto"][0] == streams["auto"][1]


def test_engine_greedy_streams_equal_the_jax_engine(pair):
    """The JAX ``ServingEngine`` serves tiny_mixtral on the CPU; the port's
    greedy streams equal its."""
    jmodel, params, tmodel = pair
    prompts, _ = _workload()
    jcfg = JGenerationConfig(max_new_tokens=6, temperature=0.0)
    jeng = JServingEngine(jmodel, params, num_slots=3, decode_chunk_size=3, prefix_cache=None)
    jreqs = [jeng.submit(p, jcfg, key=jax.random.PRNGKey(i)) for i, p in enumerate(prompts)]
    jeng.run()
    engine = ServingEngine(tmodel, num_slots=3, decode_chunk_size=3, prefix_cache=None)
    reqs = [engine.submit(p, GenerationConfig(6, temperature=0.0), seed=i)
            for i, p in enumerate(prompts)]
    engine.run()
    assert [r.tokens for r in reqs] == [list(r.tokens) for r in jreqs]


@pytest.mark.parametrize("slots,paged", [(3, False), (3, True), (16, True)])
def test_decode_chunk_reads_nothing_from_the_device(slots, paged, monkeypatch):
    """A Mixtral decode chunk (the router's top-k, the selective route at 3
    slots, the blockwise sort and grouped products at 16, the aux losses)
    runs with every host read of a tensor made to raise, and steady chunks
    cost the engine's one read each."""
    from test_torch_decode_program import no_host_reads

    from neuronx_distributed_tpu_torch.inference.generate import ChunkedDecode

    _, _, tmodel = build_pair(scan_layers=True, num_experts=8)
    real = ChunkedDecode.__call__
    chunks = []

    def guarded(self):
        with no_host_reads():
            out = real(self)
        chunks.append(out)
        return out

    monkeypatch.setattr(ChunkedDecode, "__call__", guarded)
    kw = dict(kv_page_size=8, kv_num_pages=64) if paged else {}
    engine = ServingEngine(tmodel, num_slots=slots, decode_chunk_size=4, **kw)
    prompts, gcfgs = _workload()
    engine.submit(prompts[0], GenerationConfig(12, temperature=0.0))
    engine.step()  # admission (first token) + one chunk
    assert engine.host_reads == 2
    engine.step()  # steady: the chunk's token block only
    assert engine.host_reads == 3
    engine.run()
    assert chunks and sum(chunks) == engine.metrics.executed_steps


def test_quantized_mixtral_engine_streams_equal_solo_generate(pair):
    """``ServingEngine(quantize=QuantConfig(weights="int8"))`` quantizes a
    Mixtral (experts included, the routers float) and serves what solo
    ``generate`` on ``quantize_model`` of it does."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig

    _, _, tmodel = pair
    prompts, gcfgs = _workload()
    engine = ServingEngine(tmodel, num_slots=2, kv_page_size=8, kv_num_pages=40,
                           quantize=QuantConfig(weights="int8"))
    assert engine.model.model.layers[0].moe.experts.up_proj.dtype == torch.int8
    assert engine.model.model.layers[0].moe.router.weight.dtype == torch.float32
    qmodel = tmixtral.quantize_model(tmodel, QuantConfig(weights="int8").weight_qconfig())
    reqs = [engine.submit(p, g, seed=i) for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    engine.run()
    for i, req in enumerate(reqs):
        assert req.tokens == _solo(qmodel, prompts[i], gcfgs[i], i), i
    engine.cache.check()
