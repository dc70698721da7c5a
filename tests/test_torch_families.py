"""The port's GPT-NeoX, CodeGen and DBRX against the JAX package (CPU, fp32,
the tiny presets, GPT-NeoX also at head_dim 96 and with the sequential
residual).

Weights are the JAX model's init with every linear bias and LayerNorm
parameter redrawn from a seeded numpy RNG (init leaves them 0 and 1, which
would hide a dropped bias or a swapped norm), carried across by the
family's ``*_flax_to_torch``; inputs are made with numpy from a seed. Tolerances:
logits 2e-4 absolute and DBRX's aux losses and ``loss`` 1e-5 relative (the
Llama and Mixtral tests' limits: XLA and PyTorch sum the same fp32 products
in other orders and use other erf/tanh/sin/cos); greedy tokens exactly.
The quantized DBRX: codes and scales bit for bit against JAX's
``quantize_param_tree``, the logits 2e-4 against JAX's quantized model and
within JAX's own budget of the float model (median relative error under
0.02, more than 0.95 of the logits under 0.1)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.models import codegen as jcodegen
from neuronx_distributed_tpu.models import dbrx as jdbrx
from neuronx_distributed_tpu.models import gpt_neox as jneox
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig, generate
from neuronx_distributed_tpu_torch.models import codegen as tcodegen
from neuronx_distributed_tpu_torch.models import dbrx as tdbrx
from neuronx_distributed_tpu_torch.models import gpt_neox as tneox
from neuronx_distributed_tpu_torch.models.convert import (
    codegen_flax_to_torch,
    dbrx_flax_to_torch,
    gpt_neox_flax_to_torch,
)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 2e-4

# the JAX `inference` package re-exports the function `generate` under the
# module's name
jgen = importlib.import_module("neuronx_distributed_tpu.inference.generate")

# family -> (JAX module, JAX model class name, port module, tiny preset, converter)
FAMILIES = {
    "gpt_neox": (jneox, "GPTNeoXForCausalLM", tneox, "tiny_gpt_neox", gpt_neox_flax_to_torch),
    "codegen": (jcodegen, "CodeGenForCausalLM", tcodegen, "tiny_codegen", codegen_flax_to_torch),
    "dbrx": (jdbrx, "DbrxForCausalLM", tdbrx, "tiny_dbrx", dbrx_flax_to_torch),
}
# (family, config overrides): GPT-NeoX also at head_dim 96 (hidden 192 over
# 2 heads: 24 rotary channels, GPT-NeoX-20B's split) and sequential
CASES = [
    ("gpt_neox", {}),
    ("gpt_neox", dict(hidden_size=192, num_heads=2)),
    ("gpt_neox", dict(use_parallel_residual=False)),
    ("codegen", {}),
    ("dbrx", {}),
]
CASE_IDS = ["gpt_neox", "gpt_neox_d96", "gpt_neox_sequential", "codegen", "dbrx"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_model(family, cfg, mode="train"):
    jmod, cls, *_ = FAMILIES[family]
    kw = dict(attention_impl="xla") if family == "dbrx" else {}
    return getattr(jmod, cls)(cfg, mode=mode, **kw)


def _redraw_affine(params, seed):
    """``params`` with every ``bias`` leaf drawn N(0, 0.1) and every
    LayerNorm ``scale`` 1 + N(0, 0.1), from numpy's RNG at ``seed``: each
    bias and each norm of a layer distinct."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "bias":
            return jnp.asarray(rng.normal(0.0, 0.1, leaf.shape), leaf.dtype)
        if name == "scale":
            return jnp.asarray(1.0 + rng.normal(0.0, 0.1, leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, params)


def build_pair(family, seed=0, **over):
    """A JAX tiny model of ``family`` with initialized params (biases and
    LayerNorm parameters redrawn) and the port model carrying the same
    weights: ``(jmodel, params, tmodel)``."""
    jmod, cls, tmod, preset, convert = FAMILIES[family]
    jcfg = getattr(jmod, preset)(**over)
    jmodel = jax_model(family, jcfg)
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32)))
    params = _redraw_affine(params, seed)
    tcfg = getattr(tmod, preset)(**over)
    tmodel = getattr(tmod, cls)(tcfg, device="cpu")
    tmodel.load_state_dict(convert(_np_tree(params), tcfg))
    return jmodel, {"params": params["params"]}, tmodel


def logits_of(out):
    """A family's logits: DBRX returns ``(logits, aux)``."""
    return out[0] if isinstance(out, tuple) else out


def _ids(rng, b, s, vocab=256):
    return rng.integers(1, vocab, size=(b, s)).astype(np.int32)


def _left_mask(lengths, s):
    m = np.zeros((len(lengths), s), bool)
    for i, n in enumerate(lengths):
        m[i, s - n:] = True
    return m


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_flax_to_torch_fills_every_weight(family):
    """The converter gives every entry of the port's state dict, at its
    shape, from the JAX tree: kernels transposed, LayerNorm scales and
    biases, linear biases (NeoX everywhere, CodeGen's MLP and lm_head)."""
    jmodel, params, tmodel = build_pair(family)
    convert = FAMILIES[family][4]
    sd = convert(_np_tree(params), tmodel.config)
    own = tmodel.state_dict()
    assert sorted(sd) == sorted(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in own)
    p = params["params"]
    layer = p["layers_1" if family == "gpt_neox" else "blocks_1"]
    np.testing.assert_array_equal(sd["model.layers.1.attn.qkv.k_proj.weight"].numpy(),
                                  np.asarray(layer["attn"]["qkv"]["k_proj"]["kernel"]).T)
    norms = ("norm_1", "norm_2") if family == "dbrx" else ("input_norm", "post_attn_norm")
    for norm in norms[:1 if family == "codegen" else 2]:
        np.testing.assert_array_equal(sd[f"model.layers.1.{norm}.weight"].numpy(),
                                      np.asarray(layer[norm]["ln"]["scale"]))
    if family == "gpt_neox":
        np.testing.assert_array_equal(sd["model.layers.1.post_attn_norm.bias"].numpy(),
                                      np.asarray(layer["post_attn_norm"]["ln"]["bias"]))
        assert not np.array_equal(np.asarray(layer["input_norm"]["ln"]["scale"]),
                                  np.asarray(layer["post_attn_norm"]["ln"]["scale"]))
    if family == "codegen":
        np.testing.assert_array_equal(sd["lm_head.bias"].numpy(), np.asarray(p["lm_head"]["bias"]))
        assert "model.layers.0.attn.o_proj.bias" not in sd
    if family == "gpt_neox":
        np.testing.assert_array_equal(sd["model.layers.1.attn.o_proj.bias"].numpy(),
                                      np.asarray(layer["attn"]["o_proj"]["bias"]))
        assert np.abs(np.asarray(layer["attn"]["o_proj"]["bias"])).max() > 0
    if family == "dbrx":
        assert "model.layers.0.norm_1.bias" not in sd and "model.final_norm.bias" not in sd


@pytest.mark.parametrize("family,over", CASES, ids=CASE_IDS)
def test_train_mode_logits_match(family, over):
    jmodel, params, tmodel = build_pair(family, seed=3, **over)
    ids = _ids(np.random.default_rng(2), 3, 16)
    want = np.asarray(logits_of(jmodel.apply(params, jnp.asarray(ids))))
    with torch.no_grad():
        got = logits_of(tmodel(torch.from_numpy(ids).long(), mode="train")).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("family,over", CASES, ids=CASE_IDS)
def test_prefill_and_decode_logits_match(family, over):
    """A left-padded prefill (the rows of real tokens), then two decode
    steps with a finished row masked, against JAX's cached modes."""
    jmodel, params, tmodel = build_pair(family, seed=5, **over)
    rng = np.random.default_rng(4)
    b, s = 3, 10
    ids = _ids(rng, b, s)
    mask = _left_mask([10, 6, 3], s)
    jpre, jdec = jmodel.clone(mode="prefill"), jmodel.clone(mode="decode")
    want, vars_ = jpre.apply(params, jnp.asarray(ids), padding_mask=jnp.asarray(mask),
                             mutable=["cache"])
    cache = tmodel.new_cache(b)
    with torch.no_grad():
        got = logits_of(tmodel(torch.from_numpy(ids).long(), mode="prefill", cache=cache,
                               padding_mask=torch.from_numpy(mask)))
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(logits_of(want))[mask], atol=ATOL,
                               rtol=0)
    jcache = vars_["cache"]
    step_mask = np.array([[True], [False], [True]])
    for _ in range(2):
        tok = _ids(rng, b, 1)
        want, vars_ = jdec.apply({**params, "cache": jcache}, jnp.asarray(tok),
                                 padding_mask=jnp.asarray(step_mask), mutable=["cache"])
        jcache = vars_["cache"]
        with torch.no_grad():
            got = logits_of(tmodel(torch.from_numpy(tok).long(), mode="decode", cache=cache,
                                   padding_mask=torch.from_numpy(step_mask)))
        np.testing.assert_allclose(got.numpy(), np.asarray(logits_of(want)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_presets_match_jax(family):
    """Every preset's fields equal JAX's (the dtypes aside)."""
    jmod, _, tmod, preset, _ = FAMILIES[family]
    full = {"gpt_neox": "gpt_neox_20b", "codegen": "codegen25_7b", "dbrx": "dbrx_base"}[family]
    for name in (full, preset):
        j, t = getattr(jmod, name)(), getattr(tmod, name)()
        for f in dataclasses.fields(t):
            if f.name not in ("dtype", "param_dtype", "remat_policy", "quantization"):
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert t.head_dim_ == j.hidden_size // j.num_heads
    assert tneox.gpt_neox_20b().head_dim_ == 96


def _left_padded(rng, lengths, s, vocab=256):
    ids = np.zeros((len(lengths), s), np.int32)
    mask = np.zeros((len(lengths), s), bool)
    for i, n in enumerate(lengths):
        ids[i, s - n:] = rng.integers(1, vocab, size=n)
        mask[i, s - n:] = True
    return ids, mask


def _greedy_recompute(tmodel, ids, steps):
    cur = torch.from_numpy(ids).long()
    out = []
    with torch.no_grad():
        for _ in range(steps):
            nxt = logits_of(tmodel(cur))[:, -1].argmax(-1)
            out.append(nxt)
            cur = torch.cat([cur, nxt[:, None]], 1)
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("family,over", CASES, ids=CASE_IDS)
def test_greedy_generate_matches_jax_on_left_padded_batch(family, over):
    """JAX ``test_family_generate.py:60,100`` and ``test_moe_generate.py:77``:
    greedy ``generate`` over a left-padded batch gives JAX's tokens, and
    each row's tokens alone."""
    jmodel, params, tmodel = build_pair(family, seed=11, **over)
    rng = np.random.default_rng(7)
    ids, mask = _left_padded(rng, [9, 4, 6], 9)
    cfg = jgen.GenerationConfig(max_new_tokens=6, temperature=0.0)
    want = np.asarray(jgen.generate(jmodel, params, jnp.asarray(ids), jax.random.PRNGKey(0),
                                    cfg, attention_mask=jnp.asarray(mask)))
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    got = generate(tmodel, ids, gcfg, attention_mask=mask).numpy()
    np.testing.assert_array_equal(got, want)
    short = ids[1:2, -4:]
    np.testing.assert_array_equal(generate(tmodel, short, gcfg).numpy(), got[1:2])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cached_greedy_equals_full_recompute(family):
    """JAX ``test_family_generate.py:34,47`` and ``test_moe_generate.py:77``:
    the cached greedy tokens equal a full recompute's, and JAX's."""
    jmodel, params, tmodel = build_pair(family, seed=1)
    ids = np.array(jax.random.randint(jax.random.PRNGKey(0), (2, 8), 0, 256))
    want = np.asarray(jgen.generate(jmodel, params, jnp.asarray(ids), jax.random.PRNGKey(2),
                                    jgen.GenerationConfig(max_new_tokens=4, temperature=0.0)))
    got = generate(tmodel, torch.from_numpy(ids).long(),
                   GenerationConfig(max_new_tokens=4, temperature=0.0)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _greedy_recompute(tmodel, ids, 4))


def test_dbrx_aux_losses_and_loss_equal_jax():
    """DBRX's train-mode aux losses (summed over blocks) and ``loss`` (cross
    entropy plus both router losses weighted), plain and packed, against
    JAX's; serving forwards return zero aux."""
    jmodel, params, tmodel = build_pair("dbrx", seed=2)
    ids, labels = _ids(np.random.default_rng(1), 2, 16), _ids(np.random.default_rng(2), 2, 16)
    _, jaux = jmodel.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        _, aux = tmodel(torch.from_numpy(ids).long())
    for key in ("load_balancing_loss", "router_z_loss"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-5)
    jz = jdbrx.DbrxForCausalLM(dataclasses.replace(jmodel.config, router_z_loss_coef=0.001),
                               attention_impl="xla")
    tmodel.config = dataclasses.replace(tmodel.config, router_z_loss_coef=0.001)
    seg = np.array([[1] * 6 + [2] * 10, [1] * 16], np.int32)
    mask = (seg > 0).astype(np.float32)
    mask[0, 5] = 0.0
    for kw, tkw in (({}, {}), (dict(segment_ids=seg, loss_mask=mask),
                               dict(segment_ids=torch.from_numpy(seg).long(),
                                    loss_mask=torch.from_numpy(mask)))):
        want = float(jz.loss(params, ids, labels, **kw))
        with torch.no_grad():
            got = float(tmodel.loss(torch.from_numpy(ids).long(), torch.from_numpy(labels).long(),
                                    **tkw))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=str(list(kw)))
    cache = tmodel.new_cache(2)
    with torch.no_grad():
        _, aux = tmodel(torch.from_numpy(ids).long(), mode="prefill", cache=cache)
    assert all(float(v) == 0.0 for v in aux.values())


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_dbrx_equals_jax(kind):
    """JAX ``test_quantized_dbrx_structure_and_logits``: ``DbrxConfig(
    quantization=)`` quantizes the attention linears, the expert stacks and
    lm_head (routers, norms and the embedding float). The port's
    ``quantize_model`` gives JAX's ``quantize_param_tree`` codes and scales
    bit for bit, its logits equal JAX's quantized model's, within JAX's
    budget of the float model; ``init_params`` of the quantized model equals
    ``quantize_model`` of the float one's."""
    from neuronx_distributed_tpu.quantization.config import QuantizationConfig as JQC
    from neuronx_distributed_tpu.quantization.config import QuantizedDtype as JQD
    from neuronx_distributed_tpu.quantization.utils import quantize_param_tree
    from neuronx_distributed_tpu_torch.models.llama import quantize_model
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig

    jmodel, params, tmodel = build_pair("dbrx", seed=1)
    jq = JQC(quantized_dtype=JQD.INT8 if kind == "int8" else JQD.FP8E4M3)
    qparams = quantize_param_tree(params, jq)
    qcfg = QuantConfig(weights=kind).weight_qconfig()
    qmodel = quantize_model(tmodel, qcfg)
    want_sd = dbrx_flax_to_torch(_np_tree(qparams), qmodel.config)
    got_sd = qmodel.state_dict()
    assert sorted(want_sd) == sorted(got_sd)
    for name, t in got_sd.items():
        w = want_sd[name]
        if t.dtype in (torch.int8, torch.float8_e4m3fn) or name.endswith("scale"):
            assert t.dtype == w.dtype and torch.equal(t.view(torch.uint8) if t.dtype.itemsize == 1
                                                      else t, w.view(torch.uint8)
                                                      if w.dtype.itemsize == 1 else w), name
    assert got_sd["model.layers.0.moe.router.weight"].dtype == torch.float32
    ids = np.array(jax.random.randint(jax.random.PRNGKey(0), (2, 16), 0, 256))
    jqmodel = jdbrx.DbrxForCausalLM(dataclasses.replace(jmodel.config, quantization=jq),
                                    attention_impl="xla")
    want, _ = jqmodel.apply(qparams, jnp.asarray(ids))
    ref, _ = jmodel.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        got, _ = qmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=ATOL, rtol=0)
    ref = np.asarray(ref, np.float32)
    rel = np.abs(got.numpy() - ref) / np.abs(ref).max()
    assert np.median(rel) < 0.02 and (rel < 0.1).mean() > 0.95
    seeded = tdbrx.init_params(tdbrx.DbrxForCausalLM(
        dataclasses.replace(tmodel.config, quantization=qcfg), device="cpu"), seed=4)
    floats = quantize_model(tdbrx.init_params(tdbrx.DbrxForCausalLM(tmodel.config, device="cpu"),
                                              seed=4), qcfg)
    for name, t in seeded.state_dict().items():
        assert torch.equal(t.view(torch.uint8) if t.dtype.itemsize == 1 else t,
                           floats.state_dict()[name].view(torch.uint8)
                           if t.dtype.itemsize == 1 else floats.state_dict()[name]), name


@pytest.mark.parametrize("family", ["gpt_neox", "codegen"])
def test_init_params_fills_norms_biases_and_linears(family):
    """``init_params`` on a family: LayerNorm scales 1, every bias 0, the
    embedding N(0, 1), linears N(0, 1/fan_in), the same bits for the same
    seed."""
    _, cls, tmod, preset, _ = FAMILIES[family]
    cfg = getattr(tmod, preset)()
    a = tmod.init_params(getattr(tmod, cls)(cfg, device="cpu"), seed=3)
    b = tmod.init_params(getattr(tmod, cls)(cfg, device="cpu"), seed=3)
    for name, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[name]), name
        if name.endswith("norm.weight"):
            assert bool((t == 1).all()), name
        elif name.endswith("bias"):
            assert bool((t == 0).all()), name
        else:
            std = float(t.std())
            want = 1.0 if name == "model.embed.weight" else t.shape[-1] ** -0.5
            assert abs(std / want - 1) < 0.2, (name, std, want)


def test_dbrx_create_train_state_uses_the_moe_init():
    """``create_train_state`` on a trainable DBRX fills it as the MoE
    ``init_params`` does (its expert stacks drawn, not zeroed), bit for
    bit for the same seed."""
    from neuronx_distributed_tpu_torch.trainer.trainer import AdamW, create_train_state

    cfg = tdbrx.tiny_dbrx()
    got = tdbrx.DbrxForCausalLM(cfg, device="cpu", trainable=True)
    create_train_state(got, AdamW(1e-3), seed=5)
    want = tdbrx.init_params(tdbrx.DbrxForCausalLM(cfg, device="cpu", trainable=True), seed=5)
    for name, t in got.state_dict().items():
        assert torch.equal(t, want.state_dict()[name]), name
    stack = got.state_dict()["model.layers.0.moe.experts.up_proj"]
    assert float(stack.std()) > 0
