"""The port's Llama against the JAX reference on tiny_llama (CPU, fp32).

Both models carry the same weights (``flax_to_torch``) and see the same
inputs, made with numpy from a seed. Tolerance: fp32 logits agree to
2e-4 absolute (max |logit| ~ 4): XLA and PyTorch sum the same fp32
products in different orders and use different sin/cos/pow
implementations, ~1e-6 relative per op over 4 layers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn
import pytest
import torch

from neuronx_distributed_tpu.models import llama as jllama
from neuronx_distributed_tpu_torch.models import llama as tllama
from neuronx_distributed_tpu_torch.models.convert import flax_to_torch

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 2e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def build_pair(scan_layers=False, seed=0, **over):
    """A JAX tiny_llama with initialized params and the port model carrying
    the same weights."""
    jcfg = jllama.tiny_llama(scan_layers=scan_layers, **over)
    jmodel = jllama.LlamaForCausalLM(jcfg, attention_impl="xla")
    ids = jnp.ones((1, 8), jnp.int32)
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(seed), ids))
    tcfg = tllama.tiny_llama(**over)
    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(flax_to_torch(_np_tree(params), tcfg))
    return jmodel, {"params": params["params"]}, tmodel


def _ids(rng, b, s, vocab=256):
    return rng.integers(1, vocab, size=(b, s)).astype(np.int32)


def _left_mask(lengths, s):
    m = np.zeros((len(lengths), s), bool)
    for i, n in enumerate(lengths):
        m[i, s - n:] = True
    return m


@pytest.mark.parametrize("scan_layers", [False, True])
def test_flax_to_torch_layouts(scan_layers):
    jmodel, params, tmodel = build_pair(scan_layers=scan_layers)
    sd = tmodel.state_dict()
    tree = params["params"]
    if scan_layers:
        q0 = np.asarray(tree["model"]["layers"]["layer"]["attn"]["qkv"]["q_proj"]["kernel"][2])
    else:
        q0 = np.asarray(tree["model"]["layers_2"]["attn"]["qkv"]["q_proj"]["kernel"])
    np.testing.assert_array_equal(sd["model.layers.2.attn.qkv.q_proj.weight"].numpy(), q0.T)
    np.testing.assert_array_equal(
        sd["lm_head.weight"].numpy(), np.asarray(tree["lm_head"]["kernel"]).T
    )
    rng = np.random.default_rng(1)
    ids = _ids(rng, 2, 12)
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids)))
    got = tmodel(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_train_mode_logits_match():
    jmodel, params, tmodel = build_pair(seed=3)
    rng = np.random.default_rng(2)
    ids = _ids(rng, 3, 16)
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids)))
    got = tmodel(torch.from_numpy(ids).long(), mode="train").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _jax_cache_arrays(cache):
    """(k, v, kv_valid, index) stacked over layers from the JAX collection."""
    layers = [cache["model"][f"layers_{i}"]["attn"] for i in range(4)]
    k = np.stack([np.asarray(c["k"]) for c in layers])
    v = np.stack([np.asarray(c["v"]) for c in layers])
    return k, v, np.asarray(layers[0]["kv_valid"]), int(layers[0]["index"])


def test_prefill_and_decode_logits_and_cache_match():
    jmodel, params, tmodel = build_pair(seed=5)
    rng = np.random.default_rng(4)
    b, s = 3, 10
    ids = _ids(rng, b, s)
    mask = _left_mask([10, 6, 3], s)
    jpre = jmodel.clone(mode="prefill")
    jdec = jmodel.clone(mode="decode")
    want, vars_ = jpre.apply(params, jnp.asarray(ids), padding_mask=jnp.asarray(mask),
                             mutable=["cache"])
    cache = tmodel.new_cache(b)
    got = tmodel(torch.from_numpy(ids).long(), mode="prefill", cache=cache,
                 padding_mask=torch.from_numpy(mask))
    # padded query rows are garbage in both (attention-masked); compare the
    # rows of real tokens
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask], atol=ATOL, rtol=0)

    def check_cache(jcache):
        k, v, valid, index = _jax_cache_arrays(jcache)
        # the device cursor: a decode forward moves it and leaves the host
        # mirror to the loop that runs its steps
        assert int(cache.cursor) == index
        np.testing.assert_array_equal(cache.valid.numpy(), valid)
        np.testing.assert_allclose(cache.k.numpy(), k, atol=ATOL, rtol=0)
        np.testing.assert_allclose(cache.v.numpy(), v, atol=ATOL, rtol=0)

    check_cache(vars_["cache"])
    jcache = vars_["cache"]
    step_mask = np.array([[True], [False], [True]])
    for step in range(2):
        tok = _ids(rng, b, 1)
        want, vars_ = jdec.apply({**params, "cache": jcache}, jnp.asarray(tok),
                                 padding_mask=jnp.asarray(step_mask), mutable=["cache"])
        jcache = vars_["cache"]
        got = tmodel(torch.from_numpy(tok).long(), mode="decode", cache=cache,
                     padding_mask=torch.from_numpy(step_mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        check_cache(jcache)


def test_presets_match_jax_widths():
    for name in ("llama2_7b", "llama2_70b", "llama3_8b", "tiny_llama"):
        j, t = getattr(jllama, name)(), getattr(tllama, name)()
        for f in dataclasses.fields(t):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
