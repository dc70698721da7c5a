"""The port's quantization against the JAX package (CPU, tiny_llama, fp32).

Inputs come from numpy seeds and go through both packages. Bit for bit
where the arithmetic is the same: the weight codes and scales
(``jnp.round`` and ``torch.round`` both round half to even, and both cast
f32 to fp8 e4m3 to nearest even), the KV page quantizer and the dequantizing
page reads. ``quantized_matmul`` and the quantized model's logits: 2e-4
absolute, the float Llama tests' limit (``test_torch_llama.py``: XLA and
PyTorch sum the same fp32 products in other orders). K5q's plain version
against JAX's gather-dequantize and the Pallas decode kernel in interpret
mode: 1e-5 (``test_torch_kernels.py``'s limit)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.models import llama as jllama
from neuronx_distributed_tpu.quantization import config as jqc
from neuronx_distributed_tpu.quantization import layers as jql
from neuronx_distributed_tpu.quantization import utils as jqu
from neuronx_distributed_tpu_torch.kernels import dequantize as tdq
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd
from neuronx_distributed_tpu_torch.models import llama as tllama
from neuronx_distributed_tpu_torch.models.convert import flax_to_torch
from neuronx_distributed_tpu_torch.parallel.layers import ColumnParallelLinear
from neuronx_distributed_tpu_torch.quantization import config as tqc
from neuronx_distributed_tpu_torch.quantization import layers as tql
from neuronx_distributed_tpu_torch.quantization import utils as tqu

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

jfd = importlib.import_module("neuronx_distributed_tpu.kernels.flash_decode")

ATOL = 2e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _qcfgs(kind, per_tensor):
    """The same qconfig in both packages."""
    jt = (jqc.QuantizationType.PER_TENSOR_SYMMETRIC if per_tensor
          else jqc.QuantizationType.PER_CHANNEL_SYMMETRIC)
    tt = (tqc.QuantizationType.PER_TENSOR_SYMMETRIC if per_tensor
          else tqc.QuantizationType.PER_CHANNEL_SYMMETRIC)
    jd = jqc.QuantizedDtype.INT8 if kind == "int8" else jqc.QuantizedDtype.FP8E4M3
    td = tqc.QuantizedDtype.INT8 if kind == "int8" else tqc.QuantizedDtype.FP8E4M3
    return (jqc.QuantizationConfig(quantization_type=jt, quantized_dtype=jd),
            tqc.QuantizationConfig(tt, td))


def _jax_params(scan_layers, seed=0):
    jcfg = jllama.tiny_llama(scan_layers=scan_layers)
    jmodel = jllama.LlamaForCausalLM(jcfg, attention_impl="xla")
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32)))
    return jcfg, {"params": params["params"]}


def _codes(t):
    """A tensor's bits, for bitwise comparison (fp8 as its bytes)."""
    return t.view(torch.uint8).numpy() if t.dtype == torch.float8_e4m3fn else t.numpy()


# --- config -------------------------------------------------------------------

def test_quant_config_lowers_and_validates_as_jax():
    for weights, dt in (("int8", tqc.QuantizedDtype.INT8), ("fp8", tqc.QuantizedDtype.FP8E4M3)):
        qc = tqc.QuantConfig(weights=weights).weight_qconfig()
        assert qc.quantized_dtype is dt
        assert qc.quantization_type is tqc.QuantizationType.PER_CHANNEL_SYMMETRIC
        jq = jqc.QuantConfig(weights=weights).weight_qconfig()
        assert (qc.quantized_dtype.value, qc.quantization_type.value) == (
            jq.quantized_dtype.value, jq.quantization_type.value)
        assert qc.quantized_dtype.max_value == jq.quantized_dtype.max_value
    assert tqc.QuantConfig(weights=None, kv="int8").weight_qconfig() is None
    assert tqc.QuantizedDtype.FP8E4M3.torch_dtype == torch.float8_e4m3fn
    for kw, match in ((dict(weights="int4"), "weight quantization"),
                      (dict(kv="fp8"), "KV quantization"),
                      (dict(weights=None, kv=None), "quantizes nothing")):
        with pytest.raises(ValueError, match=match):
            tqc.QuantConfig(**kw)
        with pytest.raises(ValueError, match=match):
            jqc.QuantConfig(**kw)


# --- weights ------------------------------------------------------------------

@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("per_tensor", [False, True])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_state_dict_equals_quantize_param_tree(kind, per_tensor, scan_layers):
    """The codes and scales of every linear, lm_head included, bit for bit,
    carried across by ``flax_to_torch`` from either JAX layer layout; the
    embedding and norms stay float."""
    jq, tq = _qcfgs(kind, per_tensor)
    jcfg, params = _jax_params(scan_layers)
    tcfg = tllama.tiny_llama()
    want = flax_to_torch(_np_tree(jqu.quantize_param_tree(params, jq)), tcfg)
    got = tqu.quantize_state_dict(flax_to_torch(_np_tree(params), tcfg), tq)
    assert sorted(got) == sorted(want)
    n_linears = 0
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(_codes(g), _codes(w), err_msg=name)
        n_linears += name.endswith(".scale")
    assert n_linears == 7 * tcfg.num_layers + 1
    assert got["lm_head.scale"].shape == (() if per_tensor else (tcfg.vocab_size,))
    assert got["model.embed.weight"].dtype == torch.float32
    assert tqu.is_quantized_state_dict(got) and not tqu.is_quantized_state_dict(
        flax_to_torch(_np_tree(params), tcfg))


def test_requantizing_a_quantized_state_dict_raises():
    sd = tllama.init_params(tllama.LlamaForCausalLM(tllama.tiny_llama(), device="cpu")).state_dict()
    cfg = tqc.QuantConfig().weight_qconfig()
    q = tqu.quantize_state_dict(sd, cfg)
    with pytest.raises(ValueError, match="already quantized"):
        tqu.quantize_state_dict(q, cfg)
    with pytest.raises(ValueError, match="already carries"):
        tllama.quantize_model(tllama.quantize_model(
            tllama.init_params(tllama.LlamaForCausalLM(tllama.tiny_llama(), device="cpu")), cfg),
            cfg)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_direct_cast_quantize_and_dequantize_equal_jax(kind):
    """The primitives on an (out, in) weight against JAX's on its (in, out)
    transpose: abs-max scale, codes, and the dequantized weight."""
    jq, tq = _qcfgs(kind, False)
    w = np.random.default_rng(0).normal(size=(48, 32)).astype(np.float32) * 0.2
    w[3] = 0.0  # a dead channel: the 1e-12 floor
    jqw, js = jqu.direct_cast_quantize(jnp.asarray(w.T), jq)
    tqw, ts = tqu.direct_cast_quantize(torch.from_numpy(w), tq)
    np.testing.assert_array_equal(ts.numpy().reshape(-1), np.asarray(js).reshape(-1))
    np.testing.assert_array_equal(_codes(tqw).T, np.asarray(jqw).view(np.uint8)
                                  if kind == "fp8" else np.asarray(jqw))
    np.testing.assert_array_equal(tdq.dequantize_plain(tqw, ts).numpy().T,
                                  np.asarray(jqu.dequantize(jqw, js)))


def test_quantized_matmul_equals_jax_within_gemm_tolerance():
    """``quantized_matmul`` (the plain dequantize, then ``F.linear``) against
    JAX's: the dequantized weights bit for bit, the products within fp32
    GEMM rounding; and the linear built with ``quantization_config=``
    routes through it, frozen."""
    cfg = tqc.QuantConfig().weight_qconfig()
    rng = np.random.default_rng(1)
    w = rng.normal(size=(48, 32)).astype(np.float32) * 0.2
    x = rng.normal(size=(4, 5, 32)).astype(np.float32)
    q, s = tqu.direct_cast_quantize(torch.from_numpy(w), cfg)
    s = s.reshape(-1)
    got = tql.quantized_matmul(torch.from_numpy(x), q, s, torch.float32)
    want = jql.quantized_matmul(jnp.asarray(x), jnp.asarray(q.numpy().T),
                                jnp.asarray(s.numpy()[None]), jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tdq.dequantize_fwd(q, s, torch.float32).numpy(),
                                  (q.float() * s[:, None]).numpy())
    lin = ColumnParallelLinear(32, 48, use_bias=False, device="cpu", quantization_config=cfg)
    lin.load_state_dict({"weight": q, "scale": s})
    assert not any(p.requires_grad for p in lin.parameters())
    torch.testing.assert_close(lin(torch.from_numpy(x)), got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="trainable"):
        ColumnParallelLinear(32, 48, device="cpu", trainable=True, quantization_config=cfg)


# --- KV pages -----------------------------------------------------------------

def _pages(seed, n=6, ps=16, hkv=2, d=8):
    return np.random.default_rng(seed).normal(size=(n, ps, hkv, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_page_block_equals_jax(dtype):
    """Codes and per-(page, kv-head) scales bit for bit, in the blocks'
    dtype (the scale is cast before the pages are quantized); an outlier
    head and a zero page included."""
    pages = _pages(2)
    pages[0, :, 0] *= 100.0
    pages[4] = 0.0
    jp = jnp.asarray(pages).astype(dtype)
    tp = torch.from_numpy(pages).to(getattr(torch, dtype))
    jq, js = jfd.quantize_page_block(jp)
    tq, ts = tfd.quantize_page_block(tp)
    assert tq.dtype == torch.int8 and ts.shape == (6, 1, 2, 1) and ts.dtype == tp.dtype
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js.astype(jnp.float32)))


def test_requantize_with_unchanged_absmax_is_exact():
    """JAX ``test_requantize_with_unchanged_absmax_is_exact``: dequantize,
    then quantize again, gives the same codes and scales."""
    q, s = tfd.quantize_page_block(torch.from_numpy(_pages(2)))
    q2, s2 = tfd.quantize_page_block(q.float() * s)
    assert torch.equal(q, q2) and torch.equal(s, s2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantizing_page_reads_equal_jax(dtype):
    """``paged_gather_leaf_dequant`` through a table with unmapped entries
    and ``paged_read_pages_leaf_dequant`` of scattered pages, bit for bit,
    on single-layer and layer-stacked pools."""
    pool = _pages(3, n=10, ps=8)
    jq, js = jfd.quantize_page_block(jnp.asarray(pool).astype(dtype))
    tq, ts = tfd.quantize_page_block(torch.from_numpy(pool).to(getattr(torch, dtype)))
    bt = np.asarray([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    ids = np.asarray([3, 1, 7], np.int32)
    for stack in (False, True):
        jqq, jss = (jnp.stack([jq, jq[::-1]]), jnp.stack([js, js[::-1]])) if stack else (jq, js)
        tqq, tss = (torch.stack([tq, tq.flip(0)]), torch.stack([ts, ts.flip(0)])) if stack else (tq, ts)
        want = jfd.paged_gather_leaf_dequant(jqq, jss, jnp.asarray(bt), 8)
        got = tfd.paged_gather_leaf_dequant(tqq, tss, torch.from_numpy(bt), 8)
        assert got.dtype == tss.dtype and got.shape == tuple(want.shape)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
        want = jfd.paged_read_pages_leaf_dequant(jqq, jss, jnp.asarray(ids), 8)
        got = tfd.paged_read_pages_leaf_dequant(tqq, tss, torch.from_numpy(ids), 8)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("s,h,hkv", [(1, 8, 2), (4, 8, 2), (1, 4, 4)])
def test_k5q_plain_matches_dequantized_pallas_decode(s, h, hkv):
    """K5q's plain version on an int8 pool against the JAX engine's route
    for such a pool: ``paged_gather_leaf_dequant`` then the Pallas decode
    kernel in interpret mode; the wrapper takes the plain version on CPU
    tensors and counts no launch."""
    rng = np.random.default_rng(s + h)
    b, d, ps, n_log, n_pages = 3, 16, 8, 6, 20
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    pool_k = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    pool_v = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    bt = np.zeros((b, n_log), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    bt[0, :5], bt[1, 1:6], bt[2, :2] = perm[:5], perm[5:10], perm[10:12]
    L = n_log * ps
    pos = np.arange(40 - s, 40, dtype=np.int32)
    valid = (rng.random((b, L)) > 0.2) & (np.repeat(bt, ps, axis=1) != 0)
    jkq, jks = jfd.quantize_page_block(jnp.asarray(pool_k))
    jvq, jvs = jfd.quantize_page_block(jnp.asarray(pool_v))
    want = jfd.flash_decode_attention(
        jnp.asarray(q), jfd.paged_gather_leaf_dequant(jkq, jks, jnp.asarray(bt), ps),
        jfd.paged_gather_leaf_dequant(jvq, jvs, jnp.asarray(bt), ps), jnp.asarray(pos),
        jnp.asarray(valid), interpret=True)
    tkq, tks = tfd.quantize_page_block(torch.from_numpy(pool_k))
    tvq, tvs = tfd.quantize_page_block(torch.from_numpy(pool_v))
    n = tfd.qpaged_flash_decode_fwd.launches
    got, _ = tfd.paged_flash_decode_fwd(torch.from_numpy(q), tkq, tvq, torch.from_numpy(bt),
                                        torch.from_numpy(pos), torch.from_numpy(valid), ps,
                                        tks, tvs)
    assert tfd.qpaged_flash_decode_fwd.launches == n
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# --- the quantized model ------------------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_llama_logits_match_jax(kind):
    """The port's quantized Llama built from ``quantize_param_tree``'s
    output (``flax_to_torch``) against the JAX quantized model: prefill and
    two teacher-forced decode steps, left padding and a masked step."""
    jq, tq = _qcfgs(kind, False)
    jcfg, params = _jax_params(False, seed=5)
    qparams = jqu.quantize_param_tree(params, jq)
    jmodel = jllama.LlamaForCausalLM(dataclasses.replace(jcfg, quantization=jq),
                                     attention_impl="xla")
    tcfg = tllama.tiny_llama(quantization=tq)
    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(flax_to_torch(_np_tree(qparams), tcfg))
    assert tmodel.lm_head.weight.dtype == tq.quantized_dtype.torch_dtype
    rng = np.random.default_rng(4)
    b, s = 3, 10
    ids = rng.integers(1, 256, size=(b, s)).astype(np.int32)
    mask = np.zeros((b, s), bool)
    for i, n in enumerate((10, 6, 3)):
        mask[i, s - n:] = True
    want, vars_ = jmodel.clone(mode="prefill").apply(
        qparams, jnp.asarray(ids), padding_mask=jnp.asarray(mask), mutable=["cache"])
    cache = tmodel.new_cache(b)
    got = tmodel(torch.from_numpy(ids).long(), mode="prefill", cache=cache,
                 padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy()[mask], np.asarray(want)[mask], atol=ATOL,
                               rtol=0)
    jcache = vars_["cache"]
    step_mask = np.array([[True], [False], [True]])
    jdec = jmodel.clone(mode="decode")
    for _ in range(2):
        tok = rng.integers(1, 256, size=(b, 1)).astype(np.int32)
        want, vars_ = jdec.apply({**qparams, "cache": jcache}, jnp.asarray(tok),
                                 padding_mask=jnp.asarray(step_mask), mutable=["cache"])
        jcache = vars_["cache"]
        got = tmodel(torch.from_numpy(tok).long(), mode="decode", cache=cache,
                     padding_mask=torch.from_numpy(step_mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_quantize_model_shares_the_float_tensors_it_keeps():
    """``quantize_model``: the state dict of ``quantize_state_dict`` bound to
    a model of the quantized config; the RoPE table it keeps is the float
    model's own tensor, the embedding and norms are equal copies of their
    own (a weight swap writes them in place), the float model is
    unchanged."""
    model = tllama.init_params(tllama.LlamaForCausalLM(tllama.tiny_llama(), device="cpu"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = tqc.QuantConfig(weights="fp8").weight_qconfig()
    qm = tllama.quantize_model(model, cfg)
    assert qm.config.quantization == cfg and model.config.quantization is None
    assert qm.model.freqs is model.model.freqs
    for name in ("model.embed.weight", "model.layers.1.input_norm.weight"):
        q, f = qm.state_dict()[name], model.state_dict()[name]
        assert torch.equal(q, f) and q.untyped_storage().data_ptr() != f.untyped_storage().data_ptr()
    assert tllama.storage_ptrs(qm) & tllama.storage_ptrs(model) == {
        model.model.freqs.untyped_storage().data_ptr()}
    want = tqu.quantize_state_dict(model.state_dict(), cfg)
    for name, t in qm.state_dict().items():
        assert torch.equal(_codes_t(t), _codes_t(want[name])), name
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())


def _codes_t(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
