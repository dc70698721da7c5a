"""Quantized experts against the JAX package (CPU, fp32, ``tiny_mixtral``).

Bit for bit where the arithmetic is the same: ``quantize_state_dict`` on a
Mixtral against ``quantize_param_tree`` (the expert stacks with one scale per
expert and output channel, the router left float), carried across by
``mixtral_flax_to_torch``. MX/MXq's plain version and the quantized expert
layers against JAX's on the same codes: 1e-5 absolute (XLA and PyTorch sum
the same fp32 products in other orders). The quantized model's logits: 2e-4
against JAX's quantized model, and JAX's own Mixtral criterion against the
float model (median relative error < 0.02, 95% of positions < 0.1:
``tests/quantization/test_quantized_model.py:199-205``; near ties may
re-route a token)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.models import mixtral as jmixtral
from neuronx_distributed_tpu.modules import moe as jmoe
from neuronx_distributed_tpu.quantization import config as jqc
from neuronx_distributed_tpu.quantization import layers as jql
from neuronx_distributed_tpu.quantization import utils as jqu
from neuronx_distributed_tpu_torch.kernels import moe_experts as tmx
from neuronx_distributed_tpu_torch.models import mixtral as tmixtral
from neuronx_distributed_tpu_torch.models.convert import mixtral_flax_to_torch
from neuronx_distributed_tpu_torch.modules import moe as tmoe
from neuronx_distributed_tpu_torch.quantization import config as tqc
from neuronx_distributed_tpu_torch.quantization import utils as tqu
from neuronx_distributed_tpu_torch.quantization.layers import dequantize_stack

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _qcfgs(kind, per_tensor=False):
    jt = (jqc.QuantizationType.PER_TENSOR_SYMMETRIC if per_tensor
          else jqc.QuantizationType.PER_CHANNEL_SYMMETRIC)
    tt = (tqc.QuantizationType.PER_TENSOR_SYMMETRIC if per_tensor
          else tqc.QuantizationType.PER_CHANNEL_SYMMETRIC)
    jd = jqc.QuantizedDtype.INT8 if kind == "int8" else jqc.QuantizedDtype.FP8E4M3
    td = tqc.QuantizedDtype.INT8 if kind == "int8" else tqc.QuantizedDtype.FP8E4M3
    return (jqc.QuantizationConfig(quantization_type=jt, quantized_dtype=jd),
            tqc.QuantizationConfig(tt, td))


def _codes(t):
    return t.view(torch.uint8).numpy() if t.dtype == torch.float8_e4m3fn else t.numpy()


def _jax_params(scan_layers, seed=1):
    jcfg = jmixtral.tiny_mixtral(scan_layers=scan_layers)
    jmodel = jmixtral.MixtralForCausalLM(jcfg, attention_impl="xla")
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32)))
    return jmodel, {"params": params["params"]}


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("per_tensor", [False, True])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_state_dict_equals_quantize_param_tree(kind, per_tensor, scan_layers):
    """Codes and scales of every linear and expert stack bit for bit; the
    router, the embedding and the norms stay float."""
    jq, tq = _qcfgs(kind, per_tensor)
    _, params = _jax_params(scan_layers)
    cfg = tmixtral.tiny_mixtral()
    want = mixtral_flax_to_torch(_np_tree(jqu.quantize_param_tree(params, jq)), cfg)
    got = tqu.quantize_state_dict(mixtral_flax_to_torch(_np_tree(params), cfg), tq)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(_codes(g), _codes(w), err_msg=name)
    e, h, i = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    pre = "model.layers.0.moe."
    assert got[pre + "experts.gate_proj"].dtype == tq.quantized_dtype.torch_dtype
    assert got[pre + "experts.gate_proj_scale"].shape == ((e,) if per_tensor else (e, i))
    assert got[pre + "experts.down_proj_scale"].shape == ((e,) if per_tensor else (e, h))
    assert got[pre + "router.weight"].dtype == torch.float32
    assert pre + "router.scale" not in got
    assert tqu.is_quantized_state_dict(got)
    assert not tqu.is_quantized_state_dict(mixtral_flax_to_torch(_np_tree(params), cfg))
    with pytest.raises(ValueError, match="already quantized"):
        tqu.quantize_state_dict(got, tq)


def test_quantized_model_layout_and_init():
    """A quantized Mixtral's buffers are the ``quantize_state_dict``
    layout, and ``init_params`` of it equals ``quantize_model`` of the
    float model's ``init_params`` bit for bit."""
    _, tq = _qcfgs("int8")
    float_model = tmixtral.init_params(
        tmixtral.MixtralForCausalLM(tmixtral.tiny_mixtral(), device="cpu"), seed=4)
    want = tmixtral.quantize_model(float_model, tq).state_dict()
    got = tmixtral.init_params(tmixtral.MixtralForCausalLM(
        tmixtral.tiny_mixtral(quantization=tq), device="cpu"), seed=4).state_dict()
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert sorted(want) == sorted(tqu.quantize_state_dict(float_model.state_dict(), tq))


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_logits_equal_jax_and_meet_its_criterion(kind, scan_layers):
    """The quantized model's logits equal JAX's quantized model's; against
    the float model they meet JAX's Mixtral criterion (the max relative
    error is printed: a re-routed token may exceed it)."""
    jq, tq = _qcfgs(kind)
    jmodel, params = _jax_params(scan_layers)
    qparams = jqu.quantize_param_tree(params, jq)
    jqmodel = jmixtral.MixtralForCausalLM(dataclasses.replace(jmodel.config, quantization=jq),
                                          attention_impl="xla")
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 16), 0, 256))
    want, _ = jqmodel.apply(qparams, ids)
    cfg = tmixtral.tiny_mixtral()
    fmodel = tmixtral.MixtralForCausalLM(cfg, device="cpu")
    fmodel.load_state_dict(mixtral_flax_to_torch(_np_tree(params), cfg))
    qmodel = tmixtral.quantize_model(fmodel, tq)
    with torch.no_grad():
        got = qmodel(torch.from_numpy(ids).long())[0].numpy()
        ref = fmodel(torch.from_numpy(ids).long())[0].numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4)
    rel = np.abs(got - ref) / np.abs(ref).max()
    print(f"{kind}: median rel {np.median(rel):.3g}, 95th {np.quantile(rel, 0.95):.3g}, "
          f"max {rel.max():.3g}")
    assert np.median(rel) < 0.02 and (rel < 0.1).mean() > 0.95


T, H, I, E, K = 8, 32, 48, 4, 2


def _routed(seed, t=T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, H)).astype(np.float32)
    top_e = np.stack([rng.permutation(E)[:K] for _ in range(t)]).astype(np.int32)
    w = rng.random((t, K)).astype(np.float32) + 0.1
    return x, top_e, w / w.sum(-1, keepdims=True)


@pytest.mark.parametrize("per_tensor", [False, True])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_mx_plain_equals_jax_selective_on_dequantized_weights(kind, per_tensor):
    """MX/MXq's plain version, and the quantized ExpertMLPs' selective route,
    equal JAX ``_selective`` of a quantized ExpertMLPs (its stacks
    dequantized by ``_declare_kernel``) on the same codes; MX's plain version
    on float stacks equals JAX's float ``_selective``."""
    jq, tq = _qcfgs(kind, per_tensor)
    x, top_e, top_w = _routed(0)
    jf = jmoe.ExpertMLPs(num_experts=E, hidden_size=H, intermediate_size=I, top_k=K,
                         strategy="selective")
    fparams = nn.unbox(jf.init(jax.random.PRNGKey(3), x, top_e, top_w))
    qparams = jqu.quantize_param_tree(fparams, jq)
    jqm = jmoe.ExpertMLPs(num_experts=E, hidden_size=H, intermediate_size=I, top_k=K,
                          strategy="selective", quantization_config=jq)
    want = np.asarray(jqm.apply(qparams, x, top_e, top_w))
    want_f = np.asarray(jf.apply(fparams, x, top_e, top_w))
    qp = {k: np.asarray(v) for k, v in qparams["params"].items()}

    def stack(name):
        return torch.from_numpy(np.ascontiguousarray(np.swapaxes(
            qp[name].view(np.uint8) if qp[name].dtype.name == "float8_e4m3fn" else qp[name],
            -1, -2)))

    def codes(name):
        t = stack(name)
        return t.view(torch.float8_e4m3fn) if kind == "fp8" else t

    def scale(name):
        s = qp[name + "_scale"].astype(np.float32)
        return torch.from_numpy(np.array(s[:, 0, :] if s.ndim == 3 else s))

    tx, te, tw = torch.from_numpy(x), torch.from_numpy(top_e).long(), torch.from_numpy(top_w)
    got = tmx.moe_experts_quantized(tx, te, tw, codes("gate_proj"), codes("up_proj"),
                                    codes("down_proj"), scale("gate_proj"), scale("up_proj"),
                                    scale("down_proj"))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    tm = tmoe.ExpertMLPs(E, H, I, top_k=K, strategy="selective", device="cpu",
                         quantization_config=tq)
    with torch.no_grad():
        for name in ("gate_proj", "up_proj", "down_proj"):
            getattr(tm, name).copy_(codes(name))
            getattr(tm, name + "_scale").copy_(scale(name))
        np.testing.assert_allclose(tm(tx, te, tw).numpy(), want, atol=ATOL)
        for strategy in ("all_experts", "blockwise"):
            tm.strategy = strategy
            np.testing.assert_allclose(tm(tx, te, tw).numpy(), want, atol=ATOL,
                                       err_msg=strategy)
    fp = {k: torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(v), -1, -2)))
          for k, v in fparams["params"].items()}
    got_f = tmx.moe_experts(tx, te, tw, fp["gate_proj"], fp["up_proj"], fp["down_proj"])
    np.testing.assert_allclose(got_f.numpy(), want_f, atol=ATOL)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_expert_fused_layers_equal_jax(kind):
    """The expert-fused linears with ``quantization_config=`` equal JAX's
    ``QuantizedExpertFusedColumnParallel``/``RowParallel`` on the same codes
    (its (E, 1, out) scales as (E, out)); ``dequantize_stack`` is JAX's
    ``dequantize``."""
    jq, tq = _qcfgs(kind)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((E, 8, H)).astype(np.float32)
    for jcls, tcls, (n_in, n_out) in (
            (jql.QuantizedExpertFusedColumnParallel, tmoe.ExpertFusedColumnParallelLinear,
             (H, I)),
            (jql.QuantizedExpertFusedRowParallel, tmoe.ExpertFusedRowParallelLinear, (H, I))):
        w = rng.standard_normal((E, n_in, n_out)).astype(np.float32)
        jq3 = dataclasses.replace(jq, channel_dim=2, batch_dim=0)  # a scale per (expert, out)
        q, s = jqu.direct_cast_quantize(jnp.asarray(w), jq3)
        jl = jcls(num_experts=E, input_size=n_in, output_size=n_out, quantization_config=jq3,
                  dtype=jnp.float32)
        want = np.asarray(jl.apply({"params": {"kernel": q, "scale": s}}, x))
        tl = tcls(E, n_in, n_out, device="cpu", quantization_config=tq)
        qn = np.swapaxes(np.asarray(q), -1, -2)
        qt = torch.from_numpy(np.ascontiguousarray(
            qn.view(np.uint8) if kind == "fp8" else qn))
        with torch.no_grad():
            tl.weight.copy_(qt.view(torch.float8_e4m3fn) if kind == "fp8" else qt)
            tl.scale.copy_(torch.from_numpy(np.array(np.asarray(s)[:, 0, :])))
            got = tl(torch.from_numpy(x))
            deq = dequantize_stack(tl.weight, tl.scale, torch.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
        np.testing.assert_array_equal(
            deq.numpy(), np.swapaxes(np.asarray(jqu.dequantize(q, s)), -1, -2))
