"""The port's MoE stack against the JAX package (CPU, fp32, small widths).

The same numpy inputs and the same weights (flax's ``(..., in, out)``
transposed to torch's ``(..., out, in)``) go through both packages. Routers,
aux losses and expert strategies: 1e-5 absolute (XLA and PyTorch sum the
same fp32 products in other orders); expert ids and the capacity factor's
dropped slots exactly. The MX/MXq plain versions against JAX
``_selective`` are in ``test_torch_moe_quant.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.modules import moe as jmoe
from neuronx_distributed_tpu.modules.moe import routing as jrouting
from neuronx_distributed_tpu_torch.kernels import moe_experts as tmx
from neuronx_distributed_tpu_torch.modules import moe as tmoe
from neuronx_distributed_tpu_torch.modules.moe import expert_mlps as texp

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T, H, I, E, K = 32, 16, 24, 4, 2
ATOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), dtype=np.float32))


def _k(a) -> torch.Tensor:
    """A flax kernel (..., in, out) as torch's (..., out, in)."""
    return _t(np.swapaxes(np.asarray(a), -1, -2)).contiguous()


def _routed(seed=0, t=T, e=E):
    """x (t, H), distinct top-2 expert ids and softmax affinities, numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, H)).astype(np.float32)
    top_e = np.stack([rng.permutation(e)[:K] for _ in range(t)]).astype(np.int32)
    w = rng.standard_normal((t, K)).astype(np.float32)
    top_w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    return x, top_e, top_w


def _jax_mlps(strategy, e=E, capacity_factor=None, glu=True, act="silu"):
    return jmoe.ExpertMLPs(num_experts=e, hidden_size=H, intermediate_size=I, top_k=K,
                           glu_mlp=glu, hidden_act=act, capacity_factor=capacity_factor,
                           strategy=strategy)


def _pair(strategy, e=E, capacity_factor=None, glu=True, act="silu", seed=0):
    """The JAX ExpertMLPs with its params and the port's with the same
    weights, and the routed inputs."""
    x, top_e, top_w = _routed(seed, e=e)
    jm = _jax_mlps(strategy, e, capacity_factor, glu, act)
    params = nn.unbox(jm.init(jax.random.PRNGKey(7), x, top_e, top_w))
    tm = texp.ExpertMLPs(e, H, I, top_k=K, hidden_act=act, glu_mlp=glu,
                         capacity_factor=capacity_factor, strategy=strategy, device="cpu")
    p = params["params"]
    with torch.no_grad():
        for name in ("gate_proj", "up_proj", "down_proj"):
            if name in p:
                getattr(tm, name).copy_(_k(p[name]))
    return jm, params, tm, (x, top_e, top_w)


def _run(tm, x, top_e, top_w):
    with torch.no_grad():
        return tm(_t(x), torch.from_numpy(top_e).long(), _t(top_w)).numpy()


# --- routers ------------------------------------------------------------------

@pytest.mark.parametrize("act_fn", ["softmax", "sigmoid"])
@pytest.mark.parametrize("normalize", [True, False])
def test_router_topk_equals_jax(act_fn, normalize):
    """logits, probs, top_e and top_w of the same weight."""
    x = np.random.default_rng(1).standard_normal((T, H)).astype(np.float32)
    jr = jrouting.RouterTopK(hidden_size=H, num_experts=E, top_k=K, act_fn=act_fn,
                             normalize_top_k_affinities=normalize)
    params = jr.init(jax.random.PRNGKey(1), x)
    want = jr.apply(params, x)
    tr = tmoe.RouterTopK(H, E, K, act_fn=act_fn, normalize_top_k_affinities=normalize,
                         device="cpu")
    with torch.no_grad():
        tr.weight.copy_(_k(nn.unbox(params)["params"]["weight"]))
        got = tr(_t(x))
    for name in ("logits", "probs", "top_w"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got.top_e.numpy(), np.asarray(want.top_e))
    if normalize and act_fn == "softmax":
        np.testing.assert_allclose(got.top_w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_router_sinkhorn_equals_jax_and_spreads_a_skewed_assignment():
    """Nearly identical tokens: plain top-1 collapses onto one expert, the
    Sinkhorn-balanced training assignment spreads them (JAX's test), and
    the port's balanced selection and affinities equal JAX's."""
    x = np.asarray(jnp.ones((64, H)) + 0.01 * jax.random.normal(jax.random.PRNGKey(3), (64, H)))
    jr = jrouting.RouterSinkhorn(hidden_size=H, num_experts=E, top_k=1)
    params = jr.init(jax.random.PRNGKey(1), x)
    tr = tmoe.RouterSinkhorn(H, E, 1, device="cpu")
    with torch.no_grad():
        tr.weight.copy_(_k(nn.unbox(params)["params"]["weight"]))
        got_eval, got_train = tr(_t(x), deterministic=True), tr(_t(x), deterministic=False)
    want_train = jr.apply(params, x, deterministic=False)
    np.testing.assert_array_equal(got_train.top_e.numpy(), np.asarray(want_train.top_e))
    np.testing.assert_allclose(got_train.top_w.numpy(), np.asarray(want_train.top_w), atol=ATOL)
    np.testing.assert_allclose(tr._sinkhorn(got_train.logits).numpy(),
                               np.asarray(jr.apply(params, jnp.asarray(want_train.logits),
                                                   method=lambda m, lg: m._sinkhorn(lg))),
                               rtol=1e-5, atol=1e-7)
    eval_counts = np.bincount(got_eval.top_e.numpy().ravel(), minlength=E)
    train_counts = np.bincount(got_train.top_e.numpy().ravel(), minlength=E)
    assert train_counts.max() < eval_counts.max()
    assert (train_counts > 0).sum() > (eval_counts > 0).sum()


def test_sinkhorn_large_logits_stay_finite():
    x = 30.0 * np.random.default_rng(0).standard_normal((T, H)).astype(np.float32)
    tr = tmoe.RouterSinkhorn(H, E, 1, device="cpu")
    with torch.no_grad():
        tr.weight.normal_(0.0, 1.0 / np.sqrt(H), generator=torch.Generator().manual_seed(0))
        out = tr(_t(x), deterministic=False)
    assert torch.isfinite(out.top_w).all() and ((out.top_e >= 0) & (out.top_e < E)).all()


def test_router_jitter_stays_in_range_and_only_when_not_deterministic():
    """The jitter draws U[1 - eps, 1 + eps] from the caller's generator
    (``jax.random`` cannot be reproduced): a deterministic call ignores it,
    a jittered call's logits are those of x times noise in that range, the
    same generator state gives the same logits."""
    eps = 0.1
    x = _t(np.random.default_rng(2).standard_normal((T, H)))
    tr = tmoe.RouterTopK(H, E, K, jitter_eps=eps, device="cpu")
    with torch.no_grad():
        tr.weight.normal_(0.0, 1.0 / np.sqrt(H), generator=torch.Generator().manual_seed(0))
        plain = tr(x, deterministic=True, generator=torch.Generator().manual_seed(5))
        np.testing.assert_array_equal(plain.logits.numpy(), (x @ tr.weight.t()).numpy())
        a = tr(x, deterministic=False, generator=torch.Generator().manual_seed(5))
        b = tr(x, deterministic=False, generator=torch.Generator().manual_seed(5))
        noise = torch.empty_like(x).uniform_(1 - eps, 1 + eps,
                                            generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.logits, b.logits) and not torch.equal(a.logits, plain.logits)
    assert float(noise.min()) >= 1 - eps and float(noise.max()) <= 1 + eps
    np.testing.assert_allclose(a.logits.numpy(), ((x * noise) @ tr.weight.t()).numpy(),
                               atol=1e-6)


# --- aux losses and the shuffle -------------------------------------------------

def test_aux_losses_equal_jax():
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((T, E))).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    top_e = np.argsort(-probs, -1)[:, :K].astype(np.int32)
    np.testing.assert_allclose(
        float(tmoe.load_balancing_loss_func(_t(probs), torch.from_numpy(top_e), E)),
        float(jmoe.load_balancing_loss_func(probs, top_e, E)), rtol=1e-6)
    from neuronx_distributed_tpu.modules.moe.loss_function import router_z_loss_func
    np.testing.assert_allclose(float(tmoe.router_z_loss_func(_t(logits))),
                               float(router_z_loss_func(logits)), rtol=1e-6)
    uniform = np.full((T, E), 1.0 / E, np.float32)
    spread = np.tile(np.arange(E), T // E * K).reshape(T, K)
    np.testing.assert_allclose(float(tmoe.load_balancing_loss_func(
        _t(uniform), torch.from_numpy(spread), E)), 1.0, rtol=1e-6)


def test_token_shuffle_roundtrip():
    x = _t(np.random.default_rng(4).standard_normal((T, H)))
    shuffled, perm = tmoe.shuffle_tokens(x, torch.Generator().manual_seed(1))
    assert not torch.equal(shuffled, x)
    assert torch.equal(tmoe.unshuffle_tokens(shuffled, perm), x)
    again, perm2 = tmoe.shuffle_tokens(x, torch.Generator().manual_seed(1))
    assert torch.equal(perm, perm2) and torch.equal(again, shuffled)


# --- expert strategies ----------------------------------------------------------

@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu"), (True, "relu")])
@pytest.mark.parametrize("strategy", ["selective", "all_experts", "blockwise"])
def test_strategy_equals_jax(strategy, glu, act):
    """Each dropless strategy equals JAX's same strategy on the same
    weights and routes."""
    jm, params, tm, (x, top_e, top_w) = _pair(strategy, glu=glu, act=act)
    want = np.asarray(jm.apply(params, x, top_e, top_w))
    np.testing.assert_allclose(_run(tm, x, top_e, top_w), want, atol=ATOL)


@pytest.mark.parametrize("glu", [True, False])
def test_selective_equals_all_experts_equals_blockwise(glu):
    """The port's dropless strategies agree with each other, as JAX's
    ``tests/modules/test_moe.py`` holds."""
    _, _, tm, (x, top_e, top_w) = _pair("all_experts", glu=glu)
    ref = _run(tm, x, top_e, top_w)
    for strategy in ("selective", "blockwise"):
        tm.strategy = strategy
        np.testing.assert_allclose(_run(tm, x, top_e, top_w), ref, atol=ATOL,
                                   err_msg=strategy)


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0, float(E)])
def test_capacity_factor_drops_jaxs_slots(cf):
    """The capacity strategy equals JAX's, dropping exactly its slots: a
    token whose slots all overflowed gets a zero row in both; with
    capacity >= T nothing drops and it equals all_experts."""
    jm, params, tm, (x, top_e, top_w) = _pair("capacity_factor", capacity_factor=cf)
    want = np.asarray(jm.apply(params, x, top_e, top_w))
    got = _run(tm, x, top_e, top_w)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert tm.capacity(T) == jm.capacity(T)
    np.testing.assert_array_equal(np.abs(got).sum(-1) == 0, np.abs(want).sum(-1) == 0)
    tm.strategy = "all_experts"
    ref = _run(tm, x, top_e, top_w)
    if cf >= E:
        np.testing.assert_allclose(got, ref, atol=ATOL)
    else:
        assert not np.allclose(got, ref)


@pytest.mark.parametrize("num_experts,n_tokens,cf,strategy", [
    (8, 256, None, "blockwise"), (8, 4, None, "selective"), (8, 8, None, "selective"),
    (8, 9, None, "blockwise"), (4, 256, None, "all_experts"), (4, 256, 2.0, "capacity_factor"),
    (8, 16, 2.0, "capacity_factor"), (4, 1, 2.0, "selective")])
def test_auto_policy_equals_jax(num_experts, n_tokens, cf, strategy):
    jm = jmoe.ExpertMLPs(num_experts=num_experts, hidden_size=H, intermediate_size=I, top_k=K,
                         capacity_factor=cf, strategy="auto")
    tm = texp.ExpertMLPs(num_experts, H, I, top_k=K, capacity_factor=cf, device="cpu")
    assert tm.resolve_strategy(n_tokens) == jm._resolve_strategy(n_tokens) == strategy


def test_blockwise_group_sizes_come_from_the_device():
    """The blockwise dispatch: the pairs in stable expert order and each
    expert's end offset (an expert no pair routes to gets an empty group),
    with no ``bincount``."""
    top_e = torch.tensor([[2, 0], [2, 3], [0, 2]])
    order, offs = texp.expert_groups(top_e, 5)
    assert order.tolist() == [1, 4, 0, 2, 5, 3]
    assert offs.dtype == torch.int32 and offs.tolist() == [2, 2, 5, 6, 6]


def test_expert_parallel_raises_for_item_9():
    with pytest.raises(NotImplementedError, match="item 9"):
        texp.ExpertMLPs(E, H, I, ep=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        texp.ExpertMLPs(E, H, I, tp=2, device="cpu")


def test_selective_route_on_cuda_needs_swiglu():
    """MX computes SwiGLU experts only: the wrapper raises for another
    activation on a CUDA tensor before it reaches the card (here: the
    ``meta`` device stands in for a non-CPU tensor)."""
    x = torch.empty(2, H, device="meta")
    stack = torch.empty(E, I, H, device="meta")
    with pytest.raises(ValueError, match="SwiGLU"):
        tmx.moe_experts(x, torch.zeros(2, K, dtype=torch.long, device="meta"),
                        torch.empty(2, K, device="meta"), stack, stack,
                        torch.empty(E, H, I, device="meta"), act="gelu")


def test_expert_fused_layers_equal_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((E, 8, H)).astype(np.float32)
    col = jmoe.ExpertFusedColumnParallelLinear(num_experts=E, input_size=H, output_size=I)
    pc = col.init(jax.random.PRNGKey(1), x)
    y = np.asarray(col.apply(pc, x))
    row = jmoe.ExpertFusedRowParallelLinear(num_experts=E, input_size=I, output_size=H)
    pr = row.init(jax.random.PRNGKey(2), y)
    z = np.asarray(row.apply(pr, y))
    tcol = tmoe.ExpertFusedColumnParallelLinear(E, H, I, device="cpu")
    trow = tmoe.ExpertFusedRowParallelLinear(E, I, H, device="cpu")
    with torch.no_grad():
        tcol.weight.copy_(_k(nn.unbox(pc)["params"]["kernel"]))
        trow.weight.copy_(_k(nn.unbox(pr)["params"]["kernel"]))
        ty = tcol(_t(x))
        tz = trow(ty)
    assert tuple(ty.shape) == (E, 8, I) and tuple(tz.shape) == (E, 8, H)
    np.testing.assert_allclose(ty.numpy(), y, atol=ATOL)
    np.testing.assert_allclose(tz.numpy(), z, atol=ATOL)


# --- the MoE layer --------------------------------------------------------------

def _moe_pair(**kw):
    x = np.random.default_rng(6).standard_normal((4, 8, H)).astype(np.float32)
    jl = jmoe.MoE(num_experts=E, hidden_size=H, intermediate_size=I, top_k=K,
                  dtype=jnp.float32, **kw)
    params = nn.unbox(jl.init(jax.random.PRNGKey(1), x))
    tl = tmoe.MoE(E, H, I, top_k=K, device="cpu", **kw)
    p = params["params"]
    with torch.no_grad():
        tl.router.weight.copy_(_k(p["router"]["weight"]))
        for name in ("gate_proj", "up_proj", "down_proj"):
            getattr(tl.experts, name).copy_(_k(p["experts"][name]))
    return jl, params, tl, x


@pytest.mark.parametrize("kw", [{}, {"capacity_factor": 2.0}, {"capacity_factor": 0.5},
                                {"expert_strategy": "blockwise"}])
def test_moe_layer_equals_jax(kw):
    """``(out, aux)`` of the MoE layer, deterministic."""
    jl, params, tl, x = _moe_pair(**kw)
    want, want_aux = jl.apply(params, x)
    with torch.no_grad():
        got, aux = tl(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for name in ("load_balancing_loss", "router_z_loss"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]), rtol=1e-5,
                                   err_msg=name)


def test_moe_layer_shuffles_only_when_not_deterministic():
    """With ``token_shuffle`` the tokens are permuted and restored only
    when not deterministic; the dropless result is the unshuffled one's."""
    _, _, tl, x = _moe_pair(token_shuffle=True)
    with torch.no_grad():
        ref, ref_aux = tl(_t(x), deterministic=True)
        got, aux = tl(_t(x), deterministic=False, generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)
    np.testing.assert_allclose(float(aux["load_balancing_loss"]),
                               float(ref_aux["load_balancing_loss"]), rtol=1e-5)
