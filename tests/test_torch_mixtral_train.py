"""Mixtral training in the port against the JAX package (CPU, fp32,
``tiny_mixtral``), and the port's own training invariants where JAX's
draws cannot be reproduced.

Both sides start from one flax init (``mixtral_flax_to_torch`` gives the
port's fp32 masters) and see the same numpy batches; JAX runs
``attention_impl="xla"``, the port its plain versions (CPU tensors).
``tiny_mixtral`` has 4 experts, where the auto policy takes
``all_experts``, so each case forces its expert strategy, as JAX's matrix
does. Tolerances (``tests/test_torch_train.py``'s): step-1 gradients per
leaf 1e-6 + 1e-5 x the leaf's largest entry (the same fp32 math summed in
another order); three steps' losses 2e-6 relative. The router jitter and the
token shuffle draw from ``jax.random`` there and from a ``torch.Generator``
here, so the stochastic cases (remat, resume, the canary) are held inside
the port, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.models import mixtral as jmixtral
from neuronx_distributed_tpu.modules.moe import MoE as JMoE
from neuronx_distributed_tpu.parallel import mesh as mesh_lib
from neuronx_distributed_tpu.trainer import trainer as jtrainer
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig, generate
from neuronx_distributed_tpu_torch.integrity import SentinelConfig
from neuronx_distributed_tpu_torch.kernels.tree_fingerprint import tree_fingerprint_plain
from neuronx_distributed_tpu_torch.models import mixtral as tmixtral
from neuronx_distributed_tpu_torch.models.convert import mixtral_flax_to_torch
from neuronx_distributed_tpu_torch.modules.moe import MoE
from neuronx_distributed_tpu_torch.modules.moe import expert_mlps as texperts
from neuronx_distributed_tpu_torch.modules.moe.expert_mlps import ExpertMLPs, blockwise
from neuronx_distributed_tpu_torch.observability.programs import CostMeter, _grouped_mm_flops
from neuronx_distributed_tpu_torch.parallel.losses import parallel_cross_entropy
from neuronx_distributed_tpu_torch.trainer import checkpoint as tcheckpoint
from neuronx_distributed_tpu_torch.trainer import faults as tfaults
from neuronx_distributed_tpu_torch.trainer import loop as tloop
from neuronx_distributed_tpu_torch.trainer import trainer as ttrainer

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, S = 4, 16
LR = 1e-3
LOSS_RTOL = 2e-6
# the stochastic training features, on for every in-port case
STOCHASTIC = dict(router_jitter_eps=0.01, token_shuffle=True, expert_strategy="blockwise")
CASES = {
    "blockwise": dict(expert_strategy="blockwise"),
    "capacity_2.0": dict(expert_strategy="capacity_factor", capacity_factor=2.0),
    "capacity_0.5": dict(expert_strategy="capacity_factor", capacity_factor=0.5),
    "all_experts": dict(expert_strategy="all_experts"),
    "z_loss": dict(expert_strategy="blockwise", router_z_loss_coef=1e-2),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(seed=1, **over):
    jcfg = jmixtral.tiny_mixtral(**over)
    jmodel = jmixtral.MixtralForCausalLM(jcfg, attention_impl="xla")
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32)))
    return jmodel, {"params": params["params"]}


def _port_model(params, **over):
    tmodel = tmixtral.MixtralForCausalLM(tmixtral.tiny_mixtral(**over), device="cpu",
                                         trainable=True)
    tmodel.load_state_dict(mixtral_flax_to_torch(_np_tree(params), tmodel.config))
    return tmodel


def _batch(seed=0, b=B, s=S):
    ids = np.random.default_rng(seed).integers(1, 256, size=(b, s + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _tloss(model, **kw):
    def loss_fn(batch, generator):
        return model.loss(batch["input_ids"], batch["labels"], segment_ids=batch.get("segment_ids"),
                          loss_mask=batch.get("loss_mask"), generator=generator, **kw)
    return loss_fn


def _grads_equal(jgrads, tmodel, what):
    sd = mixtral_flax_to_torch(_np_tree(jgrads), tmodel.config)
    got = dict(tmodel.named_parameters())
    assert sorted(sd) == sorted(got)
    for name, g in sd.items():
        g = g.numpy()
        np.testing.assert_allclose(got[name].grad.numpy(), g, rtol=0,
                                   atol=1e-6 + 1e-5 * float(np.abs(g).max()),
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_step1_grads_equal_jax(case):
    """``jax.grad`` of ``model.loss`` against the port's backward of
    ``loss``, leaf by leaf, on every expert route (the capacity route at a
    dropping 0.5 too) and with a z-loss weight above 0."""
    over = CASES[case]
    jmodel, params = _jax_params(**over)
    tmodel = _port_model(params, **over)
    b = _batch()
    ids, labels = jnp.asarray(b["input_ids"]), jnp.asarray(b["labels"])
    want, jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, ids, labels))(params)
    loss = tmodel.loss(torch.from_numpy(b["input_ids"]).long(),
                       torch.from_numpy(b["labels"]).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=LOSS_RTOL)
    _grads_equal(jgrads, tmodel, case)
    if case == "capacity_0.5":
        experts = tmodel.model.layers[0].moe.experts
        assert experts.capacity(B * S) < B * S * 2 // 4  # a full share drops slots


@pytest.mark.parametrize("case", ["blockwise", "capacity_0.5"])
def test_three_steps_equal_jax_build_train_step(case):
    """Three steps of JAX's ``build_train_step(loss_fn=model.loss)`` with
    ``OptimizerConfig(zero1=False)`` on one device against the port's
    ``build_train_step`` on ``loss``: the losses and pre-clip grad norms."""
    over = CASES[case]
    jmodel, params = _jax_params(**over)
    tmodel = _port_model(params, **over)  # before the JAX step consumes (donates) params
    batches = [_batch(i) for i in range(3)]
    mesh_lib.initialize_model_parallel(tensor_model_parallel_size=1, devices=jax.devices()[:1])
    opt_cfg = jtrainer.OptimizerConfig(learning_rate=LR, zero1=False)
    optimizer = jtrainer.make_optimizer(opt_cfg)
    state, p_sh, s_sh = jtrainer.create_train_state(
        jmodel, optimizer, jax.random.PRNGKey(0), jnp.asarray(batches[0]["input_ids"]),
        zero1=False)
    state = state.replace(params=jax.device_put(params, p_sh))
    step = jtrainer.build_train_step(
        jmodel, optimizer, p_sh, s_sh, max_grad_norm=opt_cfg.max_grad_norm,
        loss_fn=lambda p, b: jmodel.loss(p, b["input_ids"], b["labels"]))
    want = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(m["loss"]), float(m["grad_norm"])))

    topt = ttrainer.make_optimizer(ttrainer.OptimizerConfig(learning_rate=LR))
    tstate = ttrainer.TrainState(step=0, params=tmodel, opt_state=topt.init(
        [p for p in tmodel.parameters() if p.requires_grad]))
    tstep = ttrainer.build_train_step(tmodel, topt, max_grad_norm=opt_cfg.max_grad_norm,
                                      loss_fn=_tloss(tmodel))
    got = []
    for b in batches:
        tstate, m = tstep(tstate, b)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=LOSS_RTOL, atol=0)


def _jmoe_params(params):
    """A JAX MoE layer's params as the port's ``MoE`` state dict."""
    p = _np_tree(params)["params"]
    sd = {"router.weight": torch.from_numpy(np.ascontiguousarray(p["router"]["weight"].T))}
    for key in ("gate_proj", "up_proj", "down_proj"):
        sd[f"experts.{key}"] = torch.from_numpy(
            np.ascontiguousarray(np.swapaxes(p["experts"][key], -1, -2)))
    return sd


@pytest.mark.parametrize("router,strategy,tokens", [
    ("top_k", "blockwise", (4, 8)), ("sinkhorn", "blockwise", (4, 8)),
    ("sinkhorn", "capacity_factor", (4, 8)), ("top_k", "selective", (1, 8))])
def test_moe_layer_value_and_grad_equal_jax(router, strategy, tokens):
    """The MoE layer's train path (JAX ``test_moe.py:257``): ``out.sum()``
    plus both weighted aux losses, differentiated with
    ``deterministic=False`` (the Sinkhorn router balances the assignment
    only then; no jitter or shuffle, so JAX's draws are not needed), on
    the top-k and Sinkhorn routers and the selective route (on the CPU the
    plain einsums differentiate, as JAX's)."""
    e, h, i = 4, 64, 96
    kw = dict(num_experts=e, hidden_size=h, intermediate_size=i, top_k=2, router_kind=router,
              expert_strategy=strategy, capacity_factor=1.0 if strategy == "capacity_factor"
              else None)
    jlayer = JMoE(**kw, dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal(tokens + (h,)).astype(np.float32)
    params = nn.unbox(jlayer.init(jax.random.PRNGKey(1), jnp.asarray(x)))

    def jloss(p, xin):
        out, aux = jlayer.apply(p, xin, deterministic=False)
        return out.sum() + 0.01 * aux["load_balancing_loss"] + 0.01 * aux["router_z_loss"]

    want, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    layer = MoE(e, h, i, top_k=2, router_kind=router, expert_strategy=strategy,
                capacity_factor=kw["capacity_factor"], device="cpu", trainable=True)
    layer.load_state_dict(_jmoe_params(params))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = layer(tx, deterministic=False)
    loss = out.sum() + 0.01 * aux["load_balancing_loss"] + 0.01 * aux["router_z_loss"]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    for name, g in _jmoe_params(jg).items():
        g = g.numpy()
        np.testing.assert_allclose(grads[name], g, rtol=0,
                                   atol=1e-6 + 1e-5 * float(np.abs(g).max()), err_msg=name)
    gx = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), gx, rtol=0, atol=1e-6 + 1e-5 * np.abs(gx).max())


def test_moe_layer_token_shuffle_training_path():
    """JAX ``test_moe.py:284``: the shuffle and the jitter under
    ``deterministic=False`` give a finite output of the input's shape and a
    finite, non-zero gradient to every weight; without jitter the shuffled
    layer's output is the unshuffled one's (the unshuffle puts each token
    back where it came from)."""
    e, h, i = 4, 64, 96

    def run(jitter, shuffle):
        layer = MoE(e, h, i, top_k=2, router_jitter_eps=jitter, token_shuffle=shuffle,
                    expert_strategy="blockwise", device="cpu", trainable=True)
        gen = torch.Generator().manual_seed(3)
        layer.load_state_dict({n: torch.randn(t.shape, generator=gen) * 0.1
                               for n, t in layer.state_dict().items()})
        x = torch.randn(4, 8, h, generator=torch.Generator().manual_seed(0))
        y, aux = layer(x, deterministic=False, generator=torch.Generator().manual_seed(7))
        (y.sum() + aux["load_balancing_loss"]).backward()
        return layer, x, y

    layer, x, y = run(0.01, True)
    assert y.shape == x.shape and torch.isfinite(y).all()
    for name, p in layer.named_parameters():
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name
    torch.testing.assert_close(run(0.0, True)[2], run(0.0, False)[2], rtol=1e-6, atol=1e-6)


def test_capacity_dropped_slots_get_no_gradient():
    """A slot the capacity route drops contributes nothing forward and gets
    no gradient: its affinity's gradient is 0, and a token whose slots all
    drop gets a zero input gradient."""
    torch.manual_seed(0)
    m = ExpertMLPs(4, 64, 96, capacity_factor=0.25, strategy="capacity_factor", device="cpu",
                   trainable=True)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.1)
    t = 16
    x = torch.randn(t, 64, requires_grad=True)
    top_e = torch.zeros(t, 2, dtype=torch.long)
    top_e[:, 1] = 1  # every token on experts 0 and 1: capacity 2 keeps tokens 0 and 1
    top_w = torch.full((t, 2), 0.5, requires_grad=True)
    assert m.capacity(t) == 2
    m(x, top_e, top_w).sum().backward()
    assert x.grad[2:].abs().max() == 0 and (x.grad[:2].abs().amax(-1) > 0).all()
    assert top_w.grad[2:].abs().max() == 0 and (top_w.grad[:2].abs() > 0).all()
    assert m.gate_proj.grad[2:].abs().max() == 0  # untouched experts


def test_blockwise_backward_equals_per_expert_matmuls():
    """The blockwise route's backward (``torch._grouped_mm``'s, the weight
    gradient a product grouped along the pairs) against a per-expert
    ``torch.matmul`` loop, from a ``.sum()``: the stride-0 gradient of the
    sum meets the combine einsum, never a grouped product."""
    torch.manual_seed(0)
    e, h, i, t, k = 4, 64, 96, 24, 2
    ws = [torch.randn(e, i, h) * 0.1, torch.randn(e, i, h) * 0.1, torch.randn(e, h, i) * 0.1]
    x = torch.randn(t, h)
    top_e = torch.stack([torch.randperm(e)[:k] for _ in range(t)])
    top_w = torch.rand(t, k)

    def loop(x, gate, up, down):
        out = torch.zeros(t, h)
        for j in range(k):
            for ex in range(e):
                rows = top_e[:, j] == ex
                a = x[rows]
                y = (torch.nn.functional.silu(a @ gate[ex].t()) * (a @ up[ex].t())) @ down[ex].t()
                out = out.index_add(0, rows.nonzero()[:, 0], y * top_w[rows, j:j + 1])
        return out

    grads = []
    for fn in (lambda *a: blockwise(a[0], top_e, top_w, *a[1:], e), loop):
        leaves = [x.clone().requires_grad_(True)] + [w.clone().requires_grad_(True) for w in ws]
        fn(*leaves).sum().backward()
        grads.append([p.grad for p in leaves])
    for name, a, b in zip(("x", "gate", "up", "down"), *grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


def test_grouped_mm_flops_count_each_form():
    """``torch._grouped_mm``'s FLOPs in its three forms: grouped along the
    rows (the route's products and their input gradients), grouped along
    the contraction (the weight gradients: 2 x M x N x K, not E times it),
    batched; and a metered blockwise forward and backward counts its
    grouped products three times the forward's."""
    a, w = torch.zeros(10, 8), torch.zeros(3, 8, 12)
    assert _grouped_mm_flops(a, w, out_val=torch.zeros(10, 12)) == 2 * 10 * 8 * 12
    assert _grouped_mm_flops(torch.zeros(12, 10), a, out_val=torch.zeros(3, 12, 8)) == \
        2 * 12 * 10 * 8
    assert _grouped_mm_flops(torch.zeros(3, 5, 8), w, out_val=torch.zeros(3, 5, 12)) == \
        2 * 8 * 3 * 5 * 12
    m = ExpertMLPs(4, 64, 96, strategy="blockwise", device="cpu", trainable=True)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.1)
    t = 16
    top_e = torch.stack([torch.arange(t) % 4, (torch.arange(t) + 1) % 4], 1)
    x, top_w = torch.randn(t, 64, requires_grad=True), torch.rand(t, 2)
    combine = 2 * t * 2 * 64  # the slot combine einsum, forward
    with CostMeter() as fwd:
        m(x, top_e, top_w)
    with CostMeter() as both:
        m(x, top_e, top_w).sum().backward()
    grouped = fwd.flops - combine
    assert grouped == 3 * 2 * (t * 2) * 64 * 96
    assert both.flops - 2 * combine == 3 * grouped


def test_packed_loss_equals_unpacked_documents_and_jax():
    """JAX ``test_packed_segments.py:147``: a packed window's loss (aux
    weights 0) is the per-document losses' mean, and equals JAX's packed
    loss."""
    from neuronx_distributed_tpu_torch.trainer.data import pack_documents

    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 256, size=n).astype(np.int32) for n in (10, 8, 7)]
    windows, segs = pack_documents(docs, 24, return_segments=True)
    over = dict(max_seq_len=64, router_aux_loss_coef=0.0, router_z_loss_coef=0.0,
                expert_strategy="blockwise")
    jmodel, params = _jax_params(seed=0, **over)
    tmodel = _port_model(params, **over)
    mask = (segs[:, :-1] == segs[:, 1:]).astype(np.float32)
    want = float(jmodel.loss(params, jnp.asarray(windows[:, :-1]), jnp.asarray(windows[:, 1:]),
                             segment_ids=jnp.asarray(segs[:, :-1]), loss_mask=jnp.asarray(mask)))
    with torch.no_grad():
        packed = float(tmodel.loss(torch.from_numpy(windows[:, :-1]).long(),
                                   torch.from_numpy(windows[:, 1:]).long(),
                                   segment_ids=torch.from_numpy(segs[:, :-1]).int(),
                                   loss_mask=torch.from_numpy(mask)))
        toks = []
        for d in docs:
            logits, _ = tmodel(torch.from_numpy(d[None, :-1]).long())
            toks.append(parallel_cross_entropy(logits, torch.from_numpy(d[None, 1:]).long())[0])
    np.testing.assert_allclose(packed, float(torch.cat(toks).mean()), rtol=2e-5)
    np.testing.assert_allclose(packed, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("policy", [None, "dots", "dots_saveable"])
def test_remat_equals_no_remat_with_jitter_and_shuffle(policy):
    """Remat replays each layer's jitter and permutation (JAX
    ``test_remat_with_training_mode_features``): the loss, every gradient
    and the generator's end state equal the run without remat bit for
    bit, under every remat policy."""
    _, params = _jax_params(**STOCHASTIC)
    runs = []
    for remat in (False, True):
        tmodel = _port_model(params, remat=remat, remat_policy=policy, **STOCHASTIC)
        g = torch.Generator().manual_seed(11)
        b = _batch()
        loss = tmodel.loss(torch.from_numpy(b["input_ids"]).long(),
                           torch.from_numpy(b["labels"]).long(), deterministic=False, generator=g)
        loss.backward()
        runs.append((loss.detach(), [p.grad for p in tmodel.parameters()], g.get_state()))
    (la, ga, sa), (lb, gb, sb) = runs
    assert torch.equal(la, lb) and torch.equal(sa, sb)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


class _Source:
    """Batches from a seed with the ``state()``/``restore()`` cursor the
    loop's exact resume reads."""

    def __init__(self):
        self.i = 0

    def state(self):
        return {"batch": self.i}

    def restore(self, st):
        self.i = int(st["batch"])

    def __iter__(self):
        while True:
            b = _batch(100 + self.i)
            self.i += 1
            yield b


def _fit(**kw):
    model = tmixtral.MixtralForCausalLM(tmixtral.tiny_mixtral(remat=True, **STOCHASTIC),
                                        device="cpu", trainable=True)
    losses = []

    class Rec(tloop.Callback):
        def on_step_end(self, trainer, metrics):
            losses.append(float(metrics["loss"]))

    tr = tloop.Trainer(model=model, loss_fn=_tloss(model, deterministic=False),
                       callbacks=[Rec(), *kw.pop("callbacks", ())],
                       optimizer_config=ttrainer.OptimizerConfig(learning_rate=LR), **kw)
    return tr, losses


def _state(tr):
    return [t.detach().clone() for t in tr._state_leaves()]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_fit_resumed_from_step_2_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    """``Trainer.fit`` with jitter and shuffle on: a fit resumed from
    ``step_2`` draws the uninterrupted run's jitter and permutations, so its
    losses and final state equal that run's bit for bit. The shard size is
    cut below one expert stack, which then fills a shard alone (as an
    8x7B stack of 1.88 GB does under the 1 GiB shard)."""
    monkeypatch.setattr(tcheckpoint, "SHARD_BYTES", 64 << 10)
    ref, ref_losses = _fit()
    ref.fit(_Source(), 5, max_steps=6)
    d = str(tmp_path / "ckpt")
    first, first_losses = _fit(callbacks=[tloop.CheckpointCallback(d, every=2, async_save=False)])
    first.fit(_Source(), 5, max_steps=2)
    stack = first.model.model.layers[0].moe.experts.gate_proj
    assert stack.numel() * stack.element_size() > tcheckpoint.SHARD_BYTES
    resumed, resumed_losses = _fit()
    resumed.fit(_Source(), 99, max_steps=6, resume_from=d)
    assert resumed.steps_run == 4
    assert first_losses + resumed_losses == ref_losses
    assert _same(_state(resumed), _state(ref))
    g_ref, g_res = ref.step_rng(), resumed.step_rng()
    assert g_ref.initial_seed() == g_res.initial_seed() == ttrainer.step_seed(5, 6)


def test_canary_no_false_positive_with_jitter_and_shuffle_and_convicts_a_flip():
    """The canary re-runs a check step from the same state with a generator
    made afresh from (seed, step): every check of a clean run agrees, and
    the run's losses and state equal a sentinel-free run's; a params flip
    at a check step is convicted and rolled back to the same final bits."""
    clean, clean_losses = _fit()
    clean.fit(_Source(), 0, max_steps=8)
    runs = {}
    for name, inj in (("canary", None),
                      ("flip", tfaults.FaultInjector().flip_bits("params", at=7))):
        tr, losses = _fit(integrity=SentinelConfig(check_every=4), fault_injector=inj)
        tr.fit(_Source(), 0, max_steps=8)
        runs[name] = (tr, losses)
    tr, losses = runs["canary"]
    assert tr._sentinel.counters == {"integrity_checks": 2, "sdc_detected": 0,
                                     "sdc_unlocalized": 0, "sdc_rollbacks": 0}
    assert losses == clean_losses and _same(_state(tr), _state(clean))
    tr, _ = runs["flip"]
    assert (tr._sentinel.counters["sdc_detected"], tr._sentinel.counters["sdc_rollbacks"]) == (1, 1)
    assert _same(_state(tr), _state(clean))


def test_train_step_hands_the_loss_a_fresh_step_generator():
    """``build_train_step`` gives a ``loss_fn`` with a ``generator``
    parameter one made from (seed, ``state.step``) on the model's device,
    afresh each call: a step re-run from a copy of the state draws the
    same and gives the same bits."""
    model = tmixtral.init_params(tmixtral.MixtralForCausalLM(
        tmixtral.tiny_mixtral(**STOCHASTIC), device="cpu", trainable=True), seed=0)
    seen = []
    inner = _tloss(model, deterministic=False)

    def loss_fn(batch, generator):
        seen.append((generator.initial_seed(), generator.device))
        return inner(batch, generator)

    opt = ttrainer.make_optimizer(ttrainer.OptimizerConfig(learning_rate=LR))
    state = ttrainer.TrainState(step=3, params=model, opt_state=opt.init(
        [p for p in model.parameters() if p.requires_grad]))
    step = ttrainer.build_train_step(model, opt, loss_fn=loss_fn, seed=7)
    saved = [t.detach().clone() for t in model.parameters()]
    saved_opt = {k: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
                 for k, v in state.opt_state.items()}
    step(state, _batch())
    after = [t.detach().clone() for t in model.parameters()]
    with torch.no_grad():
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    state.opt_state, state.step = saved_opt, 3
    step(state, _batch())
    assert seen == [(ttrainer.step_seed(7, 3), torch.device("cpu"))] * 2
    assert all(torch.equal(a, p) for a, p in zip(after, model.parameters()))
    assert tree_fingerprint_plain(after) == tree_fingerprint_plain(list(model.parameters()))


def test_default_loss_fn_raises_and_create_train_state_fills_masters():
    """``default_loss_fn`` on a Mixtral raises JAX's ``TypeError`` (its
    objective is ``model.loss``); ``create_train_state`` fills a trainable
    Mixtral's fp32 masters with Mixtral's ``init_params`` (the expert
    stacks and routers drawn, which Llama's would leave zero)."""
    model = tmixtral.MixtralForCausalLM(tmixtral.tiny_mixtral(), device="cpu", trainable=True)
    with pytest.raises(TypeError, match="model.loss"):
        ttrainer.default_loss_fn(model, ttrainer._to_device(_batch(), "cpu"))
    opt = ttrainer.make_optimizer(ttrainer.OptimizerConfig())
    state = ttrainer.create_train_state(model, opt, seed=4)
    ref = tmixtral.init_params(tmixtral.MixtralForCausalLM(
        tmixtral.tiny_mixtral(), device="cpu", trainable=True), seed=4)
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        assert p.dtype == torch.float32 and p.requires_grad, name
        assert torch.equal(p, q), name
    assert model.model.layers[0].moe.experts.down_proj.abs().max() > 0
    assert len(state.opt_state["mu"]) == len(list(model.parameters()))


def test_selective_serves_trainable_stacks_in_the_compute_dtype(monkeypatch):
    """The selective route hands MX a trainable model's fp32 masters cast
    to the compute dtype, as the other routes cast them (MX takes bf16
    stacks); on the CPU it differentiates (its plain einsums) and equals
    the all-experts route's gradients."""
    seen = []
    real = texperts.moe_experts

    def spy(x, top_e, top_w, gate, up, down, **kw):
        seen.append((x.dtype, gate.dtype, up.dtype, down.dtype))
        return real(x, top_e, top_w, gate, up, down, **kw)

    monkeypatch.setattr(texperts, "moe_experts", spy)
    m = ExpertMLPs(4, 64, 96, strategy="selective", dtype=torch.bfloat16, device="cpu",
                   trainable=True)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.1)
    top_e = torch.tensor([[0, 1], [2, 3], [1, 2], [3, 0]])
    m(torch.randn(4, 64), top_e, torch.rand(4, 2))
    assert seen == [(torch.bfloat16,) * 4] and m.gate_proj.dtype == torch.float32
    grads = {}
    for strategy in ("selective", "all_experts"):
        m.strategy = strategy
        m.zero_grad(set_to_none=True)
        m.dtype = torch.float32
        m(torch.randn(4, 64, generator=torch.Generator().manual_seed(0)), top_e,
          torch.full((4, 2), 0.5)).sum().backward()
        grads[strategy] = [p.grad.clone() for p in m.parameters()]
    for a, b in zip(grads["selective"], grads["all_experts"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_generate_on_a_trainable_mixtral_equals_the_frozen_one():
    """A trainable Mixtral decodes (its selective route on cast stacks) the
    frozen model's greedy tokens, with the same weights."""
    _, params = _jax_params()
    trained = _port_model(params)
    frozen = tmixtral.MixtralForCausalLM(tmixtral.tiny_mixtral(), device="cpu")
    frozen.load_state_dict(mixtral_flax_to_torch(_np_tree(params), frozen.config))
    prompt = torch.tensor([[5, 17, 33, 2, 9]])
    cfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    with torch.no_grad():
        a = generate(trained, prompt, cfg)
        b = generate(frozen, prompt, cfg)
    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_mixtral_flax_to_torch_maps_gradient_trees():
    """A JAX gradient tree maps leaf by leaf onto the port's parameter
    names and shapes (the comparisons above read it so)."""
    jmodel, params = _jax_params()
    b = _batch()
    grads = jax.grad(lambda p: jmodel.loss(p, jnp.asarray(b["input_ids"]),
                                           jnp.asarray(b["labels"])))(params)
    model = _port_model(params)
    sd = mixtral_flax_to_torch(_np_tree(grads), model.config)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {n: tuple(t.shape) for n, t in sd.items()} == shapes
    assert all(t.dtype == torch.float32 for t in sd.values())
