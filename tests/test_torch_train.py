"""The port's train step against the JAX ``build_train_step`` on tiny_llama
(CPU, fp32), and the port's own training invariants.

Both sides start from one flax init (``flax_to_torch`` gives the port's fp32
masters) and see the same numpy batches. The JAX step runs on the test
harness's 8-device virtual mesh at tp=1 (dp=8, so batches hold 8 rows),
with ``attention_impl="xla"``; the port runs its plain attention versions
(CPU tensors). Tolerances:

* step-1 gradients, per leaf: 1e-5 relative to the leaf's largest entry
  plus 1e-6 absolute — the same fp32 math, summed in another order by XLA
  and by PyTorch (~1e-7 relative per op, a few hundred ops deep);
* per-step loss and pre-clip grad norm over 5 steps: 2e-6 relative (the
  runs agree to ~2e-7; AdamW divides by sqrt(nu), so an element whose
  gradient is ~0 can move on either side's rounding noise, and the
  parameters, and through them the later losses, drift slowly apart);
* parameters after 5 steps: at most 5·lr apart anywhere (an element moves
  by at most ~lr per step, so a sign flip of a ~0 gradient costs at most
  that), and 1e-4·lr in the mean absolute difference (measured ~1e-5·lr),
  which only a systematic error can exceed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.models import llama as jllama
from neuronx_distributed_tpu.trainer import data as jdata
from neuronx_distributed_tpu.trainer import trainer as jtrainer
from neuronx_distributed_tpu_torch.models import llama as tllama
from neuronx_distributed_tpu_torch.models.convert import flax_to_torch
from neuronx_distributed_tpu_torch.trainer import data as tdata
from neuronx_distributed_tpu_torch.trainer import trainer as ttrainer

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LR = 1e-3
STEPS = 5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _synthetic_batches(n, seq=16):
    it = iter(tdata.SyntheticTokens(256, 8, seq, seed=3))
    return [next(it) for _ in range(n)]


def _packed_batches(n, seq=16):
    """Packed windows of 3..20-token documents with an EOS separator:
    segment_ids, loss_mask and per-document RoPE positions."""
    rng = np.random.default_rng(4)
    docs = [rng.integers(1, 255, size=rng.integers(3, 21)) for _ in range(200)]
    windows, segs = tdata.pack_documents(docs, seq, eos_token_id=255, return_segments=True)
    out = []
    for i in range(n):
        w, s = windows[8 * i: 8 * i + 8], segs[8 * i: 8 * i + 8]
        out.append({"input_ids": w[:, :-1], "labels": w[:, 1:], "segment_ids": s[:, :-1],
                    "loss_mask": (s[:, :-1] == s[:, 1:]).astype(np.float32)})
    return out


def _jax_run(params, batches, opt_cfg):
    cfg = jtrainer.neuronx_distributed_tpu_config(tensor_parallel_size=1, optimizer=opt_cfg)
    model = jllama.LlamaForCausalLM(jllama.tiny_llama(), attention_impl="xla")
    optimizer = jtrainer.make_optimizer(cfg.optimizer)
    ids = jnp.asarray(batches[0]["input_ids"])
    state, p_sh, s_sh = jtrainer.create_train_state(model, optimizer, jax.random.PRNGKey(0),
                                                    ids, zero1=False)
    state = state.replace(params=jax.device_put(params, p_sh))
    grads0 = jax.grad(lambda p: jtrainer.default_loss_fn(model, p, {
        k: jnp.asarray(v) for k, v in batches[0].items()}))(params)
    step = jtrainer.build_train_step(model, optimizer, p_sh, s_sh,
                                     max_grad_norm=opt_cfg.max_grad_norm)
    metrics = []
    for b in batches:
        state, m = step(state, jtrainer.shard_batch({k: jnp.asarray(v) for k, v in b.items()}))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, _np_tree(grads0), _np_tree(state.params)


def _port_model(params):
    model = tllama.LlamaForCausalLM(tllama.tiny_llama(), device="cpu", trainable=True)
    model.load_state_dict(flax_to_torch(params, model.config))
    return model


def _port_run(params, batches, opt_cfg, **model_over):
    model = tllama.LlamaForCausalLM(tllama.tiny_llama(**model_over), device="cpu",
                                    trainable=True)
    optimizer = ttrainer.make_optimizer(opt_cfg)
    state = ttrainer.create_train_state(model, optimizer, seed=0)
    model.load_state_dict(flax_to_torch(params, model.config))
    ttrainer.default_loss_fn(model, ttrainer._to_device(batches[0], "cpu")).backward()
    grads0 = {n: p.grad.clone() for n, p in model.named_parameters()}
    step = ttrainer.build_train_step(model, optimizer, max_grad_norm=opt_cfg.max_grad_norm)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, grads0, model


@pytest.fixture(scope="module")
def flax_params():
    model = jllama.LlamaForCausalLM(jllama.tiny_llama(), attention_impl="xla")
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32)))
    return _np_tree({"params": params["params"]})


@pytest.mark.parametrize("kind", ["synthetic", "packed"])
def test_train_steps_match_jax(flax_params, kind):
    batches = (_synthetic_batches if kind == "synthetic" else _packed_batches)(STEPS)
    opt_cfg = jtrainer.OptimizerConfig(learning_rate=LR, zero1=False)
    want, jgrads0, jparams = _jax_run(flax_params, batches, opt_cfg)
    t_cfg = ttrainer.OptimizerConfig(learning_rate=LR)
    got, tgrads0, tmodel = _port_run(flax_params, batches, t_cfg)

    # step-1 gradients, leaf by leaf
    for name, g in flax_to_torch(jgrads0, tmodel.config).items():
        t = tgrads0[name].numpy()
        np.testing.assert_allclose(t, g.numpy(), rtol=0,
                                   atol=1e-6 + 1e-5 * float(np.abs(g.numpy()).max()),
                                   err_msg=name)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-6, atol=0)
    for name, p in flax_to_torch(jparams, tmodel.config).items():
        diff = np.abs(tmodel.state_dict()[name].numpy() - p.numpy())
        assert diff.max() <= STEPS * LR, (name, diff.max())
        assert diff.mean() <= 1e-4 * LR, (name, diff.mean())


def test_remat_gives_the_same_gradients(flax_params):
    """Activation checkpointing recomputes each layer: same loss, same
    gradients, bit for bit (the same ops in the same order)."""
    batches = _packed_batches(2)
    opt_cfg = ttrainer.OptimizerConfig(learning_rate=LR)
    plain = _port_run(flax_params, batches, opt_cfg)
    remat = _port_run(flax_params, batches, opt_cfg, remat=True)
    assert plain[0] == remat[0]
    for name, g in plain[1].items():
        assert torch.equal(g, remat[1][name]), name


def test_grad_accumulation_matches_full_batch(flax_params):
    """grad_accum_steps=2 on (2, 4, S) microbatches gives the full batch's
    first update: the mean of two equal-sized means is the full mean (as
    tests/trainer/test_trainer.py pins for JAX)."""
    batch = _synthetic_batches(1)[0]
    outs = {}
    for accum in (1, 2):
        model = _port_model(flax_params)
        opt = ttrainer.make_optimizer(ttrainer.OptimizerConfig())
        state = ttrainer.TrainState(0, model, opt.init(list(model.parameters())))
        step = ttrainer.build_train_step(model, opt, grad_accum_steps=accum)
        data = batch if accum == 1 else {k: v.reshape((2, 4) + v.shape[1:])
                                         for k, v in batch.items()}
        _, m = step(state, data)
        outs[accum] = (float(m["loss"]), {n: p.detach().clone()
                                          for n, p in model.named_parameters()})
    np.testing.assert_allclose(outs[1][0], outs[2][0], rtol=1e-6)
    for name, p in outs[1][1].items():
        torch.testing.assert_close(p, outs[2][1][name], atol=3e-6, rtol=0)


@pytest.mark.parametrize("over", [
    dict(),                                               # constant
    dict(warmup_steps=4),                                 # linear warmup
    dict(lr_schedule="cosine", warmup_steps=3, total_steps=12),
    dict(lr_schedule="cosine", warmup_steps=0, total_steps=8, min_lr_ratio=0.0),
])
def test_lr_schedule_matches_optax(over):
    """The learning rate each update applies, at counts 0..13, equals
    optax's schedule for the same config."""
    jcfg = jtrainer.OptimizerConfig(learning_rate=2e-3, **over)
    tcfg = ttrainer.OptimizerConfig(learning_rate=2e-3, **over)
    jsched = jtrainer.make_lr_schedule(jcfg)
    tsched = ttrainer.make_lr_schedule(tcfg)
    for count in range(14):
        want = float(jsched(jnp.asarray(count, jnp.int32))) if callable(jsched) else jsched
        got = (float(tsched(torch.tensor(count, dtype=torch.int32))) if callable(tsched)
               else tsched)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), count


def test_adamw_update_matches_optax():
    """One AdamW update per leaf against optax.adamw at a warmup schedule's
    3rd count (bias correction, decay on every leaf, eps outside the root)."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
    mu = [rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes]
    nu = [np.abs(rng.normal(size=s)).astype(np.float32) * 0.01 for s in shapes]
    cfg = dict(learning_rate=1e-2, warmup_steps=5, weight_decay=0.1)
    jopt = jtrainer.make_optimizer(jtrainer.OptimizerConfig(**cfg))
    state = jopt.init([jnp.asarray(p) for p in params])
    adam = state[0]._replace(count=jnp.asarray(2, jnp.int32),
                             mu=[jnp.asarray(m) for m in mu], nu=[jnp.asarray(n) for n in nu])
    sched = state[2]._replace(count=jnp.asarray(2, jnp.int32))
    updates, _ = jopt.update([jnp.asarray(g) for g in grads], (adam, state[1], sched),
                             [jnp.asarray(p) for p in params])
    want = optax.apply_updates([jnp.asarray(p) for p in params], updates)

    topt = ttrainer.make_optimizer(ttrainer.OptimizerConfig(**cfg))
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = {"count": torch.tensor(2, dtype=torch.int32),
              "mu": [torch.from_numpy(m.copy()) for m in mu],
              "nu": [torch.from_numpy(n.copy()) for n in nu]}
    topt.update(tparams, [torch.from_numpy(g) for g in grads], tstate)
    for got, w in zip(tparams, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-7)
    assert int(tstate["count"]) == 3


def test_anomaly_guard_skips_a_nan_batch_bit_identically(flax_params):
    model = _port_model(flax_params)
    opt = ttrainer.make_optimizer(ttrainer.OptimizerConfig(learning_rate=LR))
    state = ttrainer.TrainState(0, model, opt.init(list(model.parameters())),
                                guard=ttrainer.init_anomaly_guard_state())
    step = ttrainer.build_train_step(model, opt, anomaly_guard=ttrainer.AnomalyGuardConfig())
    batches = _synthetic_batches(3)
    state, m = step(state, batches[0])
    assert bool(m["good_step"]) and int(m["anomaly_skips"]) == 0

    def snapshot():
        return ([p.detach().clone() for p in model.parameters()],
                [t.clone() for t in state.opt_state["mu"] + state.opt_state["nu"]],
                int(state.opt_state["count"]))

    before = snapshot()
    bad = dict(batches[1], loss_mask=np.full_like(batches[1]["loss_mask"], np.nan))
    state, m = step(state, bad)
    assert not bool(m["good_step"]) and int(m["anomaly_skips"]) == 1
    after = snapshot()
    assert after[2] == before[2] and state.step == 2
    for a, b in zip(before[0] + before[1], after[0] + after[1]):
        assert torch.equal(a, b)
    state, m = step(state, batches[2])  # training goes on
    assert bool(m["good_step"]) and int(m["anomaly_skips"]) == 1
    assert not torch.equal(before[0][0], next(model.parameters()).detach())
    assert int(state.guard["good_steps"]) == 2


def test_create_train_state_refuses_a_serving_model():
    model = tllama.LlamaForCausalLM(tllama.tiny_llama(), device="cpu")
    with pytest.raises(ValueError, match="trainable=True"):
        ttrainer.create_train_state(model, ttrainer.make_optimizer(ttrainer.OptimizerConfig()))


def test_trainable_model_keeps_fp32_masters_and_casts():
    """A trainable bf16 model stores fp32 weights that require grad and
    returns fp32 gradients; the serving build keeps frozen bf16 weights."""
    cfg = tllama.tiny_llama(dtype=torch.bfloat16)
    train = tllama.LlamaForCausalLM(cfg, device="cpu", trainable=True)
    serve = tllama.LlamaForCausalLM(cfg, device="cpu")
    for (name, p), (_, q) in zip(train.named_parameters(), serve.named_parameters()):
        assert p.dtype == torch.float32 and p.requires_grad, name
        assert not q.requires_grad, name
        assert q.dtype == (torch.float32 if name.endswith("norm.weight") else torch.bfloat16)
    tllama.init_params(train, seed=0)
    ids = torch.randint(0, 256, (2, 8))
    logits = train(ids)
    assert logits.dtype == torch.bfloat16
    train.loss(ids, torch.roll(ids, -1, 1)).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in train.parameters())


def test_segment_positions_match_jax():
    seg = np.array([[0, 0, 0, 1, 1, 2, 2, 2, 2], [5, 5, 5, 5, 5, 5, 7, 7, 8]], np.int32)
    want = np.asarray(jtrainer.segment_positions(jnp.asarray(seg)))
    np.testing.assert_array_equal(ttrainer.segment_positions(torch.from_numpy(seg)).numpy(),
                                  want)


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_synthetic_tokens_match_jax_and_resume():
    jit = iter(jdata.SyntheticTokens(256, 4, 16, seed=7))
    src = tdata.SyntheticTokens(256, 4, 16, seed=7)
    tit = iter(src)
    for _ in range(3):
        _assert_batches_equal(next(tit), next(jit))
    cursor = src.state()
    want = next(tit)
    resumed = tdata.SyntheticTokens(256, 4, 16, seed=7)
    resumed.restore(cursor)
    _assert_batches_equal(next(iter(resumed)), want)


def test_packed_corpus_matches_jax_and_resumes(tmp_path):
    rng = np.random.default_rng(1)
    docs = [rng.integers(1, 255, size=rng.integers(3, 30)) for _ in range(60)]
    offsets = np.cumsum([0] + [len(d) for d in docs]).astype(np.int64)
    path = str(tmp_path / "corpus.npz")
    np.savez(path, tokens=np.concatenate(docs).astype(np.int32), offsets=offsets)
    np.testing.assert_array_equal(tdata.pack_documents(docs, 16, 255),
                                  jdata.pack_documents(docs, 16, 255))
    kw = dict(seq_len=16, batch_size=4, seed=3, eos_token_id=255)
    jit = iter(jdata.PackedCorpus(path, **kw))
    src = tdata.PackedCorpus(path, **kw)
    tit = iter(src)
    n = src.num_batches_per_epoch + 2  # across an epoch boundary
    for _ in range(n):
        _assert_batches_equal(next(tit), next(jit))
    cursor = src.state()
    want = next(tit)
    resumed = tdata.PackedCorpus(path, **kw)
    resumed.restore(cursor)
    _assert_batches_equal(next(iter(resumed)), want)
    assert "segment_ids" in want and "loss_mask" in want


def test_train_step_batch_dtypes_are_normalised():
    """numpy int32 ids/labels are accepted (the embedding wants int64)."""
    model = tllama.LlamaForCausalLM(tllama.tiny_llama(), device="cpu", trainable=True)
    opt = ttrainer.make_optimizer(ttrainer.OptimizerConfig())
    state = ttrainer.create_train_state(model, opt, seed=1)
    step = ttrainer.build_train_step(model, opt)
    state, m = step(state, _packed_batches(1)[0])
    assert np.isfinite(float(m["loss"])) and state.step == 1
