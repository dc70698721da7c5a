"""The port's training loop (``trainer/loop.py``) against the JAX package's
(``tests/trainer/test_loop.py``), with ``MetricsCallback``, the remat
policies and ``OptimizerConfig.grad_accum_steps``.

Both sides start from one flax init: the port's initializer is patched to
load ``flax_to_torch`` of the JAX params for the same key (the JAX loop
initialises from ``rng_key``, the port's from ``seed``; key ``PRNGKey(s)``
pairs with seed ``s``), and both see the same numpy batches. The JAX loop
runs on the harness's 8-device virtual mesh (dp=8, or tp=2 where its test
asks), with ``attention_impl="xla"``; the port runs its plain attention on
CPU tensors. Tolerances: the loss stream within 2e-6 relative (the same
fp32 math reduced in another order, ``tests/test_torch_train.py``'s
budget); counters, events, tags and health exactly; everything inside the
port bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.models import llama as jllama
from neuronx_distributed_tpu.parallel import mesh as mesh_lib
from neuronx_distributed_tpu.trainer import OptimizerConfig as JOptimizerConfig
from neuronx_distributed_tpu.trainer import loop as jloop
from neuronx_distributed_tpu.trainer import trainer as jtrainer
from neuronx_distributed_tpu.utils.timeline import Timeline as JTimeline
from neuronx_distributed_tpu_torch.models import llama as tllama
from neuronx_distributed_tpu_torch.models.convert import flax_to_torch
from neuronx_distributed_tpu_torch.trainer import OptimizerConfig
from neuronx_distributed_tpu_torch.trainer import loop as tloop
from neuronx_distributed_tpu_torch.trainer import trainer as ttrainer
from neuronx_distributed_tpu_torch.trainer.checkpoint import (
    DONE_MARKER,
    create_checkpoint_storage,
    load_checkpoint,
)
from neuronx_distributed_tpu_torch.utils.timeline import Timeline

torch.set_num_threads(1)
LOSS_RTOL = 2e-6
_PARAMS = {}


def _jcfg(layers=2):
    return jllama.tiny_llama(num_layers=layers, max_seq_len=32)


def _flax_params(seed: int, layers: int = 2):
    if (seed, layers) not in _PARAMS:
        m = jllama.LlamaForCausalLM(_jcfg(layers), attention_impl="xla")
        p = nn.unbox(m.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32)))
        _PARAMS[seed, layers] = jax.tree_util.tree_map(np.asarray, {"params": p["params"]})
    return _PARAMS[seed, layers]


@pytest.fixture(autouse=True)
def _flax_init(monkeypatch):
    """The port's initializer loads the JAX init of the same key."""

    def init(model, seed=0):
        model.load_state_dict(flax_to_torch(_flax_params(seed, model.config.num_layers),
                                            model.config))
        return model

    monkeypatch.setattr(ttrainer, "init_params", init)


def _tmodel(layers=2):
    return tllama.LlamaForCausalLM(tllama.tiny_llama(num_layers=layers, max_seq_len=32),
                                   device="cpu", trainable=True)


def _jmodel(layers=2):
    return jllama.LlamaForCausalLM(_jcfg(layers), attention_impl="xla")


def _batches(n=100, bs=8, seq=16):
    """test_loop.py's ``_batches``: jax.random token windows, as numpy."""
    key = jax.random.PRNGKey(0)
    for i in range(n):
        ids = np.asarray(jax.random.randint(jax.random.fold_in(key, i), (bs, seq), 0, 256))
        yield {"input_ids": ids, "labels": np.roll(ids, -1, 1)}


def _fixed(seq=16):
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (8, seq), 0, 256))
    while True:
        yield {"input_ids": ids, "labels": np.roll(ids, -1, 1)}


class _Rec:
    def __init__(self):
        self.events, self.losses = [], []

    def on_train_start(self, trainer):
        self.events.append("start")

    def on_step_end(self, trainer, metrics):
        self.events.append(trainer.step)
        self.losses.append(float(metrics["loss"]))

    def on_train_end(self, trainer):
        self.events.append("end")


class JRec(_Rec, jloop.Callback):
    pass


class TRec(_Rec, tloop.Callback):
    pass


def test_fit_runs_and_loss_decreases(tmp_path):
    """test_loop.py:46 (its 4-layer tiny_llama): start/end events, 6 steps,
    falling loss, throughput, the trace; the losses equal JAX's (tp=2,
    ZeRO-1) within tolerance."""
    mesh_lib.initialize_model_parallel(tensor_model_parallel_size=2)
    jr = JRec()
    jt = jloop.Trainer(model=_jmodel(4), optimizer_config=JOptimizerConfig(
        learning_rate=1e-3, zero1=True), callbacks=[jr, jloop.MetricsLogger(log_every=2)])
    jt.fit(_batches(), jax.random.PRNGKey(1), max_steps=6)
    rec = TRec()
    trace = tmp_path / "trace.json"
    tr = tloop.Trainer(model=_tmodel(4), optimizer_config=OptimizerConfig(learning_rate=1e-3),
                       callbacks=[rec, tloop.MetricsLogger(log_every=2)],
                       timeline=Timeline(str(trace)))
    metrics = tr.fit(_batches(), 1, max_steps=6)
    assert rec.events == jr.events == ["start", 1, 2, 3, 4, 5, 6, "end"]
    assert tr.step == jt.step == 6
    assert rec.losses[-1] < rec.losses[0]
    np.testing.assert_allclose(rec.losses, jr.losses, rtol=LOSS_RTOL, atol=0)
    assert metrics["throughput_seq_s"] > 0 and trace.exists()


def test_checkpoint_callback_tags_equal_jax(tmp_path):
    """test_loop.py:88: periodic sync saves at steps 2 and 4."""
    tags = {}
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        if side == "jax":
            t = jloop.Trainer(model=_jmodel(), optimizer_config=JOptimizerConfig(zero1=False),
                              callbacks=[jloop.CheckpointCallback(d, every=2, async_save=False)])
            t.fit(_batches(), jax.random.PRNGKey(1), max_steps=4)
        else:
            t = tloop.Trainer(model=_tmodel(),
                              callbacks=[tloop.CheckpointCallback(d, every=2, async_save=False)])
            t.fit(_batches(), 1, max_steps=4)
        tags[side] = sorted(os.listdir(d))
    assert tags["port"] == tags["jax"] == ["newest", "step_2", "step_4"]


def test_throughput_meter():
    import time

    m = tloop.ThroughputMeter(batch_size=8, window=4)
    for _ in range(5):
        time.sleep(0.01)
        t = m.update()
    assert 0 < t < 8 / 0.01 * 2


def test_progress_and_hooks_callbacks():
    """test_loop.py:113: ProgressBar and HooksCallback through fit; the
    parameter norms equal JAX's within tolerance."""
    seen = {"jax": [], "port": []}
    jt = jloop.Trainer(model=_jmodel(), optimizer_config=JOptimizerConfig(zero1=False),
                       callbacks=[jloop.ProgressBar(total_steps=2),
                                  jloop.HooksCallback(every=1, sink=seen["jax"].append)])
    jt.fit(_fixed(), jax.random.PRNGKey(0), max_steps=2)
    tr = tloop.Trainer(model=_tmodel(), callbacks=[
        tloop.ProgressBar(total_steps=2), tloop.HooksCallback(every=1, sink=seen["port"].append)])
    tr.fit(_fixed(), 0, max_steps=2)
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for a, b in zip(seen["port"], seen["jax"]):
        assert a.keys() == b.keys() == {"params"} and a["params"] > 0
        assert a["params"] == pytest.approx(b["params"], rel=1e-5)


def test_callback_exception_isolated():
    """test_loop.py:145: a raising callback is counted, the others keep
    firing, on_train_end reaches every one, health DEGRADED — as in JAX."""
    out = {}
    for side, mod in (("jax", jloop), ("port", tloop)):

        class Raiser(mod.Callback):
            ended = False

            def on_step_end(self, trainer, metrics):
                raise RuntimeError("boom")

            def on_train_end(self, trainer):
                self.ended = True

        raiser, rec = Raiser(), (JRec() if side == "jax" else TRec())
        if side == "jax":
            t = jloop.Trainer(model=_jmodel(), optimizer_config=JOptimizerConfig(zero1=False),
                              callbacks=[raiser, rec])
            m = t.fit(_fixed(), jax.random.PRNGKey(0), max_steps=3)
        else:
            t = tloop.Trainer(model=_tmodel(), callbacks=[raiser, rec])
            m = t.fit(_fixed(), 0, max_steps=3)
        out[side] = (t.step, t.callback_errors, int(m["callback_errors"]), len(rec.losses),
                     raiser.ended, rec.events[-1], t.health().value, rec.losses)
    assert out["port"][:7] == out["jax"][:7] == (3, 3, 2, 3, True, "end", "degraded")
    np.testing.assert_allclose(out["port"][7], out["jax"][7], rtol=LOSS_RTOL, atol=0)


def test_train_end_epilogue_runs_on_non_halt_failure():
    """test_loop.py:186: a non-halt failure still runs on_train_end."""

    class ExplodingSource:
        def corrupt_batch(self, step, batch):
            if step == 2:
                raise ValueError("poisoned batch")
            return batch

        def on_step_start(self, step):
            pass

        def on_dispatch(self, attempt):
            pass

    rec = TRec()
    tr = tloop.Trainer(model=_tmodel(), callbacks=[rec], fault_injector=ExplodingSource())
    with pytest.raises(ValueError, match="poisoned batch"):
        tr.fit(_fixed(), 0, max_steps=5)
    assert len(rec.losses) == 2 and rec.events[-1] == "end"


def test_restore_signal_handlers_tolerates_none_original():
    import signal

    tr = tloop.Trainer(model=_tmodel())
    prev = signal.getsignal(signal.SIGINT)
    try:
        tr._restore_signal_handlers({signal.SIGTERM: None, signal.SIGINT: signal.SIG_DFL})
        assert signal.getsignal(signal.SIGINT) is signal.SIG_DFL
    finally:
        signal.signal(signal.SIGINT, prev)


def test_checkpoint_callback_save_on_end(tmp_path):
    """test_loop.py:244: save_on_end writes step_3 off the boundary, with the
    full exact-resume payload (the seed where JAX has its key), and does
    not save step_4 twice; tags equal JAX's."""
    import json

    tags = {}
    for side in ("jax", "port"):
        d1, d2 = str(tmp_path / side / "odd"), str(tmp_path / side / "even")
        trace = str(tmp_path / f"{side}.json")
        if side == "jax":
            jm = _jmodel()
            jloop.Trainer(model=jm, optimizer_config=JOptimizerConfig(zero1=False),
                          callbacks=[jloop.CheckpointCallback(d1, every=2, async_save=False)]
                          ).fit(_batches(), jax.random.PRNGKey(1), max_steps=3)
            jloop.Trainer(model=jm, optimizer_config=JOptimizerConfig(zero1=False),
                          callbacks=[jloop.CheckpointCallback(d2, every=2, async_save=False)],
                          timeline=JTimeline(trace)).fit(_batches(), jax.random.PRNGKey(1),
                                                         max_steps=4)
        else:
            tm = _tmodel()
            tloop.Trainer(model=tm, callbacks=[tloop.CheckpointCallback(d1, every=2,
                                                                        async_save=False)]
                          ).fit(_batches(), 1, max_steps=3)
            tloop.Trainer(model=tm, callbacks=[tloop.CheckpointCallback(d2, every=2,
                                                                        async_save=False)],
                          timeline=Timeline(trace)).fit(_batches(), 1, max_steps=4)
            _, uc, _ = load_checkpoint(d1, tag="step_3")
            assert uc["step"] == 3 and uc["seed"] == 1 and "data_state" not in uc
            assert create_checkpoint_storage(d2).file_exists(os.path.join("step_4", DONE_MARKER))
        saves = [e["args"]["tag"] for e in json.load(open(trace))["traceEvents"]
                 if e["name"] == "checkpoint"]
        tags[side] = (sorted(os.listdir(d1)), sorted(os.listdir(d2)), saves)
    assert tags["port"] == tags["jax"]
    assert "step_3" in tags["port"][0] and tags["port"][2].count("step_4") == 1


def test_trainer_evaluate():
    """test_loop.py:271: the mean loss with the current parameters, no
    update; equal to JAX's within tolerance; one host read."""
    jt = jloop.Trainer(model=_jmodel(), optimizer_config=JOptimizerConfig(zero1=False))
    jt.fit(_fixed(), jax.random.PRNGKey(0), max_steps=2)
    jrep = jt.evaluate(_fixed(), max_steps=3)
    tr = tloop.Trainer(model=_tmodel())
    tr.fit(_fixed(), 0, max_steps=2)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    reads = tr.host_reads
    rep = tr.evaluate(_fixed(), max_steps=3)
    assert rep["eval_steps"] == jrep["eval_steps"] == 3 and rep["eval_loss"] > 0
    assert rep["eval_loss"] == pytest.approx(jrep["eval_loss"], rel=LOSS_RTOL)
    assert tr.host_reads == reads + 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert tr.programs.dispatches("eval_step") == 3


def test_pipeline_and_zero1_are_refused():
    """Pipelines, ZeRO-1 and the dp vote are multi-GPU work (item 9)."""
    tr = tloop.Trainer(model=_tmodel(), pipeline=object())
    with pytest.raises(NotImplementedError, match="item 9"):
        tr.fit(_fixed(), 0, max_steps=1)
    assert not hasattr(OptimizerConfig(), "zero1")
    from neuronx_distributed_tpu_torch.integrity import SentinelConfig

    tr = tloop.Trainer(model=_tmodel(), integrity=SentinelConfig(mode="vote"))
    with pytest.raises(NotImplementedError, match="item 9"):
        tr.fit(_fixed(), 0, max_steps=1)


def test_grad_accum_steps_through_the_loop_matches_full_batch():
    """test_trainer.py:100 through ``OptimizerConfig.grad_accum_steps``: two
    microbatches of 4 rows give the full batch's first update; the losses
    equal JAX's loop with the same setting within tolerance."""
    states = {}
    for accum in (1, 2):
        rec = TRec()
        tr = tloop.Trainer(model=_tmodel(), callbacks=[rec],
                           optimizer_config=OptimizerConfig(grad_accum_steps=accum))
        tr.fit(_batches(), 0, max_steps=2)
        states[accum] = (rec.losses, {k: v.clone() for k, v in tr.model.state_dict().items()})
    np.testing.assert_allclose(states[1][0], states[2][0], rtol=1e-6)
    for k, v in states[1][1].items():
        torch.testing.assert_close(v, states[2][1][k], atol=3e-6, rtol=0)
    mesh_lib.initialize_model_parallel(tensor_model_parallel_size=2)  # a microbatch >= dp
    jr = JRec()
    jloop.Trainer(model=_jmodel(), callbacks=[jr], optimizer_config=JOptimizerConfig(
        zero1=False, grad_accum_steps=2)).fit(_batches(), jax.random.PRNGKey(0), max_steps=2)
    np.testing.assert_allclose(states[2][0], jr.losses, rtol=LOSS_RTOL, atol=0)


def test_ledger_hbm_manifest_and_prewarm(tmp_path):
    """The trainer's program ledger (train_step metered at its first
    dispatch, one variant), the HBM residents, the step generator riding
    the seed, and a prewarm that changes neither the state nor the
    cursor (it loads kernel libraries only)."""
    from neuronx_distributed_tpu_torch.trainer.data import SyntheticTokens

    tr = tloop.Trainer(model=_tmodel())
    src = SyntheticTokens(256, 8, 16, seed=3)
    tr.fit(src, 4, max_steps=3)
    entry = tr.programs.snapshot()["by_program"]["train_step"]
    assert entry["dispatches"] == 3 and entry["compiles"] == 1
    assert isinstance(entry["flops_per_dispatch"], float) and entry["flops_per_dispatch"] > 0
    hbm = tr.hbm.halt_summary()
    n_params = sum(p.numel() * 4 for p in tr.model.parameters())
    assert hbm["resident_params_bytes"] == n_params
    assert hbm["resident_opt_state_bytes"] == 2 * n_params + 4
    assert hbm["resident_anomaly_guard_bytes"] == 12
    g1 = tr.step_rng().initial_seed()
    assert g1 == tloop.step_seed(4, 3) and g1 != tloop.step_seed(4, 2)
    man = tr.manifest()
    assert "train_step" in man.names()
    man.save(str(tmp_path))
    before = ({k: v.clone() for k, v in tr.model.state_dict().items()}, src.state(), tr.step)
    rep = tr.prewarm(cache_dir=str(tmp_path))
    assert rep["replayed"] == [] and "train_step" in rep["skipped"] and not rep["deferred"]
    assert src.state() == before[1] and tr.step == before[2]
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[0][k]), k


def test_profile_dir_traces_steps_two_to_five(tmp_path):
    tr = tloop.Trainer(model=_tmodel(), profile_dir=str(tmp_path / "prof"))
    tr.fit(_fixed(), 0, max_steps=6)
    assert (tmp_path / "prof" / "trace.json").exists()


def test_metrics_callback_registry_text_equals_jax(monkeypatch):
    """MetricsCallback: the registry's Prometheus text equals JAX's on the
    same metric dicts (device scalars gauged raw), the same health and the
    same clock."""
    from neuronx_distributed_tpu.observability.callback import MetricsCallback as JMC
    from neuronx_distributed_tpu_torch.observability.callback import MetricsCallback as TMC

    class Health:
        def __init__(self, value):
            self.value = value

    class Fake:
        tokens_seen, anomaly_skips, train_seconds = 0, 0, 0.0

        def __init__(self):
            self.h = "ok"

        def health(self):
            return Health(self.h)

    import time

    texts = {}
    for side, cls, scal in (("jax", JMC, jnp.asarray), ("port", TMC, torch.tensor)):
        ticks = iter(0.25 * i for i in range(100))
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        cb, fake = cls(), Fake()
        cb.on_train_start(fake)
        for i in range(4):
            fake.tokens_seen, fake.anomaly_skips = 128 * (i + 1), i // 2
            fake.h = "degraded" if i == 2 else "ok"
            cb.on_step_end(fake, {"loss": scal(2.5 - 0.25 * i), "grad_norm": scal(0.5 * i),
                                  "good_step": scal(i != 1), "anomaly_skips": scal(i // 2),
                                  "throughput_seq_s": 10.0 + i, "dispatch_retries": 0,
                                  "emergency_checkpoints": 0, "callback_errors": i})
        fake.train_seconds = 3.75
        cb.on_train_end(fake)
        texts[side] = cb.registry.prometheus_text()
    assert texts["port"] == texts["jax"]
    assert "train_loss 1.75" in texts["port"] and "train_health 0" in texts["port"]


def test_metrics_callback_does_not_keep_a_deleted_trainer_alive():
    """A trainer that holds its MetricsCallback (trainer -> callback ->
    registry -> health gauge -> trainer) is freed by its last ``del`` with
    the cyclic collector off: the gauge reads the trainer through a weak
    reference. While the trainer lives the gauge reads as JAX's does; after,
    -1."""
    import gc
    import weakref

    from neuronx_distributed_tpu.observability.callback import MetricsCallback as JMC
    from neuronx_distributed_tpu_torch.observability.callback import MetricsCallback as TMC

    class Health:
        def __init__(self, value):
            self.value = value

    class Trainer:
        def __init__(self, cb):
            self.callbacks = [cb]
            self.h = "degraded"

        def health(self):
            return Health(self.h)

    texts = {}
    for side, cls in (("jax", JMC), ("port", TMC)):
        cb = cls()
        trainer = Trainer(cb)
        cb.on_train_start(trainer)
        texts[side] = cb.registry.prometheus_text()
    assert texts["port"] == texts["jax"] and "train_health 1" in texts["port"]
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        ref = weakref.ref(trainer)
        del trainer
        assert ref() is None
    finally:
        if was_enabled:
            gc.enable()
    assert "train_health -1" in cb.registry.prometheus_text()


@pytest.mark.parametrize("policy", ["dots", "dots_saveable"])
def test_remat_policies_give_bit_identical_gradients(policy):
    """A remat policy only chooses what is kept: the loss and every gradient
    equal policy None's bit for bit, while the backward's recompute runs
    fewer products."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] = self.ops.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    ids = torch.from_numpy(next(_fixed())["input_ids"]).long()
    out = {}
    for pol in (None, policy):
        cfg = tllama.tiny_llama(num_layers=2, max_seq_len=32, remat=True, remat_policy=pol)
        model = tllama.LlamaForCausalLM(cfg, device="cpu", trainable=True)
        ttrainer.init_params(model, seed=0)
        loss = model.loss(ids, torch.roll(ids, -1, 1))
        with Count() as c:
            loss.backward()
        out[pol] = (loss.detach(), [p.grad for p in model.parameters()], c.ops)
    assert torch.equal(out[None][0], out[policy][0])
    for a, b in zip(out[None][1], out[policy][1]):
        assert torch.equal(a, b)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    # policy None recomputes the linears' products in the backward; both
    # policies keep them, and dots_saveable keeps the attention's bmm too
    assert out[policy][2][mm] < out[None][2][mm]
    assert (out[policy][2].get(bmm, 0) < out[None][2].get(bmm, 0)) == (policy == "dots_saveable")
    with pytest.raises(ValueError, match="remat_policy"):
        tllama.remat_context_fn("everything")


def test_jax_and_port_inits_agree():
    """The patched initializer gives the JAX loop's own init: fit's
    ``jit(model.init)(key, first_ids)`` equals ``model.init(key, ones)``."""
    mesh_lib.initialize_model_parallel()
    m = _jmodel()
    opt = jtrainer.make_optimizer(JOptimizerConfig(zero1=False))
    state, _, _ = jtrainer.create_train_state(m, opt, jax.random.PRNGKey(1),
                                              jnp.asarray(next(_batches())["input_ids"]),
                                              zero1=False)
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, state.params))
    assert len(got) == len(jax.tree_util.tree_leaves(_flax_params(1)))
    for a, b in zip(got, jax.tree_util.tree_leaves(_flax_params(1))):
        np.testing.assert_array_equal(a, b)
