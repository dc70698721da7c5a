"""The training loop under injected faults (``trainer/faults.py``) against
the JAX package's chaos suite (``tests/trainer/test_faults.py`` :114-:478).

Every scenario runs the same schedule through the JAX loop (8-device
virtual mesh, ``attention_impl="xla"``) and the port's (CPU tensors) from
one flax init (the port's initializer patched to load it) on the same
``SyntheticTokens`` batches. Exact against JAX: the injector's counters,
the trainer's counters, health, halt reasons, ``preempted``, the steps and
tokens, and the tags on disk. The losses within 2e-6 relative
(``tests/test_torch_train.py``'s budget; NaN where JAX has NaN). Inside the
port bit for bit wherever JAX's suite asserts bit identity: a skipped
step's state, resumed and retried streams against the clean run."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.models import llama as jllama
from neuronx_distributed_tpu.trainer import AnomalyGuardConfig as JGuard
from neuronx_distributed_tpu.trainer import OptimizerConfig as JOptimizerConfig
from neuronx_distributed_tpu.trainer import data as jdata
from neuronx_distributed_tpu.trainer import faults as jfaults
from neuronx_distributed_tpu.trainer import loop as jloop
from neuronx_distributed_tpu.utils.retry import RetryPolicy as JRetry
from neuronx_distributed_tpu.utils.timeline import Timeline as JTimeline
from neuronx_distributed_tpu_torch.models import llama as tllama
from neuronx_distributed_tpu_torch.models.convert import flax_to_torch
from neuronx_distributed_tpu_torch.trainer import AnomalyGuardConfig as TGuard
from neuronx_distributed_tpu_torch.trainer import data as tdata
from neuronx_distributed_tpu_torch.trainer import faults as tfaults
from neuronx_distributed_tpu_torch.trainer import loop as tloop
from neuronx_distributed_tpu_torch.trainer import trainer as ttrainer
from neuronx_distributed_tpu_torch.trainer.checkpoint import (
    DONE_MARKER,
    latest_checkpoint_tag,
    load_checkpoint,
)
from neuronx_distributed_tpu_torch.utils.retry import RetryPolicy as TRetry
from neuronx_distributed_tpu_torch.utils.timeline import Timeline as TTimeline

pytestmark = pytest.mark.chaos
torch.set_num_threads(1)
BS, SEQ, STEPS = 8, 16, 6
LOSS_RTOL = 2e-6
_PARAMS = {}
_JMODEL = []


def _flax_params(seed: int):
    if seed not in _PARAMS:
        m = jllama.LlamaForCausalLM(jllama.tiny_llama(num_layers=2, max_seq_len=32),
                                    attention_impl="xla")
        p = nn.unbox(m.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32)))
        _PARAMS[seed] = jax.tree_util.tree_map(np.asarray, {"params": p["params"]})
    return _PARAMS[seed]


@pytest.fixture(autouse=True)
def _flax_init(monkeypatch):
    def init(model, seed=0):
        model.load_state_dict(flax_to_torch(_flax_params(seed), model.config))
        return model

    monkeypatch.setattr(ttrainer, "init_params", init)


SIDES = {
    "jax": dict(loop=jloop, faults=jfaults, data=jdata, guard=JGuard, retry=JRetry,
                timeline=JTimeline),
    "port": dict(loop=tloop, faults=tfaults, data=tdata, guard=TGuard, retry=TRetry,
                 timeline=TTimeline),
}


def _model(side):
    if side == "jax":
        if not _JMODEL:
            _JMODEL.append(jllama.LlamaForCausalLM(jllama.tiny_llama(num_layers=2, max_seq_len=32),
                                                   attention_impl="xla"))
        return _JMODEL[0]
    return tllama.LlamaForCausalLM(tllama.tiny_llama(num_layers=2, max_seq_len=32), device="cpu",
                                   trainable=True)


def _host_state(side, tr):
    if side == "jax":
        return [np.asarray(x).copy() for x in jax.tree_util.tree_leaves(
            (tr.state.params, tr.state.opt_state))]
    st = tr.state
    return [t.detach().clone() for t in list(st.params.state_dict().values())
            + st.opt_state["mu"] + st.opt_state["nu"] + [st.opt_state["count"]]]


def _equal(side, a, b):
    if side == "jax":
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _run(side, max_steps, *, inj=None, guard="default", retry=None, ckpt=None, emergency=None,
         key=0, resume_from=None, snapshot=False, trace=None, data=None, **kw):
    """One fit on ``side`` with the schedule ``inj(faults_module)``; returns
    a result dict (the trainer, the injector, the recorder, the halt)."""
    s = SIDES[side]
    rec = {"losses": [], "good": [], "states": [], "events": []}

    class Rec(s["loop"].Callback):
        def on_step_end(self, trainer, metrics):
            rec["losses"].append(float(metrics["loss"]))
            if "good_step" in metrics:
                rec["good"].append(bool(metrics["good_step"]))
            if snapshot:
                rec["states"].append(_host_state(side, trainer))

        def on_train_end(self, trainer):
            rec["events"].append("end")

    injector = inj(s["faults"]) if inj is not None else None
    cbs = [Rec()]
    if ckpt is not None:
        d, ckw = ckpt
        cbs.append(s["loop"].CheckpointCallback(d, **ckw))
    if guard != "default":
        kw["anomaly_guard"] = None if guard is None else s["guard"](**guard)
    if retry is not None:
        kw["dispatch_retry"] = s["retry"](**retry)
    if side == "jax":
        kw["optimizer_config"] = JOptimizerConfig(zero1=False)
    if trace is not None:
        kw["timeline"] = s["timeline"](trace)
    tr = s["loop"].Trainer(model=_model(side), callbacks=cbs, fault_injector=injector,
                           emergency_dir=emergency, **kw)
    src = data(side) if data is not None else s["data"].SyntheticTokens(256, BS, SEQ, seed=3)
    halted = None
    try:
        tr.fit(src, jax.random.PRNGKey(key) if side == "jax" else key, max_steps=max_steps,
               resume_from=resume_from)
    except s["loop"].TrainerHalted as e:
        halted = e
    return dict(tr=tr, inj=injector, rec=rec, halted=halted)


def _facts(r, root=None):
    """What must equal JAX's exactly."""
    tr = r["tr"]
    out = dict(step=tr.step, steps_run=tr.steps_run, tokens=tr.tokens_seen,
               skips=tr.anomaly_skips, retries=tr.dispatch_retries,
               emergency=tr.emergency_checkpoints, callback_errors=tr.callback_errors,
               health=tr.health().value, halt=tr.halt_reason, preempted=tr.preempted,
               good=r["rec"]["good"], events=r["rec"]["events"],
               counters=dict(r["inj"].counters) if r["inj"] is not None else None,
               emergency_tag=r["halted"].emergency_tag if r["halted"] is not None else None)
    if root is not None:
        out["tags"] = sorted(os.listdir(root)) if os.path.isdir(root) else []
    return out


def _both(tmp_path, max_steps, ckpt_every=None, ckpt_kw=None, emergency=False, **kw):
    """The same scenario on both sides; checks the facts and the losses."""
    out = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side / "ck")
        args = dict(kw)
        if ckpt_every is not None:
            args["ckpt"] = (root, dict(every=ckpt_every, async_save=False, **(ckpt_kw or {})))
        if emergency:
            args["emergency"] = root
        out[side] = _run(side, max_steps, **args)
        out[side]["root"] = root
    fj = _facts(out["jax"], out["jax"]["root"])
    fp = _facts(out["port"], out["port"]["root"])
    assert fp == fj
    np.testing.assert_allclose(out["port"]["rec"]["losses"], out["jax"]["rec"]["losses"],
                               rtol=LOSS_RTOL, atol=0)
    return out["port"], out["jax"]


_CLEAN = {}


def _clean(steps=8):
    """The port's fault-free stream (memoized, 8 steps; callers take a
    prefix) and its final state."""
    if not _CLEAN:
        r = _run("port", 8, snapshot=True)
        _CLEAN.update(losses=r["rec"]["losses"], states=r["rec"]["states"])
    return list(_CLEAN["losses"][:steps])


# --- (b) the anomaly guard ----------------------------------------------------------


def test_nan_step_skipped_params_and_opt_unchanged(tmp_path):
    """test_faults.py:114: the NaN step is skipped on the device bit for bit,
    training goes on, DEGRADED."""
    p, _ = _both(tmp_path, STEPS, inj=lambda F: F.FaultInjector().nan_loss(at=2), snapshot=True)
    assert p["inj"].counters["nan_losses"] == 1 and np.isnan(p["rec"]["losses"][2])
    states = p["rec"]["states"]
    assert _equal("port", states[2], states[1]) and not _equal("port", states[3], states[2])
    assert p["tr"].health().value == "degraded" and p["tr"].anomaly_skips == 1


def test_grad_spike_skipped(tmp_path):
    """test_faults.py:138: a finite spike trips the EMA detector after
    warm-up."""
    p, _ = _both(tmp_path, STEPS, inj=lambda F: F.FaultInjector().spike_grads(at=4, factor=1e6),
                 guard=dict(warmup_steps=2, spike_factor=10.0), snapshot=True)
    assert p["rec"]["good"][4] is False and np.isfinite(p["rec"]["losses"][4])
    assert _equal("port", p["rec"]["states"][4], p["rec"]["states"][3])


def test_anomaly_budget_halts_with_emergency_checkpoint(tmp_path):
    """test_faults.py:157: open-ended NaNs exhaust the budget: HALTED with
    an emergency checkpoint holding the last good state and the
    exact-resume payload."""
    p, _ = _both(tmp_path, 50, emergency=True, snapshot=True, guard=dict(budget=2),
                 inj=lambda F: F.FaultInjector().nan_loss(at=2, times=None))
    tr = p["tr"]
    assert "anomaly budget" in tr.halt_reason and tr.anomaly_skips == 3
    items, uc, _ = load_checkpoint(p["root"], tag=p["halted"].emergency_tag)
    assert uc["emergency"].startswith("anomaly budget")
    assert uc["step"] == tr.step and "seed" in uc and "data_state" in uc
    model_leaves = list(items["model"].values())
    assert _equal("port", model_leaves, p["rec"]["states"][1][:len(model_leaves)])


# --- (c) dispatch recovery ----------------------------------------------------------


def test_dispatch_failure_recovers_no_step_lost(tmp_path):
    """test_faults.py:184: one failed dispatch retries on the intact state:
    the stream equals the clean run's bit for bit; the timeline records the
    failure and the recovery."""
    clean = _clean(STEPS)
    trace = {s: str(tmp_path / f"{s}.json") for s in ("jax", "port")}
    out = {}
    for side in ("jax", "port"):
        out[side] = _run(side, STEPS, inj=lambda F: F.FaultInjector().fail_dispatch(at=3, times=1),
                         retry=dict(max_attempts=3, first_wait=0.0, min_wait=0.0),
                         trace=trace[side])
        names = [e["name"] for e in json.load(open(trace[side]))["traceEvents"]]
        assert "dispatch_failure" in names and "recovery" in names
    assert _facts(out["port"]) == _facts(out["jax"])
    assert out["port"]["rec"]["losses"] == clean
    assert out["port"]["tr"].dispatch_retries == 1


def test_dispatch_budget_halts_then_emergency_resume(tmp_path):
    """test_faults.py:207: open-ended failures halt with the intact state
    checkpointed; a fresh trainer resumes from it bit for bit."""
    clean = _clean(5)
    p, j = _both(tmp_path, 5, emergency=True,
                 inj=lambda F: F.FaultInjector().fail_dispatch(at=3, times=None),
                 retry=dict(max_attempts=3, first_wait=0.0, min_wait=0.0))
    assert "consecutive dispatch failures" in p["tr"].halt_reason
    assert p["halted"].emergency_tag == f"emergency_step_{p['tr'].step}"
    assert p["rec"]["losses"] == clean[:p["tr"].step]
    r2 = _run("port", 5, key=9, resume_from=p["root"])
    j2 = _run("jax", 5, key=9, resume_from=j["root"])
    assert _facts(r2) == _facts(j2)
    assert p["rec"]["losses"] + r2["rec"]["losses"] == clean


def test_dispatch_failure_after_the_first_write_halts_without_a_checkpoint(tmp_path):
    """The port's counterpart of consumed donated buffers: a failure raised
    after the step began writing the state in place halts for cause and
    saves nothing (the state is torn)."""
    from neuronx_distributed_tpu_torch.trainer.trainer import AdamW

    calls = {"n": 0}
    real = AdamW.update

    def update(self, params, grads, opt_state, good=None):
        calls["n"] += 1
        if calls["n"] == 3:
            params[0].data.add_(1.0)  # a partial write
            raise RuntimeError("device lost mid-update")
        return real(self, params, grads, opt_state, good)

    AdamW.update = update
    try:
        r = _run("port", STEPS, emergency=str(tmp_path / "ck"))
    finally:
        AdamW.update = real
    assert r["halted"] is not None and r["halted"].emergency_tag is None
    assert "began updating the state" in r["tr"].halt_reason
    # the post-mortem lands there, no checkpoint does
    assert not [n for n in os.listdir(tmp_path / "ck") if n.startswith(("emergency", "step"))]
    assert r["rec"]["events"] == ["end"]


# --- (a) exact resume ----------------------------------------------------------------


def test_kill_and_resume_bit_identical(tmp_path):
    """test_faults.py:235: killed at the step-4 checkpoint, resumed by a
    fresh trainer with another seed: the stream equals the clean run's bit
    for bit, the bookkeeping restored and extended."""
    clean = _clean(8)
    p, j = _both(tmp_path, 4, ckpt_every=2)
    r2 = _run("port", 8, key=123, resume_from=p["root"])
    j2 = _run("jax", 8, key=123, resume_from=j["root"])
    assert _facts(r2) == _facts(j2)
    assert p["rec"]["losses"] + r2["rec"]["losses"] == clean
    assert r2["tr"].steps_run == 4 and r2["tr"].step == 8 and r2["tr"].tokens_seen == 8 * BS * SEQ


def test_guard_carry_rides_checkpoints_spike_after_resume(tmp_path):
    """test_faults.py:256: the guard carry is resumed, so a spike after the
    resume is skipped as in the uninterrupted run and the skip count
    continues."""
    guard = dict(warmup_steps=2, spike_factor=10.0)
    u, _ = _both(tmp_path / "u", 8, guard=guard,
                 inj=lambda F: F.FaultInjector().spike_grads(at=3).spike_grads(at=5))
    assert u["rec"]["good"][3] is False and u["rec"]["good"][5] is False
    b, jb = _both(tmp_path / "b", 4, ckpt_every=2, guard=guard,
                  inj=lambda F: F.FaultInjector().spike_grads(at=3))
    c = _run("port", 8, key=42, resume_from=b["root"], guard=guard,
             inj=lambda F: F.FaultInjector().spike_grads(at=5))
    jc = _run("jax", 8, key=42, resume_from=jb["root"], guard=guard,
              inj=lambda F: F.FaultInjector().spike_grads(at=5))
    assert _facts(c) == _facts(jc)
    assert c["rec"]["good"][1] is False and c["tr"].anomaly_skips == 2
    assert b["rec"]["losses"] + c["rec"]["losses"] == u["rec"]["losses"]


def test_sigterm_finishes_step_checkpoints_and_resumes(tmp_path):
    """test_faults.py:290: a real SIGTERM finishes the step, writes step_3
    through the protocol and returns; the resume is bit-identical."""
    clean = _clean(STEPS)
    p, j = _both(tmp_path, STEPS, emergency=True,
                 inj=lambda F: F.FaultInjector().deliver_sigterm(at=3))
    assert p["tr"].preempted and p["tr"].step == 3 and len(p["rec"]["losses"]) == 3
    assert latest_checkpoint_tag(p["root"]) == "step_3"
    assert os.path.exists(os.path.join(p["root"], "step_3", DONE_MARKER))
    r2 = _run("port", STEPS, key=7, resume_from=p["root"])
    assert p["rec"]["losses"] + r2["rec"]["losses"] == clean


def test_sigterm_before_first_step_loses_no_batch(tmp_path):
    """test_faults.py:314: step_0 carries the pre-pull cursor."""
    clean = _clean(STEPS)
    p, _ = _both(tmp_path, STEPS, emergency=True,
                 inj=lambda F: F.FaultInjector().deliver_sigterm(at=0))
    assert p["tr"].preempted and p["tr"].step == 0 and p["rec"]["losses"] == []
    assert latest_checkpoint_tag(p["root"]) == "step_0"
    r2 = _run("port", STEPS, key=7, resume_from=p["root"])
    assert r2["rec"]["losses"] == clean


def test_failure_between_pull_and_dispatch_loses_no_batch(tmp_path):
    """test_faults.py:334: save_on_end after a pre-dispatch failure carries
    the pre-pull cursor."""
    clean = _clean(8)

    def exploding(F):
        class Exploding(F.FaultInjector):
            def corrupt_batch(self, step, batch):
                if step == 3:
                    raise RuntimeError("injected pre-dispatch failure")
                return super().corrupt_batch(step, batch)

        return Exploding()

    out = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        with pytest.raises(RuntimeError, match="pre-dispatch"):
            _run(side, 8, inj=exploding, ckpt=(root, dict(every=100, async_save=False)))
        out[side] = (latest_checkpoint_tag(root) if side == "port" else None, root)
    assert out["port"][0] == "step_3"
    r2 = _run("port", 8, key=9, resume_from=out["port"][1])
    assert r2["rec"]["losses"] == clean[3:]


def test_step_rng_rides_resume(tmp_path):
    """test_faults.py:368: the resumed trainer's step generator equals the
    uninterrupted one's though its fit got another seed."""
    d = str(tmp_path / "ck")
    a = _run("port", 3, ckpt=(d, dict(every=3, async_save=False)))
    b = _run("port", 3, key=9, resume_from=d)
    assert a["tr"].step == b["tr"].step == 3
    assert a["tr"].step_rng().initial_seed() == b["tr"].step_rng().initial_seed()


def test_corrupt_checkpoint_falls_back_and_retrains(tmp_path):
    """test_faults.py:383: a tag that lost its marker is never resumed: the
    fallback to step_2 cleans it up and retrains bit for bit."""
    clean = _clean(STEPS)
    p, j = _both(tmp_path, 4, ckpt_every=2, ckpt_kw=dict(save_on_end=False),
                 inj=lambda F: F.FaultInjector().corrupt_checkpoint("step_4"))
    assert p["inj"].counters["corrupted_checkpoints"] == 1
    r2 = _run("port", STEPS, key=5, resume_from=p["root"])
    j2 = _run("jax", STEPS, key=5, resume_from=j["root"])
    assert _facts(r2, p["root"]) == _facts(j2, j["root"])
    assert r2["tr"].steps_run == 4 and not os.path.isdir(os.path.join(p["root"], "step_4"))
    assert r2["rec"]["losses"] == clean[2:]


def test_corrupt_checkpoint_fires_under_async_save(tmp_path):
    """test_faults.py:407: the async path drains before corrupting."""
    out = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        r = _run(side, 4, inj=lambda F: F.FaultInjector().corrupt_checkpoint("step_4"),
                 ckpt=(root, dict(every=2, async_save=True, save_on_end=False)))
        out[side] = (r["inj"].counters["corrupted_checkpoints"],
                     os.path.isdir(os.path.join(root, "step_4")),
                     os.path.exists(os.path.join(root, "step_4", DONE_MARKER)),
                     sorted(os.listdir(root)))
    assert out["port"] == out["jax"] and out["port"][:3] == (1, True, False)


def test_execution_failure_at_readback_halts_for_cause(monkeypatch):
    """test_faults.py:427: a device failure surfacing at the deferred read
    halts with a reason and no checkpoint; on_train_end still runs."""
    real = tloop.Trainer._host_read
    fired = {"n": 0}

    def failing(self, pending):
        if fired["n"] == 0:
            fired["n"] += 1
            raise RuntimeError("DEVICE_ERROR: simulated async execution fault")
        return real(self, pending)

    monkeypatch.setattr(tloop.Trainer, "_host_read", failing)
    r = _run("port", STEPS)
    assert r["halted"] is not None and "execution failed" in r["tr"].halt_reason
    assert r["halted"].emergency_tag is None and r["tr"].health().value == "halted"
    assert r["rec"]["events"] == ["end"]


# --- the dispatch and host-read budget -------------------------------------------------


def test_one_program_serves_clean_and_anomalous_steps(tmp_path):
    """test_faults.py:457: one variant of the train step serves clean, NaN
    and spiked batches (anomaly handling is data, not control flow)."""
    p, _ = _both(tmp_path, STEPS, guard=dict(warmup_steps=2),
                 inj=lambda F: F.FaultInjector().nan_loss(at=2).spike_grads(at=4, factor=1e6))
    entry = p["tr"].programs.snapshot()["by_program"]["train_step"]
    assert p["tr"].anomaly_skips == 2 and entry["compiles"] == 1 and entry["variants"] == 1


@pytest.mark.parametrize("guard", ["default", None])
def test_guard_host_traffic_is_one_deferred_read_a_step(guard):
    """test_faults.py:478: with the guard on, one deferred read of the
    scalar pair a step; with it off, none."""
    r = _run("port", STEPS, guard=guard)
    assert r["tr"].host_reads == (STEPS if guard == "default" else 0)
