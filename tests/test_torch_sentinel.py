"""The trainer's SDC sentinel (``integrity/sentinel.py``) against the JAX
package's (``tests/integrity/test_sentinel.py`` :107 in canary mode, :262,
:289, :309, :335; the dp-vote cases are multi-GPU work).

Both loops run the canary on the same schedule from one flax init on the
same ``SyntheticTokens`` batches (JAX on its 8-device virtual mesh with
``mode="canary"``, the port on CPU tensors). Exact against JAX: the
sentinel's counters and quarantine, the flight events' steps, the halt
reasons, the trainer's step. The losses within 2e-6 relative. Inside the
port bit for bit: the final state of every recovered run equals the clean
run's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.integrity import SentinelConfig as JSentinel
from neuronx_distributed_tpu.models import llama as jllama
from neuronx_distributed_tpu.observability.flight_recorder import FlightRecorder as JFlight
from neuronx_distributed_tpu.trainer import OptimizerConfig as JOptimizerConfig
from neuronx_distributed_tpu.trainer import data as jdata
from neuronx_distributed_tpu.trainer import faults as jfaults
from neuronx_distributed_tpu.trainer import loop as jloop
from neuronx_distributed_tpu_torch.integrity import SentinelConfig
from neuronx_distributed_tpu_torch.models import llama as tllama
from neuronx_distributed_tpu_torch.models.convert import flax_to_torch
from neuronx_distributed_tpu_torch.observability.flight_recorder import FlightRecorder
from neuronx_distributed_tpu_torch.trainer import data as tdata
from neuronx_distributed_tpu_torch.trainer import faults as tfaults
from neuronx_distributed_tpu_torch.trainer import loop as tloop
from neuronx_distributed_tpu_torch.trainer import trainer as ttrainer

pytestmark = pytest.mark.chaos
torch.set_num_threads(1)
BS, SEQ, STEPS = 8, 16, 6
CHECK = 2  # steps 1, 3, 5 close check windows
LOSS_RTOL = 2e-6
_PARAMS = {}
_JMODEL = []


@pytest.fixture(autouse=True)
def _flax_init(monkeypatch):
    def init(model, seed=0):
        if seed not in _PARAMS:
            m = jllama.LlamaForCausalLM(jllama.tiny_llama(num_layers=2, max_seq_len=32),
                                        attention_impl="xla")
            p = nn.unbox(m.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32)))
            _PARAMS[seed] = jax.tree_util.tree_map(np.asarray, {"params": p["params"]})
        model.load_state_dict(flax_to_torch(_PARAMS[seed], model.config))
        return model

    monkeypatch.setattr(ttrainer, "init_params", init)


def _run(side, *, check=CHECK, inj=None, cursor=True, steps=STEPS, sentinel=True):
    mod = {"jax": (jloop, jfaults, jdata, JSentinel, JFlight),
           "port": (tloop, tfaults, tdata, SentinelConfig, FlightRecorder)}[side]
    losses = []

    class Rec(mod[0].Callback):
        def on_step_end(self, trainer, metrics):
            losses.append(float(metrics["loss"]))

    if side == "jax":
        if not _JMODEL:
            _JMODEL.append(jllama.LlamaForCausalLM(jllama.tiny_llama(num_layers=2, max_seq_len=32),
                                                   attention_impl="xla"))
        model, kw = _JMODEL[0], dict(optimizer_config=JOptimizerConfig(zero1=False))
    else:
        model, kw = tllama.LlamaForCausalLM(tllama.tiny_llama(num_layers=2, max_seq_len=32),
                                            device="cpu", trainable=True), {}
    flight = mod[4](subsystem="trainer")
    injector = inj(mod[1]) if inj is not None else None
    tr = mod[0].Trainer(model=model, callbacks=[Rec()], fault_injector=injector,
                        flight_recorder=flight,
                        integrity=mod[3](check_every=check, mode="canary") if sentinel else None,
                        **kw)
    src = mod[2].SyntheticTokens(256, BS, SEQ, seed=3)
    if not cursor:
        it = iter(src)

        def gen():
            while True:
                yield next(it)

        src = gen()
    halted = None
    try:
        tr.fit(src, jax.random.PRNGKey(0) if side == "jax" else 0, max_steps=steps)
    except mod[0].TrainerHalted as e:
        halted = e
    return dict(tr=tr, inj=injector, losses=losses, flight=flight, halted=halted)


def _facts(r):
    tr, s = r["tr"], r["tr"]._sentinel
    events = [(e["kind"], e.get("step", e.get("to_step"))) for e in r["flight"].events()
              if e["kind"].startswith("sdc")]
    return dict(mode=s.mode if s else None, counters=dict(s.counters) if s else None,
                quarantined=list(s.quarantined_devices) if s else None, step=tr.step,
                skips=tr.anomaly_skips, halt=tr.halt_reason, events=events,
                flips=r["inj"].counters["bit_flips"] if r["inj"] else None)


def _both(**kw):
    p, j = _run("port", **kw), _run("jax", **kw)
    assert _facts(p) == _facts(j)
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=LOSS_RTOL, atol=0)
    return p, j


def _state(tr):
    return [t.detach().clone() for t in tr._state_leaves()]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


_CLEAN = {}


def _clean():
    if not _CLEAN:
        r = _run("port", sentinel=False)
        _CLEAN.update(losses=r["losses"], state=_state(r["tr"]))
    return _CLEAN


def test_clean_run_no_false_positives_and_bit_identical():
    """test_sentinel.py:107 and :289 in canary mode: every check clean, no
    rollback; the stream and the final state equal the sentinel-off run's
    bit for bit."""
    p, _ = _both()
    s = p["tr"]._sentinel
    assert s.mode == "canary" and s.counters == {"integrity_checks": STEPS // CHECK,
                                                 "sdc_detected": 0, "sdc_unlocalized": 0,
                                                 "sdc_rollbacks": 0}
    assert p["losses"] == _clean()["losses"] and _same(_state(p["tr"]), _clean()["state"])


@pytest.mark.parametrize("target", ["params", "opt_state"])
def test_canary_detects_a_flip_at_a_check_step_and_recovers(target):
    """test_sentinel.py:262: a flip landing at check step 3 makes the two
    runs of the step disagree: detected at its own check (trainer step 4),
    unlocalized, rolled back to step 2 and retrained to the clean final
    state bit for bit."""
    p, _ = _both(inj=lambda F: F.FaultInjector().flip_bits(target, at=3))
    s = p["tr"]._sentinel
    assert p["inj"].counters["bit_flips"] == 1
    assert s.counters == {"integrity_checks": 4, "sdc_detected": 1, "sdc_unlocalized": 1,
                          "sdc_rollbacks": 1}
    assert s.quarantined_devices == [] and p["tr"].step == STEPS
    assert ("sdc_detected", 4) in _facts(p)["events"] and ("sdc_rollback", 2) in _facts(p)["events"]
    assert _same(_state(p["tr"]), _clean()["state"])
    assert p["tr"].anomaly_skips == 0  # the loud guard never saw it


def test_a_flip_between_checks_is_outside_the_canarys_reach():
    """A flip at step 2 (no check) is carried quietly into step 3's
    pre-step state, so both runs of the check agree: undetected, in JAX as
    in the port, and the final state is not the clean one."""
    p, _ = _both(inj=lambda F: F.FaultInjector().flip_bits("params", at=2))
    assert p["tr"]._sentinel.counters["sdc_detected"] == 0
    assert not _same(_state(p["tr"]), _clean()["state"])


def test_detection_without_data_cursor_halts_for_cause():
    """test_sentinel.py:309 (canary on both sides): no cursor to replay the
    discarded batches, so the run halts."""
    p, _ = _both(cursor=False, inj=lambda F: F.FaultInjector().flip_bits("params", at=3))
    assert "silent data corruption" in p["tr"].halt_reason
    s = p["tr"]._sentinel
    assert s.counters["sdc_detected"] == 1 and s.counters["sdc_rollbacks"] == 0


def test_sentinel_host_traffic_rides_the_one_deferred_read(monkeypatch):
    """test_sentinel.py:335: with the guard and the sentinel on, still one
    read a step; a check step's read carries its two fingerprints beside
    the guard's pair."""
    sizes = []
    real = tloop.Trainer._host_read

    def counting(self, pending):
        sizes.append(pending.host.numel())
        return real(self, pending)

    monkeypatch.setattr(tloop.Trainer, "_host_read", counting)
    r = _run("port")
    assert r["tr"].host_reads == STEPS == len(sizes)
    assert sizes == [4 if (i + 1) % CHECK == 0 else 2 for i in range(STEPS)]
    assert r["tr"]._sentinel.counters["integrity_checks"] == STEPS // CHECK


def test_check_every_step_swaps_buffers_correctly():
    """check_every=1: each check's candidate waits in the scratch buffer while
    the next step's pre-step copy lands there; clean runs stay clean and
    bit-identical, a flip is detected at its own check and recovered."""
    r = _run("port", check=1)
    assert r["tr"]._sentinel.counters["sdc_detected"] == 0
    assert r["losses"] == _clean()["losses"] and _same(_state(r["tr"]), _clean()["state"])
    p, _ = _both(check=1, inj=lambda F: F.FaultInjector().flip_bits("params", at=4))
    assert p["tr"]._sentinel.counters["sdc_rollbacks"] == 1
    assert _same(_state(p["tr"]), _clean()["state"])


def test_state_stays_at_its_addresses_and_the_snapshots_are_accounted():
    """Restore and rollback copy in place: the fingerprint table built at
    the fit's start stays valid; the HBM ledger holds two state-sized
    snapshot buffers."""
    r = _run("port", inj=lambda F: F.FaultInjector().flip_bits("params", at=3))
    tr = r["tr"]
    fp = tr._sentinel._fp.__wrapped__
    assert [t.data_ptr() for t in tr._state_leaves()] == [t.data_ptr() for t in fp.leaves]
    state_bytes = sum(t.numel() * t.element_size() for t in tr._state_leaves())
    assert tr.hbm.resident_bytes("integrity_snapshots") == 2 * state_bytes
    snap = tr.programs.snapshot()["by_program"]
    assert snap["integrity_fingerprint"]["dispatches"] == 2 * 4
    # steps 2-4 ran twice (the detection lands after step 4's dispatch), and
    # four canary re-runs
    assert snap["train_step"]["dispatches"] == STEPS + 3 + 4
