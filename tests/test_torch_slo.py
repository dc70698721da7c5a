"""SLO accounting against the JAX package (``observability/slo.py``): the
same ``record_finish``/``record_violation`` sequence gives equal
``SLOTracker.snapshot()``, ``state()`` and registry exports in both
frameworks; and the engine-level cases of
``tests/observability/test_slo.py`` (classification under a fake clock,
sheds and rejects as violations) give equal ``slo`` and ``tenants`` blocks
from the port's engine and the JAX engine built from one seed (CPU, fp32,
tiny_llama)."""

import json

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.observability import registry as jreg
from neuronx_distributed_tpu.observability.slo import SLOSpec as JSLOSpec
from neuronx_distributed_tpu.observability.slo import SLOTracker as JSLOTracker
from neuronx_distributed_tpu.serving import RejectedError as JRejectedError
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.observability import registry as treg
from neuronx_distributed_tpu_torch.observability.slo import SLOSpec, SLOTracker
from neuronx_distributed_tpu_torch.serving.engine import RejectedError, ServingEngine
from test_torch_llama import build_pair

torch.set_num_threads(1)


def _events(seed, n=120):
    """A seeded sequence of finishes and violations over four tenants,
    one of them without a spec."""
    rng = np.random.default_rng(seed)
    tenants = ["chat", "docs", "batch", "nospec"]
    out, t = [], 0.0
    for _ in range(n):
        t += float(rng.exponential(0.05))
        tenant = tenants[int(rng.integers(0, 4))]
        if rng.random() < 0.7:
            ttft = None if rng.random() < 0.05 else float(rng.exponential(0.3))
            tpot = None if rng.random() < 0.1 else float(rng.exponential(0.04))
            out.append(("finish", tenant, ttft, tpot, int(rng.integers(1, 40)), t))
        else:
            reason = ["shed_queue", "shed_inflight", "reject", "failed_prefill"][
                int(rng.integers(0, 4))]
            now = None if reason == "reject" and rng.random() < 0.5 else t
            out.append(("violation", tenant, reason, int(rng.integers(0, 9)), now))
    return out


def _track(spec_mod, tracker_cls, reg_mod, events):
    specs = {"chat": spec_mod(ttft_p99_s=0.5, tpot_p99_s=0.05),
             "docs": spec_mod(ttft_p99_s=4.0), "batch": spec_mod(tpot_p99_s=0.1)}
    reg = reg_mod.MetricsRegistry()
    view = reg_mod.MetricsView(reg, ("engine",), ("e",))
    tr = tracker_cls(specs, view=view, prefix="serving_slo")
    verdicts = []
    for ev in events:
        if ev[0] == "finish":
            _, tenant, ttft, tpot, tokens, now = ev
            verdicts.append(tr.record_finish(tenant, ttft, tpot, tokens, now))
        else:
            _, tenant, reason, tokens, now = ev
            tr.record_violation(tenant, now, reason=reason, tokens=tokens)
    return tr, reg, verdicts


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tracker_snapshot_state_and_exports_equal_jax(seed):
    events = _events(seed)
    jt, jr, jv = _track(JSLOSpec, JSLOTracker, jreg, events)
    tt, tr, tv = _track(SLOSpec, SLOTracker, treg, events)
    assert tv == jv
    assert json.dumps(tt.snapshot()) == json.dumps(jt.snapshot())
    assert json.dumps(tt.state()) == json.dumps(jt.state())
    assert tr.prometheus_text() == jr.prometheus_text()
    for tenant in ("chat", "docs", "batch", "nospec", "unknown"):
        assert tt.decided(tenant) == jt.decided(tenant)
        assert tt.attainment(tenant) == jt.attainment(tenant)


def test_restore_state_merges_like_jax():
    events = _events(5)
    jt, _, _ = _track(JSLOSpec, JSLOTracker, jreg, events)
    tt, _, _ = _track(SLOSpec, SLOTracker, treg, events)
    state = tt.state()
    assert state == jt.state()
    j2, t2 = JSLOTracker(JSLOSpec(ttft_p99_s=1.0)), SLOTracker(SLOSpec(ttft_p99_s=1.0))
    j2.record_finish("x", 0.1, None, 3, 100.0)
    t2.record_finish("x", 0.1, None, 3, 100.0)
    j2.restore_state(jt.state(), shift_s=50.0)
    t2.restore_state(state, shift_s=50.0)
    assert json.dumps(t2.snapshot()) == json.dumps(j2.snapshot())


def test_spec_validation_and_attains():
    with pytest.raises(ValueError):
        SLOSpec(ttft_p99_s=0.0)
    with pytest.raises(ValueError, match="not both"):
        SLOTracker(SLOSpec(), default=SLOSpec())
    with pytest.raises(TypeError):
        SLOTracker({"a": 1.0})
    s = SLOSpec(ttft_p99_s=0.5, tpot_p99_s=0.05)
    for args in ((0.4, 0.04), (0.6, 0.04), (0.4, 0.06), (None, 0.01), (0.1, None)):
        assert s.attains(*args) == JSLOSpec(ttft_p99_s=0.5, tpot_p99_s=0.05).attains(*args)


# --- engine level: tests/observability/test_slo.py:156-229 ------------------


@pytest.fixture(scope="module")
def setup():
    jm, jp, tm = build_pair(seed=1)
    return jm, jp, tm


def _pair(setup, clock, **kw):
    jm, jp, tm = setup
    jslo, tslo = kw.pop("slo")
    port = ServingEngine(tm, time_fn=lambda: clock["t"], slo=tslo, **kw)
    jeng = JServingEngine(jm, jp, time_fn=lambda: clock["t"], slo=jslo, **kw)
    return port, jeng


def _jcfg(g):
    return JGenerationConfig(max_new_tokens=g.max_new_tokens, temperature=g.temperature)


def test_engine_classifies_requests_against_slo(setup):
    """A request admitted at once attains; one that waits for the busy slot
    past its 0.5 s TTFT bound violates. Both engines agree on every
    classification, the request verdicts and the registry's export."""
    clock = {"t": 0.0}
    port, jeng = _pair(setup, clock, num_slots=1, decode_chunk_size=2, prefix_cache=None,
                       slo=({"chat": JSLOSpec(ttft_p99_s=0.5)}, {"chat": SLOSpec(ttft_p99_s=0.5)}))
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    out = {}
    for name, eng, cfg, kw in (("port", port, gcfg, dict(seed=0)),
                               ("jax", jeng, _jcfg(gcfg), dict(key=jax.random.PRNGKey(0)))):
        clock["t"] = 0.0
        fast = eng.submit(np.asarray([1, 2, 3], np.int32), cfg, tenant="chat", **kw)
        eng.step()
        slow = eng.submit(np.asarray([4, 5, 6], np.int32), cfg, tenant="chat", **kw)
        while slow.slot is None and eng.has_work:
            clock["t"] += 0.4
            eng.step()
        eng.run()
        out[name] = (fast, slow, eng.metrics.snapshot(), eng.metrics.registry.prometheus_text())
    fast, slow, snap, text = out["port"]
    assert snap["slo"] == out["jax"][2]["slo"]
    assert snap["tenants"] == out["jax"][2]["tenants"]
    assert snap["slo"]["attained"] == 1 and snap["slo"]["violated"] == 1
    assert snap["slo"]["violation_reasons"] == {"chat": {"latency": 1}}
    assert snap["slo"]["attained_tokens"] == len(fast.tokens)
    assert port.metrics.request_snapshot(fast.rid)["slo_attained"] is True
    assert port.metrics.request_snapshot(slow.rid)["slo_attained"] is False
    assert 'serving_slo_attained_requests{tenant="chat"} 1' in text
    assert 'serving_slo_violated_requests{tenant="chat"} 1' in text
    for key in ("ttft_p50_s", "ttft_p95_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
                "queue_wait_p95_s"):
        assert snap[key] == out["jax"][2][key], key


def test_engine_shed_and_reject_are_violations(setup):
    """A queue-timeout shed and a door reject land on their tenants as
    violations, with the JAX engine's reasons and counts."""
    clock = {"t": 0.0}
    port, jeng = _pair(setup, clock, num_slots=1, decode_chunk_size=2, prefix_cache=None,
                       max_queue=1, slo=(JSLOSpec(ttft_p99_s=10.0), SLOSpec(ttft_p99_s=10.0)))
    gcfg = GenerationConfig(max_new_tokens=20, temperature=0.0)
    snaps = {}
    for name, eng, cfg, rejected in (("port", port, gcfg, RejectedError),
                                     ("jax", jeng, _jcfg(gcfg), JRejectedError)):
        clock["t"] = 0.0
        eng.submit(np.asarray([1, 2], np.int32), cfg, tenant="a")
        eng.step()
        victim = eng.submit(np.asarray([3, 4], np.int32), cfg, tenant="b", queue_timeout_s=1.0)
        with pytest.raises(rejected):
            eng.submit(np.asarray([5, 6], np.int32), cfg, tenant="c")
        clock["t"] = 2.0
        eng.run()
        assert victim.tokens == []
        snaps[name] = eng.metrics.snapshot()
    snap = snaps["port"]
    assert snap["slo"] == snaps["jax"]["slo"]
    assert snap["tenants"] == snaps["jax"]["tenants"]
    assert snap["slo"]["violation_reasons"]["b"] == {"shed_queue": 1}
    assert snap["slo"]["violation_reasons"]["c"] == {"reject": 1}
    assert snap["tenants"]["b"]["sheds"] == 1 and snap["tenants"]["c"]["rejects"] == 1
    assert snap["slo"]["per_tenant"]["a"]["attained"] == 1
