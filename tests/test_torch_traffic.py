"""Seeded traffic replay against the JAX package (``serving/traffic.py``):
``tape_bytes`` equal to JAX's byte for byte for poisson and bursty tenants
at several seeds; ``json.dumps(build_report(...))`` of the port's engine
equal to the JAX engine's on the same greedy tape under ``fifo`` and
``slo``, on row and paged engines, with equal per-request streams (CPU,
fp32, tiny_llama from one seed); the virtual clock required, overload
attributed, an unplaceable arrival that does not end the replay, and the
determinism pin (two replays, one report)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.observability.slo import SLOSpec as JSLOSpec
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu.serving import traffic as jtraffic
from neuronx_distributed_tpu_torch.observability.slo import SLOSpec
from neuronx_distributed_tpu_torch.serving import traffic
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from neuronx_distributed_tpu_torch.serving.traffic import (
    TenantProfile,
    VirtualClock,
    generate_tape,
    replay,
    tape_bytes,
)
from test_torch_llama import build_pair

torch.set_num_threads(1)


def _tenants(mod, arrival="poisson", chat_rps=2.0, docs_rps=0.8):
    """The JAX suite's two-tenant mix (``tests/serving/test_traffic.py``)."""
    return [
        mod.TenantProfile("chat", rate_rps=chat_rps, arrival=arrival, workload="chat",
                          priority="interactive", burst_factor=4.0, burst_period_s=4.0,
                          burst_duty=0.25),
        mod.TenantProfile("docs", rate_rps=docs_rps, arrival=arrival, workload="longdoc",
                          priority="batch"),
    ]


# --- the tape ------------------------------------------------------------------


@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
@pytest.mark.parametrize("seed", [0, 11, 12345])
def test_tape_bytes_equal_jax(arrival, seed):
    args = dict(duration_s=20.0, seed=seed, vocab_size=512)
    tape = generate_tape(_tenants(traffic, arrival), **args)
    jtape = jtraffic.generate_tape(_tenants(jtraffic, arrival), **args)
    assert tape_bytes(tape) == jtraffic.tape_bytes(jtape)
    assert len(tape) > 10
    assert tape_bytes(tape) != tape_bytes(generate_tape(_tenants(traffic, arrival),
                                                        **{**args, "seed": seed + 1}))


def test_tape_shapes_streams_and_validation():
    tape = generate_tape(_tenants(traffic, "bursty"), duration_s=30.0, seed=3, vocab_size=128)
    assert [a.t for a in tape] == sorted(a.t for a in tape)
    assert all(0.0 <= a.t < 30.0 and all(1 <= t < 128 for t in a.prompt) for a in tape)
    chat = [len(a.prompt) for a in tape if a.tenant == "chat"]
    docs = [len(a.prompt) for a in tape if a.tenant == "docs"]
    assert chat and docs and max(chat) <= 16 and min(docs) >= 24
    # adding a tenant never perturbs another's arrivals
    solo = generate_tape(_tenants(traffic)[:1], duration_s=20.0, seed=11, vocab_size=512)
    both = generate_tape(_tenants(traffic), duration_s=20.0, seed=11, vocab_size=512)
    assert tape_bytes(solo) == tape_bytes([a for a in both if a.tenant == "chat"])
    for bad in (dict(rate_rps=0.0), dict(arrival="fractal"), dict(workload="video"),
                dict(arrival="bursty", burst_duty=1.5)):
        with pytest.raises(ValueError):
            TenantProfile("x", **bad)
    with pytest.raises(ValueError):
        generate_tape([TenantProfile("a"), TenantProfile("a")], 10.0)
    with pytest.raises(ValueError):
        generate_tape([TenantProfile("a")], 0.0)


# --- replay against the JAX engine ---------------------------------------------


@pytest.fixture(scope="module")
def setup():
    return build_pair(seed=1)


# chat's bound is tight, docs' loose: under this load the SLO policy both
# reorders and preempts (a docs victim for a pressured chat request)
_SLO = {"chat": dict(ttft_p99_s=0.15, tpot_p99_s=0.05), "docs": dict(ttft_p99_s=100.0)}


def _engines(setup, scheduling, paged, **kw):
    jm, jp, tm = setup
    clock, jclock = VirtualClock(), jtraffic.VirtualClock()
    common = dict(num_slots=2, decode_chunk_size=4, prefix_cache=None, scheduling=scheduling,
                  sleep_fn=lambda s: None, **kw)
    if paged:
        common["kv_page_size"] = 8
    port = ServingEngine(tm, time_fn=clock, slo={t: SLOSpec(**s) for t, s in _SLO.items()},
                         **common)
    jeng = JServingEngine(jm, jp, time_fn=jclock,
                          slo={t: JSLOSpec(**s) for t, s in _SLO.items()}, **common)
    return (port, clock), (jeng, jclock)


def _streams(engine):
    return [(r.rid, r.state.value, list(r.tokens))
            for r in sorted(engine.scheduler.requests.values(), key=lambda r: r.rid)]


@pytest.mark.parametrize("paged", [False, True], ids=["row", "paged"])
@pytest.mark.parametrize("scheduling", ["fifo", "slo"])
def test_replay_report_equals_jax(setup, scheduling, paged):
    """The same greedy bursty tape through both engines: the report's JSON
    (per-tenant TTFT/TPOT percentiles, attainment, goodput, attribution,
    preemptions) and every request's stream are equal."""
    tape = generate_tape(_tenants(traffic, "bursty", 6.0, 1.5), duration_s=3.0, seed=9,
                         vocab_size=256)
    jtape = jtraffic.generate_tape(_tenants(jtraffic, "bursty", 6.0, 1.5), duration_s=3.0,
                                   seed=9, vocab_size=256)
    assert tape_bytes(tape) == jtraffic.tape_bytes(jtape) and len(tape) > 20
    (port, clock), (jeng, jclock) = _engines(setup, scheduling, paged)
    report = replay(port, tape, clock, step_dt=0.05)
    jreport = jtraffic.replay(jeng, jtape, jclock, step_dt=0.05)
    assert json.dumps(report) == json.dumps(jreport)
    assert _streams(port) == _streams(jeng)
    assert report["completed"] == len(tape) and not report["replay"]["truncated"]
    assert report["slo"]["attained"] + report["slo"]["violated"] == len(tape)
    if scheduling == "slo":
        assert report["preemptions"] >= 1  # the policy chose a victim
        assert port.policy.snapshot() == jeng.policy.snapshot()
    else:
        assert report["preemptions"] == 0
    if paged:
        port.cache.check()


def test_replay_requires_the_virtual_clock(setup):
    engine = ServingEngine(setup[2], num_slots=2, prefix_cache=None)
    with pytest.raises(ValueError, match="time_fn"):
        replay(engine, [], VirtualClock())
    clock = VirtualClock()
    with pytest.raises(ValueError, match="step_dt"):
        replay(ServingEngine(setup[2], num_slots=2, time_fn=clock), [], clock, step_dt=0.0)


def test_same_seed_identical_report(setup):
    """The determinism pin, port alone: two byte-identical tapes through two
    fresh engines give identical reports, key order included."""
    reports = []
    for _ in range(2):
        tape = generate_tape(_tenants(traffic, "bursty"), duration_s=3.0, seed=9, vocab_size=256)
        clock = VirtualClock()
        port = ServingEngine(setup[2], num_slots=2, decode_chunk_size=4, prefix_cache=None,
                             scheduling="slo", time_fn=clock, sleep_fn=lambda s: None,
                             slo={t: SLOSpec(**s) for t, s in _SLO.items()})
        reports.append(replay(port, tape, clock, step_dt=0.05))
    assert json.dumps(reports[0]) == json.dumps(reports[1])


def test_overload_rejects_and_sheds_attributed(setup):
    """Open loop under a bounded queue: arrivals past capacity are rejected
    (attributed to the tenant, SLO violations) and queue timeouts shed;
    every arrival is accounted for."""
    tape = generate_tape([TenantProfile("chat", rate_rps=30.0, workload="chat",
                                        priority="interactive", queue_timeout_s=0.3)],
                         duration_s=2.0, seed=3, vocab_size=256)
    assert len(tape) > 20
    clock = VirtualClock()
    engine = ServingEngine(setup[2], num_slots=2, decode_chunk_size=4, prefix_cache=None,
                           max_queue=4, time_fn=clock, sleep_fn=lambda s: None,
                           slo={"chat": SLOSpec(ttft_p99_s=0.15, tpot_p99_s=0.05)})
    report = replay(engine, tape, clock, step_dt=0.05)
    rep, row = report["replay"], report["tenants"]["chat"]
    assert rep["submitted"] + rep["rejected"] == len(tape) and rep["rejected"] > 0
    assert row["rejects"] == rep["rejected"]
    assert row["completed"] + row["sheds"] + row["rejects"] == len(tape)
    assert report["slo"]["violation_reasons"]["chat"]["reject"] == rep["rejected"]


def test_unplaceable_arrival_does_not_end_the_replay(setup):
    """Every longdoc arrival is over ``max_tokens_in_flight``: each fails at
    the door, is attributed as a reject for its tenant, and the chat
    traffic is served in full."""
    tape = generate_tape(_tenants(traffic), duration_s=3.0, seed=7, vocab_size=256)
    n_docs = sum(a.tenant == "docs" for a in tape)
    assert n_docs
    clock = VirtualClock()
    engine = ServingEngine(setup[2], num_slots=2, decode_chunk_size=4, prefix_cache=None,
                           time_fn=clock, sleep_fn=lambda s: None, max_tokens_in_flight=38,
                           slo={t: SLOSpec(**s) for t, s in _SLO.items()})
    report = replay(engine, tape, clock, step_dt=0.05)
    rep = report["replay"]
    assert rep["unplaceable"] == n_docs
    assert rep["submitted"] + rep["rejected"] + rep["unplaceable"] == len(tape)
    assert report["tenants"]["docs"]["rejects"] == n_docs
    assert report["slo"]["violation_reasons"]["docs"]["reject"] == n_docs
    assert report["tenants"]["chat"]["completed"] == len(tape) - n_docs
    assert all(r.state is RequestState.DONE for r in engine.scheduler.requests.values())


def test_arrival_seed_is_the_request_seed(setup):
    """An arrival's ``key_seed`` is its request's sampling seed: a sampled
    tenant's streams equal solo ``generate`` with that seed."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig, generate

    tp = dataclasses.replace(_tenants(traffic)[0], temperature=0.8)
    tape = generate_tape([tp], duration_s=1.5, seed=4, vocab_size=256)
    clock = VirtualClock()
    engine = ServingEngine(setup[2], num_slots=2, decode_chunk_size=4, time_fn=clock,
                           sleep_fn=lambda s: None)
    replay(engine, tape, clock, step_dt=0.05)
    reqs = sorted(engine.scheduler.requests.values(), key=lambda r: r.rid)
    assert len(reqs) == len(tape) > 1
    for a, r in zip(tape, reqs):
        cfg = GenerationConfig(max_new_tokens=a.max_new_tokens, temperature=a.temperature)
        solo = generate(setup[2], np.asarray(a.prompt, np.int32)[None], cfg, seed=a.key_seed)
        assert r.seed == a.key_seed and r.tokens == solo[0].tolist()
