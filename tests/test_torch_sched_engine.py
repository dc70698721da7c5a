"""SLO-aware scheduling through the live engine (the port's counterparts of
``tests/serving/test_sched_engine.py`` and ``test_sched_chaos.py``; CPU,
fp32, tiny_llama from one seed). The policy may change WHO runs WHEN, never
WHAT anyone generates: SLO streams equal FIFO streams and solo
``generate``, sampled tenants too, and the JAX SLO engine's greedy
streams; a selectively preempted victim resumes bit-identically on row and
paged engines; priority tiers reorder admission; the decode step keeps one
program on the same buffers through selective preemptions; ``host_reads``
equals a bare engine's with the SLO policy, a registry, ``slo=`` and a
timeline on; and the policy composes with dispatch recovery and slot
quarantine. Cases the JAX suite marks slow run the port alone."""

import json

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.observability.slo import SLOSpec as JSLOSpec
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry
from neuronx_distributed_tpu_torch.observability.slo import SLOSpec
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
from neuronx_distributed_tpu_torch.serving.sched import (
    FeedbackConfig,
    FifoPolicy,
    SloPolicy,
)
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from neuronx_distributed_tpu_torch.utils.timeline import Timeline
from test_torch_decode_program import _step_buffers
from test_torch_llama import build_pair
from test_torch_serving import _solo

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    return build_pair(seed=1)


def _workload(n=6, seed=11, max_new=(4, 9), sampled=(1, 4)):
    """The JAX suite's mix, with two sampled requests."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, 256, size=rng.randint(3, 12)).astype(np.int32) for _ in range(n)]
    cfgs = [GenerationConfig(max_new_tokens=int(rng.randint(*max_new)),
                             temperature=0.8 if i in sampled else 0.0, top_k=20)
            for i in range(n)]
    return prompts, cfgs


def _run(tmodel, prompts, cfgs, tenants, priorities, **kw):
    engine = ServingEngine(tmodel, num_slots=2, decode_chunk_size=3, sleep_fn=lambda s: None,
                           **kw)
    reqs = [engine.submit(p, c, seed=500 + i, tenant=t, priority=pr)
            for i, (p, c, t, pr) in enumerate(zip(prompts, cfgs, tenants, priorities))]
    engine.run()
    return engine, reqs


def test_slo_streams_equal_fifo_generate_and_jax(setup):
    """The same mixed-tenant workload through a FIFO engine and an SLO engine:
    every stream (sampled ones too) equals solo ``generate``; the greedy
    ones equal the JAX SLO engine's; every request classified once."""
    jm, jp, tm = setup
    prompts, cfgs = _workload()
    tenants = ["chat", "docs"] * 3
    priorities = ["interactive", "batch"] * 3
    slo = {t: SLOSpec(ttft_p99_s=1e6, tpot_p99_s=1e6) for t in ("chat", "docs")}
    refs = [_solo(tm, p, c, 500 + i) for i, (p, c) in enumerate(zip(prompts, cfgs))]
    fifo, freqs = _run(tm, prompts, cfgs, tenants, priorities, scheduling="fifo", slo=dict(slo))
    sched, sreqs = _run(tm, prompts, cfgs, tenants, priorities, scheduling="slo", slo=dict(slo))
    jeng = JServingEngine(jm, jp, num_slots=2, decode_chunk_size=3, sleep_fn=lambda s: None,
                          scheduling="slo",
                          slo={t: JSLOSpec(ttft_p99_s=1e6, tpot_p99_s=1e6)
                               for t in ("chat", "docs")})
    jreqs = [jeng.submit(p, JGenerationConfig(max_new_tokens=c.max_new_tokens,
                                              temperature=c.temperature, top_k=c.top_k),
                         key=jax.random.PRNGKey(500 + i), tenant=t, priority=pr)
             for i, (p, c, t, pr) in enumerate(zip(prompts, cfgs, tenants, priorities))]
    jeng.run()
    for i, (fr, sr, jr, ref) in enumerate(zip(freqs, sreqs, jreqs, refs)):
        assert fr.state is sr.state is RequestState.DONE
        assert fr.tokens == ref and sr.tokens == ref, i
        if cfgs[i].temperature == 0.0:
            assert sr.tokens == jr.tokens, i
    assert isinstance(fifo.policy, FifoPolicy) and isinstance(sched.policy, SloPolicy)
    for eng in (fifo, sched):
        s = eng.metrics.snapshot()["slo"]
        assert s["attained"] + s["violated"] == 6
    js = jeng.metrics.snapshot()["slo"]
    assert js["attained"] + js["violated"] == 6
    assert sched.policy.snapshot()["fairness"]["tokens_charged"] == sum(len(r.tokens)
                                                                       for r in sreqs)


def test_fifo_policy_is_the_default_engine(setup):
    """``scheduling="fifo"`` is the engine without the argument: the same
    streams and admission counts."""
    tm = setup[2]
    prompts, cfgs = _workload(n=5, seed=23)
    tenants, prios = ["a", "b", "a", "b", "a"], ["standard"] * 5
    base, breqs = _run(tm, prompts, cfgs, tenants, prios)
    fifo, freqs = _run(tm, prompts, cfgs, tenants, prios, scheduling="fifo")
    assert [r.tokens for r in breqs] == [r.tokens for r in freqs]
    b, f = base.metrics.snapshot(), fifo.metrics.snapshot()
    assert {k: b[k] for k in ("completed", "prefills", "preemptions", "chunks")} == \
        {k: f[k] for k in ("completed", "prefills", "preemptions", "chunks")}


def _hot_policy():
    """One decided sample is pressure enough; no cooldown; any victim."""
    return SloPolicy(feedback=FeedbackConfig(min_decided=1, cooldown_s=0.0,
                                             min_victim_remaining=1))


def _stage_pressured(tm, rng, page_size=None, injector=None, **kw):
    """One chat request finishes and violates its unmeetable TTFT bound
    (pressure), then two healthy docs requests fill both slots."""
    extra = dict(kv_page_size=page_size) if page_size else {}
    engine = ServingEngine(tm, num_slots=2, decode_chunk_size=3, scheduling=_hot_policy(),
                           sleep_fn=lambda s: None, fault_injector=injector,
                           slo={"chat": SLOSpec(ttft_p99_s=1e-9, tpot_p99_s=1e6)}, **extra,
                           **kw)
    chat_cfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    docs_cfg = GenerationConfig(max_new_tokens=14, temperature=0.0)
    reqs, refs = {}, {}

    def sub(name, tenant, priority, gcfg, plen):
        prompt = rng.randint(1, 256, size=plen).astype(np.int32)
        seed = 1000 + len(reqs)
        refs[name] = _solo(tm, prompt, gcfg, seed)
        reqs[name] = engine.submit(prompt, gcfg, seed=seed, tenant=tenant, priority=priority)

    sub("chat_a", "chat", "interactive", chat_cfg, 5)
    while not reqs["chat_a"].finished:
        engine.step()
    sub("docs_a", "docs", "batch", docs_cfg, 7)
    sub("docs_b", "docs", "batch", docs_cfg, 9)
    engine.step()
    assert engine.cache.free_slots == 0
    return engine, reqs, refs, sub


@pytest.mark.parametrize("page_size", [None, 8], ids=["row", "paged"])
def test_live_victim_resumes_bit_identical_on_one_program(setup, page_size):
    """A pressured chat arrival behind two healthy docs requests: the policy
    vacates the cheapest docs request mid-generation (its device ``active``
    flag cleared, a paged victim's pages back in the pool at once, the
    cursor not rewound), chat admits into the freed slot in the same step,
    and the victim resumes to its solo ``generate`` stream; the decode step
    keeps its program and every buffer address throughout."""
    tm = setup[2]
    engine, reqs, refs, sub = _stage_pressured(tm, np.random.RandomState(4), page_size)
    program, buffers = engine.decode_program, _step_buffers(engine)
    sub("chat_b", "chat", "interactive", GenerationConfig(max_new_tokens=4, temperature=0.0), 4)
    events = []
    real = engine._preempt_victims

    def watch(victims, now):
        cursor = engine.cache.cursor
        mapped = engine.cache.pages_mapped if page_size else 0
        real(victims, now)
        slots = [s for s in range(2) if engine._slot_req[s] is None]
        events.append(dict(cursor=(cursor, engine.cache.cursor),
                           active=[bool(engine._state["active"][s]) for s in slots],
                           freed=mapped - (engine.cache.pages_mapped if page_size else 0)))

    engine._preempt_victims = watch
    while engine.has_work:
        engine.step()
        if page_size:
            engine.cache.check()
        assert engine.decode_program is program and _step_buffers(engine) == buffers
    assert engine.policy.preemptions_requested >= 1 and events
    ev = events[0]
    assert ev["cursor"][0] == ev["cursor"][1] and ev["active"] == [False] * len(ev["active"])
    if page_size:
        assert ev["freed"] > 0
    victims = [n for n, r in reqs.items() if r.preemptions]
    assert victims and all(n.startswith("docs") for n in victims)
    for name, req in reqs.items():
        assert req.state is RequestState.DONE and req.tokens == refs[name], name
    snap = engine.metrics.snapshot()
    assert snap["preemptions"] >= 1
    assert snap["slo"]["attained"] + snap["slo"]["violated"] == 2  # each chat once
    assert engine.decode_compilations == 0  # nothing captured on the CPU: the step runs eagerly


def test_priority_tiers_reorder_admission(setup):
    """One slot, a stacked queue: the SLO policy admits the interactive
    arrival ahead of earlier batch arrivals; FIFO admits in arrival order;
    the streams are the same either way."""
    tm = setup[2]
    prompts, cfgs = _workload(n=3, seed=31, max_new=(3, 5), sampled=())
    order, streams = {}, {}
    for scheduling in ("fifo", "slo"):
        engine = ServingEngine(tm, num_slots=1, decode_chunk_size=2, scheduling=scheduling)
        reqs = [engine.submit(p, c, seed=i, tenant=t, priority=pr)
                for i, (p, c, t, pr) in enumerate(zip(prompts, cfgs, ["bulk", "bulk", "live"],
                                                      ["batch", "batch", "interactive"]))]
        engine.run()
        assert all(r.state is RequestState.DONE for r in reqs)
        order[scheduling] = sorted(range(3), key=lambda i: reqs[i].admit_time)
        streams[scheduling] = [r.tokens for r in reqs]
    assert order["fifo"] == [0, 1, 2] and order["slo"][0] == 2
    assert streams["fifo"] == streams["slo"]


@pytest.mark.parametrize("page_size", [None, 8], ids=["row", "paged"])
def test_host_reads_equal_a_bare_engine(setup, page_size, tmp_path):
    """The SLO policy, a shared registry, ``slo=`` and a timeline read
    nothing from the device: on traffic where the policy changes no decision
    the instrumented engine's ``host_reads`` equal a bare engine's, and on a
    run that preempts they still equal chunks + first tokens + prefix hits
    (each hit's validation is its one read)."""
    tm = setup[2]
    prompts, cfgs = _workload(n=6, seed=5, sampled=())
    extra = dict(kv_page_size=page_size) if page_size else {}
    bare, breqs = _run(tm, prompts, cfgs, ["a"] * 6, ["standard"] * 6, **extra)
    timeline = Timeline(str(tmp_path / "trace.json"))
    full, freqs = _run(tm, prompts, cfgs, ["a"] * 6, ["standard"] * 6, scheduling="slo",
                       registry=MetricsRegistry(), engine_label="x", timeline=timeline,
                       slo=SLOSpec(ttft_p99_s=1e6, tpot_p99_s=1e6), **extra)
    assert [r.tokens for r in breqs] == [r.tokens for r in freqs]
    assert full.host_reads == bare.host_reads
    assert full.metrics.chunks == bare.metrics.chunks
    engine, reqs, refs, sub = _stage_pressured(tm, np.random.RandomState(4), page_size,
                                               registry=MetricsRegistry(), timeline=timeline)
    sub("chat_b", "chat", "interactive", GenerationConfig(max_new_tokens=4, temperature=0.0), 4)
    engine.run()
    snap = engine.metrics.snapshot()
    assert snap["preemptions"] >= 1 and snap["prefix_hits"] >= 1  # a victim's resume hit
    # one first token a request, one read a chunk, one a validated prefix hit
    assert engine.host_reads == (snap["chunks"] + len(reqs) + snap["prefix_hits"]
                                 + snap["prefix_validation_failures"])


def test_victim_hit_by_dispatch_fault(setup):
    """The SLO victim is preempted and a later decode dispatch fails
    (recovery requeues every slot): both requeue paths interleave on the
    same requests and every stream still equals solo ``generate``; each
    chat request is classified once."""
    tm = setup[2]
    inj = FaultInjector().fail_dispatch(at=4, times=1)
    engine, reqs, refs, sub = _stage_pressured(tm, np.random.RandomState(8), injector=inj)
    sub("chat_b", "chat", "interactive", GenerationConfig(max_new_tokens=4, temperature=0.0), 4)
    engine.run()
    assert engine.policy.preemptions_requested >= 1
    assert inj.counters["dispatch_failures"] == 1
    snap = engine.metrics.snapshot()
    assert snap["recoveries"] == 1
    for name, req in reqs.items():
        assert req.state is RequestState.DONE and req.tokens == refs[name], name
    assert snap["slo"]["attained"] + snap["slo"]["violated"] == 2


def test_slo_admission_against_quarantine_shrunk_slots(setup):
    """A poisoned readback quarantines slot 0 mid-run; the SLO policy keeps
    admitting against the one slot left: streams bit-identical, the
    quarantine victim resumed, every request classified once."""
    tm = setup[2]
    rng = np.random.RandomState(10)
    inj = FaultInjector().poison_readback(at=2, slot=0, token=-1)
    engine = ServingEngine(tm, num_slots=2, decode_chunk_size=3, scheduling="slo",
                           sleep_fn=lambda s: None, fault_injector=inj,
                           slo={t: SLOSpec(ttft_p99_s=1e6, tpot_p99_s=1e6)
                                for t in ("chat", "docs")})
    names = ["chat_a", "docs_a", "chat_b", "docs_b", "chat_c"]
    prompts = [rng.randint(1, 256, size=rng.randint(4, 11)).astype(np.int32) for _ in names]
    cfgs = [GenerationConfig(max_new_tokens=5 + i % 3, temperature=0.0)
            for i in range(len(names))]
    reqs = [engine.submit(p, c, seed=300 + i, tenant=n.split("_")[0],
                          priority="interactive" if n.startswith("chat") else "batch")
            for i, (n, p, c) in enumerate(zip(names, prompts, cfgs))]
    engine.run()
    assert engine.cache.quarantined_slots == [0]
    snap = engine.metrics.snapshot()
    assert snap["quarantines"] == 1
    for i, req in enumerate(reqs):
        assert req.state is RequestState.DONE
        assert req.tokens == _solo(tm, prompts[i], cfgs[i], 300 + i), names[i]
    assert snap["slo"]["attained"] + snap["slo"]["violated"] == len(names)


def test_halt_post_mortem_carries_tenant_depths_and_slo(setup):
    """A halt's post-mortem records the per-tenant queue depths after the
    requeue and the SLO state (JAX ``engine.py:1957-1988``)."""
    tm = setup[2]
    inj = FaultInjector().fail_dispatch(at=0, times=None)
    engine = ServingEngine(tm, num_slots=2, decode_chunk_size=3, sleep_fn=lambda s: None,
                           fault_injector=inj, slo=SLOSpec(ttft_p99_s=1e6))
    for i, t in enumerate(["a", "b", "b"]):
        engine.submit(np.arange(1, 6 + i), GenerationConfig(max_new_tokens=6), tenant=t)
    engine.run()
    pm = engine.flight.last_postmortem
    assert engine.health().value == "halted" and pm is not None
    assert pm["extra"]["tenant_queue_depths"] == {"a": 1, "b": 2}
    assert set(pm["extra"]["slo_totals"]) >= {"attained", "violated", "goodput_tok_s"}
    json.dumps(pm)


def test_later_slices_refuse_loudly(setup, tmp_path):
    """Item 10c is served: ``profile_dir=`` and ``program_ledger=`` build an
    engine (a shared ledger is the engine's), and ``flip_bits("params")``
    schedules."""
    from neuronx_distributed_tpu_torch.observability.programs import ProgramLedger

    tm = setup[2]
    ledger = ProgramLedger()
    e = ServingEngine(tm, num_slots=1, profile_dir=str(tmp_path / "prof"), program_ledger=ledger)
    assert e.programs is ledger and "decode_chunk" in ledger.programs()
    # item 10b is served: the router's load signal answers (an idle FIFO
    # engine: 0; a queued request: 1) and the two stubs without a JAX
    # counterpart are gone
    engine = ServingEngine(tm, num_slots=1)
    assert engine.load_score() == 0.0 and engine.load_score(tenant="a") == 0.0
    engine.submit(np.arange(1, 6), GenerationConfig(max_new_tokens=2))
    assert engine.load_score() == 1.0 and engine.page_pressure() == 0.0
    for name in ("export_requests", "import_requests"):
        assert not hasattr(engine, name)
    assert FaultInjector().flip_bits("params").flips_params
