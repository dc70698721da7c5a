"""Request-scoped tracing against the JAX package
(``observability/tracing.py``, ``utils/timeline.py``): a traced engine's
Perfetto JSON holds one connected flow per request (one start, one end,
linked waypoints, one id and name, non-decreasing times), a request
cancelled while queued gets a closed flow, a disabled tracer records
nothing, a selectively preempted victim's flow holds its ``slo_preempt``
step, and the port's flow stage sequence of every request equals the JAX
engine's for the same run (CPU, fp32, tiny_llama from one seed). The
timeline's atomic save and flow validation are held here too."""

import json

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu.utils.timeline import Timeline as JTimeline
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.observability.slo import SLOSpec
from neuronx_distributed_tpu_torch.observability.tracing import FLOW_CATEGORY, RequestTracer
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.sched import FeedbackConfig, SloPolicy
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from neuronx_distributed_tpu_torch.utils.timeline import Timeline
from test_torch_llama import build_pair

torch.set_num_threads(1)


def _flows(trace, rid):
    return [e for e in trace["traceEvents"]
            if e.get("cat") == FLOW_CATEGORY and e.get("id") == rid and e["ph"] in "stf"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The JAX suite's traced run through both engines: two requests with a
    shared prefix retire, one is cancelled while queued."""
    jm, jp, tm = build_pair(seed=1)
    out = {}
    shared = np.arange(1, 11, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    for name in ("port", "jax"):
        path = tmp_path_factory.mktemp(name) / "serving_trace.json"
        if name == "port":
            tl = Timeline(str(path))
            eng = ServingEngine(tm, num_slots=2, decode_chunk_size=4, timeline=tl)
            sub = lambda p, i: eng.submit(p, gcfg, seed=i)  # noqa: E731
        else:
            tl = JTimeline(str(path))
            eng = JServingEngine(jm, jp, num_slots=2, decode_chunk_size=4, timeline=tl)
            jcfg = JGenerationConfig(max_new_tokens=6, temperature=0.0)
            sub = lambda p, i: eng.submit(p, jcfg, key=jax.random.PRNGKey(i))  # noqa: E731
        reqs = [sub(np.concatenate([shared, np.asarray([30 + i], np.int32)]), i)
                for i in range(2)]
        victim = sub(shared, 9)
        eng.cancel(victim.rid)
        eng.run()
        tl.save()
        with open(path) as f:
            out[name] = (reqs, victim, json.load(f))
    return out


def test_full_request_is_one_connected_flow(traced):
    reqs, _, trace = traced["port"]
    for req in reqs:
        assert req.state is RequestState.DONE
        flows = _flows(trace, req.rid)
        phases = [e["ph"] for e in flows]
        assert phases.count("s") == 1 and phases.count("f") == 1, phases
        assert phases[0] == "s" and phases[-1] == "f" and phases.count("t") >= 3
        assert len({e["name"] for e in flows}) == 1
        assert [e["ts"] for e in flows] == sorted(e["ts"] for e in flows)
        stages = [e["args"]["stage"] for e in flows]
        assert stages[0] == "submit" and stages[-1] == "retire"
        assert {"admission", "prefix_lookup", "first_token", "decode_chunk"} <= set(stages)
        assert "full_prefill" in stages or "suffix_prefill" in stages
        assert flows[-1]["args"]["tokens"] == len(req.tokens)


def test_flow_events_carry_rids_and_bind_to_slices(traced):
    _, _, trace = traced["port"]
    events = trace["traceEvents"]
    flows = [e for e in events if e.get("cat") == FLOW_CATEGORY and e["ph"] in "stf"]
    assert len({e["id"] for e in flows}) == 3
    instants = {e["name"] for e in events if e["ph"] == "i"}
    for e in flows:
        assert e["args"]["rid"] == e["id"] and e.get("bp") == "e"
        # each flow event has its instant twin carrying the payload
        assert f"{e['args']['stage']} r{e['id']}" in instants
    # the scheduling view beside the flows: prefill and decode spans, counters
    names = {e["name"] for e in events}
    assert {"prefill", "decode_dispatch", "decode_readback", "slots_active",
            "queue_depth", "chunk_tokens"} <= names


def test_cancelled_queued_request_flow_terminates(traced):
    _, victim, trace = traced["port"]
    flows = _flows(trace, victim.rid)
    assert [e["ph"] for e in flows] == ["s", "f"]
    assert flows[-1]["args"]["stage"] == "cancelled"


def test_flow_stage_sequences_equal_jax(traced):
    """Every request's flow, stage by stage with its payload, equals the
    JAX engine's."""
    preqs, pvictim, ptrace = traced["port"]
    jreqs, jvictim, jtrace = traced["jax"]
    assert [r.tokens for r in preqs] == [r.tokens for r in jreqs]
    for rid in [r.rid for r in preqs] + [pvictim.rid]:
        p = [(e["ph"], e["args"]["stage"], e["args"]) for e in _flows(ptrace, rid)]
        j = [(e["ph"], e["args"]["stage"], e["args"]) for e in _flows(jtrace, rid)]
        assert p == j, rid


def test_slo_victim_flow_holds_its_preemption(tmp_path):
    """A selectively preempted victim's flow: submit ... slo_preempt ...
    admission again ... retire, still one connected flow."""
    tm = build_pair(seed=1)[2]
    path = tmp_path / "trace.json"
    tl = Timeline(str(path))
    engine = ServingEngine(tm, num_slots=2, decode_chunk_size=3, timeline=tl,
                           scheduling=SloPolicy(feedback=FeedbackConfig(
                               min_decided=1, cooldown_s=0.0, min_victim_remaining=1)),
                           slo={"chat": SLOSpec(ttft_p99_s=1e-9)})
    rng = np.random.RandomState(4)
    chat = GenerationConfig(max_new_tokens=4, temperature=0.0)
    docs = GenerationConfig(max_new_tokens=14, temperature=0.0)
    first = engine.submit(rng.randint(1, 256, 5), chat, tenant="chat", priority="interactive")
    while not first.finished:
        engine.step()
    victims = [engine.submit(rng.randint(1, 256, n), docs, tenant="docs", priority="batch")
               for n in (7, 9)]
    engine.step()
    engine.submit(rng.randint(1, 256, 4), chat, tenant="chat", priority="interactive")
    engine.run()
    tl.save()
    trace = json.loads(path.read_text())
    hit = [r for r in victims if r.preemptions]
    assert hit
    for r in hit:
        flows = _flows(trace, r.rid)
        stages = [e["args"]["stage"] for e in flows]
        assert [e["ph"] for e in flows].count("s") == 1 and flows[-1]["ph"] == "f"
        assert "slo_preempt" in stages and stages[-1] == "retire"
        i = stages.index("slo_preempt")
        assert "admission" in stages[i:]  # resumed through admission
        assert flows[i]["args"]["tenant"] == "docs"
    assert any(e["name"].startswith("slo_preempt r") for e in trace["traceEvents"])


def test_tracer_disabled_is_a_noop(tmp_path):
    tracer = RequestTracer(None)
    assert not tracer.enabled
    tracer.begin(0)
    tracer.step(0, "x")
    tracer.end(0, "y")
    off = Timeline(None)
    assert not RequestTracer(off).enabled
    RequestTracer(off).begin(1)
    off.counter("c", 1.0)
    off.save()
    assert off._events == []
    with pytest.raises(ValueError, match="s/t/f"):
        Timeline(str(tmp_path / "t.json")).flow("x", 1, "q")


def test_timeline_saves_atomically_and_events_match_jax(tmp_path):
    """The same calls on both timelines give the same events, times and
    thread ids aside; a save leaves no temporary file behind."""
    out = []
    for mod, name in ((Timeline, "port"), (JTimeline, "jax")):
        path = tmp_path / f"{name}.json"
        tl = mod(str(path))
        with tl.event("span", "serving", args={"k": 1}):
            tl.counter("depth", 3, "serving")
        tl.instant("mark", "serving", args={"reason": "x"})
        tl.flow("r0", 0, "s", "request", args={"rid": 0})
        tl.mark_event_end("never_opened")
        tl.save()
        events = json.loads(path.read_text())["traceEvents"]
        out.append([{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events])
        assert sorted(p.name for p in tmp_path.iterdir() if name in p.name) == [f"{name}.json"]
    assert out[0] == out[1]
