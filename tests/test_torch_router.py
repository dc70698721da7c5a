"""The replica router against the JAX package (CPU, fp32, the JAX suite's
2-layer tiny_llama; weights from one seed through ``flax_to_torch``): the
cases of ``tests/serving/test_router.py`` (its tier-1 ones, and balancing,
affinity, the overcommit guard, drain-around, the shared registry, the
fabric's exports, add and remove at tiny size) and the router's warm
restart (``tests/serving/test_warm_restart.py:224``).

Greedy streams equal JAX's solo ``generate``, sampled ones the port's solo
``generate`` with the same seed (behind a router a request's default seed
is the rid its replica mints, so every request passes one). Where the
router's decisions do not depend on the model's arithmetic (the watchdog
ladder, spillover, the halt re-home) JAX's router runs the same schedule
beside the port's: equal stats, probe states and health."""

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.observability import MetricsRegistry as JMetricsRegistry
from neuronx_distributed_tpu.serving import ChaosTransport as JChaosTransport
from neuronx_distributed_tpu.serving import FaultInjector as JFaultInjector
from neuronx_distributed_tpu.serving import InProcessTransport as JInProcessTransport
from neuronx_distributed_tpu.serving import ReplicaRouter as JReplicaRouter
from neuronx_distributed_tpu.serving import VirtualClock as JVirtualClock
from neuronx_distributed_tpu.serving import WatchdogConfig as JWatchdogConfig
from neuronx_distributed_tpu.serving.router import RID_STRIDE as JRID_STRIDE
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry
from neuronx_distributed_tpu_torch.serving import (
    ChaosTransport,
    InProcessTransport,
    ReplicaRouter,
    WatchdogConfig,
)
from neuronx_distributed_tpu_torch.serving.engine import RejectedError, ServingEngine
from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
from neuronx_distributed_tpu_torch.serving.router import RID_STRIDE
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from neuronx_distributed_tpu_torch.serving.traffic import VirtualClock
from test_torch_disagg import fabric_refs
from test_torch_llama import build_pair

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def setup():
    """JAX ``setup``: tiny_llama with 2 layers, hidden 32, vocab 128."""
    return build_pair(seed=1, num_layers=2, hidden_size=32, intermediate_size=96,
                      vocab_size=128)


def _build(tm, n=2, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("decode_chunk_size", 2)
    kw.setdefault("prefix_cache", None)
    return ReplicaRouter.build(tm, n, **kw)


def _jbuild(jm, jp, n=2, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("decode_chunk_size", 2)
    kw.setdefault("prefix_cache", None)
    return JReplicaRouter.build(jm, jp, n, **kw)


def _fabric(tm, clock, faults=None, watchdog=None, n=2, **kw):
    """JAX's ``_fabric``: a router over a ChaosTransport (a clean
    InProcessTransport without faults), every clock one VirtualClock."""
    transport = (ChaosTransport(faults, time_fn=clock) if faults is not None
                 else InProcessTransport(time_fn=clock))
    kw.setdefault("time_fn", clock)
    router = _build(tm, n, transport=transport,
                    watchdog=WatchdogConfig() if watchdog is None else watchdog, **kw)
    return router, transport


def _jfabric(jm, jp, clock, faults=None, n=2, **kw):
    transport = (JChaosTransport(faults, time_fn=clock) if faults is not None
                 else JInProcessTransport(time_fn=clock))
    kw.setdefault("time_fn", clock)
    router = _jbuild(jm, jp, n, transport=transport, watchdog=JWatchdogConfig(), **kw)
    return router, transport


def _prompts(rng, n, vocab=128, lo=4, hi=10):
    return [rng.randint(1, vocab, size=rng.randint(lo, hi)).astype(np.int32) for _ in range(n)]


def _same_view(router, jrouter):
    """The router's host-side view equals JAX's router's."""
    assert router.stats == jrouter.stats
    assert router.routed_by_replica == jrouter.routed_by_replica
    assert router.health() == jrouter.health()
    assert router.probe_states() == jrouter.probe_states()
    assert router.transport.snapshot() == jrouter.transport.snapshot()


def test_balancing_completes_all_streams_bit_identical(setup):
    """JAX :57 (slow there). 8 requests through 2 replicas: every stream
    equals its solo golden and both replicas serve some."""
    _, _, tm = setup
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 128, size=rng.randint(4, 12)).astype(np.int32) for _ in range(8)]
    gcfgs = [GenerationConfig(max_new_tokens=5 + (i % 3), temperature=0.0) if i % 2 == 0
             else GenerationConfig(max_new_tokens=6, temperature=0.8, top_k=13)
             for i in range(8)]
    seeds = [400 + i for i in range(8)]
    refs = fabric_refs(setup, prompts, gcfgs, seeds)
    router = _build(tm)
    reqs = [router.submit(p, g, seed=s) for p, g, s in zip(prompts, gcfgs, seeds)]
    router.run()
    for i, (req, ref) in enumerate(zip(reqs, refs)):
        assert req.state is RequestState.DONE
        assert req.tokens == ref, f"request {i} diverged through the router"
    assert all(n > 0 for n in router.routed_by_replica)
    assert router.stats["routed"] == 8


def test_rid_namespacing_enforced(setup):
    """JAX :88, and the stride is JAX's; rids from 2^31 on stay exact."""
    _, _, tm = setup
    assert RID_STRIDE == JRID_STRIDE
    e0 = ServingEngine(tm, num_slots=2, prefix_cache=None)
    e1 = ServingEngine(tm, num_slots=2, prefix_cache=None)
    with pytest.raises(ValueError, match="rid_base"):
        ReplicaRouter([e0, e1])
    e2 = ServingEngine(tm, num_slots=2, prefix_cache=None, rid_base=RID_STRIDE)
    ReplicaRouter([e0, e2])
    with pytest.raises(ValueError, match="rid_base"):
        ServingEngine(tm, num_slots=1, rid_base=-1)
    big = ServingEngine(tm, num_slots=1, prefix_cache=None, rid_base=3 * RID_STRIDE)
    req = big.submit([1, 2, 3], GenerationConfig(max_new_tokens=3, temperature=0.0))
    big.run()
    assert req.rid == 3 * RID_STRIDE > 2 ** 31 and req.state is RequestState.DONE


def test_rids_past_2_31_survive_snapshot_trace_and_recorder(setup, tmp_path):
    """A replica minting from ``rid_base = 3 * RID_STRIDE`` (past 2^31): the
    rid and its default seed survive the snapshot's JSON, the saved trace's
    flow ids and the flight recorder, and a restore onto replica 0's range
    continues the request without moving that replica's minting."""
    import json

    from neuronx_distributed_tpu_torch.utils.timeline import Timeline

    _, _, tm = setup
    path = str(tmp_path / "trace.json")
    engine = ServingEngine(tm, num_slots=1, prefix_cache=None, rid_base=3 * RID_STRIDE,
                           timeline=Timeline(path), decode_chunk_size=2)
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    req = engine.submit([1, 2, 3], gcfg)
    engine.step()
    engine.fence("move")
    snap = json.loads(json.dumps(engine.snapshot_serving_state()))
    assert [r["rid"] for r in snap["requests"]] == [req.rid] == [r["seed"] for r in snap["requests"]]
    assert snap["next_rid"] == 3 * RID_STRIDE + 1
    engine.timeline.save()
    with open(path) as f:
        flows = {e["id"] for e in json.load(f)["traceEvents"] if e.get("ph") in ("s", "t", "f")}
    assert flows == {req.rid}
    assert any(e.get("kind") == "halt" for e in engine.flight.events())
    other = ServingEngine(tm, num_slots=1, prefix_cache=None)
    other.adopt(engine.scheduler.queued_requests[0])
    other.run()
    got = other.scheduler.requests[req.rid]
    assert got.state is RequestState.DONE and got.tokens[:len(req.tokens)] == req.tokens
    assert got.tokens == fabric_refs(setup, [np.array([1, 2, 3], np.int32)], [gcfg],
                                     [req.rid])[0]
    assert other._next_rid == 0  # another range's rid leaves the minting as it was


def test_affinity_steers_shared_prefix_sessions(setup):
    """JAX :99 (slow there). Sessions whose prefix is resident in one
    replica's prefix cache steer there (suffix prefill, shared pages)."""
    _, _, tm = setup
    router = _build(tm, prefix_cache="auto", kv_page_size=8, num_slots=2)
    shared = np.arange(1, 25, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    first = router.submit(np.concatenate([shared, np.asarray([40], np.int32)]), gcfg, seed=0)
    router.run()
    warm = next(i for i, e in enumerate(router.replicas)
                if e.prefix is not None and len(e.prefix) > 0)
    before = router.routed_by_replica[warm]
    hits0 = router.stats["affinity_hits"]
    for i in range(3):
        router.submit(np.concatenate([shared, np.asarray([50 + i], np.int32)]), gcfg, seed=1 + i)
        router.run()
    assert router.routed_by_replica[warm] == before + 3
    assert router.stats["affinity_hits"] >= hits0 + 3
    assert router.replicas[warm].metrics.snapshot()["prefix_hits"] >= 3
    assert first.state is RequestState.DONE
    for e in router.replicas:
        e.cache.check()


def test_affinity_overcommit_guard_spreads_page_pressure(setup):
    """JAX :136 (slow there). A shared-prefix burst at replicas with small
    pools: once the warm replica's projected page footprint crosses the
    overcommit bound, later sessions balance away; all requests complete
    identically with zero preemptions and the cold replica serves some."""
    _, _, tm = setup
    router = _build(tm, prefix_cache="auto", kv_page_size=8, kv_num_pages=2 * (128 // 8) + 1,
                    num_slots=2, admission="eager")
    shared = np.arange(1, 33, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    prompts = [np.concatenate([shared, np.asarray([60 + i], np.int32)]) for i in range(6)]
    seeds = [500 + i for i in range(6)]
    refs = fabric_refs(setup, prompts, [gcfg] * 6, seeds)
    reqs = [router.submit(p, gcfg, seed=s) for p, s in zip(prompts, seeds)]
    router.run(max_steps=2_000)
    for i, (req, ref) in enumerate(zip(reqs, refs)):
        assert req.state is RequestState.DONE, f"request {i} never finished"
        assert req.tokens == ref, f"request {i} diverged"
    assert all(n > 0 for n in router.routed_by_replica), router.routed_by_replica
    assert sum(e.metrics.snapshot()["preemptions"] for e in router.replicas) == 0


def test_drain_around_degraded_replica(setup):
    """JAX :175 (slow there). A DEGRADED replica takes no new work while an
    OK one exists, and serves when it is the only one accepting."""
    _, _, tm = setup
    router = _build(tm)
    router.replicas[0].cache.quarantine(0)
    assert router.replicas[0].health().value == "degraded"
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    for i in range(3):
        router.submit(np.arange(1, 6 + i, dtype=np.int32), gcfg, seed=i)
    assert router.routed_by_replica == [0, 3]
    router.run()
    router.replicas[1].drain()
    req = router.submit(np.arange(1, 9, dtype=np.int32), gcfg, seed=9)
    router.run()
    assert req.state is RequestState.DONE
    assert router.routed_by_replica[0] == 1
    assert router.health()["aggregate"] == "degraded"


def test_bounded_queue_spillover_and_final_reject(setup):
    """JAX :201, beside JAX's router: the same spillover, reject and stats."""
    jm, jp, tm = setup
    router, jrouter = _build(tm, max_queue=1), _jbuild(jm, jp, max_queue=1)
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    jcfg = JGenerationConfig(max_new_tokens=4, temperature=0.0)
    prompt = np.arange(1, 6, dtype=np.int32)
    for i in range(2):
        router.submit(prompt, gcfg, seed=i)
        jrouter.submit(prompt, jcfg, key=jax.random.PRNGKey(i))
    with pytest.raises(RejectedError):
        router.submit(prompt, gcfg, seed=2)
    with pytest.raises(Exception, match="queue full"):
        jrouter.submit(prompt, jcfg, key=jax.random.PRNGKey(2))
    assert router.stats["spillovers"] >= 1
    _same_view(router, jrouter)
    router.run()
    assert all(r.state is RequestState.DONE for r in router.requests.values())


def test_halted_replica_rehomes_with_zero_tokens_lost(setup):
    """JAX :214, beside JAX's router on the same schedule: replica 0's
    dispatches fail from its third on, it HALTS with its work requeued, the
    router re-homes it to the survivor, and every request completes with
    its solo stream (``tokens_lost == 0``); stats and health equal JAX's."""
    jm, jp, tm = setup
    rng = np.random.RandomState(11)
    prompts = _prompts(rng, 6)
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    seeds = [700 + i for i in range(6)]
    refs = fabric_refs(setup, prompts, [gcfg] * 6, seeds)
    router = _build(tm, registry=MetricsRegistry(), sleep_fn=lambda s: None)
    inj = FaultInjector().fail_dispatch(at=2, times=None)
    router.replicas[0]._faults = inj
    reqs = [router.submit(p, gcfg, seed=s) for p, s in zip(prompts, seeds)]
    router.run()
    assert inj.counters["dispatch_failures"] >= 3
    assert router.replicas[0].health().value == "halted"
    assert sum(1 for req, ref in zip(reqs, refs)
               if req.state is not RequestState.DONE or req.tokens != ref) == 0
    assert router.stats["rehomed_requests"] > 0 and router.stats["replicas_drained"] == 1
    health = router.health()
    assert health["replica0"] == "halted" and health["aggregate"] == "ok"

    jrouter = _jbuild(jm, jp, registry=JMetricsRegistry(), sleep_fn=lambda s: None)
    jinj = JFaultInjector().fail_dispatch(at=2, times=None)
    jrouter.replicas[0]._faults = jinj
    jreqs = [jrouter.submit(p, JGenerationConfig(max_new_tokens=8, temperature=0.0),
                            key=jax.random.PRNGKey(s)) for p, s in zip(prompts, seeds)]
    jrouter.run()
    assert inj.counters == jinj.counters
    _same_view(router, jrouter)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]


def test_probe_death_fences_and_rehomes_bit_identical(setup):
    """JAX :288. A replica that stops answering probes (a partition; the
    engine itself healthy) walks OK -> SUSPECT -> DEGRADED -> DEAD, is
    FENCED, and its streams, mid-decode ones included, complete on the
    survivor with their solo streams."""
    _, _, tm = setup
    clock = VirtualClock()
    inj = FaultInjector()
    router, transport = _fabric(tm, clock, faults=inj)
    rng = np.random.RandomState(21)
    prompts = _prompts(rng, 4)
    gcfg = GenerationConfig(max_new_tokens=18, temperature=0.0)
    seeds = [800 + i for i in range(4)]
    refs = fabric_refs(setup, prompts, [gcfg] * 4, seeds)
    reqs = [router.submit(p, gcfg, seed=s) for p, s in zip(prompts, seeds)]
    for _ in range(3):
        router.step()
    assert any(r.tokens for r in reqs if r.rid < RID_STRIDE)
    inj.partition(0, at=transport._send_idx)
    seen = []
    for _ in range(3):
        clock.advance(0.3)
        router.step()
        seen.append(router.probe_states()["replica0"])
    assert seen == ["suspect", "degraded", "dead"]
    assert router.stats["watchdog_deaths"] == 1
    assert router.replicas[0].health().value == "halted"
    assert inj.counters["partitioned_sends"] >= 3
    router.run()
    assert sum(1 for req, ref in zip(reqs, refs)
               if req.state is not RequestState.DONE or req.tokens != ref) == 0
    assert router.stats["rehomed_requests"] > 0 and router.stats["probe_failures"] >= 3
    assert router.health()["aggregate"] == "ok"


def test_watchdog_hysteresis_holds_flapper_at_suspect(setup):
    """JAX :345, beside JAX's router on the same probe schedule: a flapping
    replica is held at SUSPECT (still accepting), then two clean rounds
    bring it back to OK; the probe states and stats equal JAX's each round."""
    jm, jp, tm = setup
    clock, jclock = VirtualClock(), JVirtualClock()
    inj, jinj = FaultInjector(), JFaultInjector()
    for at in (0, 4, 8):
        inj.partition(0, at=at, times=1)
        jinj.partition(0, at=at, times=1)
    router, _ = _fabric(tm, clock, faults=inj)
    jrouter, _ = _jfabric(jm, jp, jclock, faults=jinj)
    for k in range(8):
        clock.advance(0.3)
        jclock.advance(0.3)
        router.step()
        jrouter.step()
        _same_view(router, jrouter)
        if k < 6:
            assert router.probe_states()["replica0"] == "suspect", f"round {k}"
            assert 0 in router._accepting()
    assert router.stats["watchdog_deaths"] == 0
    assert router.probe_states()["replica0"] == "ok"
    assert inj.counters == jinj.counters


def test_watchdog_recovery_climbs_one_level_per_streak(setup):
    """JAX :373, beside JAX's router: after two failures (DEGRADED) the
    replica climbs back one level per ``recover_after`` clean probes, and
    a probe-DEGRADED replica drains around like an engine-DEGRADED one."""
    jm, jp, tm = setup
    clock, jclock = VirtualClock(), JVirtualClock()
    inj, jinj = FaultInjector(), JFaultInjector()
    for at in (0, 2):
        inj.partition(0, at=at, times=1)
        jinj.partition(0, at=at, times=1)
    router, _ = _fabric(tm, clock, faults=inj)
    jrouter, _ = _jfabric(jm, jp, jclock, faults=jinj)
    states = []
    for _ in range(6):
        clock.advance(0.3)
        jclock.advance(0.3)
        router.step()
        jrouter.step()
        _same_view(router, jrouter)
        states.append(router.probe_states()["replica0"])
        if len(states) == 2:
            assert router._accepting() == [1]
    assert states == ["suspect", "degraded", "degraded", "suspect", "suspect", "ok"]
    assert 0 in router._accepting() and router.stats["watchdog_deaths"] == 0


def test_rehome_keeps_original_deadline_budget(setup):
    """JAX :403. A re-homed request keeps its ABSOLUTE deadline: the
    survivor enforces the remaining budget, and a request whose budget ran
    out before its replica died is shed there."""
    _, _, tm = setup
    clock = VirtualClock()
    router, _ = _fabric(tm, clock, watchdog=None)
    gcfg = GenerationConfig(max_new_tokens=10, temperature=0.0)
    prompt_a, prompt_b = np.arange(1, 8, dtype=np.int32), np.arange(3, 9, dtype=np.int32)
    ref_a = fabric_refs(setup, [prompt_a], [gcfg], [0])[0]
    router.replicas[1].drain()
    req_a = router.submit(prompt_a, gcfg, seed=0, deadline_s=50.0)
    req_b = router.submit(prompt_b, gcfg, seed=1, deadline_s=8.0)
    router.replicas[1].resume()
    assert req_a.deadline == 50.0 and req_b.deadline == 8.0
    for _ in range(2):
        router.step()
    assert req_a.tokens and req_b.tokens
    clock.advance(10.0)
    router.replicas[0].fence("test kill")
    router.step()
    assert req_a.rid in router.replicas[1].scheduler.requests
    assert req_a.deadline == 50.0 and req_a.submit_time == 0.0
    router.run()
    assert req_a.state is RequestState.DONE and req_a.tokens == ref_a
    assert req_b.state is RequestState.TIMED_OUT and "deadline" in req_b.error


def test_unreachable_replica_spills_submit(setup):
    """JAX :447, beside JAX's router: a submit the transport cannot deliver
    spills to the next replica and counts as a transport failure."""
    jm, jp, tm = setup
    clock, jclock = VirtualClock(), JVirtualClock()
    router, _ = _fabric(tm, clock, faults=FaultInjector().partition(0, at=0))
    jrouter, _ = _jfabric(jm, jp, jclock, faults=JFaultInjector().partition(0, at=0))
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    prompt = np.arange(1, 7, dtype=np.int32)
    ref = fabric_refs(setup, [prompt], [gcfg], [5])[0]
    req = router.submit(prompt, gcfg, seed=5)
    jreq = jrouter.submit(prompt, JGenerationConfig(max_new_tokens=4, temperature=0.0),
                          key=jax.random.PRNGKey(5))
    assert req.rid == jreq.rid == RID_STRIDE
    _same_view(router, jrouter)
    assert router.stats["transport_failures"] >= 1 and router.stats["spillovers"] >= 1
    router.run()
    assert req.state is RequestState.DONE and req.tokens == ref


def _join_drain_workload(setup, seed, n, base):
    rng = np.random.RandomState(seed)
    prompts = _prompts(rng, n)
    gcfg = GenerationConfig(max_new_tokens=5, temperature=0.0)
    seeds = [base + i for i in range(n)]
    return prompts, gcfg, seeds, fabric_refs(setup, prompts, [gcfg] * n, seeds)


def test_add_replica_joins_live_and_rebalances(setup):
    """JAX :468 (slow there). A third replica joins mid-burst and takes
    rebalanced backlog through the transport's adopt; every stream still
    matches its golden."""
    _, _, tm = setup
    clock = VirtualClock()
    router, _ = _fabric(tm, clock)
    prompts, gcfg, seeds, refs = _join_drain_workload(setup, 31, 8, 900)
    reqs = [router.submit(p, gcfg, seed=s) for p, s in zip(prompts, seeds)]
    router.step()
    assert router.add_replica() == 2 and len(router.replicas) == 3
    assert router.stats["replicas_joined"] == 1 and router.stats["rebalanced_requests"] > 0
    assert router.replicas[2].scheduler.queued > 0
    assert router.replicas[2]._next_rid >= 2 * RID_STRIDE
    router.run()
    for i, (req, ref) in enumerate(zip(reqs, refs)):
        assert req.state is RequestState.DONE and req.tokens == ref, f"request {i}"
    assert any(r.finished for r in router.replicas[2].scheduler.requests.values())


def test_remove_replica_drains_out_live(setup):
    """JAX :510 (slow there). The removed replica finishes its admitted
    work, its never-admitted queue re-homes, new submits avoid it, and
    ``step()`` retires it once idle."""
    _, _, tm = setup
    clock = VirtualClock()
    router, _ = _fabric(tm, clock)
    prompts, gcfg, seeds, refs = _join_drain_workload(setup, 41, 6, 950)
    reqs = [router.submit(p, gcfg, seed=s) for p, s in zip(prompts, seeds)]
    router.step()
    router.remove_replica(0)
    assert router.replicas[0].health().value == "draining"
    late = router.submit(np.arange(1, 8, dtype=np.int32), gcfg, seed=99)
    assert late.rid >= RID_STRIDE
    router.run()
    for i, (req, ref) in enumerate(zip(reqs, refs)):
        assert req.state is RequestState.DONE and req.tokens == ref, f"request {i}"
    assert late.state is RequestState.DONE
    assert router.stats["replicas_removed"] == 1 and 0 in router._dead
    with pytest.raises(RejectedError):
        router.replicas[0].submit(np.arange(1, 5, dtype=np.int32), gcfg, seed=1)
    with pytest.raises(ValueError, match="not live"):
        router.remove_replica(0)


def test_shared_registry_scrapes_all_replicas(setup):
    """JAX :256 (slow there): one labeled registry, one scrape; the
    snapshot's router keys are JAX's."""
    jm, jp, tm = setup
    router = _build(tm, registry=MetricsRegistry())
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    for i in range(4):
        router.submit(np.arange(1, 6 + i, dtype=np.int32), gcfg, seed=i)
    router.run()
    text = router.replicas[0].metrics.view.registry.prometheus_text()
    assert 'engine="replica0"' in text and 'engine="replica1"' in text
    snap = router.snapshot()
    assert snap["router"]["routed"] == 4
    assert set(snap["replicas"]) == {"replica0", "replica1"}
    assert sum(snap["replicas"][k]["completed"] for k in snap["replicas"]) == 4
    jsnap = _jbuild(jm, jp).snapshot()
    assert set(snap["router"]) == set(jsnap["router"])
    assert set(snap["router"]["transport"]) == set(jsnap["router"]["transport"])


def test_fabric_observability_exports(setup):
    """JAX :555 (slow there): the probe-state gauge, the transport counters
    and the re-home histogram are exported; the probe transitions land in
    the dead replica's flight recorder."""
    _, _, tm = setup
    clock = VirtualClock()
    registry = MetricsRegistry()
    router, _ = _fabric(tm, clock, faults=FaultInjector().partition(0, at=0), registry=registry)
    for _ in range(3):
        clock.advance(0.3)
        router.step()
    assert router.probe_states()["replica0"] == "dead"
    text = registry.prometheus_text()
    for name in ("router_probe_state", "router_transport_events", "router_rehome_latency_s"):
        assert name in text
    kinds = [e["kind"] for e in router.replicas[0].flight.events()]
    assert kinds.count("probe_state") == 3 and "rehome" in kinds


def test_router_restart_replica_end_to_end(setup):
    """``tests/serving/test_warm_restart.py:224`` (slow there): fence
    replica 0 mid-burst; ``restart_replica`` snapshots it, makes a
    replacement from the build() recipe, restores and reattaches the
    streaming callbacks: every stream completes identically and every
    callback saw every token once. A replica whose work was re-homed
    already refuses the restart."""
    _, _, tm = setup
    clock = VirtualClock()
    router = _build(tm, time_fn=clock, registry=MetricsRegistry())
    rng = np.random.RandomState(17)
    prompts = _prompts(rng, 4)
    gcfg = GenerationConfig(max_new_tokens=10, temperature=0.0)
    seeds = [300 + i for i in range(4)]
    refs = fabric_refs(setup, prompts, [gcfg] * 4, seeds)
    streamed = {}

    def on_token(req, tok):
        streamed.setdefault(req.rid, []).append(tok)

    reqs = [router.submit(p, gcfg, seed=s, on_token=on_token) for p, s in zip(prompts, seeds)]
    for _ in range(2):
        router.step()
    router.replicas[0].fence("chaos kill")
    assert router.restart_replica(0) == 2
    assert router.stats["replicas_restarted"] == 1 and 0 in router._dead
    router.run()
    for i, (req, ref) in enumerate(zip(reqs, refs)):
        final = router.requests[req.rid]
        assert final.state is RequestState.DONE and final.tokens == ref, f"request {i}"
        assert streamed[req.rid] == ref, f"request {i}'s callback stream broke"
    assert any(r.finished and r.rid < len(refs)
               for r in router.replicas[2].scheduler.requests.values())
    assert "router_restart_latency_s" in router._view.registry.prometheus_text()
    with pytest.raises(ValueError, match="add_replica"):
        router.replicas[1].fence("second kill")
        router.step()
        router.restart_replica(1)


def test_item_10c_pieces_refuse_loudly(setup, tmp_path):
    """Item 10c is served: the integrity vote configures, and ``add_replica``
    and ``restart_replica`` take ``cache_dir=``/``manifest=`` (a donor's
    manifest replayed before the replica takes work); only a bad watchdog
    threshold still refuses."""
    _, _, tm = setup
    assert WatchdogConfig(integrity_interval_s=1.0).integrity_interval_s == 1.0
    router = _build(tm, n=1)
    req = router.submit([1, 2, 3, 4], GenerationConfig(max_new_tokens=4, temperature=0.0))
    router.run()
    assert req.state is RequestState.DONE
    donor = router.replicas[0]
    donor.save_aot(str(tmp_path))
    a = router.add_replica(manifest=donor.manifest())
    b = router.add_replica(cache_dir=str(tmp_path))
    for i in (a, b):
        progs = router.replicas[i].programs.programs()
        assert progs["decode_chunk"].prewarm_dispatches == 1
        assert progs["decode_chunk"].compiles == 1 and progs["decode_chunk"].dispatches == 0
    router.replicas[0].fence("restart")
    c = router.restart_replica(0, cache_dir=str(tmp_path))
    assert router.replicas[c].programs.programs()["prefill[8]"].prewarm_dispatches == 1
    assert len(router.replicas) == 4
    with pytest.raises(ValueError):
        WatchdogConfig(suspect_after=2, degraded_after=1)


def test_warm_spawn_with_failed_replays_is_refused(setup):
    """A manifest holding a program the new replica cannot replay (a draft
    prefill, on replicas without a draft) refuses the warm spawn: the
    replica would compile it inside live requests. ``add_replica`` adds
    nothing; ``restart_replica`` prewarms before it touches the old
    replica, which stays as it was (not re-homed, its queue kept)."""
    from neuronx_distributed_tpu_torch.inference.aot import ProgramManifest
    from neuronx_distributed_tpu_torch.serving.engine import EngineHealth

    _, _, tm = setup
    router = _build(tm, n=2)
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    req = router.submit([1, 2, 3, 4], gcfg, seed=1)
    router.run()
    assert req.state is RequestState.DONE
    base = router.replicas[0].manifest()
    bad = ProgramManifest(dict(base.programs, **{
        "draft_prefill[8]": base.entries("first_token")}), base.meta)
    with pytest.raises(ValueError, match=r"draft_prefill\[8\]"):
        router.add_replica(manifest=bad)
    assert len(router.replicas) == 2 and router.stats["replicas_joined"] == 0
    queued = [router.submit([5, 6, 7], gcfg, seed=2 + i) for i in range(2)]
    with pytest.raises(ValueError, match="warm spawn refused"):
        router.restart_replica(1, manifest=bad)
    assert not router._dead and router.stats["replicas_restarted"] == 0
    assert all(e.health() is EngineHealth.OK for e in router.replicas)
    router.run()
    assert all(router.requests[q.rid].state is RequestState.DONE for q in queued)
    assert router.add_replica(manifest=base) == 2
