"""The router's cross-replica weight fingerprint vote and
``flip_bits("params")`` against the JAX package: the router cases of
``tests/serving/test_integrity.py`` (:95 a conviction, :133 a two-replica
disagreement, :154 a clean fleet) run with JAX's router beside the port's
on one schedule (one virtual clock each, the same steps): router stats,
probe states, health, the injector's counters and the flight events equal
(host integers: exact), greedy streams = JAX's solo ``generate``
(``tokens_lost == 0``). Each port replica serves its own copy of the
weights (``copy.deepcopy``), as JAX's replicas hold their own params. Then
the port's refusals of shared weight storage."""

import copy

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import FaultInjector as JFaultInjector
from neuronx_distributed_tpu.serving import InProcessTransport as JInProcessTransport
from neuronx_distributed_tpu.serving import ReplicaRouter as JReplicaRouter
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu.serving import VirtualClock as JVirtualClock
from neuronx_distributed_tpu.serving import WatchdogConfig as JWatchdogConfig
from neuronx_distributed_tpu.serving.router import RID_STRIDE as JRID_STRIDE
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
from neuronx_distributed_tpu_torch.serving import InProcessTransport, ReplicaRouter, WatchdogConfig
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
from neuronx_distributed_tpu_torch.serving.router import RID_STRIDE
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from neuronx_distributed_tpu_torch.serving.traffic import VirtualClock
from test_torch_disagg import fabric_refs
from test_torch_llama import build_pair

torch.set_num_threads(1)
INTEGRITY_EVENTS = ("integrity_disagreement", "integrity_conviction", "probe_state", "rehome")


@pytest.fixture(scope="module")
def setup():
    """JAX ``setup``: tiny_llama with 2 layers, hidden 32, vocab 128."""
    return build_pair(seed=1, num_layers=2, hidden_size=32, intermediate_size=96,
                      vocab_size=128)


def _fleet(tm, clock, injectors, interval=0.5):
    """JAX ``_fleet``: hand-built replicas (one injector each, None clean),
    each over its own copy of the weights."""
    engines = [ServingEngine(copy.deepcopy(tm), num_slots=2, decode_chunk_size=2,
                             prefix_cache=None, rid_base=i * RID_STRIDE, time_fn=clock,
                             fault_injector=inj)
               for i, inj in enumerate(injectors)]
    return ReplicaRouter(engines, transport=InProcessTransport(time_fn=clock),
                         watchdog=WatchdogConfig(integrity_interval_s=interval), time_fn=clock)


def _jfleet(jm, jp, clock, injectors, interval=0.5):
    engines = [JServingEngine(jm, jp, num_slots=2, decode_chunk_size=2, prefix_cache=None,
                              rid_base=i * JRID_STRIDE, time_fn=clock, fault_injector=inj)
               for i, inj in enumerate(injectors)]
    return JReplicaRouter(engines, transport=JInProcessTransport(time_fn=clock),
                          watchdog=JWatchdogConfig(integrity_interval_s=interval), time_fn=clock)


def _workload(setup, router, jrouter, n, seed, max_new=12):
    """JAX ``_workload`` submitted to both routers: greedy requests, the
    JAX run with keys 900 + i, the port's with seeds 900 + i."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, 128, size=rng.randint(4, 10)).astype(np.int32) for _ in range(n)]
    gcfg = GenerationConfig(max_new_tokens=max_new, temperature=0.0)
    jcfg = JGenerationConfig(max_new_tokens=max_new, temperature=0.0)
    refs = fabric_refs(setup, prompts, [gcfg] * n, [900 + i for i in range(n)])
    reqs = [router.submit(p, gcfg, seed=900 + i) for i, p in enumerate(prompts)]
    jreqs = [jrouter.submit(p, jcfg, key=jax.random.PRNGKey(900 + i))
             for i, p in enumerate(prompts)]
    return reqs, jreqs, refs


def _events(router):
    return [[(e["kind"], {k: v for k, v in e.items() if k in ("replica", "voters", "now",
                                                                  "was", "moved")})
             for e in r.flight.events() if e["kind"] in INTEGRITY_EVENTS]
            for r in router.replicas]


def _same_view(router, jrouter):
    assert router.stats == jrouter.stats
    assert router.probe_states() == jrouter.probe_states()
    assert router.health() == jrouter.health()
    assert _events(router) == _events(jrouter)


def test_params_flip_convicted_fenced_rehomed_zero_tokens_lost(setup):
    """JAX :95: one replica of three flips a weight bit at its step 1; the
    next vote convicts it 2 to 1, fences it straight to DEAD and re-homes
    its work: every stream = solo ``generate``, ``tokens_lost == 0``."""
    jm, jp, tm = setup
    clock, jclock = VirtualClock(), JVirtualClock()
    inj0, jinj0 = FaultInjector().flip_bits("params", at=1), JFaultInjector().flip_bits("params", at=1)
    router = _fleet(tm, clock, [inj0, None, None])
    jrouter = _jfleet(jm, jp, jclock, [jinj0, None, None])
    reqs, jreqs, refs = _workload(setup, router, jrouter, n=6, seed=31)
    for r in (router, jrouter):
        r.step()
    assert router.stats["integrity_fences"] == 0
    for c, r in ((clock, router), (jclock, jrouter)):
        c.advance(0.6)
        r.step()
    assert inj0.counters == jinj0.counters and inj0.counters["bit_flips"] == 1
    assert router.probe_states()["replica0"] == "ok"  # liveness is blind
    _same_view(router, jrouter)
    for c, r in ((clock, router), (jclock, jrouter)):
        c.advance(0.6)
        r.step()
    assert router.stats["integrity_fences"] == 1
    assert router.probe_states()["replica0"] == "dead"
    assert router.replicas[0].health().value == "halted"
    assert router.stats["watchdog_deaths"] == 0
    _same_view(router, jrouter)
    router.run()
    jrouter.run()
    _same_view(router, jrouter)
    lost = sum(req.tokens != ref for req, ref in zip(reqs, refs))
    assert all(req.state is RequestState.DONE for req in reqs)
    assert lost == 0
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert router.stats["rehomed_requests"] > 0
    assert router.stats["integrity_probes"] >= 3 * 2 + 2
    assert router.stats["integrity_disagreements"] == 0


def test_two_replica_disagreement_detected_never_fenced(setup):
    """JAX :133: two fingerprints that disagree prove corruption but not
    where: recorded, nobody fenced."""
    jm, jp, tm = setup
    clock, jclock = VirtualClock(), JVirtualClock()
    inj0, jinj0 = FaultInjector().flip_bits("params", at=0), JFaultInjector().flip_bits("params", at=0)
    router = _fleet(tm, clock, [inj0, None])
    jrouter = _jfleet(jm, jp, jclock, [jinj0, None])
    reqs, jreqs, _ = _workload(setup, router, jrouter, n=4, seed=33)
    for r in (router, jrouter):
        r.step()
    assert inj0.counters["bit_flips"] == 1 == jinj0.counters["bit_flips"]
    for c, r in ((clock, router), (jclock, jrouter)):
        c.advance(0.6)
        r.step()
    assert router.stats["integrity_disagreements"] >= 1
    assert router.stats["integrity_fences"] == 0
    assert "dead" not in router.probe_states().values()
    _same_view(router, jrouter)
    router.run()
    jrouter.run()
    _same_view(router, jrouter)
    assert all(r.state is RequestState.DONE for r in reqs)


def test_clean_fleet_no_false_positives(setup):
    """JAX :154: replicas over copies of one model fingerprint alike; the
    vote fires nothing and streams stay = solo ``generate``."""
    jm, jp, tm = setup
    clock, jclock = VirtualClock(), JVirtualClock()
    router = _fleet(tm, clock, [None, None])
    jrouter = _jfleet(jm, jp, jclock, [None, None])
    reqs, jreqs, refs = _workload(setup, router, jrouter, n=4, seed=35, max_new=8)
    for c, r, rs in ((clock, router, reqs), (jclock, jrouter, jreqs)):
        while any(q.state is not RequestState.DONE for q in rs):
            c.advance(0.6)
            if not r.step():
                break
    assert router.stats["integrity_probes"] >= 4
    assert router.stats["integrity_fences"] == 0 == router.stats["integrity_disagreements"]
    _same_view(router, jrouter)
    for req, ref in zip(reqs, refs):
        assert req.state is RequestState.DONE and req.tokens == ref
    fps = {r.integrity_fingerprint() for r in router.replicas}
    assert len(fps) == 1


def test_integrity_fingerprint_covers_every_served_tensor(setup):
    """The probe is TF's plain version over the served weights, one read a
    probe; a quantized engine's leaves are its own codes, scales, embedding
    and norms (no storage shared with the float source)."""
    _, _, tm = setup
    e = ServingEngine(copy.deepcopy(tm), num_slots=1, prefix_cache=None)
    leaves = e.integrity_leaves()
    assert {t.data_ptr() for t in leaves} == {t.data_ptr() for t in e.model.state_dict().values()}
    reads = e.host_reads
    fp = e.integrity_fingerprint()
    assert e.host_reads == reads + 1 and 0 <= fp < 2 ** 32
    assert e.programs.dispatches("integrity_fingerprint") == 1
    q = ServingEngine(tm, num_slots=1, prefix_cache=None, quantize=QuantConfig(weights="int8"))
    qleaves = q.integrity_leaves()
    assert any(t.dtype == torch.int8 for t in qleaves)
    src = {t.untyped_storage().data_ptr() for t in tm.state_dict().values()}
    assert src.isdisjoint(t.untyped_storage().data_ptr() for t in qleaves)
    before = q.integrity_fingerprint()
    inj = FaultInjector().flip_bits("params", at=0)
    q2 = ServingEngine(tm, num_slots=1, prefix_cache=None, quantize=QuantConfig(weights="int8"),
                       fault_injector=inj)
    assert q2.integrity_fingerprint() == before
    q2.submit([1, 2, 3], GenerationConfig(max_new_tokens=2, temperature=0.0))
    q2.step()
    assert inj.counters["bit_flips"] == 1 and q2.integrity_fingerprint() != before
    assert q.integrity_fingerprint() == before  # its own tensors: untouched


def test_shared_weight_storage_is_refused(setup):
    """A flip in storage two engines share would corrupt both and no vote
    could see it: ``flip_bits("params")`` on a float engine whose module
    another live engine serves, a router over one module under the vote, and
    a joining replica over a member's weights are refused (``ValueError``);
    ``ReplicaRouter.build`` under the vote copies the weights per replica and
    its replacements mint from the clean source."""
    _, _, tm = setup
    model = copy.deepcopy(tm)
    first = ServingEngine(model, num_slots=1, prefix_cache=None)
    with pytest.raises(ValueError, match="flip_bits"):
        ServingEngine(model, num_slots=1, prefix_cache=None,
                      fault_injector=FaultInjector().flip_bits("params"))
    del first
    wd = WatchdogConfig(integrity_interval_s=1.0)
    shared = [ServingEngine(tm, num_slots=1, prefix_cache=None, rid_base=i * RID_STRIDE)
              for i in range(2)]
    with pytest.raises(ValueError, match="own\\s+weights"):
        ReplicaRouter(shared, watchdog=wd)
    ReplicaRouter(shared, watchdog=WatchdogConfig())  # no vote: one module is fine
    with pytest.raises(ValueError, match="flip_bits"):
        ReplicaRouter.build(tm, 2, num_slots=1, prefix_cache=None,
                            fault_injector=FaultInjector().flip_bits("params"))
    router = ReplicaRouter.build(tm, 2, watchdog=wd, num_slots=1, prefix_cache=None)
    ptrs = [{t.untyped_storage().data_ptr() for t in e.integrity_leaves()} for e in router.replicas]
    src = {t.untyped_storage().data_ptr() for t in tm.state_dict().values()}
    assert ptrs[0].isdisjoint(ptrs[1]) and src.isdisjoint(ptrs[0] | ptrs[1])
    with pytest.raises(ValueError, match="own\\s+weights"):
        router.add_replica(ServingEngine(router.replicas[0].model, num_slots=1,
                                         prefix_cache=None, rid_base=7 * RID_STRIDE))
    clean = router.replicas[0].integrity_fingerprint()
    router.replicas[0].fence("test")
    router.step()
    new = router.add_replica()
    assert router.replicas[new].integrity_fingerprint() == clean
    with pytest.raises(ValueError):
        WatchdogConfig(integrity_interval_s=0.0)
