"""The fabric's cross-feature soak (the core slice of
``tests/serving/test_fabric_soak.py``, CPU, fp32, the JAX suite's 2-layer
tiny_llama): one bursty two-tenant tape drives a router of paged replicas
under the SLO scheduling policy while a ``ChaosTransport`` duplicates,
drops and delays messages and replica 0 dies mid-tape (fenced at once, or,
in the second case, partitioned until the watchdog walks it to DEAD, the
replicas then being disaggregated servers whose handoffs ride the same
transport).

The oracle is a plain fault-free FIFO row engine of the port replaying the
same tape: every layer above it (the policy, paging, disaggregation,
routing, re-homing, the transport's retries and dedup) is placement and
recovery, never arithmetic, so per-arrival streams must be IDENTICAL and
``tokens_lost == 0``; and no rid may exist as two request objects (a
duplicated adopt would admit and stream it twice)."""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.serving import (
    RID_STRIDE,
    ChaosTransport,
    DisaggregatedServer,
    ReplicaRouter,
    WatchdogConfig,
)
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
from neuronx_distributed_tpu_torch.serving.sched import SloPolicy
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
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def setup():
    """JAX ``setup``: tiny_llama with 2 layers, hidden 32, vocab 128 (the
    port's model alone: the oracle is the port's plain engine)."""
    return build_pair(seed=1, num_layers=2, hidden_size=32, intermediate_size=96,
                      vocab_size=128)[2]


def _tenants():
    return [
        TenantProfile("chat", rate_rps=1.5, arrival="bursty", workload="chat",
                      priority="interactive", temperature=0.8, burst_factor=4.0,
                      burst_period_s=3.0, burst_duty=0.3),
        TenantProfile("docs", rate_rps=0.6, arrival="poisson", workload="longdoc",
                      priority="batch"),
    ]


def _reference_streams(tm, tape):
    """The fault-free FIFO row oracle: per-arrival streams in tape order."""
    clock = VirtualClock()
    engine = ServingEngine(tm, num_slots=4, decode_chunk_size=2, prefix_cache=None,
                           time_fn=clock)
    replay(engine, tape, clock, step_dt=0.05)
    reqs = sorted(engine.scheduler.requests.values(), key=lambda r: r.rid)
    assert len(reqs) == len(tape) and all(r.state is RequestState.DONE for r in reqs)
    return [list(r.tokens) for r in reqs]


def _replay_router(router, tape, clock, kill_at, kill_fn, step_dt=0.05, max_steps=100_000):
    """JAX's ``_replay_router``: arrivals submit at their virtual times,
    each step costs ``step_dt``, idle gaps fast-forward; ``kill_fn`` fires
    once, right after arrival ``kill_at`` submits."""
    reqs, i, steps, killed = [], 0, 0, False
    while i < len(tape) or router.has_work:
        while i < len(tape) and tape[i].t <= clock.now:
            a = tape[i]
            i += 1
            cfg = GenerationConfig(max_new_tokens=a.max_new_tokens, temperature=a.temperature,
                                   eos_token_id=None)
            reqs.append(router.submit(np.asarray(a.prompt, np.int32), cfg, seed=a.key_seed,
                                      tenant=a.tenant, priority=a.priority))
            if not killed and len(reqs) > kill_at:
                killed = True
                kill_fn()
        if not router.has_work:
            if i < len(tape):
                clock.advance_to(tape[i].t)
                continue
            break
        if steps >= max_steps:
            break
        router.step()
        for e in router.replicas:
            getattr(e, "engine", e).cache.check()
        steps += 1
        clock.advance(step_dt)
    return reqs


@pytest.mark.parametrize("entry", ["halt_fence", "watchdog_partition_disagg"])
def test_fabric_soak_core_slice(setup, entry):
    """``halt_fence`` is JAX's tier-1 core slice: SLO-policy paged replicas,
    the chaos transport, replica 0 fenced mid-tape and re-homed.
    ``watchdog_partition_disagg`` is its matrix's second entry on the same
    short tape: the replicas are disaggregated servers and replica 0 dies
    by a partition that the watchdog walks to DEAD."""
    tm = setup
    tape = generate_tape(_tenants(), duration_s=2.5, seed=18, vocab_size=128)
    assert tape_bytes(tape) == tape_bytes(generate_tape(_tenants(), duration_s=2.5, seed=18,
                                                        vocab_size=128))
    refs = _reference_streams(tm, tape)
    clock = VirtualClock()
    inj = (FaultInjector().dup_send(at=1, times=1).drop_send(at=3, times=1)
           .delay_send(at=5, times=1, by=0.01))
    transport = ChaosTransport(inj, time_fn=clock)
    kw = dict(num_slots=2, decode_chunk_size=2, prefix_cache=None, kv_page_size=8,
              time_fn=clock)
    if entry == "halt_fence":
        router = ReplicaRouter.build(tm, 2, scheduling=SloPolicy(), transport=transport, **kw)
        kill = lambda: router.replicas[0].fence("soak kill")  # noqa: E731
    else:
        replicas = [DisaggregatedServer(ServingEngine(tm, scheduling=SloPolicy(),
                                                      rid_base=i * RID_STRIDE, **kw),
                                        n_workers=1, transport=transport) for i in range(2)]
        router = ReplicaRouter(replicas, transport=transport, watchdog=WatchdogConfig(),
                               time_fn=clock)
        kill = lambda: inj.partition(0, at=transport._send_idx)  # noqa: E731
    reqs = _replay_router(router, tape, clock, kill_at=min(2, len(tape) - 1), kill_fn=kill)
    assert router.replicas[0].health().value == "halted"
    assert router.stats["replicas_drained"] == 1
    if entry == "halt_fence":
        assert router.stats["rehomed_requests"] >= 1  # fenced with work in flight
    else:
        assert router.probe_states()["replica0"] == "dead"
        assert router.stats["watchdog_deaths"] == 1
        assert sum(r.stats["handoffs"] for r in replicas) > 0
    tokens_lost = 0
    for i, req in enumerate(reqs):
        final = router.requests[req.rid]
        assert final.state is RequestState.DONE, f"arrival {i} stranded"
        tokens_lost += final.tokens != refs[i]
    assert tokens_lost == 0
    assert inj.counters["dup_sends"] >= 1 and inj.counters["dropped_sends"] >= 1
    assert transport.stats["retries"] >= 1 and transport.stats["dedup_hits"] >= 1
    objects = {}
    for e in router.replicas:
        for rid, r in e.scheduler.requests.items():
            objects.setdefault(rid, set()).add(id(r))
    assert all(len(ids) == 1 for ids in objects.values())
