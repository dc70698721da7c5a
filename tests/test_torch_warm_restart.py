"""Fence, adopt and warm restart against the JAX package (CPU, fp32, the
JAX suite's 2-layer tiny_llama; weights from one seed through
``flax_to_torch``): the four tier-1 cases of
``tests/serving/test_warm_restart.py`` (:58, :119, :154, :179) on the port.

A fenced engine's host-current state, round-tripped through JSON, restores
into a fresh engine on another clock origin: every stream continues its
pre-kill tokens and equals solo ``generate`` (sampled ones too: the seed
and the token index are the sampling state), the greedy ones JAX's; every
remaining deadline budget is exact; a snapshot restores exactly once; the
SLO counters and the prefix index ride along. On the same greedy workload
the snapshot has JAX's keys and JAX's per-request fields, ``seed`` standing
where JAX keeps ``key``. ``adopt`` continues a fenced engine's requests bit
for bit and refuses DRAINING, HALTED and known rids."""

import json

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu.serving import VirtualClock as JVirtualClock
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.observability.slo import SLOSpec
from neuronx_distributed_tpu_torch.serving.engine import RejectedError, ServingEngine
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from neuronx_distributed_tpu_torch.serving.traffic import VirtualClock
from test_torch_llama import build_pair
from test_torch_serving import _solo

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def setup():
    """JAX ``setup``: tiny_llama with 2 layers, hidden 32, vocab 128."""
    return build_pair(seed=1, num_layers=2, hidden_size=32, intermediate_size=96,
                      vocab_size=128)


def _engine(tmodel, clock, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("decode_chunk_size", 2)
    kw.setdefault("prefix_cache", None)
    return ServingEngine(tmodel, time_fn=clock, **kw)


def _jengine(jm, params, clock, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("decode_chunk_size", 2)
    kw.setdefault("prefix_cache", None)
    return JServingEngine(jm, params, time_fn=clock, **kw)


def _workload(vocab, greedy=False):
    """JAX's: three prompts of 4-9 tokens, the second sampled."""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, vocab, size=rng.randint(4, 10)).astype(np.int32)
               for _ in range(3)]
    gcfgs = [GenerationConfig(max_new_tokens=10, temperature=0.0),
             GenerationConfig(max_new_tokens=9, temperature=0.0 if greedy else 0.8, top_k=13),
             GenerationConfig(max_new_tokens=8, temperature=0.0)]
    return prompts, gcfgs


def _jcfg(g):
    return JGenerationConfig(max_new_tokens=g.max_new_tokens, temperature=g.temperature,
                             top_k=g.top_k, top_p=g.top_p, eos_token_id=g.eos_token_id)


def _kill(engine, clock, prompts, gcfgs, submit):
    """JAX's kill: three submits, 1 s, two steps (two slots busy, the third
    queued), 9 s more, fence, the snapshot through JSON."""
    reqs = [submit(i, p, g) for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    clock.advance(1.0)
    for _ in range(2):
        engine.step()
    mid = [list(r.tokens) for r in reqs]
    clock.advance(9.0)
    engine.fence("chaos kill")
    return reqs, mid, json.loads(json.dumps(engine.snapshot_serving_state()))


def test_kill_snapshot_restore_streams_bit_identical(setup):
    """JAX :58. A mid-stream kill, the snapshot through JSON, a restore on a
    fresh engine 990 s later: every stream (two active with tokens out, one
    still queued) continues its pre-kill tokens and equals solo
    ``generate``; stepping the fenced engine changes nothing."""
    jm, jp, tm = setup
    prompts, gcfgs = _workload(tm.config.vocab_size)
    refs = [_solo(tm, p, g, 100 + i) for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    clock_a = VirtualClock(start=0.0)
    a = _engine(tm, clock_a)
    reqs, mid, snap = _kill(a, clock_a, prompts, gcfgs,
                            lambda i, p, g: a.submit(p, g, seed=100 + i, tenant=f"t{i % 2}"))
    assert reqs[0].tokens and reqs[1].tokens and not reqs[2].tokens
    assert snap["halted"] and snap["halt_reason"] == "fenced: chaos kill"
    assert len(snap["requests"]) == 3
    a.fence("again")  # a second fence does nothing
    assert a.halt_reason == "fenced: chaos kill"
    a.step()
    assert [list(r.tokens) for r in reqs] == mid
    clock_b = VirtualClock(start=1000.0)
    b = _engine(tm, clock_b)
    report = b.restore_serving_state(snap)
    assert report == {"restored": 3, "downtime_s": 990.0, "rid_floor": 3}
    b.run()
    for i, ref in enumerate(refs):
        req = b.scheduler.requests[reqs[i].rid]
        assert req.state is RequestState.DONE, f"request {i} stranded"
        assert req.tokens == ref, f"request {i} diverged across the restart"
        assert req.tokens[:len(mid[i])] == mid[i]
        assert req.tenant == f"t{i % 2}"
    msnap = b.metrics.snapshot()
    assert msnap["restored"] == 3 and msnap["completed"] == 3
    assert msnap["restore_downtime_p95_s"] > 0
    assert [e["kind"] for e in a.flight.events()].count("snapshot") == 1
    restore = [e for e in b.flight.events() if e["kind"] == "restore"]
    assert len(restore) == 1 and restore[0]["requests"] == 3


def test_snapshot_matches_jax_on_a_greedy_workload(setup):
    """The same greedy workload and kill on both engines: the snapshots have
    the same keys and the same top-level values, and each request the same
    fields and values, ``seed`` standing for ``key``; both restores finish
    with equal streams."""
    jm, jp, tm = setup
    prompts, gcfgs = _workload(tm.config.vocab_size, greedy=True)
    clock_a, jclock_a = VirtualClock(start=0.0), JVirtualClock(start=0.0)
    a, ja = _engine(tm, clock_a), _jengine(jm, jp, jclock_a)
    kw = [dict(tenant=f"t{i % 2}", deadline_s=30.0 + i) for i in range(3)]
    _, _, snap = _kill(a, clock_a, prompts, gcfgs,
                       lambda i, p, g: a.submit(p, g, seed=100 + i, **kw[i]))
    _, _, jsnap = _kill(ja, jclock_a, prompts, gcfgs,
                        lambda i, p, g: ja.submit(p, _jcfg(g), key=jax.random.PRNGKey(100 + i),
                                                  **kw[i]))
    assert sorted(snap) == sorted(jsnap)
    for k in snap:
        if k != "requests":
            assert snap[k] == jsnap[k], k
    for r, jr in zip(snap["requests"], jsnap["requests"]):
        assert list(r) == [("seed" if k == "key" else k) for k in jr]
        assert {k: v for k, v in r.items() if k != "seed"} == \
            {k: v for k, v in jr.items() if k != "key"}
    b = _engine(tm, VirtualClock(start=1000.0))
    jb = _jengine(jm, jp, JVirtualClock(start=1000.0))
    b.restore_serving_state(snap)
    jb.restore_serving_state(jsnap)
    b.run()
    jb.run()
    assert ([list(r.tokens) for r in b.scheduler.requests.values()]
            == [[int(t) for t in r.tokens] for r in jb.scheduler.requests.values()])


def test_restore_preserves_remaining_deadline_budget(setup):
    """JAX :119: times shift by the clock delta, so 40 s of budget left at
    the kill is 40 s on the restored engine; past it the request is shed,
    not revived."""
    tm = setup[2]
    clock_a = VirtualClock(start=0.0)
    a = _engine(tm, clock_a)
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    req = a.submit(np.arange(1, 8, dtype=np.int32), gcfg, seed=3, deadline_s=50.0)
    a.step()
    clock_a.advance(10.0)
    a.fence("kill")
    snap = a.snapshot_serving_state()
    clock_b = VirtualClock(start=2000.0)
    b = _engine(tm, clock_b)
    b.restore_serving_state(snap)
    got = b.scheduler.requests[req.rid]
    assert got.deadline == 2000.0 + 40.0
    assert got.submit_time == 2000.0 - 10.0
    clock_b.advance(41.0)
    b.step()
    b.run()
    assert got.state in (RequestState.DONE, RequestState.TIMED_OUT)
    assert got.deadline == 2040.0


def test_restore_is_exactly_once(setup):
    """JAX :154: the same snapshot restores once; a halted engine and an
    unknown version are refused."""
    tm = setup[2]
    a = _engine(tm, VirtualClock())
    a.submit(np.arange(1, 7, dtype=np.int32), GenerationConfig(5, temperature=0.0), seed=0)
    a.fence("kill")
    snap = a.snapshot_serving_state()
    b = _engine(tm, VirtualClock(start=50.0))
    b.restore_serving_state(snap)
    with pytest.raises(ValueError, match="exactly once"):
        b.restore_serving_state(snap)
    c = _engine(tm, VirtualClock())
    c.fence("dead on arrival")
    with pytest.raises(RejectedError):
        c.restore_serving_state(snap)
    with pytest.raises(ValueError, match="snapshot version"):
        b.restore_serving_state({"version": 99})
    b.run()
    assert all(r.state is RequestState.DONE for r in b.scheduler.requests.values())


def test_restore_carries_slo_and_prefix_index(setup):
    """JAX :179: the SLO tracker's decided counts survive the restart and
    the snapshot holds the prefix store's token index (never K/V); the
    same counts as the JAX engine's."""
    jm, jp, tm = setup
    shared = np.arange(1, 12, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=4, temperature=0.0)
    slo = {"acme": SLOSpec(ttft_p99_s=1e6, tpot_p99_s=1e6)}
    a = _engine(tm, VirtualClock(), prefix_cache="auto", slo=dict(slo))
    done = a.submit(np.concatenate([shared, [30]]).astype(np.int32), gcfg, seed=0,
                    tenant="acme")
    a.run()
    assert done.state is RequestState.DONE
    assert a.metrics.snapshot()["slo"]["attained"] == 1
    live = a.submit(np.concatenate([shared, [31]]).astype(np.int32), gcfg, seed=1,
                    tenant="acme")
    a.fence("kill")
    snap = json.loads(json.dumps(a.snapshot_serving_state()))
    assert snap["prefix_index"] == [list(range(1, 12)) + [30]]
    assert snap["slo"]["tenants"]["acme"]["attained"] == 1
    b = _engine(tm, VirtualClock(start=500.0), prefix_cache="auto", slo=dict(slo))
    b.restore_serving_state(snap)
    b.run()
    msnap = b.metrics.snapshot()
    assert b.scheduler.requests[live.rid].state is RequestState.DONE
    assert msnap["slo"]["attained"] == 2
    assert msnap["tenants"]["acme"]["completed"] == 1
    from neuronx_distributed_tpu.observability import SLOSpec as JSLOSpec

    jslo = {"acme": JSLOSpec(ttft_p99_s=1e6, tpot_p99_s=1e6)}
    ja = _jengine(jm, jp, JVirtualClock(), prefix_cache="auto", slo=jslo)
    jc = _jcfg(gcfg)
    ja.submit(np.concatenate([shared, [30]]).astype(np.int32), jc, key=jax.random.PRNGKey(0),
              tenant="acme")
    ja.run()
    ja.submit(np.concatenate([shared, [31]]).astype(np.int32), jc, key=jax.random.PRNGKey(1),
              tenant="acme")
    ja.fence("kill")
    jsnap = json.loads(json.dumps(ja.snapshot_serving_state()))
    assert snap["prefix_index"] == jsnap["prefix_index"] and snap["slo"] == jsnap["slo"]


def test_adopt_continues_streams_and_refuses(setup):
    """The fenced engine's requeued requests adopted one by one by a fresh
    engine continue bit for bit (solo ``generate``, sampled included),
    streaming their new tokens through ``on_token``; ``adopt`` refuses a
    known rid, a DRAINING and a HALTED engine."""
    tm = setup[2]
    prompts, gcfgs = _workload(tm.config.vocab_size)
    refs = [_solo(tm, p, g, 100 + i) for i, (p, g) in enumerate(zip(prompts, gcfgs))]
    clock = VirtualClock(start=0.0)
    a = _engine(tm, clock)
    reqs, mid, _ = _kill(a, clock, prompts, gcfgs,
                         lambda i, p, g: a.submit(p, g, seed=100 + i))
    b = _engine(tm, VirtualClock(start=20.0))
    streamed = {}
    for r in a.scheduler.queued_requests:
        b.adopt(r, on_token=lambda req, tok: streamed.setdefault(req.rid, []).append(tok))
    with pytest.raises(ValueError, match="already known"):
        b.adopt(reqs[0])
    b.run()
    for i, (r, ref) in enumerate(zip(reqs, refs)):
        assert r.state is RequestState.DONE and r.tokens == ref, f"request {i}"
        assert streamed[r.rid] == ref[len(mid[i]):]
    assert b.metrics.snapshot()["completed"] == 3
    new = b.submit(prompts[0], gcfgs[0])
    assert new.rid == 3  # minted above every adopted rid
    c = _engine(tm, VirtualClock())
    c.drain()
    with pytest.raises(RejectedError):
        c.adopt(reqs[0])
    c.fence("dead")
    with pytest.raises(RejectedError):
        c.adopt(reqs[0])
