"""The serving engine's fault contract against the JAX engine's (CPU, fp32,
tiny_llama): deadlines and shedding, dispatch recovery over the decode
program, readback validation and slot quarantine, prefill faults, drain and
health, the speculative fallback, and the flight recorder. The counterpart
of ``tests/serving/test_faults.py`` (its single-engine tests; the SLO,
tenant and timeline tests wait for their modules; the poisoned-draft test
is ``tests/test_torch_draft_params.py``'s).

Both engines are built from one seed (``flax_to_torch``) and given the same
prompts and the same ``FaultInjector`` schedule. Across frameworks: equal
terminal states per request, equal fault counters (the injector's and the
metrics'), equal health transition sequences (the flight recorders'
``health`` events) and identical greedy streams. Within the port, every
stream (sampled ones too) equals the port's solo ``generate`` with the
request's seed, bit for bit. Tests the JAX suite marks slow are held to the
port's solo ``generate`` and fault-free runs only, so the file stays
inside the tier-1 budget."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import FaultInjector as JFaultInjector
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.kernels._build import KernelError
from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM
from neuronx_distributed_tpu_torch.serving.engine import (
    EngineHealth,
    RejectedError,
    ServingEngine,
)
from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
from neuronx_distributed_tpu_torch.serving.scheduler import RequestState
from neuronx_distributed_tpu_torch.utils.retry import RetryPolicy, with_retries
from test_torch_llama import build_pair
from test_torch_serving import _solo

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FAULT_KEYS = ("sheds", "timed_out", "failed", "quarantines", "dispatch_retries", "recoveries",
              "prefill_failures", "page_quarantines", "spec_fallbacks", "completed",
              "preemptions", "prefix_hits", "prefix_validation_failures")


@pytest.fixture(scope="module")
def setup():
    """The JAX suite's fixture: tiny_llama from key 1; a 2-layer draft from
    key 7 for the speculative cases."""
    jt, tp, tt = build_pair(seed=1)
    jd, dp, td = build_pair(seed=7, num_layers=2)
    return jt, tp, tt, jd, dp, td


def _workload(n=4, seed=17):
    """The JAX suite's mix: one greedy request, three sampled."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, 256, size=rng.randint(3, 12)).astype(np.int32) for _ in range(n)]
    gcfgs = [
        GenerationConfig(max_new_tokens=10, temperature=0.0),
        GenerationConfig(max_new_tokens=12, temperature=0.8, top_k=17),
        GenerationConfig(max_new_tokens=8, temperature=1.1, top_p=0.9),
        GenerationConfig(max_new_tokens=11, temperature=0.6, top_k=30),
    ][:n]
    return prompts, gcfgs


def _jcfg(g):
    return JGenerationConfig(max_new_tokens=g.max_new_tokens, temperature=g.temperature,
                             top_k=g.top_k, top_p=g.top_p, eos_token_id=g.eos_token_id)


def _health(engine):
    """The engine's health transitions, as its flight recorder saw them."""
    return [e["value"] for e in engine.flight.events() if e["kind"] == "health"]


def _counters(engine):
    snap = engine.metrics.snapshot()
    return {k: snap[k] for k in FAULT_KEYS}


class Pair:
    """One port engine and one JAX engine, built alike, fed alike."""

    def __init__(self, setup, schedule=None, draft=False, prefix=None, **kw):
        from neuronx_distributed_tpu.serving import PrefixCache as JPrefixCache
        from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache

        jt, tp, tt, jd, dp, td = setup
        self.inj = schedule(FaultInjector()) if schedule else None
        self.jinj = schedule(JFaultInjector()) if schedule else None
        self.waits, self.jwaits = [], []
        extra = dict(draft_model=td, gamma=3) if draft else {}
        jextra = dict(draft_model=jd, draft_params=dp, gamma=3) if draft else {}
        if prefix is not None:  # one store each, built alike
            extra["prefix_cache"], jextra["prefix_cache"] = PrefixCache(**prefix), \
                JPrefixCache(**prefix)
        self.port = ServingEngine(tt, fault_injector=self.inj, sleep_fn=self.waits.append,
                                  **extra, **kw)
        self.jax = JServingEngine(jt, tp, fault_injector=self.jinj, sleep_fn=self.jwaits.append,
                                  **jextra, **kw)
        self.reqs, self.jreqs = [], []

    def submit(self, prompt, gcfg, seed, **kw):
        self.reqs.append(self.port.submit(prompt, gcfg, seed=seed, **kw))
        self.jreqs.append(self.jax.submit(prompt, _jcfg(gcfg), key=jax.random.PRNGKey(seed),
                                          **kw))
        return self.reqs[-1], self.jreqs[-1]

    def step(self):
        self.port.step()
        self.jax.step()

    def run(self, **kw):
        self.port.run(**kw)
        self.jax.run(**kw)

    def check_alike(self, gcfgs=None):
        """Terminal states, fault counters, health transitions and greedy
        streams equal across frameworks."""
        assert [r.state.value for r in self.reqs] == [r.state.value for r in self.jreqs]
        assert _counters(self.port) == _counters(self.jax)
        if self.inj is not None:
            assert self.inj.counters == self.jinj.counters
        assert _health(self.port) == _health(self.jax)
        assert self.port.health().value == self.jax.health().value
        # a halt names its last error in its framework's words
        assert [(r or "").split(" (last")[0] for r in (self.port.halt_reason,
                                                       self.jax.halt_reason)] == \
            [(self.jax.halt_reason or "").split(" (last")[0]] * 2
        for i, r in enumerate(self.reqs):
            if gcfgs is None or gcfgs[i].temperature == 0.0:
                assert r.tokens == [int(t) for t in self.jreqs[i].tokens], f"request {i}"


def _port_refs(tt, prompts, gcfgs, seeds):
    return [_solo(tt, p, g, s) for p, g, s in zip(prompts, gcfgs, seeds)]


# --- dispatch failure recovery ------------------------------------------------


def test_dispatch_failure_recovery_streams_bit_identical(setup):
    """A dispatch failure at chunk 1, mid-stream, recovers through the
    requeue machinery: every stream equals its solo ``generate`` (zero
    tokens lost or repeated), one retry, one recovery, one jittered wait,
    and the decode program keeps its buffers (JAX slow: port only)."""
    tt = setup[2]
    prompts, gcfgs = _workload()
    refs = _port_refs(tt, prompts, gcfgs, range(500, 504))
    waits = []
    inj = FaultInjector().fail_dispatch(at=1, times=1)
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=3, fault_injector=inj,
                           sleep_fn=waits.append)
    ptrs = _buffers(engine)
    reqs = [engine.submit(p, c, seed=500 + i) for i, (p, c) in enumerate(zip(prompts, gcfgs))]
    engine.run()
    assert inj.counters["dispatch_failures"] == 1
    for i, (req, ref) in enumerate(zip(reqs, refs)):
        assert req.state is RequestState.DONE
        assert req.tokens == ref, f"request {i} diverged across recovery"
    snap = engine.metrics.snapshot()
    assert (snap["dispatch_retries"], snap["recoveries"], snap["completed"]) == (1, 1, 4)
    assert len(waits) == 1 and waits[0] > 0
    assert _buffers(engine) == ptrs  # recovery reset in place, nothing reallocated


def test_dispatch_failure_marks_degraded_then_cools_down(setup):
    """One recovered failure reads DEGRADED, then OK after the cooldown's
    worth of clean chunks; the same transitions as the JAX engine."""
    pair = Pair(setup, lambda i: i.fail_dispatch(at=1, times=1), num_slots=1,
                decode_chunk_size=1, degraded_cooldown_chunks=3)
    gcfg = GenerationConfig(max_new_tokens=20, temperature=0.0)
    pair.submit(np.asarray([3, 5, 7], np.int32), gcfg, 0)
    pair.step()  # admit + first chunk
    pair.step()  # the injected failure: recovery
    assert pair.port.health() is EngineHealth.DEGRADED
    assert pair.port.metrics.snapshot()["health"] == "degraded"
    pair.run()
    assert pair.reqs[0].state is RequestState.DONE
    assert pair.port.health() is EngineHealth.OK
    assert pair.port.metrics.snapshot()["health"] == "ok"
    assert _health(pair.port) == ["degraded", "ok"]
    pair.check_alike()


def test_consecutive_dispatch_failures_halt_with_work_requeued(setup, tmp_path):
    """max_attempts consecutive failures HALT the engine: the in-flight
    requests are requeued with their tokens, run() returns, submissions are
    rejected, only the non-final failures wait, and the flight recorder's
    post-mortem lands in ``flight_dir`` and parses back."""
    prompts, gcfgs = _workload(n=2)
    pair = Pair(setup, lambda i: i.fail_dispatch(at=1, times=None), num_slots=2,
                decode_chunk_size=2, flight_dir=str(tmp_path))
    for i, (p, g) in enumerate(zip(prompts, gcfgs)):
        pair.submit(p, g, 500 + i)
    pair.run()
    engine = pair.port
    assert engine.health() is EngineHealth.HALTED
    assert "consecutive dispatch failures" in engine.halt_reason
    assert engine.metrics.dispatch_retries == 3  # the default max_attempts
    for req in pair.reqs:
        assert req.state is RequestState.QUEUED and len(req.tokens) >= 1
    assert not engine.has_work
    with pytest.raises(RejectedError):
        engine.submit(prompts[0], gcfgs[0])
    assert len(pair.waits) == 2 == len(pair.jwaits)
    pm = json.loads(open(engine.flight.last_dump_path).read())
    assert pm["subsystem"] == "serving" and "consecutive dispatch failures" in pm["reason"]
    # recovery requeued the work before the halt, as in JAX
    assert pm["extra"]["metrics"]["dispatch_retries"] == 3
    assert [e["kind"] for e in pm["events"]].count("dispatch_failure") == 3
    pair.check_alike(gcfgs)


class _StepsThenFail:
    """A decode chunk whose call runs its steps, then raises: a failure
    after the cache, the cursors and the slot state moved in place."""

    def __init__(self, chunk, exc):
        self.chunk, self.exc = chunk, exc

    def __getattr__(self, name):
        return getattr(self.chunk, name)

    def __call__(self):
        self.chunk()
        raise self.exc


def _buffers(engine):
    """The data pointers of every buffer the decode program touches."""
    c = engine.cache.cache
    leaves = [c.k, c.v, c.valid, c.cursor, *engine._state.values(), engine._chunk.toks,
              engine._chunk.counts, engine._chunk.step]
    return [t.data_ptr() for t in leaves]


def test_recovery_after_steps_ran_resets_in_place(setup):
    """The port's counterpart of recovery with consumed buffers: the chunk
    raises after its steps advanced the cache in place. Recovery resets the
    caches and slot state IN PLACE (every buffer the decode program reads
    keeps its address: nothing to recapture), requeues the request, and its
    stream still equals solo ``generate``."""
    tt = setup[2]
    gcfg = GenerationConfig(max_new_tokens=10, temperature=0.7, top_k=9)
    prompt = np.asarray([2, 3, 4, 5], np.int32)
    ref = _solo(tt, prompt, gcfg, 77)
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=2, sleep_fn=lambda s: None)
    ptrs = _buffers(engine)
    req = engine.submit(prompt, gcfg, seed=77)
    engine.step()  # admit + one clean chunk
    real = engine._chunk
    engine._chunk = _StepsThenFail(real, RuntimeError("fault after the steps ran"))
    engine.step()
    engine._chunk = real
    assert req.state is RequestState.QUEUED
    assert engine.cache.cursor == 0 and not engine.cache.cache.valid.any()
    assert not engine._state["active"].any()
    assert engine.metrics.snapshot()["recoveries"] == 1
    assert _buffers(engine) == ptrs
    engine.run()
    assert req.state is RequestState.DONE and req.tokens == ref
    assert engine.decode_compilations == 0  # eager on the CPU; 1 on the card (phase 5g)


@pytest.mark.parametrize("exc", [torch.AcceleratorError("CUDA error: an illegal memory access "
                                                        "was encountered"),
                                 KernelError("flash_decode_fwd: CUDA error 700 at launch")],
                         ids=["accelerator_error", "kernel_error"])
def test_cuda_errors_propagate_out_of_step(setup, exc):
    """A CUDA runtime error or a kernel's launch error is never recovered:
    it is sticky and retrying would hide a kernel fault, so it raises out
    of ``step()`` with no retry counted; a host-side error is recovered."""
    tt = setup[2]
    engine = ServingEngine(tt, num_slots=1, decode_chunk_size=2, sleep_fn=lambda s: None)
    engine.submit(np.asarray([3, 4, 5], np.int32), GenerationConfig(12, temperature=0.0))
    engine.step()
    real = engine._chunk
    engine._chunk = _StepsThenFail(real, exc)
    with pytest.raises(type(exc)):
        engine.step()
    assert engine.metrics.dispatch_retries == 0
    engine._chunk = _StepsThenFail(real, ValueError("a host-side fault"))
    engine.step()
    assert engine.metrics.dispatch_retries == 1


def test_idle_injector_and_flight_recorder_cost_no_host_read(setup):
    """An injector that never fires and the default flight recorder leave
    ``host_reads`` exactly as in a bare engine (JAX
    ``test_host_sync.py:104``), and the streams unchanged."""
    tt = setup[2]
    prompts, gcfgs = _workload()
    runs = []
    for kw in (dict(fault_injector=None, flight_recorder=None),
               dict(fault_injector=FaultInjector().fail_dispatch(at=10_000))):
        engine = ServingEngine(tt, num_slots=2, decode_chunk_size=3, **kw)
        reqs = [engine.submit(p, c, seed=500 + i) for i, (p, c) in enumerate(zip(prompts, gcfgs))]
        engine.run()
        runs.append((engine.host_reads, [r.tokens for r in reqs]))
    assert runs[0] == runs[1]
    assert engine.flight is not None


# --- output validation & quarantine ---------------------------------------------


def test_quarantine_isolates_poisoned_slot(setup):
    """A poisoned readback quarantines exactly its slot: the victim resumes
    in another slot with its stream intact, no neighbour's stream changes,
    the slot never hosts another request, and the device ``active`` flag of
    the slot is clear."""
    tt = setup[2]
    prompts, gcfgs = _workload(n=3)
    refs = _port_refs(tt, prompts, gcfgs, range(500, 503))
    pair = Pair(setup, lambda i: i.poison_readback(at=1, slot=0, token=-3), num_slots=3,
                decode_chunk_size=2)
    for i, (p, g) in enumerate(zip(prompts, gcfgs)):
        pair.submit(p, g, 500 + i)
    pair.run()
    engine = pair.port
    assert pair.inj.counters["poisoned_readbacks"] == 1
    for i, (req, ref) in enumerate(zip(pair.reqs, refs)):
        assert req.state is RequestState.DONE
        assert req.tokens == ref, f"request {i} corrupted by the poison"
    assert engine.metrics.snapshot()["quarantines"] == 1
    assert engine.cache.usable_slots == 2 and engine.cache.quarantined_slots == [0]
    assert engine.health() is EngineHealth.DEGRADED
    assert all(r.slot != 0 for r in pair.reqs)
    assert not bool(engine._state["active"][0])
    pair.check_alike(gcfgs)


def test_quarantine_fail_policy_fails_the_victim(setup):
    """``quarantine_policy="fail"`` fails the victim with a reason; the
    neighbour finishes exactly (JAX slow: port only)."""
    tt = setup[2]
    prompts, gcfgs = _workload(n=2)
    refs = _port_refs(tt, prompts, gcfgs, range(500, 502))
    inj = FaultInjector().poison_readback(at=1, slot=0, token=tt.config.vocab_size)
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=2, quarantine_policy="fail",
                           fault_injector=inj)
    reqs = [engine.submit(p, c, seed=500 + i) for i, (p, c) in enumerate(zip(prompts, gcfgs))]
    engine.run()
    victim = next(r for r in reqs if r.state is RequestState.FAILED)
    survivor = next(r for r in reqs if r is not victim)
    assert "quarantined" in victim.error
    assert survivor.state is RequestState.DONE and survivor.tokens == refs[reqs.index(survivor)]
    assert engine.metrics.snapshot()["failed"] == 1


def test_all_slots_quarantined_halts(setup):
    """Losing every slot halts rather than spinning admission against an
    empty rotation; the request stays queued."""
    pair = Pair(setup, lambda i: i.poison_readback(at=1, slot=0).poison_readback(at=2, slot=0),
                num_slots=1, decode_chunk_size=2)
    pair.submit(np.asarray([3, 5, 7], np.int32), GenerationConfig(20, temperature=0.0), 0)
    pair.run()
    assert pair.port.health() is EngineHealth.HALTED
    assert pair.port.halt_reason == "all slots quarantined"
    assert pair.reqs[0].state is RequestState.QUEUED
    pair.check_alike()


def test_poison_defers_until_slot_active(setup):
    """A poison aimed at an inactive slot defers to the next readback; one
    aimed at a slot that never runs never fires and changes nothing."""
    inj = FaultInjector().poison_readback(at=0, slot=1, token=-1)
    toks, counts = np.zeros((2, 2), np.int64), np.ones((2,), np.int64)
    t, c = inj.on_readback(0, toks, counts, np.array([True, False]))
    assert inj.counters["poisoned_readbacks"] == 0 and (t == 0).all() and (c == 1).all()
    t, c = inj.on_readback(1, toks, counts, np.array([True, True]))
    assert inj.counters["poisoned_readbacks"] == 1 and t[0, 1] == -1
    tt = setup[2]
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    prompt = np.asarray([2, 4, 6], np.int32)
    inj2 = FaultInjector().poison_readback(at=0, slot=1, token=-1)
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=2, fault_injector=inj2)
    req = engine.submit(prompt, gcfg, seed=3)
    engine.run()
    assert req.tokens == _solo(tt, prompt, gcfg, 3)
    assert inj2.counters["poisoned_readbacks"] == 0 and engine.metrics.quarantines == 0


# --- speculative decoding ---------------------------------------------------------


def test_draft_dispatch_failure_falls_back_bit_identical(setup):
    """A failed SPECULATIVE dispatch decodes that chunk with the plain step
    (streams unchanged, nothing lost), preempts to resync the draft cache
    and keeps speculating. The port builds the plain program lazily, at the
    fallback: the JAX engine compiles it there too."""
    tt = setup[2]
    prompts, gcfgs = _workload()
    refs = _port_refs(tt, prompts, gcfgs, range(500, 504))
    pair = Pair(setup, lambda i: i.fail_draft_dispatch(at=1, times=1), draft=True, num_slots=2,
                decode_chunk_size=3, prefix_cache=None)
    assert pair.port._plain_chunk is None
    for i, (p, g) in enumerate(zip(prompts, gcfgs)):
        pair.submit(p, g, 500 + i)
    pair.run()
    engine = pair.port
    assert pair.inj.counters["draft_dispatch_failures"] == 1
    snap = engine.metrics.snapshot()
    assert snap["spec_fallbacks"] == 1 and snap["preemptions"] > 0
    for i, (req, ref) in enumerate(zip(pair.reqs, refs)):
        assert req.state is RequestState.DONE
        assert req.tokens == ref, f"request {i} lost or corrupted tokens"
    assert snap["spec_rounds"] > 0
    assert engine._plain_chunk is not None
    assert engine.decode_compilations == 0  # eager on the CPU; JAX compiled both programs
    assert pair.jax.decode_compilations == 2
    pair.check_alike(gcfgs)


def test_poison_draft_is_not_ported(setup):
    """``poison_draft`` is not served for a draft that shares the target's
    tensors (the early-exit draft): such an engine refuses the schedule at
    construction, naming ``draft_params=``; with the draft's own copy
    (``draft_params=``) the same schedule is served."""
    from neuronx_distributed_tpu_torch.models.llama import early_exit_draft

    tt = setup[2]
    target, draft = early_exit_draft(tt, 1, 0.0)
    with pytest.raises(ValueError, match="shares the target's tensors.*draft_params="):
        ServingEngine(target, num_slots=1, draft_model=draft, gamma=2,
                      fault_injector=FaultInjector().poison_draft(at=0))
    ServingEngine(target, num_slots=1, draft_model=draft, draft_params=draft.state_dict(),
                  gamma=2, fault_injector=FaultInjector().poison_draft(at=0))


def test_spec_readback_poison_quarantines_slot(setup):
    """A poisoned speculative readback quarantines the slot in BOTH caches;
    the victim resumes elsewhere with its stream intact."""
    tt = setup[2]
    prompts, gcfgs = _workload(n=3)
    refs = _port_refs(tt, prompts, gcfgs, range(500, 503))
    pair = Pair(setup, lambda i: i.poison_readback(at=1, slot=0, token=-7), draft=True,
                num_slots=2, decode_chunk_size=3, prefix_cache=None)
    for i, (p, g) in enumerate(zip(prompts, gcfgs)):
        pair.submit(p, g, 500 + i)
    pair.run()
    engine = pair.port
    assert pair.inj.counters["poisoned_readbacks"] == 1 and engine.metrics.quarantines == 1
    assert engine.cache.quarantined_slots == [0] == engine.draft_cache.quarantined_slots
    for i, (req, ref) in enumerate(zip(pair.reqs, refs)):
        assert req.state is RequestState.DONE and req.tokens == ref, f"request {i}"
    pair.check_alike(gcfgs)


def test_spec_consecutive_total_failures_halt_with_work_requeued(setup):
    """Every dispatch failing, speculative and fallback alike: the engine
    escalates through recovery and halts with the work requeued."""
    prompts, gcfgs = _workload(n=2)
    pair = Pair(setup, lambda i: i.fail_dispatch(at=0, times=None), draft=True, num_slots=2,
                decode_chunk_size=3, prefix_cache=None)
    for i, (p, g) in enumerate(zip(prompts, gcfgs)):
        pair.submit(p, g, 500 + i)
    pair.run(max_steps=50)
    assert pair.port.health() is EngineHealth.HALTED
    assert "dispatch failures" in pair.port.halt_reason
    assert all(r.state is RequestState.QUEUED for r in pair.reqs)
    pair.check_alike(gcfgs)


# --- deadlines, shedding, backpressure, drain ----------------------------------------


def test_queue_timeout_sheds_before_prefill(setup):
    """Under a fake clock, a request whose queue timeout expires before a
    slot frees is shed (TIMED_OUT) before any prefill runs."""
    clock = {"t": 0.0}
    pair = Pair(setup, num_slots=1, decode_chunk_size=2, time_fn=lambda: clock["t"])
    pair.submit(np.asarray([1, 2, 3], np.int32), GenerationConfig(30, temperature=0.0), 0)
    pair.step()
    pair.submit(np.asarray([4, 5, 6], np.int32), GenerationConfig(5, temperature=0.0), 1,
                queue_timeout_s=2.0)
    before = pair.port.metrics.prefills
    clock["t"] = 3.0
    pair.step()
    victim = pair.reqs[1]
    assert victim.state is RequestState.TIMED_OUT
    assert victim.error == "queue timeout before admission" and victim.tokens == []
    assert pair.port.metrics.prefills == before
    pair.run()
    assert pair.reqs[0].state is RequestState.DONE
    snap = pair.port.metrics.snapshot()
    assert snap["sheds"] == 1 and snap["timed_out"] == 1
    assert pair.port.metrics.request_snapshot(victim.rid)["shed_where"] == "queue"
    pair.check_alike()


def test_inflight_deadline_enforced_at_chunk_boundary(setup):
    """An in-flight deadline sheds at the next chunk boundary: the request
    keeps the tokens it streamed, the neighbour runs on untouched."""
    clock = {"t": 0.0}
    pair = Pair(setup, num_slots=2, decode_chunk_size=2, time_fn=lambda: clock["t"])
    doomed, _ = pair.submit(np.asarray([2, 4, 6], np.int32), GenerationConfig(40, temperature=0.0),
                            0, deadline_s=5.0)
    free_cfg = GenerationConfig(max_new_tokens=12, temperature=0.0)
    other, _ = pair.submit(np.asarray([11, 13, 17], np.int32), free_cfg, 9)
    pair.step()
    pair.step()
    at_boundary = len(doomed.tokens)
    assert at_boundary > 0
    clock["t"] = 6.0
    pair.run()
    assert doomed.state is RequestState.TIMED_OUT
    assert doomed.error == "deadline exceeded mid-generation"
    assert len(doomed.tokens) == at_boundary
    assert other.state is RequestState.DONE
    assert other.tokens == _solo(setup[2], np.asarray([11, 13, 17], np.int32), free_cfg, 9)
    assert pair.port.metrics.request_snapshot(doomed.rid)["shed_where"] == "inflight"
    pair.check_alike()


def test_clock_skew_injection_drives_shedding(setup):
    """The injector's clock skew moves the engine clock, not real time."""
    pair = Pair(setup, lambda i: i, num_slots=1, decode_chunk_size=2)
    pair.submit(np.asarray([1, 2], np.int32), GenerationConfig(30, temperature=0.0), 0,
                deadline_s=50.0)
    pair.inj.skew_clock(by=100.0)
    pair.jinj.skew_clock(by=100.0)
    pair.run()
    assert pair.reqs[0].state is RequestState.TIMED_OUT
    pair.check_alike()


def test_bounded_queue_rejects_with_depth(setup):
    tt = setup[2]
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    engine = ServingEngine(tt, num_slots=1, max_queue=2)
    engine.submit(np.asarray([1, 2], np.int32), gcfg)
    engine.step()
    engine.submit(np.asarray([3, 4], np.int32), gcfg)
    engine.submit(np.asarray([5, 6], np.int32), gcfg)
    with pytest.raises(RejectedError) as exc:
        engine.submit(np.asarray([7, 8], np.int32), gcfg)
    assert exc.value.queue_depth == 2 and engine.metrics.snapshot()["rejects"] == 1
    engine.run()
    assert engine.metrics.completed == 3


def test_drain_finishes_in_flight_and_admits_nothing_new(setup):
    """drain() serves admitted work to completion, holds never-admitted
    queued requests, rejects submissions; resume() lets them run."""
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    pair = Pair(setup, num_slots=1)
    active, _ = pair.submit(np.asarray([1, 2, 3], np.int32), gcfg, 4)
    pair.step()
    queued, _ = pair.submit(np.asarray([4, 5], np.int32), gcfg, 5)
    pair.port.drain()
    pair.jax.drain()
    assert pair.port.health() is EngineHealth.DRAINING
    with pytest.raises(RejectedError):
        pair.port.submit(np.asarray([6, 7], np.int32), gcfg)
    pair.run()
    assert active.state is RequestState.DONE
    assert active.tokens == _solo(setup[2], np.asarray([1, 2, 3], np.int32), gcfg, 4)
    assert queued.state is RequestState.QUEUED
    assert pair.port.metrics.snapshot()["health"] == "draining"
    pair.port.resume()
    pair.jax.resume()
    pair.run()
    assert queued.state is RequestState.DONE
    pair.check_alike()


def test_drain_still_finishes_preempted_work(setup):
    """Preempted requests are in-flight work: drain lets them resume and
    finish exactly (JAX slow: port only)."""
    tt = LlamaForCausalLM(dataclasses.replace(setup[2].config, max_seq_len=48), device="cpu")
    tt.load_state_dict(setup[2].state_dict())
    gcs = [GenerationConfig(30, temperature=0.0), GenerationConfig(20, temperature=0.0),
           GenerationConfig(25, temperature=0.0)]
    prompts = [np.asarray([3, 5, 7, 11], np.int32), np.asarray([13, 17, 19, 23], np.int32),
               np.asarray([29, 31, 37, 41], np.int32)]
    refs = [_solo(tt, p, g, 60 + i) for i, (p, g) in enumerate(zip(prompts, gcs))]
    engine = ServingEngine(tt, num_slots=2, admission="eager")
    reqs = [engine.submit(p, g, seed=60 + i) for i, (p, g) in enumerate(zip(prompts, gcs))]
    while engine.metrics.preemptions == 0 and engine.has_work:
        engine.step()
    assert engine.metrics.preemptions > 0
    engine.drain()
    engine.run()
    for req, ref in zip(reqs, refs):
        assert req.state is RequestState.DONE and req.tokens == ref


# --- prefill faults ------------------------------------------------------------------


def test_prefill_fault_fails_one_request_not_the_loop(setup):
    """A prefill fault fails exactly the victim, returns its slot, and the
    other streams are exact (JAX slow: port only)."""
    tt = setup[2]
    prompts, gcfgs = _workload(n=3)
    refs = _port_refs(tt, prompts, gcfgs, range(500, 503))
    inj = FaultInjector().fail_prefill(at=1, times=1)
    engine = ServingEngine(tt, num_slots=2, fault_injector=inj)
    reqs = [engine.submit(p, c, seed=500 + i) for i, (p, c) in enumerate(zip(prompts, gcfgs))]
    engine.run()
    failed = [r for r in reqs if r.state is RequestState.FAILED]
    assert inj.counters["prefill_failures"] == 1 and len(failed) == 1
    assert "prefill failed" in failed[0].error
    for req, ref in zip(reqs, refs):
        if req.state is RequestState.DONE:
            assert req.tokens == ref
    assert engine.metrics.snapshot()["prefill_failures"] == 1
    assert engine.cache.free_slots == engine.num_slots


def test_poisoned_prefix_entry_evicted_and_stream_bit_identical(setup):
    """A poisoned stored prefix copy fails its reuse-time fingerprint: the
    entry is evicted, the admission falls back to a full prefill with the
    stream intact, and the clean re-insert serves the next hit (JAX slow:
    port only)."""
    from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache

    tt = setup[2]
    prompt = np.arange(2, 18, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.8, top_k=13)
    ref = _solo(tt, prompt, gcfg, 61)
    inj = FaultInjector().poison_prefix(at=0, times=1)
    engine = ServingEngine(tt, num_slots=1, fault_injector=inj,
                           prefix_cache=PrefixCache(max_entries=4, min_match=4))
    reqs = []
    for _ in range(2):
        reqs.append(engine.submit(prompt, gcfg, seed=61))
        engine.run()
    assert inj.counters["poisoned_prefixes"] == 1
    snap = engine.metrics.snapshot()
    assert snap["prefix_validation_failures"] == 1 and snap["prefix_hits"] == 0
    reqs.append(engine.submit(prompt, gcfg, seed=61))
    engine.run()
    assert all(r.tokens == ref for r in reqs)
    assert engine.metrics.snapshot()["prefix_hits"] == 1


def test_prefill_fault_on_suffix_path_releases_pin(setup):
    """A prefill fault on a prefix hit fails that request, releases the
    entry's pin, and leaves the store serving later requests."""
    prompt = np.arange(3, 17, dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    pair = Pair(setup, lambda i: i.fail_prefill(at=1, times=1), num_slots=1,
                prefix=dict(max_entries=4, min_match=4))
    for _ in range(3):
        pair.submit(prompt, gcfg, 62)
        pair.run()
    assert pair.reqs[1].state is RequestState.FAILED
    assert all(e.refs == 0 for e in pair.port.prefix.entries)
    ref = _solo(setup[2], prompt, gcfg, 62)
    assert pair.reqs[0].tokens == ref and pair.reqs[2].tokens == ref
    assert pair.port.metrics.snapshot()["prefix_hits"] == 2
    pair.check_alike()


def test_queue_timeout_spares_requeued_inflight_work(setup):
    """The queue timeout governs FIRST admission only: a request requeued by
    recovery after its admission is not shed while it waits (JAX slow:
    port only)."""
    tt = setup[2]
    gcfg = GenerationConfig(max_new_tokens=12, temperature=0.7, top_k=11)
    prompt = np.asarray([3, 5, 7, 9], np.int32)
    clock = {"t": 0.0}
    engine = ServingEngine(tt, num_slots=1, decode_chunk_size=2, sleep_fn=lambda s: None,
                           fault_injector=FaultInjector().fail_dispatch(at=1, times=1),
                           time_fn=lambda: clock["t"])
    req = engine.submit(prompt, gcfg, seed=31, queue_timeout_s=1.0)
    engine.step()
    engine.step()
    assert req.state is RequestState.QUEUED and req.admit_time is not None
    clock["t"] = 5.0
    engine.run()
    assert req.state is RequestState.DONE and req.tokens == _solo(tt, prompt, gcfg, 31)
    assert engine.metrics.sheds == 0


def test_persistent_prefill_failures_halt_not_silent(setup):
    """A prefill failing every admission halts after the bounded budget,
    the rest of the queue intact, every slot returned."""
    gcfg = GenerationConfig(max_new_tokens=6, temperature=0.0)
    pair = Pair(setup, lambda i: i.fail_prefill(at=0, times=None), num_slots=2)
    for i in range(6):
        pair.submit(np.asarray([i + 1, i + 2], np.int32), gcfg, i)
    pair.run()
    engine = pair.port
    assert engine.health() is EngineHealth.HALTED
    assert "consecutive prefill failures" in engine.halt_reason
    assert [r.state for r in pair.reqs].count(RequestState.FAILED) == 3
    assert [r.state for r in pair.reqs].count(RequestState.QUEUED) == 3
    assert engine.metrics.prefill_failures == 3
    assert engine.cache.free_slots == engine.num_slots
    assert engine.cache.cursor == 0
    pair.check_alike()


def test_prefill_halt_requeues_actively_decoding_requests(setup):
    """A prefill-failure halt requeues the requests that were decoding
    (with their partial streams), not stranded in a slot."""
    long_cfg = GenerationConfig(max_new_tokens=40, temperature=0.0)
    pair = Pair(setup, lambda i: i.fail_prefill(at=2, times=None), num_slots=2,
                decode_chunk_size=2)
    for i in range(2):
        pair.submit(np.asarray([i + 2, i + 3, i + 4], np.int32), long_cfg, i)
    pair.step()
    assert all(r.state is RequestState.DECODE for r in pair.reqs)
    for i in range(4):
        pair.submit(np.asarray([i + 9, i + 10], np.int32), long_cfg, 10 + i)
    pair.port.cancel(pair.reqs[1].rid)
    pair.jax.cancel(pair.jreqs[1].rid)
    pair.run()
    engine = pair.port
    assert engine.health() is EngineHealth.HALTED
    first = pair.reqs[0]
    assert first.state is RequestState.QUEUED and first.slot is None and len(first.tokens) > 0
    assert not engine._active.any() and not engine._state["active"].any()
    assert [r.state for r in pair.reqs[2:]].count(RequestState.FAILED) == 3
    assert engine.cache.cursor == 0
    pair.check_alike()


# --- submissions ------------------------------------------------------------------------


def test_unplaceable_submit_rejected_up_front(setup):
    tt = setup[2]
    engine = ServingEngine(tt, num_slots=2, max_tokens_in_flight=20)
    with pytest.raises(ValueError, match="max_tokens_in_flight"):
        engine.submit(np.arange(1, 16, dtype=np.int32), GenerationConfig(max_new_tokens=10))
    with pytest.raises(ValueError, match="max_seq_len"):
        engine.submit(np.arange(1, tt.config.max_seq_len, dtype=np.int32),
                      GenerationConfig(max_new_tokens=8))
    assert engine.scheduler.queued == 0 and not engine.scheduler.requests
    assert not engine.has_work
    engine.run()


def test_deadline_and_option_validation(setup):
    tt = setup[2]
    engine = ServingEngine(tt, num_slots=1)
    with pytest.raises(ValueError, match="deadline_s"):
        engine.submit(np.asarray([1, 2], np.int32), GenerationConfig(), deadline_s=0.0)
    with pytest.raises(ValueError, match="queue_timeout_s"):
        engine.submit(np.asarray([1, 2], np.int32), GenerationConfig(), queue_timeout_s=-1.0)
    with pytest.raises(ValueError, match="quarantine policy"):
        ServingEngine(tt, num_slots=1, quarantine_policy="drop")


def test_fault_events_land_in_the_flight_recorder(setup):
    """The port's counterpart of the timeline test (timelines wait for
    their module): dispatch_failure, recovery, quarantine and shed events
    land in the flight recorder with their redacted payloads."""
    tt = setup[2]
    clock = {"t": 0.0}
    inj = FaultInjector().fail_dispatch(at=1, times=1).poison_readback(at=3, slot=0, token=-1)
    engine = ServingEngine(tt, num_slots=2, decode_chunk_size=2, fault_injector=inj,
                           sleep_fn=lambda s: None, time_fn=lambda: clock["t"])
    engine.submit(np.asarray([1, 2, 3], np.int32), GenerationConfig(20, temperature=0.0))
    victim = engine.submit(np.asarray([4, 5], np.int32), GenerationConfig(20, temperature=0.0),
                           deadline_s=5.0)
    for _ in range(3):
        engine.step()
    clock["t"] = 6.0
    engine.run()
    kinds = [e["kind"] for e in engine.flight.events()]
    for kind in ("dispatch_failure", "recovery", "quarantine", "shed", "health"):
        assert kind in kinds, kind
    shed = next(e for e in engine.flight.events() if e["kind"] == "shed")
    assert shed["where"] == "inflight" and victim.state is RequestState.TIMED_OUT


def test_mixed_faults_under_load(setup):
    """A small soak (the JAX soak is slow): repeated dispatch faults and a
    poisoned slot over a staggered workload; every stream exact."""
    tt = setup[2]
    rng = np.random.RandomState(0)
    n = 8
    prompts = [rng.randint(1, 256, size=rng.randint(3, 12)).astype(np.int32) for _ in range(n)]
    gcfgs = [GenerationConfig(max_new_tokens=int(rng.randint(4, 10)),
                              temperature=float(rng.choice([0.0, 0.8]))) for _ in range(n)]
    refs = _port_refs(tt, prompts, gcfgs, range(900, 900 + n))
    inj = (FaultInjector().fail_dispatch(at=2, times=1).fail_dispatch(at=7, times=1)
           .poison_readback(at=4, slot=1, token=-1))
    engine = ServingEngine(tt, num_slots=3, decode_chunk_size=2, fault_injector=inj,
                           sleep_fn=lambda s: None)
    reqs = [engine.submit(p, c, seed=900 + i) for i, (p, c) in enumerate(zip(prompts[:3],
                                                                              gcfgs[:3]))]
    i = 3
    while engine.has_work or i < n:
        engine.step()
        if i < n:
            reqs.append(engine.submit(prompts[i], gcfgs[i], seed=900 + i))
            i += 1
    assert engine.metrics.dispatch_retries == 2 and engine.metrics.quarantines == 1
    for i, (req, ref) in enumerate(zip(reqs, refs)):
        assert req.state is RequestState.DONE and req.tokens == ref, f"request {i}"


# --- the shared pieces ------------------------------------------------------------------


def test_retry_policy_schedule_equals_jax():
    """RetryPolicy's waits and with_retries' schedule equal the JAX
    package's under one seeded RNG."""
    import random

    from neuronx_distributed_tpu.utils.retry import RetryPolicy as JRetryPolicy
    from neuronx_distributed_tpu.utils.retry import with_retries as jwith_retries

    pol, jpol = RetryPolicy(max_attempts=4, first_wait=2.0, min_wait=0.3), \
        JRetryPolicy(max_attempts=4, first_wait=2.0, min_wait=0.3)
    assert [pol.base_wait(k) for k in range(6)] == [jpol.base_wait(k) for k in range(6)]
    assert [pol.wait(k, random.Random(5)) for k in range(4)] == \
        [jpol.wait(k, random.Random(5)) for k in range(4)]
    for fn_retry, policy in ((with_retries, pol), (jwith_retries, jpol)):
        calls, waits = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise TimeoutError("throttled")
            return "ok"
        assert fn_retry(flaky, "op", policy, sleep=waits.append, rng=random.Random(1)) == "ok"
        assert len(calls) == 3 and len(waits) == 2
        with pytest.raises(FileNotFoundError):
            fn_retry(lambda: (_ for _ in ()).throw(FileNotFoundError("x")), "op", policy,
                     sleep=waits.append)
    r1, r2 = random.Random(9), random.Random(9)
    w1, w2 = [], []
    with pytest.raises(TimeoutError):
        with_retries(lambda: (_ for _ in ()).throw(TimeoutError()), "op", pol, sleep=w1.append,
                     rng=r1)
    with pytest.raises(TimeoutError):
        jwith_retries(lambda: (_ for _ in ()).throw(TimeoutError()), "op", jpol, sleep=w2.append,
                      rng=r2)
    assert w1 == w2 and len(w1) == 3


def test_flight_recorder_redacts_and_dumps_like_jax(tmp_path):
    """The port's recorder: the JAX recorder's redaction, ring and dump
    file names, event for event (timestamps aside)."""
    from neuronx_distributed_tpu.observability.flight_recorder import FlightRecorder as JFR
    from neuronx_distributed_tpu_torch.observability.flight_recorder import FlightRecorder

    events = [("health", dict(value="degraded", was="ok")),
              ("shed", dict(rid=3, reason="x" * 300, toks=list(range(20)), nan=float("nan"))),
              ("nested", dict(a={"b": {"c": {"d": 1}}}, arr=np.zeros((2, 3)),
                              t=torch.zeros(4), obj=object()))]
    outs = []
    for cls, d in ((FlightRecorder, tmp_path / "port"), (JFR, tmp_path / "jax")):
        fr = cls(capacity=2, dump_dir=str(d), subsystem="serving")
        for kind, fields in events:
            fr.record(kind, **fields)
        path = fr.dump("halted", extra={"requeued": 2})
        pm = json.loads(open(path).read())
        for e in pm["events"]:
            e.pop("t_mono")
        pm.pop("wall_time")
        outs.append((pm, path.rsplit("/", 1)[1]))
    (port, pname), (jax_pm, jname) = outs
    # a tensor redacts as its type and shape, like an array
    port["events"][1]["t"].pop("type")
    jax_pm["events"][1]["t"] = {"shape": [4]}
    assert port == jax_pm and pname == jname == "postmortem_serving_001.json"
    mem = FlightRecorder()
    assert mem.dump("x") is None and mem.last_postmortem["reason"] == "x"
