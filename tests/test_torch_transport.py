"""The fabric's transport against the JAX package (host only, no engine):
the 13 cases of ``tests/serving/test_transport.py``. Each case runs the
JAX transport and the port's side by side on the same schedule (the same
targets, ops, rids, clock and fault windows) and holds the outcomes, the
targets' call counts, the transport's ``snapshot()`` and the injector's
counters equal, then checks JAX's own assertions on the port.

The contracts: an in-process call equals a direct call (the target runs
once, its result and its exceptions pass unchanged); ``(rid, seq)``
idempotency (a retried or duplicated delivery returns the cached outcome
without running the target again); fault schedules are deterministic by
send index and every fired fault is counted."""

import types

import pytest
import torch

from neuronx_distributed_tpu.serving import faults as jfaults
from neuronx_distributed_tpu.serving import transport as jtransport
from neuronx_distributed_tpu.utils import retry as jretry
from neuronx_distributed_tpu_torch.serving import faults as tfaults
from neuronx_distributed_tpu_torch.serving import transport as ttransport
from neuronx_distributed_tpu_torch.utils import retry as tretry

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

JAX = types.SimpleNamespace(t=jtransport, FaultInjector=jfaults.FaultInjector,
                            RetryPolicy=jretry.RetryPolicy)
PORT = types.SimpleNamespace(t=ttransport, FaultInjector=tfaults.FaultInjector,
                             RetryPolicy=tretry.RetryPolicy)


class _Clock:
    def __init__(self, start=0.0):
        self.now = start

    def __call__(self):
        return self.now


class _Target:
    """Counts invocations; optionally raises an application error first."""

    def __init__(self, result="ok", raise_first=None):
        self.calls = 0
        self.result = result
        self.raise_first = raise_first

    def __call__(self):
        self.calls += 1
        if self.raise_first is not None:
            e, self.raise_first = self.raise_first, None
            raise e
        return (self.result, self.calls)


def _outcome(fn):
    """``("ok", value)`` or ``("raise", exception class name, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return ("raise", type(e).__name__, str(e))


def _both(case):
    """Run ``case(side)`` (it returns a dict of observables) on the JAX
    package's transport and on the port's; they must be equal. Returns the
    port's."""
    got_j, got_t = case(JAX), case(PORT)
    assert got_t == got_j
    return got_t


def _obs(t, inj=None, **extra):
    out = {"snapshot": t.snapshot(), **extra}
    if inj is not None:
        out["counters"] = dict(inj.counters)
    return out


def test_clean_call_is_direct():
    def case(s):
        t = s.t.InProcessTransport(time_fn=_Clock())
        tgt = _Target()
        return _obs(t, res=t.call(0, "submit", tgt, rid=7), calls=tgt.calls)

    got = _both(case)
    assert got["res"] == ("ok", 1) and got["calls"] == 1
    snap = got["snapshot"]
    assert snap["messages"] == 1 and snap["deliveries"] == 1
    assert snap["retries"] == 0 and snap["dedup_hits"] == 0


def test_app_exception_propagates_unwrapped():
    def case(s):
        t = s.t.InProcessTransport(time_fn=_Clock())
        boom = ValueError("rid 3 already known")
        return _obs(t, res=_outcome(lambda: t.call(1, "adopt", _Target(raise_first=boom),
                                                   rid=3)))

    got = _both(case)
    assert got["res"] == ("raise", "ValueError", "rid 3 already known")
    assert got["snapshot"]["retries"] == 0 and got["snapshot"]["deliveries"] == 1


def test_seq_is_per_message_not_per_attempt():
    def case(s):
        t = s.t.InProcessTransport(time_fn=_Clock())
        t.call(0, "submit", _Target(), rid=1)
        t.call(0, "submit", _Target(), rid=1)
        return _obs(t)

    snap = _both(case)["snapshot"]
    assert snap["dedup_hits"] == 0 and snap["deliveries"] == 2


def test_dedup_cache_is_bounded():
    def case(s):
        t = s.t.InProcessTransport(time_fn=_Clock(), dedup_capacity=4)
        for i in range(10):
            t.call(0, "submit", _Target(), rid=i)
        return _obs(t)

    assert _both(case)["snapshot"]["dedup_entries"] == 4
    with pytest.raises(ValueError):
        ttransport.InProcessTransport(dedup_capacity=0)


def test_missed_deadline_is_terminal():
    """Attempt 0 drops; the retry's wait carries the clock past the
    deadline, so attempt 1's check raises TransportTimeout: final, the
    target never ran."""
    def case(s):
        clock = _Clock(start=100.0)
        inj = s.FaultInjector().drop_send(at=0, times=1)
        t = s.t.ChaosTransport(inj, time_fn=clock,
                               sleep_fn=lambda _: setattr(clock, "now", clock.now + 6.0))
        tgt = _Target()
        res = _outcome(lambda: t.call(0, "submit", tgt, rid=1, deadline_s=5.0))
        return _obs(t, inj, res=res[:2], calls=tgt.calls)

    got = _both(case)
    assert got["res"] == ("raise", "TransportTimeout") and got["calls"] == 0
    assert got["snapshot"]["timeouts"] == 1 and got["snapshot"]["retries"] == 1


def test_drop_retries_and_delivers_once():
    def case(s):
        inj = s.FaultInjector().drop_send(at=0, times=2)
        t = s.t.ChaosTransport(inj, time_fn=_Clock())
        tgt = _Target()
        return _obs(t, inj, res=t.call(0, "submit", tgt, rid=1), calls=tgt.calls)

    got = _both(case)
    assert got["res"] == ("ok", 1) and got["calls"] == 1
    assert got["snapshot"]["drops"] == 2 and got["snapshot"]["retries"] == 2
    assert got["counters"]["dropped_sends"] == 2


def test_drop_exhausts_policy_and_gives_up():
    def case(s):
        inj = s.FaultInjector().drop_send(at=0, times=None)
        t = s.t.ChaosTransport(inj, time_fn=_Clock(),
                               retry=s.RetryPolicy(max_attempts=3, first_wait=0.0, min_wait=0.0))
        tgt = _Target()
        res = _outcome(lambda: t.call(0, "submit", tgt, rid=1))
        return _obs(t, inj, res=res[:2], calls=tgt.calls)

    got = _both(case)
    assert got["res"] == ("raise", "TransportError") and got["calls"] == 0
    assert got["snapshot"]["give_ups"] == 1 and got["snapshot"]["drops"] == 3


def test_lost_ack_retry_hits_dedup_exactly_once():
    """The target RAN but the reply was lost: the retry returns the cached
    outcome and does not run it again."""
    def case(s):
        inj = s.FaultInjector().drop_ack(at=0, times=1)
        t = s.t.ChaosTransport(inj, time_fn=_Clock())
        tgt = _Target()
        return _obs(t, inj, res=t.call(0, "adopt", tgt, rid=5), calls=tgt.calls)

    got = _both(case)
    assert got["res"] == ("ok", 1) and got["calls"] == 1
    snap = got["snapshot"]
    assert snap["ack_drops"] == 1 and snap["retries"] == 1 and snap["dedup_hits"] == 1
    assert got["counters"]["dropped_acks"] == 1


def test_duplicate_delivery_absorbed():
    def case(s):
        inj = s.FaultInjector().dup_send(at=0, times=1)
        t = s.t.ChaosTransport(inj, time_fn=_Clock())
        tgt = _Target()
        return _obs(t, inj, res=t.call(0, "handoff", tgt, rid=2), calls=tgt.calls)

    got = _both(case)
    assert got["res"] == ("ok", 1) and got["calls"] == 1
    assert got["snapshot"]["dup_deliveries"] == 1 and got["snapshot"]["dedup_hits"] == 1
    assert got["counters"]["dup_sends"] == 1


def test_duplicated_app_error_replayed_not_rerun():
    def case(s):
        inj = s.FaultInjector().dup_send(at=0, times=1)
        t = s.t.ChaosTransport(inj, time_fn=_Clock())
        tgt = _Target(raise_first=ValueError("rejected"))
        res = _outcome(lambda: t.call(0, "adopt", tgt, rid=2))
        return _obs(t, inj, res=res, calls=tgt.calls)

    got = _both(case)
    assert got["res"] == ("raise", "ValueError", "rejected")
    assert got["calls"] == 1 and got["snapshot"]["dedup_hits"] == 1


@pytest.mark.parametrize("by, deadline, outcome", [(0.5, 2.0, "ok"), (3.0, 1.0, "timeout")])
def test_delay_against_the_deadline(by, deadline, outcome):
    """JAX's ``test_delay_within_deadline_delivers`` (a call) and
    ``test_delay_past_deadline_times_out`` (a probe), one parametrized
    case each."""
    def case(s):
        inj = s.FaultInjector().delay_send(at=0, times=1 if outcome == "ok" else None, by=by)
        t = s.t.ChaosTransport(inj, time_fn=_Clock())
        tgt = _Target()
        if outcome == "ok":
            res = _outcome(lambda: t.call(0, "probe", tgt, deadline_s=deadline))
        else:
            res = _outcome(lambda: t.probe(0, tgt, deadline_s=deadline))[:2]
        return _obs(t, inj, res=res, calls=tgt.calls)

    got = _both(case)
    snap = got["snapshot"]
    if outcome == "ok":
        assert got["res"] == ("ok", ("ok", 1))
        assert snap["delays"] == 1 and snap["timeouts"] == 0
    else:
        assert got["res"] == ("raise", "TransportTimeout") and got["calls"] == 0
        assert snap["timeouts"] == 1 and got["counters"]["delayed_sends"] == 1


def test_partition_is_per_target():
    def case(s):
        inj = s.FaultInjector().partition(0, at=0, times=None)
        t = s.t.ChaosTransport(inj, time_fn=_Clock(),
                               retry=s.RetryPolicy(max_attempts=2, first_wait=0.0, min_wait=0.0))
        ok_tgt, dead_tgt = _Target(), _Target()
        dead = _outcome(lambda: t.call(0, "submit", dead_tgt, rid=1))[:2]
        ok = t.call(1, "submit", ok_tgt, rid=2)
        return _obs(t, inj, dead=dead, ok=ok, calls=(dead_tgt.calls, ok_tgt.calls))

    got = _both(case)
    assert got["dead"] == ("raise", "PartitionedError") and got["ok"] == ("ok", 1)
    assert got["calls"] == (0, 1)
    assert got["counters"]["partitioned_sends"] == 2  # both attempts


def test_partition_window_heals():
    """The window covers sends 0..2; the fourth attempt gets through."""
    def case(s):
        inj = s.FaultInjector().partition("decode", at=0, times=3)
        t = s.t.ChaosTransport(inj, time_fn=_Clock())
        tgt = _Target()
        return _obs(t, inj, res=t.call("decode", "handoff", tgt, rid=9), calls=tgt.calls)

    got = _both(case)
    assert got["res"] == ("ok", 1) and got["calls"] == 1
    assert got["snapshot"]["retries"] == 3


def test_probe_is_single_attempt():
    def case(s):
        inj = s.FaultInjector().partition(0, at=0, times=None)
        t = s.t.ChaosTransport(inj, time_fn=_Clock())
        res = _outcome(lambda: t.probe(0, _Target(), deadline_s=1.0))[:2]
        return _obs(t, inj, res=res)

    got = _both(case)
    assert got["res"] == ("raise", "PartitionedError")
    assert got["snapshot"]["retries"] == 0


def test_schedule_is_deterministic():
    def case(s):
        inj = s.FaultInjector().drop_send(at=1, times=1).dup_send(at=4, times=1)
        t = s.t.ChaosTransport(inj, time_fn=_Clock())
        for i in range(4):
            t.call(i % 2, "submit", _Target(), rid=i)
        return _obs(t, inj)

    assert _both(case) == _both(case)


def test_every_schedule_matches_jax_call_for_call():
    """One long mixed schedule (every action kind, two partition windows,
    application errors) over forty messages: the outcome of every call,
    the snapshot and the counters equal JAX's after each call."""
    def case(s):
        clock = _Clock()
        inj = (s.FaultInjector().dup_send(at=3, times=2).drop_send(at=9, times=2)
               .delay_send(at=15, times=2, by=0.01).dup_send(at=24, times=1)
               .drop_ack(at=27, times=2).drop_send(at=33, times=1)
               .partition(1, at=40, times=6).partition("decode", at=50))
        t = s.t.ChaosTransport(inj, time_fn=clock,
                               sleep_fn=lambda w: setattr(clock, "now", clock.now + 0.001))
        trace = []
        for i in range(40):
            target = ("decode", 0, 1)[i % 3]
            tgt = _Target(raise_first=ValueError(f"app {i}") if i % 7 == 3 else None)
            res = _outcome(lambda: t.call(target, ("submit", "adopt")[i % 2], tgt, rid=i,
                                          deadline_s=0.5 if i % 5 == 0 else None))
            trace.append((res[:2], tgt.calls, t.snapshot(), dict(inj.counters)))
        return {"trace": trace}

    trace = _both(case)["trace"]
    assert any(r[0][0] == "raise" for r in trace) and any(r[0][0] == "ok" for r in trace)
    assert all(r[1] <= 1 for r in trace)  # exactly once, whatever the schedule
