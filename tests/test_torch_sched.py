"""The scheduling policies against the JAX package's
(``serving/sched/*``): the cases of ``tests/serving/test_sched_policy.py``
(aging, DWRR, the tier ladder, ``select`` ordering, budget and fits, the
live TTFT early warning, victims: cheapest, cooldown, spares nearly done,
never from a pressured tenant), each run on the same synthetic queue
through both packages' policies with equal orders, leftover queues and
victims; and the FIFO policy equal to the pre-policy ``Scheduler.select``
over seeded queues. Host code only, no model."""

from collections import deque

import numpy as np
import pytest

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.serving import sched as jsched
from neuronx_distributed_tpu.serving import scheduler as jscheduler
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.serving import sched as tsched
from neuronx_distributed_tpu_torch.serving import scheduler as tscheduler

SIDES = {
    "jax": (jsched, jscheduler, lambda rid, prompt, cfg, **kw: jscheduler.Request(
        rid=rid, prompt=prompt, key=np.zeros((2,), np.uint32),
        config=JGenerationConfig(max_new_tokens=cfg), **kw)),
    "port": (tsched, tscheduler, lambda rid, prompt, cfg, **kw: tscheduler.Request(
        rid=rid, prompt=prompt, seed=rid, config=GenerationConfig(max_new_tokens=cfg), **kw)),
}


def _req(side, rid, plen, max_new=8, tenant="default", priority="standard", submit_time=None):
    r = SIDES[side][2](rid, np.arange(1, plen + 1, dtype=np.int32), max_new, tenant=tenant,
                       priority=priority)
    r.submit_time = submit_time
    return r


def _both(fn):
    """``fn(side)`` for both packages; returns (port, jax)."""
    return fn("port"), fn("jax")


# --- FIFO: the pre-policy select, decision for decision ---------------------


def _pre_policy_select(queue, free_slots, in_flight_tokens, limit, fits=None, prefill_cost=None):
    """The port's ``Scheduler.select`` before the policy seam, the oracle."""
    selected, budget = [], in_flight_tokens
    while queue and len(selected) < free_slots:
        req = queue[0]
        if req.finished:
            queue.popleft()
            continue
        if limit is not None and budget + req.token_footprint > limit:
            break
        if fits is not None and not fits(req):
            break
        queue.popleft()
        req.state = tscheduler.RequestState.PREFILL
        budget += req.token_footprint
        selected.append(req)
    selected.sort(key=prefill_cost or (lambda r: len(r.context_ids)), reverse=True)
    return selected


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fifo_policy_matches_pre_policy_select_and_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(25):
        n = int(rng.randint(1, 9))
        plens, news = rng.randint(1, 30, size=n), rng.randint(1, 12, size=n)
        limit = int(rng.randint(10, 120)) if rng.rand() < 0.7 else None
        free, cutoff = int(rng.randint(1, 5)), int(rng.randint(0, 40))
        cancelled = rng.rand(n) < 0.15
        use_fits, use_cost = rng.rand() < 0.5, rng.rand() < 0.5
        fits = (lambda r: len(r.prompt) <= cutoff) if use_fits else None
        cost = (lambda r: -r.rid) if use_cost else None

        def queue(side):
            q = deque()
            for i in range(n):
                r = _req(side, i, int(plens[i]), int(news[i]))
                if cancelled[i]:
                    r.state = SIDES[side][1].RequestState.CANCELLED
                q.append(r)
            return q

        runs = {}
        for name in ("port", "jax"):
            sched = SIDES[name][1].Scheduler(max_tokens_in_flight=limit)
            sched._queue = queue(name)
            got = sched.select(free, 0, fits, prefill_cost=cost)
            runs[name] = ([r.rid for r in got], [r.rid for r in sched._queue])
        q = queue("port")
        want = _pre_policy_select(q, free, 0, limit, fits, cost)
        assert runs["port"] == ([r.rid for r in want], [r.rid for r in q]) == runs["jax"]


def test_make_policy_resolution_and_default():
    for mod in (tsched, jsched):
        assert isinstance(mod.make_policy(None), mod.FifoPolicy)
        assert isinstance(mod.make_policy("slo"), mod.SloPolicy)
        p = mod.SloPolicy()
        assert mod.make_policy(p) is p
        with pytest.raises(ValueError, match="unknown scheduling policy"):
            mod.make_policy("lifo")
    assert isinstance(tscheduler.Scheduler().policy, tsched.FifoPolicy)
    assert isinstance(tscheduler.Scheduler(policy="slo").policy, tsched.SloPolicy)
    base = tsched.SchedulingPolicy()
    assert base.victims(0.0) == [] and base.route_bias("t") == 0.0
    assert base.snapshot() == {"policy": "base"}
    with pytest.raises(NotImplementedError):
        base.select(deque(), 1, 0, None)


# --- priority tiers, aging, DWRR ---------------------------------------------


def test_tiers_aging_and_weights_equal_jax():
    for label in ("realtime", "interactive", "standard", "batch", "bulk-reindex", None):
        assert tsched.tier_rank(label) == jsched.tier_rank(label)
        assert tsched.tier_weight(label) == jsched.tier_weight(label)
    assert tsched.TIER_RANK == jsched.TIER_RANK
    cfg_t, cfg_j = tsched.PriorityConfig(aging_s=2.0), jsched.PriorityConfig(aging_s=2.0)
    for prio, sub, now in (("realtime", 100.0, 100.0), ("batch", 100.0, 106.5),
                           ("realtime", 106.5, 106.5), ("batch", None, 5.0),
                           ("standard", 10.0, 3.0)):
        rt, rj = _req("port", 0, 4, priority=prio, submit_time=sub), _req(
            "jax", 0, 4, priority=prio, submit_time=sub)
        assert tsched.effective_rank(rt, now, cfg_t) == jsched.effective_rank(rj, now, cfg_j)
    # starvation-free: 6.5 s of wait beats a fresh realtime arrival
    old = _req("port", 1, 4, priority="batch", submit_time=100.0)
    fresh = _req("port", 2, 4, priority="realtime", submit_time=106.5)
    assert tsched.effective_rank(old, 106.5, cfg_t) < tsched.effective_rank(fresh, 106.5, cfg_t)
    with pytest.raises(ValueError):
        tsched.PriorityConfig(aging_s=0.0)


def test_dwrr_ledger_equal_jax():
    ops = [("replenish", [("chat", "interactive"), ("docs", "batch")]), ("charge", "chat", 60),
           ("replenish", [("docs", "batch")]), ("charge", "docs", 10_000),
           *[("replenish", [("idle", "realtime")])] * 10, ("charge", "chat", 3)]
    ledgers = []
    for mod in (tsched, jsched):
        drr = mod.DeficitRoundRobin(mod.FairnessConfig(quantum_tokens=10, burst_tokens=100))
        for op in ops:
            if op[0] == "replenish":
                drr.replenish(op[1])
            else:
                drr.charge(op[1], op[2])
        ledgers.append((drr.snapshot(), [drr.rank(t) for t in ("chat", "docs", "idle", "x")]))
    assert ledgers[0] == ledgers[1]
    snap = ledgers[0][0]
    assert snap["deficits"]["idle"] == 100.0 and snap["deficits"]["docs"] == -100.0
    with pytest.raises(ValueError):
        tsched.FairnessConfig(quantum_tokens=0)
    with pytest.raises(ValueError):
        tsched.FairnessConfig(quantum_tokens=64, burst_tokens=10)


# --- the SLO policy's ordering and victims on synthetic engines -------------


class _FakeTracker:
    def __init__(self, stats, specs):
        self._stats, self._specs = stats, specs

    def spec_for(self, tenant):
        return self._specs.get(tenant)

    def decided(self, tenant):
        return self._stats.get(tenant, (0, 1.0))[0]

    def attainment(self, tenant):
        return self._stats.get(tenant, (0, 1.0))[1]


class _FakeMetrics:
    def __init__(self, tracker, ttft_p99=None):
        self.slo = tracker
        self._ttft = ttft_p99 or {}

    def tenant_latency(self, kind, tenant, q):
        return self._ttft.get(tenant, 0.0)


class _Spec:
    def __init__(self, ttft_p99_s=None):
        self.ttft_p99_s = ttft_p99_s


class _FakeCache:
    def __init__(self, free_slots, pages):
        self.free_slots = free_slots
        self._pages = pages

    def slot_pages(self, slot):
        return self._pages.get(slot, [])


class _FakePrefix:
    def __init__(self, matches):
        self._matches = matches

    def match_len(self, ctx):
        return self._matches.get(len(ctx), 0)


class _FakeEngine:
    def __init__(self, metrics, slot_reqs, queued, free_slots=0, page_size=None, pages=None,
                 prefix=None):
        self.metrics = metrics
        self._slot_req = slot_reqs
        self._page_size = page_size
        self.prefix = prefix
        self.cache = _FakeCache(free_slots, pages or {})
        self.scheduler = type("S", (), {"queued_requests": queued})()


def _policy(side, metrics, feedback=None, **kw):
    mod = SIDES[side][0]
    pol = mod.SloPolicy(feedback=mod.FeedbackConfig(**(feedback or {"cooldown_s": 0.0})), **kw)
    pol.bind(_FakeEngine(metrics, [], []))
    return pol


ORDER_CASES = {
    # a pressured tenant admits first; without pressure arrival order
    "pressure": dict(stats={"hurt": (10, 0.5), "fine": (10, 1.0)}, specs=("hurt", "fine"),
                     queue=[(0, 4, 8, "fine", "standard", 0.0), (1, 4, 8, "hurt", "standard", 0.0)],
                     free=2, limit=None, now=0.0),
    # strict tiers beat arrival order; the batch request stays queued
    "tiers": dict(stats={}, specs=(), free=1, limit=None, now=0.0,
                  queue=[(0, 4, 8, "a", "batch", 0.0), (1, 4, 8, "b", "interactive", 0.0)]),
    # 9.5 s of wait at aging 1 s unstarves the batch request
    "aging": dict(stats={}, specs=(), free=2, limit=None, now=9.5, aging=1.0,
                  queue=[(0, 4, 8, "a", "batch", 0.0), (1, 4, 8, "b", "interactive", 9.5)]),
    # the tenant that burned tokens sorts behind the starved one
    "fairness": dict(stats={}, specs=(), free=2, limit=None, now=0.0, hog=400,
                     queue=[(0, 4, 8, "hog", "standard", 0.0),
                            (1, 4, 8, "starved", "standard", 0.0)]),
    # the budget blocks the head and nothing overtakes it
    "budget": dict(stats={}, specs=(), free=2, limit=30, now=0.0,
                   queue=[(0, 20, 20, "a", "standard", 0.0), (1, 2, 2, "a", "standard", 0.0)]),
    # a fits predicate that refuses long prompts stops the scan at the head
    "fits": dict(stats={"hurt": (10, 0.2)}, specs=("hurt",), free=3, limit=None, now=1.0,
                 fits=10, queue=[(0, 4, 8, "a", "batch", 0.0), (1, 12, 8, "hurt", "batch", 0.5),
                                 (2, 3, 8, "b", "interactive", 0.9)]),
    # a live TTFT p99 over the spec pressures before any classification
    "live_ttft": dict(stats={}, specs=("chat",), ttft={"chat": 0.5}, free=1, limit=None,
                      now=0.0, queue=[(0, 4, 8, "docs", "standard", 0.0),
                                      (1, 4, 8, "chat", "standard", 0.0)]),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_slo_select_order_equal_jax(case):
    c = ORDER_CASES[case]

    def run(side):
        metrics = _FakeMetrics(_FakeTracker(c["stats"], {t: _Spec(0.1) if t == "chat" else _Spec()
                                                         for t in c["specs"]}), c.get("ttft"))
        mod = SIDES[side][0]
        pol = _policy(side, metrics)
        if "aging" in c:
            pol.priority = mod.PriorityConfig(aging_s=c["aging"])
        if "hog" in c:
            for _ in range(4):
                pol.fairness.replenish([("hog", "standard"), ("starved", "standard")])
            pol.on_tokens("hog", c["hog"])
        q = deque(_req(side, rid, plen, new, tenant, prio, sub)
                  for rid, plen, new, tenant, prio, sub in c["queue"])
        fits = (lambda r: len(r.prompt) <= c["fits"]) if "fits" in c else None
        got = pol.select(q, c["free"], 0, c["limit"], fits, now=c["now"])
        return ([r.rid for r in got], [r.rid for r in q], pol.snapshot(),
                {t: pol.route_bias(t) for t in ("hurt", "fine", "chat", "docs", None)})

    port, jax_ = _both(run)
    assert port == jax_
    expect = {"pressure": [1, 0], "tiers": [1], "aging": [0, 1], "fairness": [1, 0],
              "budget": [], "fits": [2], "live_ttft": [1]}[case]
    assert port[0] == expect


VICTIM_CASES = {
    # the cheapest healthy victim (resume work 8 < 30)
    "cheapest": dict(active=[(0, 8, 10, "fine"), (1, 30, 10, "fine")], free=0),
    # slots free: admission needs no victim
    "free_slot": dict(active=[(0, 8, 10, "fine"), (1, 30, 10, "fine")], free=1),
    # preemption off
    "off": dict(active=[(0, 8, 10, "fine")], free=0, preempt=False),
    # fewer than min_victim_remaining tokens left: spared
    "nearly_done": dict(active=[(0, 8, 2, "fine"), (1, 30, 2, "fine")], free=0),
    # the pressured tenant's own work is never a victim
    "pressured_own": dict(active=[(0, 8, 10, "hurt")], free=0),
    # paged: pages held x resume work; the prefix-cached context is cheap
    "paged": dict(active=[(0, 8, 10, "fine"), (1, 30, 10, "fine"), (2, 20, 10, "fine")], free=0,
                  page_size=8, pages={0: [1, 2, 3, 4], 1: [5], 2: [6, 7]}, prefix={20: 18}),
}


@pytest.mark.parametrize("case", sorted(VICTIM_CASES))
def test_slo_victims_equal_jax(case):
    c = VICTIM_CASES[case]

    def run(side):
        mod = SIDES[side][0]
        tracker = _FakeTracker({"hurt": (10, 0.2), "fine": (10, 1.0)},
                               {"hurt": _Spec(), "fine": _Spec()})
        pol = mod.SloPolicy(feedback=mod.FeedbackConfig(
            cooldown_s=0.0, preempt=c.get("preempt", True), min_decided=1))
        active = []
        for slot, (rid, plen, new, tenant) in enumerate(c["active"]):
            r = _req(side, rid, plen, max_new=new, tenant=tenant, submit_time=0.0)
            r.slot, r.state = slot, SIDES[side][1].RequestState.DECODE
            active.append(r)
        eng = _FakeEngine(_FakeMetrics(tracker), active + [None],
                          [_req(side, 9, 4, tenant="hurt", submit_time=0.0)],
                          free_slots=c["free"], page_size=c.get("page_size"),
                          pages=c.get("pages"),
                          prefix=_FakePrefix(c["prefix"]) if "prefix" in c else None)
        pol.bind(eng)
        costs = [mod.victim_cost(eng, r) for r in active]
        return [r.rid for r in pol.victims(now=1.0)], pol.preemptions_requested, costs

    port, jax_ = _both(run)
    assert port == jax_
    expect = {"cheapest": [0], "free_slot": [], "off": [], "nearly_done": [],
              "pressured_own": [], "paged": [2]}[case]
    assert port[0] == expect


def test_victims_cooldown_spaces_preemptions_like_jax():
    def run(side):
        mod = SIDES[side][0]
        tracker = _FakeTracker({"hurt": (10, 0.2), "fine": (10, 1.0)},
                               {"hurt": _Spec(), "fine": _Spec()})
        pol = mod.SloPolicy(feedback=mod.FeedbackConfig(cooldown_s=5.0, min_decided=1))
        r = _req(side, 0, 8, max_new=10, tenant="fine", submit_time=0.0)
        r.slot, r.state = 0, SIDES[side][1].RequestState.DECODE
        pol.bind(_FakeEngine(_FakeMetrics(tracker), [r],
                             [_req(side, 9, 4, tenant="hurt", submit_time=0.0)]))
        return [len(pol.victims(now=t)) for t in (1.0, 2.0, 5.9, 7.0)]

    port, jax_ = _both(run)
    assert port == jax_ == [1, 0, 0, 1]


def test_slo_select_reorders_seeded_queues_like_jax():
    """Seeded multi-tenant queues with mixed tiers, ages, SLO pressure and
    fairness debt: the whole admission sequence (rounds of selects with
    token charges in between) is the JAX policy's."""
    rng = np.random.default_rng(7)
    tenants = ["chat", "docs", "batch", "ops"]
    prios = ["interactive", "batch", "batch", "realtime"]
    reqs = [(i, int(rng.integers(1, 40)), int(rng.integers(1, 30)), int(rng.integers(0, 4)),
             float(rng.uniform(0, 5))) for i in range(40)]

    def run(side):
        metrics = _FakeMetrics(_FakeTracker({"chat": (8, 0.6), "docs": (8, 1.0)},
                                            {"chat": _Spec(0.2), "docs": _Spec(2.0)}),
                               {"chat": 0.3})
        pol = _policy(side, metrics)
        q = deque(_req(side, rid, plen, new, tenants[t], prios[t], sub)
                  for rid, plen, new, t, sub in reqs)
        rounds = []
        now = 5.0
        while q:
            got = pol.select(q, 3, 0, 150, lambda r: len(r.prompt) < 38, now=now)
            if not got:
                q.popleft()  # drop a blocked head so the sequence continues
                continue
            for r in got:
                pol.on_tokens(r.tenant, r.config.max_new_tokens)
            rounds.append([r.rid for r in got])
            now += 0.3
        return rounds, pol.snapshot()

    port, jax_ = _both(run)
    assert port == jax_
    assert len(port[0]) > 5
