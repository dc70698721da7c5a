"""Replica router: N serving engines behind one ``submit()`` (counterpart of
``neuronx_distributed_tpu/serving/router.py``: ``RID_STRIDE``,
``WatchdogConfig`` and ``ReplicaRouter``).

The router is a HOST-side policy layer: it owns no device state and touches
no hot path.

* **Balancing**: each submission goes to the healthiest, least-loaded
  replica by ``ServingEngine.load_score()`` (active slots, queue depth and
  the projected page footprint in slot units).
* **Prefix affinity**: a prompt whose prefix is resident in a replica's
  ``PrefixCache`` steers there (a suffix prefill and shared pages instead of
  a full prefill), unless that replica's ``page_pressure()`` is at or above
  ``affinity_overcommit`` (the overcommit guard). Affinity never overrides
  health.
* **Drain-around**: DEGRADED replicas take new work only while no OK
  replica exists; DRAINING and HALTED ones take none. A replica that HALTS
  has requeued its in-flight work with host-current tokens (the engine's
  halt contract): the router RE-HOMES it to the survivors through
  ``adopt``, each request keeping its rid (replicas mint from disjoint
  ``rid_base`` ranges), its tokens and its seed, so the survivor continues
  the stream and ``tokens_lost == 0``.
* **Transport**: every router-to-replica interaction (submit, adopt, probe,
  restore) rides an ``InProcessTransport`` (a direct call) or a
  ``ChaosTransport``; ``(rid, seq)`` keys make a retried or duplicated
  adopt admit once, and an unreachable replica's submit spills to the next.
* **Watchdog** (``watchdog=WatchdogConfig()``): ``step()`` sends periodic
  health probes on the router's clock; consecutive failures walk a replica
  OK -> SUSPECT -> DEGRADED -> DEAD, and recovery climbs one level per
  ``recover_after`` consecutive successes, so a flapping replica is held at
  SUSPECT. DEAD fences the replica and re-homes its work.
* **Integrity vote** (``WatchdogConfig(integrity_interval_s=)``): every
  interval the watchdog pass fingerprints every routable replica's weights
  through the transport (``ServingEngine.integrity_fingerprint``, TF on the
  card, one 8-byte read a replica) and votes (``integrity/voting.py``): a
  strict-minority value is silent corruption (the replica answers health
  probes OK while serving wrong weights) and goes straight to DEAD, fenced
  and re-homed like a probe death (``tokens_lost == 0``). Two replicas that
  disagree are detected, recorded, and neither is fenced. The vote needs
  replicas that hold their own weights: a fleet whose replicas share weight
  storage is refused, and :meth:`ReplicaRouter.build` gives each replica its
  own copy (a quantized replica owns its tensors already).
* **Live join, drain and restart**: :meth:`ReplicaRouter.add_replica` makes
  a replica from the ``build()`` recipe and rebalances queued work onto it;
  :meth:`ReplicaRouter.remove_replica` drains one out;
  :meth:`ReplicaRouter.restart_replica` snapshots a fenced replica's serving
  state, surrenders its queue to the snapshot and restores it on a fresh
  replica. With ``cache_dir=``/``manifest=`` the new replica is prewarmed
  (``ServingEngine.prewarm``: every program of a donor's manifest replayed
  once, the kernels loaded from ``cache_dir``) before it takes work.
* ``registry=``: the probe-state gauge per replica, the transport's
  counters, and the re-home and restart latency histograms.

On one card the replicas that :meth:`ReplicaRouter.build` makes without
the integrity vote serve ONE module: the weights are held once, each
replica has its own cache (pool or rows) and its own captured decode step,
and a ``params`` swap on one replica writes every replica's weights."""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.integrity.voting import vote
from neuronx_distributed_tpu_torch.serving.engine import (
    RID_STRIDE,
    EngineHealth,
    RejectedError,
    ServingEngine,
    weight_storages,
)
from neuronx_distributed_tpu_torch.serving.scheduler import Request
from neuronx_distributed_tpu_torch.serving.transport import InProcessTransport, TransportError

__all__ = ["RID_STRIDE", "WatchdogConfig", "ReplicaRouter"]

# the probe-state ladder: a demotion moves right (one failure threshold
# each), a recovery left one rung per ``recover_after`` successes
_PROBE_ORDER = ("ok", "suspect", "degraded", "dead")
_PROBE_CODE = {s: i for i, s in enumerate(_PROBE_ORDER)}


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """The watchdog's probe cadence and thresholds (JAX ``WatchdogConfig``,
    ``router.py:113``). Probes go out every ``probe_interval_s`` on the
    router's clock with a ``probe_timeout_s`` deadline, one transport
    attempt each; ``suspect_after``/``degraded_after``/``dead_after`` count
    consecutive failures, ``recover_after`` consecutive successes undo one
    level. DEAD is final. ``integrity_interval_s``: every that many
    seconds the cross-replica weight fingerprint vote (None: off)."""

    probe_interval_s: float = 0.25
    probe_timeout_s: float = 0.25
    suspect_after: int = 1
    degraded_after: int = 2
    dead_after: int = 3
    recover_after: int = 2
    integrity_interval_s: Optional[float] = None

    def __post_init__(self):
        if not (1 <= self.suspect_after <= self.degraded_after <= self.dead_after):
            raise ValueError("thresholds must satisfy 1 <= suspect_after <= degraded_after <= "
                             f"dead_after, got {self.suspect_after}/{self.degraded_after}/"
                             f"{self.dead_after}")
        if self.recover_after < 1:
            raise ValueError(f"recover_after must be >= 1, got {self.recover_after}")
        if self.integrity_interval_s is not None and self.integrity_interval_s <= 0:
            raise ValueError(f"integrity_interval_s must be > 0, got {self.integrity_interval_s}")


@dataclasses.dataclass
class _ProbeState:
    """One replica's watchdog view (host scalars only)."""

    state: str = "ok"
    fails: int = 0  # consecutive probe failures
    oks: int = 0    # consecutive successes while demoted
    next_probe: float = 0.0
    last_err: Optional[str] = None


def _replica_model(model, own: bool, kwargs):
    """The module a replica serves: ``model`` itself, or with ``own`` (the
    integrity vote) a copy of its own unless ``quantize=`` quantizes its
    weights (the engine's quantized model owns every weight tensor)."""
    quantize = kwargs.get("quantize")
    if not own or (quantize is not None and quantize.weight_qconfig() is not None):
        return model
    return copy.deepcopy(model)


class ReplicaRouter:
    """Host-side request router over N ``ServingEngine`` replicas (or
    ``DisaggregatedServer`` s, which speak the same surface)."""

    def __init__(self, replicas: List[ServingEngine], affinity: bool = True,
                 affinity_overcommit: float = 0.85, transport=None,
                 watchdog: Optional[WatchdogConfig] = None, registry=None,
                 time_fn: Optional[Callable[[], float]] = None):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        bases = [e._next_rid for e in replicas]
        if len(set(bases)) != len(bases):
            raise ValueError("replicas must mint request ids from disjoint rid_base ranges "
                             "(ServingEngine(rid_base=i * router.RID_STRIDE)) — re-homed requests "
                             "keep their rid on the survivor")
        self.replicas = list(replicas)
        self.watchdog = watchdog
        self._check_own_weights(self.replicas)
        self.affinity = affinity
        self.affinity_overcommit = float(affinity_overcommit)
        self._time_fn = time_fn
        self.transport = transport if transport is not None else InProcessTransport(
            time_fn=self._now)
        self._probe: List[_ProbeState] = [_ProbeState() for _ in self.replicas]
        self._dead: set = set()          # replicas drained and re-homed
        self._draining_out: set = set()  # remove_replica in progress
        self._factory: Optional[dict] = None  # build()'s recipe
        self._next_base = len(self.replicas)
        self.stats: Dict[str, int] = dict.fromkeys((
            "routed", "affinity_hits", "rehomed_requests", "replicas_drained", "spillovers",
            "probes", "probe_failures", "watchdog_deaths", "transport_failures",
            "replicas_joined", "replicas_removed", "replicas_restarted", "rebalanced_requests",
            "integrity_probes", "integrity_fences", "integrity_disagreements"), 0)
        self._next_integrity = 0.0
        self.routed_by_replica = [0] * len(replicas)
        self._view = self._g_probe = self._g_transport = None
        self._h_rehome = self._h_restart = None
        if registry is not None:
            from neuronx_distributed_tpu_torch.observability.registry import MetricsView

            self._view = MetricsView(registry)
            self._g_probe = self._view.family(
                "gauge", "router_probe_state",
                help="watchdog probe state per replica (0=ok 1=suspect 2=degraded 3=dead)")
            self._g_transport = self._view.family(
                "gauge", "router_transport_events",
                help="transport seam counters (messages/retries/drops/dups/timeouts/partitions/"
                     "dedup hits)")
            self._h_rehome = self._view.histogram(
                "router_rehome_latency_s", help="wall time to re-home one dead replica's queue")
            self._h_restart = self._view.histogram(
                "router_restart_latency_s",
                help="wall time of restart_replica (spawn + state restore)")
            for i in range(len(self.replicas)):
                self._view.child(self._g_probe, f"replica{i}").set(0)

    @property
    def _votes(self) -> bool:
        return self.watchdog is not None and self.watchdog.integrity_interval_s is not None

    def _check_own_weights(self, engines) -> None:
        """The integrity vote needs replicas that hold their own weights: a
        flip in storage two replicas share corrupts both, and a shared
        corruption outvotes the clean replica. Refused (``ValueError``) when
        the vote is on and two replicas' weights share storage."""
        if not self._votes:
            return
        seen: Dict[int, int] = {}
        for e in engines:
            model = e.model if hasattr(e, "model") else e.engine.model
            for ptr in weight_storages(model):
                if ptr in seen and seen[ptr] is not id(e):
                    raise ValueError(
                        "WatchdogConfig(integrity_interval_s=) needs replicas that hold their own "
                        "weights; these share weight storage (a router over one module): build "
                        "with ReplicaRouter.build(..., watchdog=WatchdogConfig("
                        "integrity_interval_s=...)), which copies the weights per replica")
                seen[ptr] = id(e)

    def _now(self) -> float:
        if self._time_fn is not None:
            return self._time_fn()
        return self.replicas[0]._clock()

    # --- construction -------------------------------------------------------

    @classmethod
    def build(cls, model, n_replicas: int, registry=None, engine_label: str = "replica",
              transport=None, watchdog: Optional[WatchdogConfig] = None,
              **engine_kwargs) -> "ReplicaRouter":
        """N identically configured replicas (JAX ``build``,
        ``router.py:263``, which takes a params tree; the port's engines
        carry their weights in the module), each minting from its own
        ``rid_base``; with ``registry`` one labeled registry
        (``{engine_label}{i}``). Without the integrity vote the replicas
        serve ONE module; with ``watchdog=WatchdogConfig(
        integrity_interval_s=)`` each float replica serves its own copy of
        ``model`` (a quantized one owns its tensors already), as JAX places
        the weights per replica. The router keeps the recipe and the clean
        source, so :meth:`add_replica` and :meth:`restart_replica` mint
        replicas from clean weights."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        own = watchdog is not None and watchdog.integrity_interval_s is not None
        replicas = []
        for i in range(n_replicas):
            kwargs = dict(engine_kwargs)
            if registry is not None:
                kwargs.setdefault("registry", registry)
                kwargs.setdefault("engine_label", f"{engine_label}{i}")
            replicas.append(ServingEngine(_replica_model(model, own, kwargs),
                                          rid_base=i * RID_STRIDE, **kwargs))
        router = cls(replicas, transport=transport, watchdog=watchdog, registry=registry)
        router._factory = {"model": model, "engine_kwargs": dict(engine_kwargs),
                           "registry": registry, "engine_label": engine_label, "own": own}
        return router

    def _spawn(self, **overrides) -> ServingEngine:
        """One more replica from the build() recipe, minting from the next
        disjoint rid range."""
        if self._factory is None:
            raise ValueError("this router was not built by ReplicaRouter.build() — pass an "
                             "engine to add_replica() instead")
        f = self._factory
        kwargs = dict(f["engine_kwargs"])
        kwargs.update(overrides)
        if f["registry"] is not None:
            kwargs.setdefault("registry", f["registry"])
            kwargs.setdefault("engine_label", f"{f['engine_label']}{self._next_base}")
        return ServingEngine(_replica_model(f["model"], f["own"], kwargs),
                             rid_base=self._next_base * RID_STRIDE, **kwargs)

    def add_replica(self, engine: Optional[ServingEngine] = None, cache_dir: Optional[str] = None,
                    manifest=None, adopt_backlog: bool = True, **overrides) -> int:
        """Join one replica LIVE (the others keep stepping): ``engine``, or
        one made from the build() recipe (``overrides`` update its kwargs).
        With ``adopt_backlog`` queued never-admitted requests move from the
        most loaded replicas onto it through the transport's adopt. Returns
        its index. ``cache_dir``/``manifest`` warm-spawn it (JAX
        ``router.py:319``): ``engine.prewarm(manifest=, cache_dir=)`` replays
        every program of a donor's manifest (``ServingEngine.manifest()``)
        before the replica takes work, so its first request captures and
        builds nothing. A prewarm whose replays failed (a manifest of
        another engine's programs) is refused with ``ValueError`` and the
        replica does not join; a CUDA or kernel error in it raises as it
        is."""
        if engine is None:
            engine = self._spawn(**overrides)
        elif engine._next_rid in {e._next_rid for e in self.replicas}:
            raise ValueError("joining replica must mint from a disjoint rid_base range (rid "
                             "collisions break re-homing)")
        self._check_own_weights([e for i, e in enumerate(self.replicas) if i not in self._dead]
                                + [engine])
        if cache_dir is not None or manifest is not None:
            self._warm(engine, cache_dir, manifest)
        idx = len(self.replicas)
        self.replicas.append(engine)
        self.routed_by_replica.append(0)
        self._probe.append(_ProbeState(next_probe=self._now()))
        self._next_base += 1
        self.stats["replicas_joined"] += 1
        if self._view is not None:
            self._view.child(self._g_probe, f"replica{idx}").set(0)
        if engine.flight is not None:
            engine.flight.record("join", replica=idx)
        if adopt_backlog:
            self._rebalance_into(idx)
        return idx

    def _rebalance_into(self, new_idx: int) -> int:
        """Move queued never-admitted requests from the most loaded
        accepting replicas onto a fresh one until the depths are within one
        of each other, tail first from each donor (older work keeps its
        place)."""
        moved = 0
        while True:
            new_depth = self.replicas[new_idx].scheduler.queued
            donors = [i for i in self._accepting()
                      if i != new_idx and self.replicas[i].scheduler.queued > new_depth + 1]
            if not donors:
                break
            donor = self.replicas[max(donors, key=lambda i: self.replicas[i].scheduler.queued)]
            req = next((r for r in reversed(donor.scheduler.queued_requests)
                        if r.admit_time is None), None)
            if req is None:
                break
            got, cb = donor.release_queued(req.rid)
            if got is None:
                break
            self.transport.call(new_idx, "adopt",
                                lambda r=got, c=cb: self.replicas[new_idx].adopt(r, on_token=c),
                                rid=got.rid)
            moved += 1
        self.stats["rebalanced_requests"] += moved
        return moved

    def remove_replica(self, idx: int, rehome_queued: bool = True) -> ServingEngine:
        """Drain one replica OUT live: it takes no new work (DRAINING), its
        never-admitted queue re-homes to the others (``rehome_queued``), its
        admitted work finishes, and ``step()`` retires it once idle.
        Returns the engine."""
        if idx in self._dead or not (0 <= idx < len(self.replicas)):
            raise ValueError(f"replica {idx} is not live")
        e = self.replicas[idx]
        e.drain()
        self._draining_out.add(idx)
        if rehome_queued:
            for req in list(e.scheduler.queued_requests):
                if req.admit_time is not None:
                    continue  # admitted work finishes here
                targets = [t for t in self._accepting() if t != idx]
                if not targets:
                    break
                target = min(targets,
                             key=lambda t: self.replicas[t].load_score(tenant=req.tenant))
                got, cb = e.release_queued(req.rid)
                if got is None:
                    continue
                self.transport.call(target, "adopt",
                                    lambda t=target, r=got, c=cb: self.replicas[t].adopt(
                                        r, on_token=c),
                                    rid=got.rid)
                self.stats["rehomed_requests"] += 1
        if e.flight is not None:
            e.flight.record("drain_out", replica=idx)
        return e

    @staticmethod
    def _warm(engine: ServingEngine, cache_dir: Optional[str], manifest) -> None:
        """Prewarm a joining replica; ``ValueError`` when a replay failed."""
        failed = engine.prewarm(manifest=manifest, cache_dir=cache_dir)["failed"]
        if failed:
            raise ValueError(f"warm spawn refused: {len(failed)} manifest program(s) failed to "
                             f"replay ({', '.join(sorted(failed))}): the replica would compile "
                             "them inside live requests")

    def restart_replica(self, idx: int, cache_dir: Optional[str] = None, manifest=None,
                        **overrides) -> int:
        """Warm-restart a fenced or halted replica (JAX ``restart_replica``,
        ``router.py:439``): snapshot its host-current serving state,
        SURRENDER its queue to the snapshot (so the re-home path can never
        admit twice what the restore now owns), make a replacement from the
        build() recipe and restore the state there; every request continues
        with its remaining deadline and its streaming callback. Returns the
        replacement's index. ``ValueError`` when the replica's work was
        re-homed already (use :meth:`add_replica`). ``cache_dir``/``manifest``
        prewarm the replacement as :meth:`add_replica` does, before the old
        replica is touched: a refused prewarm leaves it as it was."""
        if idx in self._dead:
            raise ValueError(f"replica {idx} was already re-homed — its work lives on the "
                             "survivors; use add_replica() for a fresh replacement")
        if not (0 <= idx < len(self.replicas)):
            raise ValueError(f"replica {idx} does not exist")
        t0 = time.perf_counter()
        fresh = self._spawn(**overrides)
        if cache_dir is not None or manifest is not None:
            self._warm(fresh, cache_dir, manifest)
        dead = self.replicas[idx]
        if dead.health() is not EngineHealth.HALTED:
            dead.fence("restart_replica")
        snap = dead.snapshot_serving_state()
        callbacks = {}
        for req in list(dead.scheduler.queued_requests):
            dead.scheduler.release(req.rid)
            cb = dead._on_token.pop(req.rid, None)
            if cb is not None:
                callbacks[req.rid] = cb
        self._dead.add(idx)
        self._draining_out.discard(idx)
        if self._view is not None:
            self._view.child(self._g_probe, f"replica{idx}").set(_PROBE_CODE["dead"])
        new_idx = self.add_replica(fresh, adopt_backlog=False)
        e = self.replicas[new_idx]
        report = self.transport.call(new_idx, "restore", lambda: e.restore_serving_state(snap))
        for rid, cb in callbacks.items():
            e._on_token[rid] = cb
        self.stats["replicas_restarted"] += 1
        if self._h_restart is not None:
            self._h_restart.observe(time.perf_counter() - t0)
        if e.flight is not None:
            e.flight.record("restart", replica=idx, replacement=new_idx,
                            restored=report["restored"])
        return new_idx

    # --- routing ------------------------------------------------------------

    def _live(self) -> List[int]:
        return [i for i in range(len(self.replicas)) if i not in self._dead]

    def _accepting(self) -> List[int]:
        """Replicas that may take NEW work: OK first (probe-SUSPECT still
        counts: the hysteresis keeps a flapper in the rotation), DEGRADED
        (by the engine or the watchdog) only when no OK one exists,
        DRAINING, HALTED and probe-DEAD never."""
        ok, degraded = [], []
        for i in self._live():
            ps = self._probe[i].state
            if ps == "dead":
                continue
            h = self.replicas[i].health()
            if h is EngineHealth.OK and ps in ("ok", "suspect"):
                ok.append(i)
            elif h is EngineHealth.DEGRADED or ps == "degraded":
                if h not in (EngineHealth.DRAINING, EngineHealth.HALTED):
                    degraded.append(i)
        return ok if ok else degraded

    def _pick(self, prompt: np.ndarray, tenant: Optional[str] = None) -> List[int]:
        """Replicas to try, best first: by load score (with the tenant's
        attainment bias), the affinity replica (the longest resident prefix
        on a replica below the overcommit bound) moved to the front."""
        candidates = self._accepting()
        if not candidates:
            raise RejectedError("no replica is accepting work (all draining/halted)",
                                queue_depth=sum(self.replicas[i].scheduler.queued
                                                for i in self._live()))
        order = sorted(candidates, key=lambda i: self.replicas[i].load_score(tenant=tenant))
        if self.affinity:
            best_i, best_m = None, 0
            for i in candidates:
                e = self.replicas[i]
                if e.prefix is None:
                    continue
                if e.page_pressure() >= self.affinity_overcommit:
                    continue  # the overcommit guard: balance instead
                m = e.prefix.match_len(prompt)
                if m > best_m:
                    best_i, best_m = i, m
            if best_i is not None:
                self.stats["affinity_hits"] += 1
                order = [best_i] + [i for i in order if i != best_i]
        return order

    def submit(self, prompt_ids, config: GenerationConfig = GenerationConfig(),
               seed: Optional[int] = None,
               on_token: Optional[Callable[[Request, int], None]] = None,
               deadline_s: Optional[float] = None, queue_timeout_s: Optional[float] = None,
               tenant: Optional[str] = None, priority: Optional[str] = None) -> Request:
        """Route one request (affinity, health, load), spilling to the next
        replica on a bounded-queue rejection or an unreachable replica (the
        transport gave up); :class:`RejectedError` only when every accepting
        replica refused. ``seed`` as ``ServingEngine.submit``'s (default: the
        rid the chosen replica mints, so pass one to reproduce a stream
        whichever replica serves it)."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        last_reject: Optional[RejectedError] = None
        for rank, i in enumerate(self._pick(prompt, tenant=tenant)):
            try:
                req = self.transport.call(
                    i, "submit",
                    lambda e=self.replicas[i]: e.submit(
                        prompt, config, seed=seed, deadline_s=deadline_s,
                        queue_timeout_s=queue_timeout_s, tenant=tenant, priority=priority,
                        on_token=on_token))
            except RejectedError as e:
                last_reject = e
                if rank == 0:
                    self.stats["spillovers"] += 1
                continue
            except TransportError as e:
                self.stats["transport_failures"] += 1
                last_reject = RejectedError(f"replica {i} unreachable: {e}",
                                            queue_depth=self.replicas[i].scheduler.queued)
                if rank == 0:
                    self.stats["spillovers"] += 1
                continue
            self.stats["routed"] += 1
            self.routed_by_replica[i] += 1
            return req
        raise last_reject

    # --- the watchdog -------------------------------------------------------

    def _probe_transition(self, i: int, ps: _ProbeState, new: str, why: Optional[str]) -> None:
        was, ps.state = ps.state, new
        if self._view is not None:
            self._view.child(self._g_probe, f"replica{i}").set(_PROBE_CODE[new])
        flight = self.replicas[i].flight
        if flight is not None:
            flight.record("probe_state", replica=i, was=was, now=new, fails=ps.fails, why=why)

    def _run_watchdog(self, now: float) -> None:
        cfg = self.watchdog
        for i in self._live():
            ps = self._probe[i]
            if ps.state == "dead" or now < ps.next_probe:
                continue
            ps.next_probe = now + cfg.probe_interval_s
            self.stats["probes"] += 1
            err = None
            try:
                h = self.transport.probe(i, lambda e=self.replicas[i]: e.health().value,
                                         deadline_s=cfg.probe_timeout_s)
                if h == "halted":
                    err = "replica reports halted"
            except TransportError as e:
                err = f"{type(e).__name__}: {e}"
            if err is None:
                self._probe_success(i, ps)
            else:
                self._probe_failure(i, ps, err)

    def _probe_success(self, i: int, ps: _ProbeState) -> None:
        ps.fails = 0
        ps.last_err = None
        if ps.state == "ok":
            ps.oks = 0
            return
        ps.oks += 1
        if ps.oks >= self.watchdog.recover_after:
            # recovery is earned one level at a time, the streak reset
            ps.oks = 0
            self._probe_transition(i, ps, _PROBE_ORDER[_PROBE_CODE[ps.state] - 1], "recovered")

    def _probe_failure(self, i: int, ps: _ProbeState, err: str) -> None:
        ps.fails += 1
        ps.oks = 0
        ps.last_err = err
        self.stats["probe_failures"] += 1
        cfg = self.watchdog
        if ps.fails >= cfg.dead_after:
            new = "dead"
        elif ps.fails >= cfg.degraded_after:
            new = "degraded"
        elif ps.fails >= cfg.suspect_after:
            new = "suspect"
        else:
            new = ps.state
        if _PROBE_CODE[new] > _PROBE_CODE[ps.state]:  # a failure only demotes
            self._probe_transition(i, ps, new, err)
            if new == "dead":
                self._declare_dead(i, err)

    def _declare_dead(self, idx: int, err: str) -> None:
        """A probe death: fence the replica (a partitioned but live engine
        must stop before its work runs elsewhere, or two engines would
        stream one rid), then re-home its queue."""
        self.stats["watchdog_deaths"] += 1
        self.replicas[idx].fence(
            f"watchdog: {self._probe[idx].fails} consecutive probe failures ({err})")
        self._rehome(idx)

    def _run_integrity(self, now: float) -> None:
        """The periodic cross-replica weight fingerprint vote (JAX
        ``_run_integrity``, ``router.py:705``): on the watchdog's clock,
        through the transport, one probe a routable replica. An unreachable
        replica is the liveness ladder's evidence, not corruption's: the
        vote runs over the replicas that answered. A strict minority is
        convicted (:meth:`_declare_corrupt`); no strict majority is
        recorded as a disagreement and fences nobody (fencing an innocent
        replica would be worse)."""
        cfg = self.watchdog
        if cfg.integrity_interval_s is None or now < self._next_integrity:
            return
        self._next_integrity = now + cfg.integrity_interval_s
        values: Dict[int, int] = {}
        for i in self._live():
            if self._probe[i].state == "dead":
                continue
            self.stats["integrity_probes"] += 1
            try:
                values[i] = int(self.transport.probe(
                    i, lambda e=self.replicas[i]: e.integrity_fingerprint(),
                    deadline_s=cfg.probe_timeout_s))
            except TransportError:
                continue
        verdict = vote(values)
        if verdict.clean:
            return
        if not verdict.localized:
            self.stats["integrity_disagreements"] += 1
            for i, v in verdict.values.items():
                flight = self.replicas[i].flight
                if flight is not None:
                    flight.record("integrity_disagreement", replica=i, fingerprint=v,
                                  voters=len(verdict.values))
            return
        for i in verdict.convicted:
            self._declare_corrupt(
                i, f"params fingerprint {values[i]:#010x} vs quorum {verdict.quorum_value:#010x} "
                   f"({len(values) - 1} of {len(values)} replicas agree)")

    def _declare_corrupt(self, idx: int, why: str) -> None:
        """An integrity conviction (JAX ``_declare_corrupt``): straight to
        DEAD (corrupted weights do not flap, and every chunk served
        meanwhile is wrong), fenced, and re-homed like a probe death."""
        self.stats["integrity_fences"] += 1
        flight = self.replicas[idx].flight
        if flight is not None:
            flight.record("integrity_conviction", replica=idx, why=why)
        self._probe_transition(idx, self._probe[idx], "dead", why)
        self.replicas[idx].fence(f"integrity: {why}")
        self._rehome(idx)

    # --- stepping and re-homing ---------------------------------------------

    def _rehome(self, dead_idx: int) -> int:
        """Move a HALTED replica's queued work (its requeued in-flight
        requests included, with host-current tokens and seeds) to the
        survivors through the transport's adopt, so a duplicated or retried
        move admits once; a request whose adopt cannot be delivered stays on
        the dead replica, its callback restored. Returns how many moved."""
        dead = self.replicas[dead_idx]
        t0 = time.perf_counter()
        moved = 0
        for req in list(dead.scheduler.queued_requests):
            targets = [t for t in self._accepting() if t != dead_idx]
            if not targets:
                break
            target = min(targets, key=lambda i: self.replicas[i].load_score(tenant=req.tenant))
            cb = dead._on_token.pop(req.rid, None)
            try:
                self.transport.call(target, "adopt",
                                    lambda t=target, r=req, c=cb: self.replicas[t].adopt(
                                        r, on_token=c),
                                    rid=req.rid)
            except TransportError:
                self.stats["transport_failures"] += 1
                if cb is not None:
                    dead._on_token[req.rid] = cb
                continue
            moved += 1
        self._dead.add(dead_idx)
        self._draining_out.discard(dead_idx)
        self.stats["replicas_drained"] += 1
        self.stats["rehomed_requests"] += moved
        if self._h_rehome is not None:
            self._h_rehome.observe(time.perf_counter() - t0)
        if dead.flight is not None:
            dead.flight.record("rehome", replica=dead_idx, moved=moved)
        return moved

    def step(self) -> bool:
        """One iteration: the watchdog (a probe death fences and re-homes at
        once), the re-home of any newly halted replica, one step of every
        live replica with work, and the retirement of replicas that have
        drained out. Returns whether work remains."""
        if self.watchdog is not None:
            now = self._now()
            self._run_watchdog(now)
            self._run_integrity(now)
        for i in self._live():
            if self.replicas[i].health() is EngineHealth.HALTED:
                self._rehome(i)
        for i in self._live():
            e = self.replicas[i]
            if e.has_work:
                e.step()
        for i in list(self._draining_out):
            if i not in self._dead and not self.replicas[i].has_work:
                self._dead.add(i)
                self._draining_out.discard(i)
                self.stats["replicas_removed"] += 1
                if self.replicas[i].flight is not None:
                    self.replicas[i].flight.record("drained_out", replica=i)
        if self._view is not None:
            for k, v in self.transport.stats.items():
                self._view.child(self._g_transport, k).set(v)
        return self.has_work

    def run(self, max_steps: int = 1_000_000) -> Dict[int, Request]:
        """Step until no replica has work (or ``max_steps``); returns every
        request any replica has seen, by rid."""
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        return self.requests

    # --- introspection ------------------------------------------------------

    @property
    def has_work(self) -> bool:
        for i in self._live():
            e = self.replicas[i]
            if e.has_work:
                return True
            # a halted replica makes no progress, but its requeued work is
            # the router's to move: keep stepping until the re-home
            if e.health() is EngineHealth.HALTED and e.scheduler.queued > 0:
                return True
        return False

    @property
    def requests(self) -> Dict[int, Request]:
        out: Dict[int, Request] = {}
        for e in self.replicas:
            out.update(e.scheduler.requests)
        return out

    def health(self) -> Dict[str, str]:
        """Each replica's health and the aggregate: ``ok`` while any replica
        accepts work, ``degraded`` when only DEGRADED ones do, ``halted``
        when none does."""
        per = {f"replica{i}": e.health().value for i, e in enumerate(self.replicas)}
        accepting = self._accepting() if self._live() else []
        if not accepting:
            agg = "halted"
        elif all(self.replicas[i].health() is EngineHealth.DEGRADED for i in accepting):
            agg = "degraded"
        else:
            agg = "ok"
        return {"aggregate": agg, **per}

    def probe_states(self) -> Dict[str, str]:
        """The watchdog's verdict per replica (``ok`` without a watchdog)."""
        return {f"replica{i}": self._probe[i].state for i in range(len(self.replicas))}

    def snapshot(self) -> dict:
        """The router's bookkeeping and each replica's metrics snapshot."""
        return {
            "router": {**self.stats, "routed_by_replica": list(self.routed_by_replica),
                       "health": self.health(), "probe_states": self.probe_states(),
                       "transport": self.transport.snapshot()},
            "replicas": {f"replica{i}": e.metrics.snapshot()
                         for i, e in enumerate(self.replicas)},
        }
