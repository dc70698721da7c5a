"""Deterministic open-loop traffic generation and replay (counterpart of
``neuronx_distributed_tpu/serving/traffic.py``).

Serving is judged under bursty, multi-tenant, open-loop load (arrivals do
not wait for completions), not by steady-state tokens a second. A SEEDED
generator materializes the whole arrival schedule (the "tape") up front,
and :func:`replay` drives a ``ServingEngine`` through it on a virtual
clock, so

* the same seed gives a byte-identical tape (:func:`tape_bytes`, equal to
  the JAX package's for the same arguments), and
* the same tape through the same engine configuration gives an identical
  SLO report: the engine's scheduling is deterministic and the virtual
  clock removes wall-time noise.

Every draw comes from a per-tenant ``random.Random`` seeded from (tape
seed, the tenant name's CRC): no process-global RNG, no wall clock, no
dict-order dependence. Arrival processes: ``poisson`` (exponential gaps at
``rate_rps``) and ``bursty`` (the rate alternates between ``rate_rps`` and
``rate_rps * burst_factor`` on a ``burst_period_s`` cycle, ``burst_duty``
of it at peak, sampled by thinning). Workload shapes: ``chat`` (short
prompt, short generation) and ``longdoc`` (long prompt, longer
generation). An arrival's ``key_seed`` is the request's sampling seed
(``submit(seed=)``). Nothing here reads a device value.
"""

from __future__ import annotations

import dataclasses
import json
import random
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig

__all__ = [
    "Arrival",
    "TenantProfile",
    "VirtualClock",
    "generate_tape",
    "tape_bytes",
    "replay",
    "build_report",
]

# (prompt_lo, prompt_hi, new_lo, new_hi) — inclusive token-count ranges
_WORKLOADS: Dict[str, Tuple[int, int, int, int]] = {
    "chat": (4, 16, 8, 20),
    "longdoc": (24, 48, 16, 32),
}


@dataclasses.dataclass(frozen=True)
class TenantProfile:
    """One tenant's traffic shape. ``rate_rps`` is the OFF-PEAK rate for
    ``bursty`` arrivals (peak = ``rate_rps * burst_factor``)."""

    name: str
    rate_rps: float = 1.0
    arrival: str = "poisson"  # "poisson" | "bursty"
    burst_factor: float = 4.0
    burst_period_s: float = 8.0
    burst_duty: float = 0.25
    workload: str = "chat"  # "chat" | "longdoc"
    priority: str = "standard"
    temperature: float = 0.0
    deadline_s: Optional[float] = None
    queue_timeout_s: Optional[float] = None

    def __post_init__(self):
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.arrival not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")
        if self.workload not in _WORKLOADS:
            raise ValueError(
                f"unknown workload {self.workload!r} "
                f"(have {sorted(_WORKLOADS)})"
            )
        if self.arrival == "bursty":
            if self.burst_factor < 1.0:
                raise ValueError("burst_factor must be >= 1")
            if not 0.0 < self.burst_duty < 1.0:
                raise ValueError("burst_duty must be in (0, 1)")
            if self.burst_period_s <= 0:
                raise ValueError("burst_period_s must be > 0")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One tape entry: everything ``replay`` needs to submit the request
    (prompt ids inline — the tape fully determines the workload)."""

    t: float
    tenant: str
    priority: str
    prompt: Tuple[int, ...]
    max_new_tokens: int
    temperature: float
    key_seed: int
    deadline_s: Optional[float] = None
    queue_timeout_s: Optional[float] = None


def _tenant_seed(seed: int, name: str) -> int:
    """Stable per-tenant stream seed: NEVER ``hash()`` (salted per
    process — it would silently break cross-run byte-identity)."""
    return (int(seed) * 1_000_003 + zlib.crc32(name.encode("utf-8"))) \
        & 0x7FFFFFFF


def _burst_rate(tp: TenantProfile, t: float) -> float:
    """Instantaneous rate of the bursty (square-wave diurnal) process."""
    phase = (t % tp.burst_period_s) / tp.burst_period_s
    if phase < tp.burst_duty:
        return tp.rate_rps * tp.burst_factor
    return tp.rate_rps


def generate_tape(
    tenants: Sequence[TenantProfile],
    duration_s: float,
    seed: int = 0,
    vocab_size: int = 32000,
) -> List[Arrival]:
    """Materialize the full arrival schedule for ``duration_s`` virtual
    seconds. Same (tenants, duration, seed, vocab) ⇒ byte-identical tape
    (:func:`tape_bytes`); per-tenant streams are independent, so adding a
    tenant never perturbs another's arrivals."""
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    if len({tp.name for tp in tenants}) != len(tuple(tenants)):
        raise ValueError("tenant names must be unique")
    arrivals: List[Arrival] = []
    for tp in tenants:
        rng = random.Random(_tenant_seed(seed, tp.name))
        p_lo, p_hi, n_lo, n_hi = _WORKLOADS[tp.workload]
        peak = (
            tp.rate_rps * tp.burst_factor if tp.arrival == "bursty"
            else tp.rate_rps
        )
        t = 0.0
        while True:
            # draw at the peak rate, then thin to the instantaneous rate —
            # the standard inhomogeneous-Poisson construction (exact, and
            # one uniform per candidate keeps the stream deterministic)
            t += rng.expovariate(peak)
            if t >= duration_s:
                break
            if tp.arrival == "bursty" and (
                rng.random() > _burst_rate(tp, t) / peak
            ):
                continue
            plen = rng.randint(p_lo, p_hi)
            prompt = tuple(
                rng.randint(1, vocab_size - 1) for _ in range(plen)
            )
            arrivals.append(
                Arrival(
                    t=t,
                    tenant=tp.name,
                    priority=tp.priority,
                    prompt=prompt,
                    max_new_tokens=rng.randint(n_lo, n_hi),
                    temperature=tp.temperature,
                    key_seed=rng.getrandbits(31),
                    deadline_s=tp.deadline_s,
                    queue_timeout_s=tp.queue_timeout_s,
                )
            )
    # merge the per-tenant streams; the (tenant, key_seed) tie-break makes
    # the order total and deterministic even for (improbable) equal times
    arrivals.sort(key=lambda a: (a.t, a.tenant, a.key_seed))
    return arrivals


def tape_bytes(tape: Sequence[Arrival]) -> bytes:
    """Canonical byte serialization of a tape — the determinism pin
    (``repr`` of Python floats is shortest-round-trip, so equal floats
    serialize equally and unequal ones never collide)."""
    return json.dumps(
        [dataclasses.asdict(a) for a in tape],
        sort_keys=True, separators=(",", ":"),
    ).encode("utf-8")


class VirtualClock:
    """Injectable engine clock (``ServingEngine(time_fn=clock)``) owned by
    the replay loop: virtual time advances a fixed amount per engine step
    and jumps across idle gaps, so every latency the metrics layer
    measures is a deterministic function of the schedule — wall-clock
    noise (and therefore run-to-run drift) cannot exist."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt

    def advance_to(self, t: float) -> None:
        if t > self.now:
            self.now = t


def replay(
    engine,
    tape: Sequence[Arrival],
    clock: VirtualClock,
    step_dt: float = 0.01,
    max_steps: int = 200_000,
) -> dict:
    """Drive ``engine`` (built with ``time_fn=clock``) through ``tape``
    open-loop: every arrival is submitted at its scheduled virtual time
    whatever the engine's state (a full queue REJECTS, a permanently-
    unplaceable request fails at the door — both are attributed signal,
    not replay errors), each ``engine.step()`` costs ``step_dt`` virtual
    seconds, and idle gaps fast-forward. Returns :func:`build_report`'s
    SLO report plus replay bookkeeping."""
    if step_dt <= 0:
        raise ValueError(f"step_dt must be > 0, got {step_dt}")
    clk = getattr(engine, "_clock", None)
    if clk is not clock:
        raise ValueError(
            "engine must be constructed with time_fn=<this VirtualClock> "
            "— replaying against a wall-clock engine would measure noise"
        )
    from neuronx_distributed_tpu_torch.serving.engine import RejectedError

    submitted = 0
    rejected = 0
    unplaceable = 0
    steps = 0
    i = 0
    while i < len(tape) or engine.has_work:
        while i < len(tape) and tape[i].t <= clock.now:
            a = tape[i]
            i += 1
            cfg = GenerationConfig(
                max_new_tokens=a.max_new_tokens,
                temperature=a.temperature,
                eos_token_id=None,
            )
            try:
                engine.submit(
                    np.asarray(a.prompt, np.int32), cfg,
                    seed=a.key_seed,
                    tenant=a.tenant, priority=a.priority,
                    deadline_s=a.deadline_s,
                    queue_timeout_s=a.queue_timeout_s,
                )
                submitted += 1
            except RejectedError:
                rejected += 1  # attributed in metrics/SLO by the engine
            except ValueError as e:
                # a PERMANENTLY-unplaceable arrival (seq-len class, token
                # budget, page footprint vs an undersized engine): the
                # engine fails it at the door BEFORE any metrics record.
                # One impossible request must not cost the whole replay
                # its report — attribute it as a reject (it is one, with
                # a reason) and keep going; the count below is the signal
                # that the engine is undersized for the tape
                unplaceable += 1
                engine.metrics.record_reject(
                    engine.scheduler.queued, f"unplaceable: {e}",
                    tenant=a.tenant, now=clock.now,
                )
        if not engine.has_work:
            if i < len(tape):
                clock.advance_to(tape[i].t)
                continue
            break
        if steps >= max_steps:
            break
        engine.step()
        steps += 1
        clock.advance(step_dt)
    report = build_report(engine)
    report["replay"] = {
        "arrivals": len(tape),
        "submitted": submitted,
        "rejected": rejected,
        "unplaceable": unplaceable,
        "steps": steps,
        "step_dt_s": step_dt,
        "virtual_end_s": clock.now,
        "truncated": steps >= max_steps,
    }
    return report


def build_report(engine) -> dict:
    """The SLO report: per-tenant p50/p99 TTFT & TPOT, goodput,
    attainment, and shed/timeout/reject attribution — tenant-sorted, so
    two identical runs serialize to identical JSON."""
    snap = engine.metrics.snapshot()
    slo = snap.get("slo")
    tenants = {}
    for tenant, row in snap.get("tenants", {}).items():
        entry = {
            "submitted": row["submitted"],
            "completed": row["completed"],
            "tokens": row["decode_tokens"],
            "sheds": row["sheds"],
            "timed_out": row["timed_out"],
            "rejects": row["rejects"],
            "failed": row["failed"],
            "ttft_p50_s": row["ttft_p50_s"],
            "ttft_p99_s": row["ttft_p99_s"],
            "tpot_p50_s": row["tpot_p50_s"],
            "tpot_p99_s": row["tpot_p99_s"],
            "queue_wait_p95_s": row["queue_wait_p95_s"],
        }
        if slo is not None:
            t_slo = slo["per_tenant"].get(tenant)
            if t_slo is not None:
                entry.update(
                    attained=t_slo["attained"],
                    violated=t_slo["violated"],
                    attainment=t_slo["attainment"],
                    goodput_tok_s=t_slo["goodput_tok_s"],
                )
        tenants[tenant] = entry
    report = {
        "tenants": tenants,
        "completed": snap["completed"],
        "sheds": snap["sheds"],
        "timed_out": snap["timed_out"],
        "rejects": snap["rejects"],
        "decode_tokens": snap["decode_tokens"],
        "preemptions": snap["preemptions"],
        "health": snap["health"],
    }
    if slo is not None:
        report["slo"] = {
            "attained": slo["attained"],
            "violated": slo["violated"],
            "attainment": slo["attainment"],
            "goodput_tok_s": slo["goodput_tok_s"],
            "span_s": slo["span_s"],
            "violation_reasons": slo["violation_reasons"],
        }
    return report
