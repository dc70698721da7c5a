"""SLO accounting: per-tenant attainment and goodput (counterpart of
``neuronx_distributed_tpu/observability/slo.py``).

* **Attainment.** A finished request ATTAINS its tenant's :class:`SLOSpec`
  when its TTFT and its mean TPOT are both within the spec's bounds; every
  terminal fault (shed, time-out, reject, failure) is a VIOLATION. The
  per-tenant counts and the attainment rate are what the SLO scheduling
  policy reads back (``serving/sched/feedback.py``).
* **Goodput.** Tokens delivered by attaining requests per second of the
  observed span: tokens a request streamed before it blew its deadline were
  wasted work, so shedding latency-sensitive traffic cannot raise it.

A request is classified exactly ONCE, at its terminal state: a request
requeued by preemption, recovery or quarantine and then finished is one
observation. Every argument is a host scalar the engine already owns, so
tracking adds no device read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry, MetricsView

__all__ = ["SLOSpec", "SLOTracker"]


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-request latency bounds for one tenant: ``ttft_p99_s`` bounds
    submit to first token, ``tpot_p99_s`` the mean time per output token
    after the first; ``None`` leaves a dimension unbounded. The ``p99``
    names the availability target the bound is held at: each request is
    classified against the raw bound, and "p99 attained" means an
    attainment rate of at least 0.99."""

    ttft_p99_s: Optional[float] = None
    tpot_p99_s: Optional[float] = None

    def __post_init__(self):
        for field in ("ttft_p99_s", "tpot_p99_s"):
            v = getattr(self, field)
            if v is not None and v <= 0:
                raise ValueError(f"{field} must be > 0, got {v}")

    def attains(self, ttft_s: Optional[float], tpot_s: Optional[float]) -> bool:
        """Whether one request's latencies meet the spec. A ``None`` TTFT
        (no first token) fails a TTFT bound; a ``None`` TPOT (a one-token
        request) passes a TPOT bound."""
        if self.ttft_p99_s is not None and (ttft_s is None or ttft_s > self.ttft_p99_s):
            return False
        if self.tpot_p99_s is not None and tpot_s is not None and tpot_s > self.tpot_p99_s:
            return False
        return True


class _TenantSLO:
    """One tenant's running attainment state (host numbers only)."""

    __slots__ = ("attained", "violated", "attained_tokens", "total_tokens",
                 "violation_reasons")

    def __init__(self):
        self.attained = 0
        self.violated = 0
        self.attained_tokens = 0
        self.total_tokens = 0
        self.violation_reasons: Dict[str, int] = {}


class SLOTracker:
    """Attainment and goodput over per-tenant :class:`SLOSpec` s.

    ``specs`` maps a tenant to its spec; ``default`` (or a bare ``SLOSpec``
    passed as ``specs``) covers tenants without one. A tenant with no
    applicable spec is observed but never classified. With a ``registry``
    (or a label-scoped ``view``), per-tenant ``<prefix>_attained_requests``,
    ``_violated_requests``, ``_attained_tokens`` counters and an
    ``_attainment`` gauge export as labelled families."""

    def __init__(self, specs=None, default: Optional[SLOSpec] = None,
                 registry: Optional[MetricsRegistry] = None, prefix: str = "slo",
                 view: Optional[MetricsView] = None):
        if isinstance(specs, SLOSpec):
            if default is not None:
                raise ValueError("pass either a bare SLOSpec (the default for every tenant) or "
                                 "a dict + default=, not both")
            specs, default = {}, specs
        self.specs: Dict[str, SLOSpec] = dict(specs or {})
        for tenant, spec in self.specs.items():
            if not isinstance(spec, SLOSpec):
                raise TypeError(f"specs[{tenant!r}] must be an SLOSpec, got "
                                f"{type(spec).__name__}")
        self.default = default
        self._tenants: Dict[str, _TenantSLO] = {}
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._view: Optional[MetricsView] = None
        self._c_attained = self._c_violated = self._c_tokens = self._g_rate = None
        if view is not None and registry is None:
            registry = view.registry
        if registry is not None:
            self._view = view if view is not None else MetricsView(registry)
            fam = self._view.family
            self._c_attained = fam("counter", f"{prefix}_attained_requests",
                                   help="requests that finished within their tenant's SLOSpec")
            self._c_violated = fam("counter", f"{prefix}_violated_requests",
                                   help="requests that missed their SLOSpec (incl. sheds, "
                                        "timeouts, rejects, failures)")
            self._c_tokens = fam("counter", f"{prefix}_attained_tokens",
                                 help="tokens delivered by SLO-attaining requests "
                                      "(the goodput numerator)")
            self._g_rate = fam("gauge", f"{prefix}_attainment",
                               help="attained / (attained + violated) per tenant")

    # --- classification -----------------------------------------------------

    def spec_for(self, tenant: str) -> Optional[SLOSpec]:
        return self.specs.get(tenant, self.default)

    def _state(self, tenant: str) -> _TenantSLO:
        s = self._tenants.get(tenant)
        if s is None:
            s = self._tenants[tenant] = _TenantSLO()
        return s

    def touch(self, now: Optional[float]) -> None:
        """Extend the observed span (goodput's denominator); the engine
        calls it at submit, so the span covers the whole run. ``None`` (an
        event with no engine-clock time) leaves it alone."""
        if now is None:
            return
        if self._t_first is None or now < self._t_first:
            self._t_first = now
        if self._t_last is None or now > self._t_last:
            self._t_last = now

    def _export(self, tenant: str, state: _TenantSLO, tokens_attained: int, violations: int,
                attainments: int) -> None:
        if self._view is None:
            return
        if attainments:
            self._view.child(self._c_attained, tenant).inc(attainments)
        if violations:
            self._view.child(self._c_violated, tenant).inc(violations)
        if tokens_attained:
            self._view.child(self._c_tokens, tenant).inc(tokens_attained)
        total = state.attained + state.violated
        self._view.child(self._g_rate, tenant).set(state.attained / total if total else 1.0)

    def record_finish(self, tenant: str, ttft_s: Optional[float], tpot_s: Optional[float],
                      tokens: int, now: float) -> bool:
        """Classify one FINISHED request (once, at DONE). Returns whether it
        attained (an untracked tenant returns True and counts nowhere)."""
        self.touch(now)
        spec = self.spec_for(tenant)
        if spec is None:
            return True
        state = self._state(tenant)
        state.total_tokens += int(tokens)
        if spec.attains(ttft_s, tpot_s):
            state.attained += 1
            state.attained_tokens += int(tokens)
            self._export(tenant, state, int(tokens), 0, 1)
            return True
        state.violated += 1
        state.violation_reasons["latency"] = state.violation_reasons.get("latency", 0) + 1
        self._export(tenant, state, 0, 1, 0)
        return False

    def record_violation(self, tenant: str, now: Optional[float], reason: str = "shed",
                         tokens: int = 0) -> None:
        """Classify one request that ended WITHOUT finishing (shed,
        time-out, reject, failure); tokens it streamed count as total
        (wasted) work, never as goodput."""
        self.touch(now)
        if self.spec_for(tenant) is None:
            return
        state = self._state(tenant)
        state.violated += 1
        state.total_tokens += int(tokens)
        state.violation_reasons[reason] = state.violation_reasons.get(reason, 0) + 1
        self._export(tenant, state, 0, 1, 0)

    # --- the scheduling policy's reads --------------------------------------

    def decided(self, tenant: str) -> int:
        """How many of ``tenant``'s requests were classified."""
        s = self._tenants.get(tenant)
        return (s.attained + s.violated) if s is not None else 0

    def attainment(self, tenant: str) -> float:
        """``tenant``'s running attainment; 1.0 before any classification."""
        s = self._tenants.get(tenant)
        if s is None:
            return 1.0
        total = s.attained + s.violated
        return s.attained / total if total else 1.0

    # --- export -------------------------------------------------------------

    @property
    def span_s(self) -> float:
        """Observed span in seconds (first submit to last terminal event)."""
        if self._t_first is None or self._t_last is None:
            return 0.0
        return self._t_last - self._t_first

    def goodput_tok_s(self, tenant: Optional[str] = None) -> float:
        """Tokens of attaining requests per second of span (one tenant, or
        everyone)."""
        span = self.span_s
        if span <= 0:
            return 0.0
        if tenant is not None:
            state = self._tenants.get(tenant)
            return state.attained_tokens / span if state else 0.0
        return sum(s.attained_tokens for s in self._tenants.values()) / span

    def per_tenant(self) -> Dict[str, dict]:
        """Per-tenant scalars, tenant-sorted."""
        out = {}
        for tenant in sorted(self._tenants):
            s = self._tenants[tenant]
            total = s.attained + s.violated
            out[tenant] = {
                "attained": s.attained,
                "violated": s.violated,
                "attainment": s.attained / total if total else 1.0,
                "attained_tokens": s.attained_tokens,
                "total_tokens": s.total_tokens,
                "goodput_tok_s": self.goodput_tok_s(tenant),
            }
        return out

    def totals(self) -> dict:
        attained = sum(s.attained for s in self._tenants.values())
        violated = sum(s.violated for s in self._tenants.values())
        total = attained + violated
        return {
            "attained": attained,
            "violated": violated,
            "attainment": attained / total if total else 1.0,
            "attained_tokens": sum(s.attained_tokens for s in self._tenants.values()),
            "total_tokens": sum(s.total_tokens for s in self._tenants.values()),
            "goodput_tok_s": self.goodput_tok_s(),
            "span_s": self.span_s,
        }

    def violation_reasons(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant violations by reason (latency, shed_queue, reject,
        failed_prefill, ...)."""
        return {t: dict(sorted(self._tenants[t].violation_reasons.items()))
                for t in sorted(self._tenants) if self._tenants[t].violation_reasons}

    def snapshot(self) -> dict:
        """Totals, the per-tenant breakdown and the reasons."""
        return {**self.totals(), "per_tenant": self.per_tenant(),
                "violation_reasons": self.violation_reasons()}

    # --- carried state ------------------------------------------------------

    def state(self) -> dict:
        """The running counters, JSON-safe (the specs are configuration and
        are not carried): who attained, who was violated and why, and the
        observed span."""
        return {
            "t_first": self._t_first,
            "t_last": self._t_last,
            "tenants": {
                t: {
                    "attained": s.attained,
                    "violated": s.violated,
                    "attained_tokens": s.attained_tokens,
                    "total_tokens": s.total_tokens,
                    "violation_reasons": dict(sorted(s.violation_reasons.items())),
                }
                for t, s in sorted(self._tenants.items())
            },
        }

    def restore_state(self, state: dict, shift_s: float = 0.0) -> None:
        """Merge a :meth:`state` into this tracker (additive); ``shift_s``
        moves its span onto this tracker's clock. Registry-backed counters
        re-export the merged counts."""
        for key in ("t_first", "t_last"):
            v = state.get(key)
            if v is not None:
                self.touch(v + shift_s)
        for tenant, d in (state.get("tenants") or {}).items():
            s = self._state(tenant)
            attained = int(d.get("attained", 0))
            violated = int(d.get("violated", 0))
            attained_tokens = int(d.get("attained_tokens", 0))
            s.attained += attained
            s.violated += violated
            s.attained_tokens += attained_tokens
            s.total_tokens += int(d.get("total_tokens", 0))
            for reason, n in (d.get("violation_reasons") or {}).items():
                s.violation_reasons[reason] = s.violation_reasons.get(reason, 0) + int(n)
            self._export(tenant, s, attained_tokens, violated, attained)
