"""Metrics registry: counter, gauge and log-bucketed histogram primitives
(counterpart of ``neuronx_distributed_tpu/observability/registry.py``).

The serving engine's :class:`~neuronx_distributed_tpu_torch.serving.metrics.
ServingMetrics` is backed by one, and so is the speculative acceptance
recorder, so latency percentiles, SLO attainment and acceptance read off a
single surface: ``snapshot()``/``snapshot_json()`` for tests and
dashboards, ``prometheus_text()`` for a scrape endpoint. Both exports equal
the JAX registry's for the same observations, byte for byte.

* **No device read on any record path.** ``Counter.inc`` and
  ``Histogram.observe`` take host scalars the caller already owns;
  ``Gauge.set`` stores its value raw and coerces it at export, so a gauge
  may hold a device scalar without the hot loop ever waiting on the card.
* **Fixed memory over unbounded streams.** Histograms are log-bucketed,
  ``bucket(v) = floor(log(v) / log(growth))``, stored sparsely; a quantile
  is the upper edge of the bucket holding its sample (never above the
  exact maximum), so it overestimates the true value by at most
  ``growth`` (5% at the default). Count, sum, min and max are exact.

Labelled families: ``registry.counter("ttft_s", labels=("tenant",))``
returns a :class:`MetricFamily`, whose ``labels("acme")`` child is a plain
Counter/Gauge/Histogram. Families export label-aware snapshot entries and
labelled Prometheus series, label values escaped as the text format asks
(backslash, double quote, newline), so a hostile tenant string cannot break
the scrape.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricFamily",
    "MetricsRegistry",
    "MetricsView",
    "DEFAULT_GROWTH",
    "escape_label_value",
]

# relative bucket width of histograms: percentile error <= 5%
DEFAULT_GROWTH = 1.05


def _sanitize(name: str) -> str:
    """Prometheus metric-name charset: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    s = "".join(ch if ch.isalnum() or ch in "_:" else "_" for ch in name)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double quote
    and newline are the three characters the format reserves; everything
    else (any unicode) passes through raw."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _braced(labels: str) -> str:
    """``{tenant="acme"}``, or ``""`` for the unlabelled series."""
    return f"{{{labels}}}" if labels else ""


def _fmt(v) -> str:
    """Prometheus float formatting: integers stay integral."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotone accumulator (int or float increments)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0

    def inc(self, n=1) -> None:
        self._value += n

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value

    def prometheus_samples(self, labels: str = "") -> List[str]:
        return [f"{_sanitize(self.name)}{_braced(labels)} {_fmt(self._value)}"]

    def prometheus_lines(self) -> List[str]:
        n = _sanitize(self.name)
        return [f"# HELP {n} {self.help}", f"# TYPE {n} counter", *self.prometheus_samples()]


class Gauge:
    """Last-value metric. ``set`` stores the value raw, coerced to float at
    export; ``set_fn`` registers a callable evaluated at export instead."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._raw = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value) -> None:
        self._raw = value
        self._fn = None

    def set_fn(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        return float(self._fn() if self._fn is not None else self._raw)

    def snapshot(self) -> float:
        return self.value

    def prometheus_samples(self, labels: str = "") -> List[str]:
        return [f"{_sanitize(self.name)}{_braced(labels)} {_fmt(self.value)}"]

    def prometheus_lines(self) -> List[str]:
        n = _sanitize(self.name)
        return [f"# HELP {n} {self.help}", f"# TYPE {n} gauge", *self.prometheus_samples()]


class Histogram:
    """Sparse log-bucketed histogram with exact-to-bucket quantiles.

    Values ``<= 0`` land in a zero bucket (a virtual clock gives zero
    latencies), reported as ``0.0`` by the quantiles."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", growth: float = DEFAULT_GROWTH):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.name = name
        self.help = help
        self.growth = growth
        self._log_growth = math.log(growth)
        self._buckets: Dict[int, int] = {}
        self._zero = 0  # observations <= 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def relative_error(self) -> float:
        """Worst-case relative overestimate of any quantile."""
        return self.growth - 1.0

    def bucket_index(self, value: float) -> int:
        return math.floor(math.log(value) / self._log_growth)

    def bucket_edges(self, index: int) -> Tuple[float, float]:
        """``[lo, hi)`` edges of bucket ``index`` (hi = lo * growth)."""
        return (self.growth ** index, self.growth ** (index + 1))

    def observe(self, value) -> None:
        v = value
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self._zero += 1
            return
        i = math.floor(math.log(v) / self._log_growth)
        self._buckets[i] = self._buckets.get(i, 0) + 1

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding the rank ``ceil(q * count)``
        sample, never above the exact maximum; 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = self._zero
        if rank <= seen:
            return 0.0
        for i in sorted(self._buckets):
            seen += self._buckets[i]
            if rank <= seen:
                return min(self.growth ** (i + 1), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }

    def prometheus_samples(self, labels: str = "") -> List[str]:
        """Cumulative ``le`` buckets over the touched range, then ``_sum``
        and ``_count``; ``labels`` composes with ``le``."""
        n = _sanitize(self.name)
        pre = f"{labels}," if labels else ""
        lines = []
        cum = self._zero
        if self._zero:
            lines.append(f'{n}_bucket{{{pre}le="0"}} {self._zero}')
        for i in sorted(self._buckets):
            cum += self._buckets[i]
            lines.append(f'{n}_bucket{{{pre}le="{_fmt(self.growth ** (i + 1))}"}} {cum}')
        lines.append(f'{n}_bucket{{{pre}le="+Inf"}} {self.count}')
        lines.append(f"{n}_sum{_braced(labels)} {_fmt(self.sum)}")
        lines.append(f"{n}_count{_braced(labels)} {self.count}")
        return lines

    def prometheus_lines(self) -> List[str]:
        n = _sanitize(self.name)
        return [f"# HELP {n} {self.help}", f"# TYPE {n} histogram", *self.prometheus_samples()]


def _labelset_key(values: Tuple[str, ...]) -> str:
    """Snapshot key of one labelset: the bare value for one label, a JSON
    list otherwise (a joined key would be ambiguous)."""
    return values[0] if len(values) == 1 else json.dumps(list(values))


class MetricFamily:
    """Get-or-create labelled children of one metric name.

    ``family.labels("acme")`` (positionally, in ``label_names`` order) or
    ``family.labels(tenant="acme")`` returns the child for that labelset, a
    plain Counter/Gauge/Histogram. Children are never dropped. Label names
    are sanitized at creation; label values stay raw and are escaped at
    export."""

    def __init__(self, name: str, cls, label_names: Iterable[str], help: str = "",
                 **child_kwargs):
        names = tuple(_sanitize(str(n)) for n in label_names)
        if not names:
            raise ValueError("a MetricFamily needs at least one label name")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate label names after sanitizing: {names}")
        self.name = name
        self.help = help
        self.cls = cls
        self.label_names = names
        self._child_kwargs = child_kwargs
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    @property
    def kind(self) -> str:
        return self.cls.kind

    def _values(self, args, by_name) -> Tuple[str, ...]:
        if by_name:
            if args:
                raise ValueError("pass label values positionally or by name, not both")
            extra = set(by_name) - set(self.label_names)
            if extra or len(by_name) != len(self.label_names):
                raise ValueError(f"labels {sorted(by_name)} do not match the family's label "
                                 f"names {list(self.label_names)}")
            args = tuple(by_name[n] for n in self.label_names)
        values = tuple(str(v) for v in args)
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected {len(self.label_names)} label value(s) for "
                             f"{list(self.label_names)}, got {len(values)}")
        return values

    def labels(self, *args, **by_name):
        """Get-or-create the child for one labelset."""
        values = self._values(args, by_name)
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    child = self.cls(self.name, help=self.help, **self._child_kwargs)
                    self._children[values] = child
        return child

    def has_child(self, *args, **by_name) -> bool:
        return self._values(args, by_name) in self._children

    def child_labelsets(self) -> List[Tuple[str, ...]]:
        """Every labelset that has a child, sorted."""
        return sorted(self._children)

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        return [(v, self._children[v]) for v in sorted(self._children)]

    def snapshot(self) -> dict:
        """``{"labels": [...], "children": {labelset: child snapshot}}``,
        children sorted."""
        return {
            "labels": list(self.label_names),
            "children": {_labelset_key(v): child.snapshot() for v, child in self.children()},
        }

    def _label_str(self, values: Tuple[str, ...]) -> str:
        return ",".join(f'{n}="{escape_label_value(v)}"' for n, v in zip(self.label_names, values))

    def prometheus_lines(self) -> List[str]:
        """One HELP/TYPE header, then every child's samples with its
        escaped labelset."""
        n = _sanitize(self.name)
        lines = [f"# HELP {n} {self.help}", f"# TYPE {n} {self.kind}"]
        for values, child in self.children():
            lines.extend(child.prometheus_samples(self._label_str(values)))
        return lines


class MetricsView:
    """A label-scoped lens over a registry: with a labelset, every metric
    resolves as that labelset's child of a family carrying the view's label
    names; an empty view resolves plain unlabelled metrics. The one owner of
    the ``engine_label`` scheme that ``ServingMetrics``, ``SpecStats`` and
    ``SLOTracker`` share. ``family``/``child``/``has_child`` extend the
    scope with per-record labels (``tenant``); ``has_child`` never creates
    a child, so a snapshot mints no empty series."""

    def __init__(self, registry: "MetricsRegistry", label_names: Iterable[str] = (),
                 label_values: Iterable[str] = ()):
        names = tuple(label_names)
        values = tuple(str(v) for v in label_values)
        if len(names) != len(values):
            raise ValueError(f"label_names {list(names)} and label_values {list(values)} must "
                             "pair up")
        self.registry = registry
        self.label_names = names
        self.label_values = values

    def _resolve(self, kind: str, name: str, help: str, extra_labels: Tuple[str, ...] = (),
                 **kwargs):
        labels = self.label_names + tuple(extra_labels)
        return getattr(self.registry, kind)(name, help=help, labels=labels or None, **kwargs)

    def counter(self, name: str, help: str = "") -> Counter:
        m = self._resolve("counter", name, help)
        return m.labels(*self.label_values) if self.label_names else m

    def gauge(self, name: str, help: str = "") -> Gauge:
        m = self._resolve("gauge", name, help)
        return m.labels(*self.label_values) if self.label_names else m

    def histogram(self, name: str, help: str = "", growth: float = DEFAULT_GROWTH) -> Histogram:
        m = self._resolve("histogram", name, help, growth=growth)
        return m.labels(*self.label_values) if self.label_names else m

    def family(self, kind: str, name: str, help: str = "", labels: Iterable[str] = ("tenant",),
               **kwargs) -> MetricFamily:
        """A family whose label names are this view's + ``labels``."""
        return self._resolve(kind, name, help, extra_labels=tuple(labels), **kwargs)

    def child(self, family: MetricFamily, *values):
        """Get-or-create the child at (view values, ``values``)."""
        return family.labels(*self.label_values, *values)

    def has_child(self, family: MetricFamily, *values) -> bool:
        """Existence check that never creates the child."""
        return family.has_child(*self.label_values, *values)


class MetricsRegistry:
    """Get-or-create home for named metrics. Creation is locked; the record
    paths are not (CPython's int adds are exact for counters, and a torn
    histogram read only skews one scrape)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, labels=None, **kwargs):
        wanted = tuple(_sanitize(str(label)) for label in labels) if labels else ()
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = MetricFamily(name, cls, wanted, **kwargs) if wanted else cls(name, **kwargs)
                self._metrics[name] = m
                return m
            if wanted:
                if (not isinstance(m, MetricFamily) or m.cls is not cls
                        or m.label_names != wanted):
                    have = (f"{m.cls.__name__} family with labels {list(m.label_names)}"
                            if isinstance(m, MetricFamily) else f"unlabeled {type(m).__name__}")
                    raise TypeError(f"metric {name!r} already registered as {have}, not a "
                                    f"{cls.__name__} family with labels {list(wanted)}")
            elif isinstance(m, MetricFamily):
                raise TypeError(f"metric {name!r} already registered as a labeled family "
                                f"({list(m.label_names)}); pass labels= to get it")
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as {type(m).__name__}, "
                                f"not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "", labels=None) -> Union[Counter, MetricFamily]:
        """An unlabelled counter, or with ``labels=`` the counter family."""
        return self._get_or_create(name, Counter, labels=labels, help=help)

    def gauge(self, name: str, help: str = "", labels=None) -> Union[Gauge, MetricFamily]:
        return self._get_or_create(name, Gauge, labels=labels, help=help)

    def histogram(self, name: str, help: str = "", growth: float = DEFAULT_GROWTH,
                  labels=None) -> Union[Histogram, MetricFamily]:
        return self._get_or_create(name, Histogram, labels=labels, help=help, growth=growth)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """JSON-safe ``{name: value or histogram dict}``; lazily held gauge
        values are coerced here."""
        return {name: m.snapshot() for name, m in sorted(self._metrics.items())}

    def snapshot_json(self, **dumps_kwargs) -> str:
        return json.dumps(self.snapshot(), **dumps_kwargs)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4) of every metric."""
        lines: List[str] = []
        for _, m in sorted(self._metrics.items()):
            lines.extend(m.prometheus_lines())
        return "\n".join(lines) + "\n"
