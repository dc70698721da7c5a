"""The port's metrics registry against the JAX package's
(``observability/registry.py``): the same observation sequences give equal
``snapshot_json()`` and ``prometheus_text()``, byte for byte, and the two
agree on bucket edges, percentiles, the zero bucket, labelled families
(hostile label values included), a labelled histogram's ``le`` series,
get-or-create identity and type conflicts. The serving metrics built on it
keep their registry rules (one unlabelled engine a registry; labelled
engines side by side)."""

import math

import numpy as np
import pytest

from neuronx_distributed_tpu.observability import registry as jreg
from neuronx_distributed_tpu_torch.observability import registry as treg
from neuronx_distributed_tpu_torch.serving.metrics import ServingMetrics

HOSTILE = ['acme', 'we"ird', 'back\\slash', 'new\nline', 'ünïcødé', 'a,b=c}{', '']


def _feed(mod, values, labelled):
    """One observation sequence into a fresh registry of ``mod``."""
    reg = mod.MetricsRegistry()
    c = reg.counter("requests_total", help="requests")
    g = reg.gauge("queue_depth", help="depth")
    h = reg.histogram("latency_s", help="latency")
    h2 = reg.histogram("tight", help="tight buckets", growth=1.01)
    fc = reg.counter("tenant_requests", help="per tenant", labels=("tenant",))
    fh = reg.histogram("tenant_latency_s", help="per tenant", labels=("tenant",))
    fg = reg.gauge("engine_tenant_rate", help="rate", labels=("engine", "tenant"))
    for i, v in enumerate(values):
        c.inc()
        c.inc(2)
        g.set(v)
        h.observe(v)
        h2.observe(abs(v))
        if labelled:
            t = HOSTILE[i % len(HOSTILE)]
            fc.labels(t).inc(i)
            fh.labels(tenant=t).observe(v)
            fg.labels("e0", t).set(v * 2)
    reg.gauge("lazy", help="set_fn").set_fn(lambda: 7)
    return reg


def _values(seed, n=200):
    rng = np.random.default_rng(seed)
    v = list(np.exp(rng.normal(-3.0, 2.0, size=n)).tolist())
    v += [0.0, 0.0, -1.5, 1e-9, 1.0, 1.05, 1234.5]  # zero bucket, negatives, edges
    return v


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("labelled", [False, True])
def test_snapshot_and_prometheus_equal_jax(seed, labelled):
    vals = _values(seed)
    want, got = _feed(jreg, vals, labelled), _feed(treg, vals, labelled)
    assert got.snapshot_json() == want.snapshot_json()
    assert got.snapshot_json(sort_keys=True) == want.snapshot_json(sort_keys=True)
    assert got.prometheus_text() == want.prometheus_text()
    assert got.names() == want.names()


@pytest.mark.parametrize("growth", [1.05, 1.01, 2.0])
def test_histogram_edges_and_percentiles_equal_jax(growth):
    vals = _values(3, n=500)
    jh, th = jreg.Histogram("h", growth=growth), treg.Histogram("h", growth=growth)
    for v in vals:
        jh.observe(v)
        th.observe(v)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert th.percentile(q) == jh.percentile(q)
    for v in (1e-6, 0.3, 1.0, 17.0):
        i = th.bucket_index(v)
        assert i == jh.bucket_index(v)
        assert th.bucket_edges(i) == jh.bucket_edges(i)
        lo, hi = th.bucket_edges(i)
        assert lo <= v * (1 + 1e-12) and v < hi * (1 + 1e-12)
    assert th.snapshot() == jh.snapshot()
    assert th.relative_error == pytest.approx(growth - 1.0)
    # exact count/sum/min/max: only the quantiles are bucketed
    assert (th.count, th.min, th.max) == (len(vals), min(vals), max(vals))
    assert th.sum == pytest.approx(math.fsum(vals))


def test_zero_bucket_and_empty_histogram():
    for mod in (jreg, treg):
        h = mod.Histogram("z")
        assert h.percentile(0.99) == 0.0 and h.snapshot()["min"] == 0.0
        for v in (0.0, -2.0, 0.0, 5.0):
            h.observe(v)
        assert h.percentile(0.5) == 0.0  # 3 of 4 samples in the zero bucket
        assert 5.0 / 1.05 <= h.percentile(1.0) <= 5.0
    th, jh = treg.Histogram("z"), jreg.Histogram("z")
    for v in (0.0, 0.5):
        th.observe(v)
        jh.observe(v)
    assert th.prometheus_lines() == jh.prometheus_lines()
    assert 'z_bucket{le="0"} 1' in th.prometheus_lines()


def test_labelled_histogram_le_composes_and_values_escape():
    for mod in (jreg, treg):
        reg = mod.MetricsRegistry()
        fam = reg.histogram("ttft_s", help="x", labels=("tenant",))
        fam.labels('we"ird\nten\\ant').observe(0.2)
        text = reg.prometheus_text()
        assert 'ttft_s_bucket{tenant="we\\"ird\\nten\\\\ant",le="+Inf"} 1' in text
        assert 'ttft_s_count{tenant="we\\"ird\\nten\\\\ant"} 1' in text
    assert treg.escape_label_value('a"b\\c\nd') == jreg.escape_label_value('a"b\\c\nd')
    assert treg._sanitize("9bad-name.x") == jreg._sanitize("9bad-name.x") == "_9bad_name_x"


def test_get_or_create_identity_and_type_conflicts():
    reg = treg.MetricsRegistry()
    c = reg.counter("x")
    assert reg.counter("x") is c
    with pytest.raises(TypeError, match="already registered as Counter"):
        reg.gauge("x")
    with pytest.raises(TypeError, match="unlabeled Counter"):
        reg.counter("x", labels=("tenant",))
    fam = reg.counter("y", labels=("tenant",))
    assert reg.counter("y", labels=("tenant",)) is fam
    assert fam.labels("a") is fam.labels(tenant="a")
    with pytest.raises(TypeError, match="labeled family"):
        reg.counter("y")
    with pytest.raises(TypeError, match="family with labels"):
        reg.counter("y", labels=("engine",))
    with pytest.raises(ValueError, match="positionally or by name"):
        fam.labels("a", tenant="b")
    with pytest.raises(ValueError, match="expected 1 label"):
        fam.labels("a", "b")
    with pytest.raises(ValueError, match="duplicate label names"):
        treg.MetricFamily("z", treg.Counter, ("a-b", "a_b"))
    assert not fam.has_child("never") and fam.child_labelsets() == [("a",)]
    with pytest.raises(ValueError, match="growth"):
        treg.Histogram("h", growth=1.0)


def test_views_scope_labels_and_never_mint_children():
    for mod in (jreg, treg):
        reg = mod.MetricsRegistry()
        a = mod.MetricsView(reg, ("engine",), ("a",))
        b = mod.MetricsView(reg, ("engine",), ("b",))
        a.counter("n").inc(3)
        b.counter("n").inc(5)
        fam = a.family("histogram", "lat")
        assert not a.has_child(fam, "t")
        a.child(fam, "t").observe(1.0)
        assert a.has_child(fam, "t") and not b.has_child(fam, "t")
        snap = reg.snapshot()
        assert snap["n"]["children"] == {"a": 3, "b": 5}
        assert list(snap["lat"]["children"]) == ['["a", "t"]']
    with pytest.raises(ValueError, match="pair up"):
        treg.MetricsView(treg.MetricsRegistry(), ("a", "b"), ("x",))


def test_serving_metrics_registry_rules():
    reg = treg.MetricsRegistry()
    ServingMetrics(2, registry=reg)
    with pytest.raises(ValueError, match="engine_label"):
        ServingMetrics(2, registry=reg)  # a second unlabelled engine
    with pytest.raises(ValueError, match="engine_label"):
        ServingMetrics(2, registry=reg, engine_label="x")  # unlabelled one already there
    shared = treg.MetricsRegistry()
    a = ServingMetrics(2, registry=shared, engine_label="fifo")
    b = ServingMetrics(2, registry=shared, engine_label="slo")
    with pytest.raises(ValueError, match="engine_label"):
        ServingMetrics(2, registry=shared, engine_label="fifo")  # the label is taken
    a._inc("steps", 3)
    b._inc("steps", 4)
    assert (a.steps, b.steps) == (3, 4)
    assert shared.snapshot()["serving_steps"]["children"] == {"fifo": 3, "slo": 4}
    assert 'serving_steps{engine="slo"} 4' in shared.prometheus_text()
