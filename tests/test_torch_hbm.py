"""The HBM ledger against the JAX package (CPU): ``observability/hbm.py``
``HBMLedger`` given the same calls as JAX's ledger gives the same snapshots,
plans and halt summaries (JAX's ``test_hbm_plan_two_tier_schema_and_math``
run on both); the engine registers the residents JAX's engine registers for
the same configuration (row, paged, paged with a host tier, prefix cache on
and off), each with its unit; ``metrics.snapshot()["hbm"]``, the registry's
gauges and the halt post-mortem carry it; on the CPU every device-derived
field is ``"unavailable"``, as JAX's on a backend without memory stats."""

import gc

import jax
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
from neuronx_distributed_tpu.observability.hbm import HBMLedger as JHBMLedger
from neuronx_distributed_tpu.serving import PrefixCache as JPrefixCache
from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.observability.hbm import UNAVAILABLE, HBMLedger, tree_nbytes
from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry
from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
from test_torch_llama import build_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    return build_pair(seed=1)


def _two_tier_calls(hbm):
    """JAX's ``test_hbm_plan_two_tier_schema_and_math``, its calls and
    assertions; returns what each call gave."""
    hbm.add_resident("kv_pages", lambda: 8 * 1024, unit_bytes=1024, count=8, unit="page")
    hbm.add_resident("kv_host_pages", lambda: 4 * 2048, unit_bytes=2048, count=4, unit="page",
                     tier="host")
    snap = hbm.snapshot()
    assert snap["residents"]["kv_pages"] == {"bytes": 8192, "unit_bytes": 1024, "unit": "page",
                                             "count": 8}
    assert snap["residents"]["kv_host_pages"]["tier"] == "host"
    assert snap["resident_bytes_total"] == 8192
    assert snap["host_resident_bytes_total"] == 4 * 2048
    assert hbm.resident_bytes_total() == 8192
    assert hbm.resident_bytes_total(tier="host") == 4 * 2048
    plan = hbm.plan(budget_bytes=8192 + 2 * 1024, host_budget_bytes=4 * 2048 + 3 * 2048)
    assert plan["free_bytes"] == 2 * 1024
    assert plan["host_free_bytes"] == 3 * 2048
    dev, host = plan["fits"]["kv_pages"], plan["fits"]["kv_host_pages"]
    assert "tier" not in dev and dev["additional"] == 2
    assert host["tier"] == "host" and host["additional"] == 3 and host["max_total"] == 7
    p2 = hbm.plan(budget_bytes=8192 + 1024)
    assert p2["fits"]["kv_pages"]["additional"] == 1
    assert p2["fits"]["kv_host_pages"]["additional"] == UNAVAILABLE
    assert p2["host_budget_bytes"] == UNAVAILABLE
    halt = hbm.halt_summary()
    assert "host_resident_bytes_total" in halt
    with pytest.raises(ValueError, match="tier"):
        hbm.add_resident("x", lambda: 1, tier="disk")
    p3 = hbm.plan()  # no budget on a backend without a limit
    hbm.remove_resident("kv_host_pages")
    return snap, plan, p2, p3, halt, hbm.snapshot()


def test_hbm_plan_two_tier_schema_and_math_equals_jax():
    assert _two_tier_calls(HBMLedger()) == _two_tier_calls(JHBMLedger())


def test_ledger_reads_and_exports():
    reg = MetricsRegistry()
    hbm = HBMLedger(registry=reg)
    state = {"a": torch.zeros(4, 8), "b": [torch.zeros(3, dtype=torch.bfloat16)]}
    hbm.add_resident("state", state)
    hbm.add_resident("fixed", 1000)
    assert tree_nbytes(state) == 4 * 8 * 4 + 3 * 2 == hbm.resident_bytes("state")
    assert hbm.resident_bytes_total() == 1134 and hbm.resident_bytes("missing") == 0
    snap = hbm.snapshot()
    assert snap["device"] == {"kind": "cpu", "platform": "cpu"}
    for key in ("bytes_limit", "bytes_in_use", "peak_bytes_in_use", "utilization",
                "unaccounted_bytes"):
        assert snap[key] == UNAVAILABLE
    text = reg.prometheus_text()
    assert 'hbm_resident_bytes{resident="state"} 134' in text
    assert "hbm_resident_bytes_total 1134" in text and "hbm_bytes_limit -1" in text


def _units(residents) -> dict:
    """Each resident without its bytes; a row slot's bytes are each
    framework's own (the JAX cache keeps a validity row and an index a
    layer, the port one validity row for all layers), so the row cache's
    ``unit_bytes`` is left out too."""
    return {name: {k: v for k, v in e.items()
                   if k != "bytes" and not (name == "kv_cache" and k == "unit_bytes")}
            for name, e in residents.items()}


def _jax_residents(setup, **kw):
    jmodel, params, _ = setup
    eng = JServingEngine(jmodel, params, num_slots=2, **kw)
    eng.submit(np.arange(1, 12, dtype=np.int32), JGenerationConfig(max_new_tokens=3,
                                                                   temperature=0.0),
               key=jax.random.PRNGKey(0))
    eng.run()
    return _units(eng.hbm.snapshot()["residents"])


@pytest.mark.parametrize("config", ["row", "row_prefix", "paged", "paged_tier"])
def test_engine_residents_equal_jax(setup, config):
    """The residents (names, units, counts, tiers) the JAX engine registers
    for the same configuration; bytes are each framework's own (the slot
    state's fields differ)."""
    tmodel = setup[2]
    kw = {"row": dict(prefix_cache=None), "row_prefix": {},
          "paged": dict(kv_page_size=8, kv_num_pages=17, prefix_cache=None),
          "paged_tier": dict(kv_page_size=8, kv_num_pages=17, kv_host_pages=4)}[config]
    jkw = dict(kw)
    if config == "row_prefix":
        jkw["prefix_cache"] = JPrefixCache()
    if config == "paged_tier":
        kw["prefix_cache"], jkw["prefix_cache"] = PrefixCache(), JPrefixCache()
    eng = ServingEngine(tmodel, num_slots=2, **kw)
    eng.submit(np.arange(1, 12, dtype=np.int32), GenerationConfig(max_new_tokens=3,
                                                                  temperature=0.0))
    eng.run()
    snap = eng.hbm.snapshot()
    assert _units(snap["residents"]) == _jax_residents(setup, **jkw)
    assert eng.metrics.snapshot()["hbm"] == snap
    assert snap["residents"]["params"]["bytes"] == sum(
        p.numel() * p.element_size() for p in tmodel.parameters())
    if config.startswith("paged"):
        assert snap["residents"]["kv_pages"]["bytes"] == eng.cache.nbytes
    else:
        assert snap["residents"]["kv_cache"]["unit_bytes"] * 2 == eng.cache.nbytes
    plan = eng.hbm.plan(budget_bytes=snap["resident_bytes_total"] + 10 * eng.cache.page_nbytes,
                        host_budget_bytes=64 * eng.cache.page_nbytes) \
        if config.startswith("paged") else None
    if plan is not None:
        assert plan["fits"]["kv_pages"]["additional"] == 10
        if config == "paged_tier":
            assert plan["fits"]["kv_host_pages"]["additional"] == 64


def test_ledger_does_not_pin_the_engine(setup):
    tmodel = setup[2]
    eng = ServingEngine(tmodel, num_slots=1, kv_page_size=8, kv_host_pages=2)
    hbm, metrics = eng.hbm, eng.metrics
    del eng
    gc.collect()
    assert hbm.resident_bytes_total() == 0 and hbm.resident_bytes_total("host") == 0
    assert all(e["bytes"] == 0 for e in metrics.snapshot()["hbm"]["residents"].values())
    del hbm
    gc.collect()
    assert metrics.snapshot()["hbm"] == {}


def test_halt_postmortem_carries_the_ledger_and_the_tier(setup):
    tmodel = setup[2]
    eng = ServingEngine(tmodel, num_slots=2, decode_chunk_size=2, kv_page_size=8,
                        kv_host_pages=4, fault_injector=FaultInjector().fail_dispatch(times=None),
                        sleep_fn=lambda s: None)
    eng.submit(np.arange(1, 12, dtype=np.int32), GenerationConfig(max_new_tokens=6,
                                                                  temperature=0.0))
    eng.run()
    assert eng.halt_reason is not None
    extra = eng.flight.last_postmortem["extra"]
    assert extra["kv_host_tier"] == eng.tier.summary()
    assert extra["hbm"]["resident_kv_host_pages_bytes"] == 0
    assert extra["hbm"]["bytes_limit"] == UNAVAILABLE and "hbm" not in extra["metrics"]
