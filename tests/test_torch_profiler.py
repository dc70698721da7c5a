"""The profiler surface (``observability/profiler.py``) against the JAX
package's (``neuronx_distributed_tpu/observability/profiler.py``): a falsy
path is a no-op, one live window a process, a trace written where asked,
``record_device_memory`` reports 0 devices on the CPU as JAX's does and
sets JAX's gauge names from ``torch.cuda``'s stats on a card (stubbed
here), the compile listener counts the port's compile events, and the
engine's ``profile_dir=`` profiles decode chunks [2, 5) without touching
the streams (exact equality) or the host reads."""

import json
import os

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.observability import MetricsRegistry as JMetricsRegistry
from neuronx_distributed_tpu.observability.profiler import record_device_memory as jrecord
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.kernels import _build
from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, tiny_llama
from neuronx_distributed_tpu_torch.observability import profiler
from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

torch.set_num_threads(1)


def test_profile_window_writes_a_trace_and_allows_one(tmp_path):
    with profiler.profile_window(None) as w:
        assert w is None
    path = str(tmp_path / "p")
    with profiler.profile_window(path) as w:
        torch.ones(8, 8) @ torch.ones(8, 8)
        with pytest.raises(RuntimeError, match="already live"):
            with profiler.profile_window(str(tmp_path / "q")):
                pass
    with open(w.trace_path) as f:
        trace = json.load(f)
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
    with pytest.raises(ValueError):  # the window closes when the block raises
        with profiler.profile_window(str(tmp_path / "r")):
            raise ValueError("boom")
    with profiler.profile_window(str(tmp_path / "s")):
        pass


def test_record_device_memory_cpu_and_stubbed_card(monkeypatch):
    assert profiler.record_device_memory(MetricsRegistry()) == 0 == jrecord(JMetricsRegistry())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 50, "allocated_bytes.all.peak": 75,
        "reserved_bytes.all.current": 64})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (150, 200))
    reg = MetricsRegistry()
    assert profiler.record_device_memory(reg) == 1
    assert reg.get("device0_bytes_in_use").value == 50
    assert reg.get("device0_peak_bytes_in_use").value == 75
    assert reg.get("device0_bytes_limit").value == 200
    assert reg.get("device0_memory_utilization").value == pytest.approx(0.25)


def test_compile_listener_counts_port_events():
    reg = MetricsRegistry()
    n = len(_build.COMPILE_LISTENERS)
    try:
        assert profiler.install_compile_listener(reg)
        _build.notify("build", 2.5, name="libx.so")
        _build.notify("capture", 0.5)
        assert reg.get("torch_compile_events").value == 2
        assert reg.get("torch_compile_time_s").count == 2
    finally:
        del _build.COMPILE_LISTENERS[n:]


@pytest.fixture(scope="module")
def tiny():
    return init_params(LlamaForCausalLM(tiny_llama(), device="cpu"), seed=0)


def _serve(model, **kw):
    engine = ServingEngine(model, num_slots=2, decode_chunk_size=2, prefix_cache=None, **kw)
    gcfg = GenerationConfig(max_new_tokens=16, temperature=0.0)
    reqs = [engine.submit(np.arange(1 + i, 7 + i, dtype=np.int32), gcfg) for i in range(2)]
    engine.run()
    return engine, reqs


def test_engine_profiles_decode_chunks_2_to_5(tiny, tmp_path):
    """``profile_dir=``: the window opens before chunk 2 and closes before
    chunk 5; the trace holds the decode step of those three chunks (the
    profiler's ``aten::mm`` of the step's linears) and the streams and host
    reads equal an unprofiled engine's."""
    bare, rb = _serve(tiny)
    d = str(tmp_path / "prof")
    prof, rp = _serve(tiny, profile_dir=d)
    assert [r.tokens for r in rp] == [r.tokens for r in rb]
    assert prof.host_reads == bare.host_reads and prof.metrics.chunks >= 6
    with open(os.path.join(d, profiler.TRACE_NAME)) as f:
        names = [ev.get("name", "") for ev in json.load(f)["traceEvents"]]
    assert sum(n == "aten::mm" for n in names) > 0
    assert prof._profiler is None  # closed
    # a second engine can profile after the first closed its window
    again, _ = _serve(tiny, profile_dir=str(tmp_path / "again"))
    assert os.path.exists(os.path.join(str(tmp_path / "again"), profiler.TRACE_NAME))


def test_window_that_cannot_start_disables_profiling(tiny, tmp_path):
    """Another live window: ``profile_start_failed`` recorded, profiling
    off, every request DONE."""
    with profiler.profile_window(str(tmp_path / "outer")):
        engine, reqs = _serve(tiny, profile_dir=str(tmp_path / "inner"))
    assert all(r.finished for r in reqs)
    assert any(e["kind"] == "profile_start_failed" for e in engine.flight.events())
    assert engine._profile_dir is None
    assert not os.path.exists(os.path.join(str(tmp_path / "inner"), profiler.TRACE_NAME))
