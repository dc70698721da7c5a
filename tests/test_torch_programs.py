"""The program ledger (``observability/programs.py``) against the contract
of the JAX package's ``tests/observability/test_programs.py`` (its ledger,
peaks, export, enumeration, prewarm and engine cases; the model-builder,
trainer and memory-analysis cases wait for the trainer's port) and the
host-read budget of ``tests/observability/test_observe_overhead.py``.

The port's cost is metered, not compiler-reported: FLOPs of the aten
products (``torch.utils.flop_counter``'s formulas) and each kernel's own
count, bytes as operands plus outputs. So the decode step's FLOPs a
dispatch equal the analytic ``2 x (linear weights) x slots`` plus the
decode kernel's ``4 x slots x heads x columns x head_dim`` a layer,
exactly (float sums of integers: tolerance 0)."""

import json

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.inference.aot import materialize_call
from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
from neuronx_distributed_tpu_torch.kernels.flash_decode import flash_decode_fwd
from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, init_params, tiny_llama
from neuronx_distributed_tpu_torch.observability import programs as programs_mod
from neuronx_distributed_tpu_torch.observability.hbm import UNAVAILABLE as HBM_UNAVAILABLE
from neuronx_distributed_tpu_torch.observability.hbm import weak_reader as hbm_weak_reader
from neuronx_distributed_tpu_torch.observability.programs import (
    UNAVAILABLE,
    CostMeter,
    ProgramLedger,
    device_peaks,
    weak_reader,
)
from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
from neuronx_distributed_tpu_torch.utils.timeline import Timeline

torch.set_num_threads(1)


def mm(x, y):
    return x @ y


def test_wrap_counts_dispatches_and_detects_compiles():
    led = ProgramLedger()
    f = led.wrap("mm", lambda x: (x @ x).sum())
    x = torch.ones(16, 16)
    f(x)
    assert f.last_call_compiled
    f(x)
    assert not f.last_call_compiled
    rec = led.record("mm")
    assert rec.dispatches == 2 and rec.compiles == 1 and rec.compile_wall_s > 0.0


def test_cost_schema_metered_on_the_first_dispatch():
    """A (32, 32) product: 2 x 32^3 FLOPs, its two operands and its output
    once each; the entry's derived fields from those. An ordinary first
    dispatch compiles unmetered (a request never pays the meter); the
    first dispatch under a prewarm meters the variant."""
    led = ProgramLedger()
    f = led.wrap("mm", mm)
    f(torch.ones(32, 32), torch.ones(32, 32))
    entry = led.snapshot()["by_program"]["mm"]
    assert entry["compiles"] == 1 and entry["flops_per_dispatch"] == UNAVAILABLE
    with led.prewarming():
        f(torch.ones(32, 32), torch.ones(32, 32))
    entry = led.snapshot()["by_program"]["mm"]
    assert entry["flops_per_dispatch"] == 2.0 * 32 ** 3
    assert entry["bytes_per_dispatch"] == 3.0 * 32 * 32 * 4
    assert entry["cost_source"] == "prewarm dispatch" and entry["compiles"] == 1
    assert entry["arithmetic_intensity"] == pytest.approx(65536 / 12288)
    assert entry["flops_total"] == entry["flops_per_dispatch"]


def test_recompile_accumulates_never_double_counts():
    """Two proxies of one name share ONE record: dispatches sum; a compile
    is a new signature of the record, so the second proxy's first call at a
    seen signature compiles nothing."""
    led = ProgramLedger()
    a, b = led.wrap("step", lambda x: x + 1), led.wrap("step", lambda x: x + 1)
    x = torch.ones(4)
    a(x), a(x), b(x), b(x), b(x)
    rec = led.record("step")
    assert rec.dispatches == 5 and rec.compiles == 1
    snap = led.snapshot()
    assert list(snap["by_program"]) == ["step"] and snap["totals"]["dispatches"] == 5


def test_multi_signature_program_reports_variants():
    led = ProgramLedger()
    f = led.wrap("poly", lambda x: x * 2)
    f(torch.ones(4))
    f(torch.ones(8))
    f(torch.ones(8).to(torch.bfloat16))
    entry = led.snapshot()["by_program"]["poly"]
    assert entry["variants"] == 3 and entry["compiles"] == 3
    assert entry["flops_per_dispatch"] == UNAVAILABLE
    assert len(entry["variant_cost"]) == 3
    # a host scalar that changes per call (a seed, a slot) is no new variant
    g = led.wrap("scalar", lambda x, seed: x + seed)
    for seed in range(4):
        g(torch.ones(2), seed)
    assert led.record("scalar").compiles == 1


def test_compile_detection_survives_raising_dispatch():
    """A first dispatch that raises still saw its signature (a compile,
    its cost metered so far) but is no dispatch; the retry counts one."""
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        y = x @ x
        if calls["n"] == 1:
            raise RuntimeError("device OOM")
        return y

    led = ProgramLedger()
    prog = led.wrap("oomer", flaky)
    with pytest.raises(RuntimeError):
        prog(torch.ones(4, 4))
    rec = led.record("oomer")
    assert rec.compiles == 1 and rec.dispatches == 0 and prog.last_call_compiled
    assert len(rec.variants) == 1
    prog(torch.ones(4, 4))
    assert rec.compiles == 1 and rec.dispatches == 1


def test_host_only_callable_costs_nothing():
    """JAX's untrackable callable: a callable that runs no aten op still
    counts its dispatches; its metered cost is 0."""
    led = ProgramLedger()
    f = led.wrap("plain", lambda x: x + 1)
    assert f(1) == 2 and f(2) == 3
    with led.prewarming():
        f(3)
    entry = led.snapshot()["by_program"]["plain"]
    assert entry["dispatches"] == 2 and entry["compiles"] == 1
    assert entry["flops_per_dispatch"] == 0.0 and entry["bytes_per_dispatch"] == 0.0


def test_observe_wall_derives_roofline_fields():
    led = ProgramLedger()
    f = led.wrap("mm", mm)
    with led.prewarming():
        f(torch.ones(64, 64), torch.ones(64, 64))
    f(torch.ones(64, 64), torch.ones(64, 64))
    led.observe_wall("mm", 0.008, dispatches=4)  # a window of four dispatches
    entry = led.snapshot()["by_program"]["mm"]
    assert entry["wall"]["count"] == 1
    assert entry["wall"]["p50_s"] == pytest.approx(0.002, rel=0.05)  # log buckets
    assert entry["achieved_flops_p50"] == pytest.approx(entry["flops_per_dispatch"]
                                                        / entry["wall"]["p50_s"])
    assert entry["mfu_p50"] == UNAVAILABLE and entry["hbm_bw_util_p50"] == UNAVAILABLE
    led.observe_wall("mm", 0.0)  # ignored
    led.observe_wall("unknown", 1.0)  # ignored
    assert led.snapshot()["by_program"]["mm"]["wall"]["count"] == 1


def test_device_peaks_unknown_on_cpu_datasheet_on_h100(monkeypatch):
    p = device_peaks()
    assert p["flops"] == UNAVAILABLE and p["hbm_bytes_per_s"] == UNAVAILABLE
    assert "unknown" in p["source"]
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    p = device_peaks(torch.device("cuda", 0))
    assert p["flops"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert p["platform"] == "gpu" and "datasheet" in p["source"]


def test_ledger_prometheus_families_labeled_by_program():
    reg = MetricsRegistry()
    led = ProgramLedger(registry=reg, prefix="serving")
    f = led.wrap("mm", mm)
    with led.prewarming():
        f(torch.ones(8, 8), torch.ones(8, 8))
    f(torch.ones(8, 8), torch.ones(8, 8))
    text = reg.prometheus_text()
    assert 'serving_program_dispatches{program="mm"} 1' in text
    assert 'serving_program_compiles{program="mm"} 1' in text
    assert 'serving_program_flops{program="mm"} 1024' in text


def test_kernel_cost_counted_once():
    """A kernel wrapper notes its own formula inside a metered dispatch; its
    plain version's aten ops (on the CPU) are not counted again; outside a
    meter the wrapper notes nothing."""
    b, s, h, d, hkv, cols = 2, 1, 4, 8, 2, 16
    q = torch.randn(b, s, h, d)
    k, v = torch.randn(b, cols, hkv, d), torch.randn(b, cols, hkv, d)
    pos = torch.tensor([9])
    with CostMeter() as meter:
        flash_decode_fwd(q, k, v, pos)
    assert meter.kernels == {"flash_decode": 1}
    assert meter.flops == 4.0 * b * s * h * cols * d
    assert meter.bytes == (2 * 4 * q.numel() + 2 * 4 * b * cols * hkv * d + b * cols
                           + 4 * b * s * h)
    out = flash_decode_fwd(q, k, v, pos)  # no meter: a plain call
    assert out[0].shape == q.shape


@pytest.fixture(scope="module")
def tiny():
    return init_params(LlamaForCausalLM(tiny_llama(), device="cpu"), seed=0)


def _run_engine(model, kv_page_size=None, kv_num_pages=None, **kw):
    engine = ServingEngine(model, num_slots=2, decode_chunk_size=4, kv_page_size=kv_page_size,
                           kv_num_pages=kv_num_pages, **kw)
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    reqs = [engine.submit(np.arange(1 + i, 7 + i, dtype=np.int32), gcfg, seed=7 + i)
            for i in range(2)]
    engine.run()
    return engine, reqs


def decode_step_flops(cfg, slots: int, cols: int) -> float:
    """The analytic decode step: every linear's 2 x in x out a slot (the
    layers' q, k, v, o, gate, up, down and lm_head), plus attention's
    4 x heads x columns x head_dim a slot and layer over every column the
    decode kernel is handed."""
    hd = cfg.head_dim_
    per_layer = (cfg.hidden_size * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                 + cfg.num_heads * hd * cfg.hidden_size + 3 * cfg.hidden_size
                 * cfg.intermediate_size)
    weights = cfg.num_layers * per_layer + cfg.hidden_size * cfg.vocab_size
    return 2.0 * weights * slots + 4.0 * slots * cfg.num_heads * cols * hd * cfg.num_layers


def test_engine_snapshot_carries_programs_and_hbm(tiny):
    engine, _ = _run_engine(tiny)
    snap = engine.metrics.snapshot()
    by = snap["programs"]["by_program"]
    for name in ("decode_chunk", "prefill[8]", "slot_write", "slot_clear", "first_token",
                 "suffix_prefill", "prefix_extract", "prefix_seed", "prefix_fingerprint",
                 "pages_fingerprint"):
        assert name in by, name
    dc = by["decode_chunk"]
    assert dc["dispatches"] == engine.metrics.executed_steps and dc["compiles"] == 1
    assert dc["flops_per_dispatch"] == decode_step_flops(tiny.config, 2, tiny.config.max_seq_len)
    assert dc["kernels"] == {"flash_decode": tiny.config.num_layers}
    assert dc["wall"]["count"] >= 1 and isinstance(dc["achieved_flops_p50"], float)
    assert dc["mfu_p50"] == UNAVAILABLE
    assert by["prefill[8]"]["dispatches"] == 2 and by["first_token"]["dispatches"] == 2
    assert by["slot_write"]["dispatches"] == 2 == by["slot_clear"]["dispatches"]
    assert snap["hbm"]["residents"]["params"]["bytes"] > 0
    summary = engine.programs.halt_summary()
    assert list(summary)[0] == "decode_chunk"


def test_served_programs_are_metered_off_the_request_path(tiny, monkeypatch):
    """A request never runs under the cost meter: the engine's eager
    programs (prefill, first token, slot write) compile at their first
    served dispatch unmetered (cost UNAVAILABLE), and the decode step,
    whose first dispatch on the CPU stands for the card's graph capture, is
    the one program metered during the run. A prewarm from the engine's own
    manifest then meters each recorded variant once, counted as prewarm
    dispatches, and their served dispatches stay as they were."""
    metered = []
    enter = CostMeter.__enter__

    def counting_enter(self):
        metered.append(self)
        return enter(self)

    monkeypatch.setattr(CostMeter, "__enter__", counting_enter)
    engine, _ = _run_engine(tiny, prefix_cache=None)
    assert len(metered) == 1  # the decode step's stand-in capture
    by = engine.programs.snapshot()["by_program"]
    eager = ("prefill[8]", "first_token", "slot_write", "slot_clear")
    for name in eager:
        assert by[name]["compiles"] == 1 and by[name]["flops_per_dispatch"] == UNAVAILABLE, name
    served = {n: by[n]["dispatches"] for n in eager}
    rep = engine.prewarm(manifest=engine.manifest())
    assert set(eager) <= set(rep["replayed"]) and not rep["failed"]
    by = engine.programs.snapshot()["by_program"]
    for name in eager:
        assert isinstance(by[name]["flops_per_dispatch"], float), name
        assert by[name]["cost_source"] == "prewarm dispatch" and by[name]["compiles"] == 1
        assert by[name]["dispatches"] == served[name] and by[name]["prewarm_dispatches"] == 1
    assert by["prefill[8]"]["flops_per_dispatch"] > 0
    n = len(metered)
    engine.prewarm(manifest=engine.manifest())
    assert len(metered) == n  # each variant metered once


def test_engine_snapshot_deterministic_across_identical_runs(tiny):
    a, ra = _run_engine(tiny)
    b, rb = _run_engine(tiny)
    pa = json.dumps(a.programs.snapshot(include_timing=False), sort_keys=True)
    pb = json.dumps(b.programs.snapshot(include_timing=False), sort_keys=True)
    assert pa == pb
    assert [r.tokens for r in ra] == [r.tokens for r in rb]


def test_paged_engine_decode_program_runs_k5(tiny):
    engine, _ = _run_engine(tiny, kv_page_size=8, kv_num_pages=16)
    dc = engine.programs.snapshot()["by_program"]["decode_chunk"]
    assert dc["kernels"] == {"paged_flash_decode": tiny.config.num_layers}
    assert dc["flops_per_dispatch"] == decode_step_flops(tiny.config, 2, tiny.config.max_seq_len)
    engine.cache.check()


def mixtral_decode_step_flops(cfg, slots: int, cols: int) -> float:
    """The analytic routed decode step of a Mixtral: attention's linears
    and attention over every column handed to the decode kernel (as
    :func:`decode_step_flops`), the router's 2 x hidden x experts, k of
    the E experts' SwiGLU (3 products of hidden x intermediate) and their
    weighted combine (2 x k x hidden) a token, and lm_head, each a slot."""
    hd = cfg.head_dim_
    attn = (cfg.hidden_size * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
            + cfg.num_heads * hd * cfg.hidden_size)
    routed = cfg.hidden_size * cfg.num_experts + cfg.top_k * cfg.hidden_size * (
        3 * cfg.intermediate_size + 1)
    weights = cfg.num_layers * (attn + routed) + cfg.hidden_size * cfg.vocab_size
    return 2.0 * weights * slots + 4.0 * slots * cfg.num_heads * cols * hd * cfg.num_layers


@pytest.mark.parametrize("slots,paged,quant", [(2, False, None), (16, True, None),
                                               (2, True, "int8"), (16, True, "int8")])
def test_mixtral_decode_flops_equal_the_routed_count(slots, paged, quant):
    """A Mixtral decode step's metered FLOPs are the routed count: k of E
    experts a token, whether the step runs MX/MXq (the selective route, at
    most 8 slots; its own formula) or the blockwise route's grouped
    products (16 slots; ``torch._grouped_mm``'s formula), plus DQ's one
    operation a weight on the quantized routes that dequantize."""
    from neuronx_distributed_tpu_torch.models.mixtral import (
        MixtralForCausalLM,
        init_params as mixtral_init,
        tiny_mixtral,
    )
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig

    cfg = tiny_mixtral(num_experts=8)
    model = mixtral_init(MixtralForCausalLM(cfg, device="cpu"), seed=0)
    kw = dict(kv_page_size=8, kv_num_pages=64) if paged else {}
    if quant:
        kw["quantize"] = QuantConfig(weights=quant)
    engine = ServingEngine(model, num_slots=slots, decode_chunk_size=4, **kw)
    gcfg = GenerationConfig(max_new_tokens=8, temperature=0.0)
    for i in range(2):
        engine.submit(np.arange(1 + i, 7 + i, dtype=np.int32), gcfg, seed=i)
    engine.run()
    dc = engine.programs.snapshot()["by_program"]["decode_chunk"]
    want = mixtral_decode_step_flops(cfg, slots, cfg.max_seq_len)
    layers = cfg.num_layers
    decode = {"paged_flash_decode" if paged else "flash_decode": layers}
    if quant is None:
        assert dc["flops_per_dispatch"] == want
        assert dc["kernels"] == ({**decode, "moe_experts": layers} if slots <= 8 else decode)
        return
    e, h, i = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    linears = layers * (h * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim_
                        + cfg.num_heads * cfg.head_dim_ * h) + h * cfg.vocab_size
    dq = linears + (layers * 3 * e * h * i if slots > 8 else 0)
    assert dc["flops_per_dispatch"] == want + dq
    n_dq = layers * (4 + (3 if slots > 8 else 0)) + 1
    assert dc["kernels"] == ({**decode, "moe_experts_quantized": layers, "dequantize": n_dq}
                             if slots <= 8 else {**decode, "dequantize": n_dq})


def test_host_reads_same_with_a_shared_ledger_and_instruments(tiny, tmp_path):
    """The host-read budget (JAX ``test_observe_overhead``'s sync parity):
    a fresh request's first token and one read a chunk, the same with the
    default ledger, a shared one, a timeline and a flight directory; the
    streams equal."""
    bare, rb = _run_engine(tiny, flight_recorder=None, prefix_cache=None)
    shared = ProgramLedger()
    inst, ri = _run_engine(tiny, program_ledger=shared, prefix_cache=None,
                           timeline=Timeline(str(tmp_path / "t.json")), flight_dir=str(tmp_path))
    assert bare.host_reads == inst.host_reads == bare.metrics.chunks + 2
    assert [r.tokens for r in rb] == [r.tokens for r in ri]
    assert inst.programs is shared and shared.dispatches("decode_chunk") == \
        inst.metrics.executed_steps


def test_programs_enumeration_reads_no_device(tiny, monkeypatch):
    """programs(), snapshot() and the manifest touch host metadata only."""
    engine, _ = _run_engine(tiny)

    def boom(*a, **k):
        raise AssertionError("enumeration must not read the device")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    infos = engine.programs.programs()
    info = infos["decode_chunk"]
    assert info.dispatches == engine.metrics.executed_steps and info.compiles == 1
    (var,) = info.variants
    assert var.signature and var.captured
    engine.programs.snapshot()
    engine.manifest()


def test_pedigree_captured_per_argument():
    led = ProgramLedger()
    f = led.wrap("mix", lambda x, n, flag, obj: x * n)
    f(torch.ones(4, dtype=torch.bfloat16), 3, True, object())
    (var,) = led.programs()["mix"].variants
    assert var.pedigree == {"args": [
        {"t": "tensor", "shape": [4], "dtype": "bfloat16", "device": "cpu"},
        {"t": "py", "v": 3}, {"t": "py", "v": True}, {"t": "opaque", "type": "object"}],
        "kwargs": {}}


def test_prewarming_scope_routes_dispatch_accounting():
    led = ProgramLedger()
    f = led.wrap("pw", lambda x: x * 2)
    with led.prewarming():
        f(torch.zeros(3))
    info = led.programs()["pw"]
    assert info.dispatches == 0 and info.prewarm_dispatches == 1 and info.compiles == 1
    f(torch.zeros(3))
    info = led.programs()["pw"]
    assert info.dispatches == 1 and info.prewarm_dispatches == 1 and info.compiles == 1


def test_ledger_manifest_entries_replay():
    led = ProgramLedger()
    f = led.wrap("m", lambda x: x + 1)
    f(torch.zeros(2, 2))
    (entry,) = led.manifest().entries("m")
    assert entry["portable"] and entry["signature"]
    args, kwargs = materialize_call(entry["call"])
    assert not kwargs and args[0].shape == (2, 2) and args[0].dtype == torch.float32


def test_weak_reader_lives_in_programs():
    """``UNAVAILABLE`` and ``weak_reader`` moved here; ``hbm`` imports them."""
    assert hbm_weak_reader is weak_reader and HBM_UNAVAILABLE == UNAVAILABLE

    class Box:
        v = 3

    box = Box()
    read = programs_mod.weak_reader(box, lambda b: b.v, -1)
    assert read() == 3
    del box
    assert read() == -1


def test_program_counts_equal_jax_engine():
    """The JAX engine's ledger on the same traffic (JAX's tiny_llama weights
    in both): the programs both engines name dispatch alike (prefill
    buckets, first token, slot write), the JAX decode chunk once a chunk
    where the port's captured step counts a step (one chunk = executed
    steps): JAX's dispatches = the port's chunks. Greedy streams equal."""
    import jax

    from neuronx_distributed_tpu.inference.generate import GenerationConfig as JGenerationConfig
    from neuronx_distributed_tpu.serving import ServingEngine as JServingEngine
    from test_torch_llama import build_pair

    jm, jp, tm = build_pair(seed=1)
    port, preqs = _run_engine(tm, prefix_cache=None)
    jeng = JServingEngine(jm, jp, num_slots=2, decode_chunk_size=4, prefix_cache=None)
    jcfg = JGenerationConfig(max_new_tokens=8, temperature=0.0)
    jreqs = [jeng.submit(np.arange(1 + i, 7 + i, dtype=np.int32), jcfg,
                         key=jax.random.PRNGKey(7 + i)) for i in range(2)]
    jeng.run()
    assert [r.tokens for r in preqs] == [r.tokens for r in jreqs]
    jby = jeng.programs.snapshot(analyze=False)["by_program"]
    pby = port.programs.snapshot()["by_program"]
    for name in ("prefill[8]", "first_token", "slot_write"):
        assert pby[name]["dispatches"] == jby[name]["dispatches"], name
        assert pby[name]["compiles"] == jby[name]["compiles"] == 1, name
    assert jby["decode_chunk"]["dispatches"] == port.metrics.chunks
    assert pby["decode_chunk"]["dispatches"] == port.metrics.executed_steps


def test_engines_leave_no_reference_cycle_through_the_ledger(tiny):
    """A dropped engine is freed by reference counting alone, its ledger,
    metered programs, integrity probe, manifest and prewarm included: a
    cycle would hold its cache (gigabytes on the card) until the cycle
    collector runs."""
    import gc
    import weakref

    gc.collect()
    gc.disable()
    try:
        for kw in (dict(), dict(kv_page_size=8, kv_num_pages=16)):
            e, _ = _run_engine(tiny, prefix_cache=None, **kw)
            e.integrity_fingerprint()
            e2 = ServingEngine(tiny, num_slots=2, decode_chunk_size=4, prefix_cache=None, **kw)
            e2.prewarm(manifest=e.manifest())
            refs = [weakref.ref(e), weakref.ref(e2)]
            del e, e2
            assert [r() for r in refs] == [None, None], kw
    finally:
        gc.enable()
