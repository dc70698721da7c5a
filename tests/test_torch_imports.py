"""The port stands alone: no module of ``neuronx_distributed_tpu_torch`` (nor
``chip_smoke.py`` or ``chip_bwd_ab.py``) imports JAX, flax or the JAX
package; its entry points never drift to the CPU; and only the kernel
wrappers choose the plain versions, on CPU tensors alone."""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import neuronx_distributed_tpu_torch as port
from neuronx_distributed_tpu_torch.kernels import dequantize as tdq
from neuronx_distributed_tpu_torch.kernels import flash_attention as tfa
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd
from neuronx_distributed_tpu_torch.kernels import kv_quant as tkq
from neuronx_distributed_tpu_torch.kernels import page_fingerprint as tpf
from neuronx_distributed_tpu_torch.kernels import moe_experts as tmx
from neuronx_distributed_tpu_torch.models import llama as tllama
from neuronx_distributed_tpu_torch.models import mixtral as tmixtral
from neuronx_distributed_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(port.__file__)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "neuronx_distributed_tpu")


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG], prefix="neuronx_distributed_tpu_torch.")
    )


def _sources():
    out = [os.path.join(ROOT, name) for name in ("chip_smoke.py", "chip_bwd_ab.py",
                                                 "chip_decode_ab.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(name: str) -> bool:
    """Whole-module-name match: ``neuronx_distributed_tpu_torch`` is not
    ``neuronx_distributed_tpu``."""
    return name.split(".")[0] in FORBIDDEN


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad, bad
    assert _forbidden("neuronx_distributed_tpu.models") and not _forbidden(
        "neuronx_distributed_tpu_torch.models")


def test_every_module_imports_and_runs_with_jax_blocked():
    """A fresh interpreter where importing JAX, flax or the JAX package
    fails: every port module (the Medusa modules among them) imports, and a
    tiny CPU model generates, serves and decodes with Medusa heads."""
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None   # any import of these now raises
        import numpy as np, torch
        for m in {_port_modules()!r}:
            importlib.import_module(m)
        from neuronx_distributed_tpu_torch.models.llama import (
            LlamaForCausalLM, init_params, tiny_llama)
        from neuronx_distributed_tpu_torch.inference.generate import (
            GenerationConfig, generate)
        from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
        model = init_params(LlamaForCausalLM(tiny_llama(), device="cpu"), seed=0)
        cfg = GenerationConfig(max_new_tokens=5, temperature=0.0)
        solo = generate(model, np.array([[3, 4, 5]]), cfg)[0].tolist()
        engine = ServingEngine(model, num_slots=2, decode_chunk_size=2)
        req = engine.submit([3, 4, 5], cfg)
        engine.run()
        assert req.tokens == solo, (req.tokens, solo)
        paged = ServingEngine(model, num_slots=2, decode_chunk_size=2, kv_page_size=8,
                              kv_num_pages=5)
        req = paged.submit([3, 4, 5], cfg)
        paged.run()
        paged.cache.check()
        assert req.tokens == solo, (req.tokens, solo)
        from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
        inj = FaultInjector().fail_dispatch(at=1).poison_readback(at=1, slot=0)
        chaos = ServingEngine(model, num_slots=2, decode_chunk_size=2, kv_page_size=8,
                              fault_injector=inj, sleep_fn=lambda s: None)
        req = chaos.submit([3, 4, 5], cfg)
        chaos.run()
        chaos.cache.check()
        assert req.tokens == solo and chaos.metrics.recoveries == 1, req.tokens
        assert chaos.metrics.quarantines == 1 and chaos.flight.events()
        tiered = ServingEngine(model, num_slots=1, decode_chunk_size=2, kv_page_size=8,
                               kv_num_pages=3, kv_host_pages=4)
        for start in (3, 20, 3):  # two prefixes through a pool of two pages
            req = tiered.submit(list(range(start, start + 8)) + [1], cfg)
            tiered.run()
        tiered.cache.check()
        tiered.tier.check()
        snap = tiered.metrics.snapshot()
        assert snap["kv_pages_spilled"] >= 1 and snap["prefix_hit_tier"] == dict(host=1), snap
        assert tiered.hbm.snapshot()["residents"]["kv_host_pages"]["tier"] == "host"
        from neuronx_distributed_tpu_torch.observability.registry import MetricsRegistry
        from neuronx_distributed_tpu_torch.observability.slo import SLOSpec
        from neuronx_distributed_tpu_torch.serving.traffic import (
            TenantProfile, VirtualClock, generate_tape, replay)
        from neuronx_distributed_tpu_torch.utils.timeline import Timeline
        clock = VirtualClock()
        slo = ServingEngine(model, num_slots=2, decode_chunk_size=2, scheduling="slo",
                            registry=MetricsRegistry(), engine_label="slo", time_fn=clock,
                            slo=SLOSpec(ttft_p99_s=1.0), timeline=Timeline(None))
        tape = generate_tape([TenantProfile("chat", rate_rps=4.0)], 1.0, seed=0,
                             vocab_size=256)
        report = replay(slo, tape, clock, step_dt=0.05)
        assert report["completed"] == len(tape) > 0, report
        assert "serving_steps" in slo.metrics.registry.prometheus_text()
        from neuronx_distributed_tpu_torch.models.mixtral import (
            MixtralForCausalLM, init_params as mixtral_init, tiny_mixtral)
        from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
        moe = mixtral_init(MixtralForCausalLM(tiny_mixtral(num_experts=8), device="cpu"), seed=0)
        moe_solo = generate(moe, np.array([[3, 4, 5]]), cfg)[0].tolist()
        for kw in (dict(num_slots=2), dict(num_slots=16, kv_page_size=8),
                   dict(num_slots=2, kv_page_size=8, quantize=QuantConfig(weights="int8"))):
            moe_engine = ServingEngine(moe, decode_chunk_size=2, **kw)
            req = moe_engine.submit([3, 4, 5], cfg)
            moe_engine.run()
            if "quantize" not in kw:
                assert req.tokens == moe_solo, (kw, req.tokens, moe_solo)
        from neuronx_distributed_tpu_torch.models import (
            CodeGenForCausalLM, DbrxForCausalLM, GPTNeoXForCausalLM, tiny_codegen, tiny_dbrx,
            tiny_gpt_neox)
        from neuronx_distributed_tpu_torch.models.gpt_neox import init_params as family_init
        for fam in (GPTNeoXForCausalLM(tiny_gpt_neox(hidden_size=192, num_heads=2), device="cpu"),
                    CodeGenForCausalLM(tiny_codegen(), device="cpu"),
                    DbrxForCausalLM(tiny_dbrx(), device="cpu")):
            family_init(fam, seed=0)
            fam_solo = generate(fam, np.array([[3, 4, 5]]), cfg)[0].tolist()
            for kw in (dict(), dict(kv_page_size=8, kv_num_pages=9)):
                fam_engine = ServingEngine(fam, num_slots=2, decode_chunk_size=2, **kw)
                req = fam_engine.submit([3, 4, 5], cfg)
                fam_engine.run()
                assert req.tokens == fam_solo, (type(fam).__name__, kw, req.tokens, fam_solo)
        from neuronx_distributed_tpu_torch.inference.medusa import medusa_generate
        from neuronx_distributed_tpu_torch.models.medusa import (
            MedusaForCausalLM, init_medusa_heads)
        medusa = init_medusa_heads(MedusaForCausalLM(tiny_llama(), 3, base=model), seed=1)
        toks, _ = medusa_generate(medusa, np.array([[3, 4, 5]]), 5)
        assert toks[0].tolist() == solo, (toks, solo)
        import tempfile
        from neuronx_distributed_tpu_torch.integrity import SentinelConfig
        from neuronx_distributed_tpu_torch.trainer import CheckpointCallback, Trainer
        from neuronx_distributed_tpu_torch.trainer.data import SyntheticTokens
        with tempfile.TemporaryDirectory() as d:
            tmodel = LlamaForCausalLM(tiny_llama(num_layers=2), device="cpu", trainable=True)
            tr = Trainer(model=tmodel, integrity=SentinelConfig(check_every=2),
                         callbacks=[CheckpointCallback(d, every=2)])
            tr.fit(SyntheticTokens(256, 2, 8, seed=0), 0, max_steps=4)
            resumed = Trainer(model=tmodel)
            resumed.fit(SyntheticTokens(256, 2, 8, seed=0), 1, max_steps=5, resume_from=d)
            assert resumed.steps_run == 1 and tr._sentinel.counters["integrity_checks"] == 2
        assert not any(k.split(".")[0] in {FORBIDDEN!r} and sys.modules[k] is not None
                       for k in sys.modules)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]
    assert {"neuronx_distributed_tpu_torch.models.medusa", "neuronx_distributed_tpu_torch.utils.medusa",
            "neuronx_distributed_tpu_torch.inference.medusa", "neuronx_distributed_tpu_torch.utils.retry",
            "neuronx_distributed_tpu_torch.observability.flight_recorder",
            "neuronx_distributed_tpu_torch.serving.faults",
            "neuronx_distributed_tpu_torch.kernels.page_fingerprint",
            "neuronx_distributed_tpu_torch.observability.registry",
            "neuronx_distributed_tpu_torch.observability.slo",
            "neuronx_distributed_tpu_torch.observability.tracing",
            "neuronx_distributed_tpu_torch.utils.timeline",
            "neuronx_distributed_tpu_torch.serving.sched",
            "neuronx_distributed_tpu_torch.serving.sched.policy",
            "neuronx_distributed_tpu_torch.serving.sched.priority",
            "neuronx_distributed_tpu_torch.serving.sched.fairness",
            "neuronx_distributed_tpu_torch.serving.sched.feedback",
            "neuronx_distributed_tpu_torch.serving.traffic",
            "neuronx_distributed_tpu_torch.serving.tiering",
            "neuronx_distributed_tpu_torch.serving.transport",
            "neuronx_distributed_tpu_torch.serving.router",
            "neuronx_distributed_tpu_torch.serving.disagg",
            "neuronx_distributed_tpu_torch.observability.hbm",
            "neuronx_distributed_tpu_torch.observability.programs",
            "neuronx_distributed_tpu_torch.observability.profiler",
            "neuronx_distributed_tpu_torch.inference.aot",
            "neuronx_distributed_tpu_torch.integrity",
            "neuronx_distributed_tpu_torch.integrity.voting",
            "neuronx_distributed_tpu_torch.integrity.chaos",
            "neuronx_distributed_tpu_torch.kernels.tree_fingerprint",
            "neuronx_distributed_tpu_torch.trainer.loop",
            "neuronx_distributed_tpu_torch.trainer.checkpoint",
            "neuronx_distributed_tpu_torch.trainer.faults",
            "neuronx_distributed_tpu_torch.integrity.sentinel",
            "neuronx_distributed_tpu_torch.integrity.checkpoint",
            "neuronx_distributed_tpu_torch.observability.callback",
            "neuronx_distributed_tpu_torch.models.mixtral",
            "neuronx_distributed_tpu_torch.models.gpt_neox",
            "neuronx_distributed_tpu_torch.models.codegen",
            "neuronx_distributed_tpu_torch.models.dbrx",
            "neuronx_distributed_tpu_torch.modules.layer_norm",
            "neuronx_distributed_tpu_torch.modules.moe",
            "neuronx_distributed_tpu_torch.modules.moe.routing",
            "neuronx_distributed_tpu_torch.modules.moe.expert_mlps",
            "neuronx_distributed_tpu_torch.modules.moe.model",
            "neuronx_distributed_tpu_torch.modules.moe.loss_function",
            "neuronx_distributed_tpu_torch.modules.moe.token_shuffling",
            "neuronx_distributed_tpu_torch.modules.moe.moe_parallel_layers",
            "neuronx_distributed_tpu_torch.kernels.moe_experts"} <= set(_port_modules())


def test_slo_serving_pieces_are_the_ports_own():
    """The registry, the SLO tracker, the tracer, the timeline, the
    scheduling policies and the traffic replay are the port's own classes
    (the JAX package's jax-free modules are not imported)."""
    from neuronx_distributed_tpu_torch.observability import registry, slo, tracing
    from neuronx_distributed_tpu_torch.serving import sched, traffic
    from neuronx_distributed_tpu_torch.utils import timeline

    for obj in (registry.MetricsRegistry, registry.Histogram, slo.SLOTracker, slo.SLOSpec,
                tracing.RequestTracer, timeline.Timeline, sched.SloPolicy, sched.FifoPolicy,
                sched.DeficitRoundRobin, traffic.TenantProfile, traffic.VirtualClock):
        assert obj.__module__.startswith("neuronx_distributed_tpu_torch."), obj


def test_fault_contract_pieces_are_the_ports_own():
    """The port keeps its own RetryPolicy, FlightRecorder, FaultInjector
    and fingerprint constants (the JAX package's values), defined in its
    modules and importing nothing of the JAX package."""
    from neuronx_distributed_tpu_torch.observability.flight_recorder import FlightRecorder
    from neuronx_distributed_tpu_torch.serving.faults import FaultInjector, InjectedFault
    from neuronx_distributed_tpu_torch.utils import fingerprint
    from neuronx_distributed_tpu_torch.utils.retry import RetryPolicy

    from neuronx_distributed_tpu_torch.observability.hbm import HBMLedger, weak_reader
    from neuronx_distributed_tpu_torch.serving.tiering import HostPageStore

    for obj in (FlightRecorder, FaultInjector, InjectedFault, RetryPolicy, HBMLedger,
                weak_reader, HostPageStore, fingerprint.page_fingerprint):
        assert obj.__module__.startswith("neuronx_distributed_tpu_torch."), obj
    assert (fingerprint.FINGERPRINT_SEED, fingerprint.FINGERPRINT_PRIME) == (0x9E3779B9, 0x01000193)


def test_entry_points_raise_without_a_device(monkeypatch):
    from neuronx_distributed_tpu_torch.trainer import init_anomaly_guard_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_anomaly_guard_state()  # the guard carry defaults to the card
    assert init_anomaly_guard_state(device="cpu")["skips"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.LlamaForCausalLM(tllama.tiny_llama())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tllama.LlamaForCausalLM(tllama.tiny_llama(), device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmixtral.MixtralForCausalLM(tmixtral.tiny_mixtral())
    from neuronx_distributed_tpu_torch import models

    for cls, preset in ((models.GPTNeoXForCausalLM, models.tiny_gpt_neox),
                        (models.CodeGenForCausalLM, models.tiny_codegen),
                        (models.DbrxForCausalLM, models.tiny_dbrx)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(preset())
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_take_plain_path_only_for_cpu_tensors():
    q = torch.randn(1, 4, 2, 8)
    k = torch.randn(1, 4, 1, 8)
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_dkdv, tfa.flash_attention_dq,
                tfd.flash_decode_fwd, tfd.paged_flash_decode_fwd, tfd.qpaged_flash_decode_fwd,
                tfd.qpaged_write_attend_fwd, tdq.dequantize_fwd, tkq.window_requantize_fwd, tpf.pool_pages_fingerprint_fwd,
                tmx.moe_experts, tmx.moe_experts_quantized)
    before = [f.launches for f in counters]
    out, lse = tfa.flash_attention_fwd(q, k, k)
    delta = (out * q).sum(-1).transpose(1, 2)
    tfa.flash_attention_dkdv(q, k, k, q, lse, delta)
    tfa.flash_attention_dq(q, k, k, q, lse, delta)
    tfd.flash_decode_fwd(q[:, :1], k, k, torch.tensor([3]))
    tfd.paged_flash_decode_fwd(q[:, :1], k.reshape(2, 2, 1, 8), k.reshape(2, 2, 1, 8),
                               torch.tensor([[1, 0]], dtype=torch.int32), torch.tensor([1]),
                               page_size=2)
    kq, ks = tfd.quantize_page_block(k.reshape(2, 2, 1, 8))
    tfd.paged_flash_decode_fwd(q[:, :1], kq, kq, torch.tensor([[1, 0]], dtype=torch.int32),
                               torch.tensor([1]), page_size=2, k_scale=ks, v_scale=ks)
    tdq.dequantize_fwd(torch.ones(4, 16, dtype=torch.int8), torch.ones(4), torch.float32)
    kq, ks = kq.clone(), ks.clone()
    tkq.window_requantize_fwd(kq, kq.clone(), ks, ks.clone(), torch.tensor([[1]]),
                              torch.tensor([0]), k[:, :1].reshape(1, 1, 1, 8),
                              k[:, 1:2].reshape(1, 1, 1, 8))
    tfd.qpaged_write_attend_fwd(q[:, :1], k[:, :1], k[:, 1:2], kq, kq.clone(), ks, ks.clone(),
                                torch.tensor([[1, 0]], dtype=torch.int32), torch.tensor([1]),
                                None, torch.tensor([1]), 2)
    tpf.pool_pages_fingerprint_fwd([k[None]], torch.tensor([0]), (0,))
    x, top_e, top_w = torch.randn(2, 16), torch.tensor([[0, 1], [1, 2]]), torch.rand(2, 2)
    stacks = [torch.randn(3, 16, 16) for _ in range(3)]
    tmx.moe_experts(x, top_e, top_w, *stacks)
    codes = [torch.ones(3, 16, 16, dtype=torch.int8) for _ in range(3)]
    tmx.moe_experts_quantized(x, top_e, top_w, *codes, *[torch.ones(3, 16) for _ in range(3)])
    assert [f.launches for f in counters] == before
    # the plain versions are called from their own wrappers and nowhere else
    # in the package (chip_smoke.py calls them only to check the kernels)
    for path in _sources():
        if os.path.basename(path) in ("chip_smoke.py", "flash_attention.py", "flash_decode.py",
                                      "dequantize.py", "kv_quant.py", "page_fingerprint.py",
                                      "moe_experts.py"):
            continue
        with open(path) as f:
            src = f.read()
        for plain in ("flash_attention_plain", "flash_attention_dkdv_plain",
                      "flash_attention_dq_plain", "flash_decode_plain",
                      "paged_flash_decode_plain", "paged_flash_decode_plain_q",
                      "qpaged_write_attend_plain",
                      "dequantize_plain", "window_requantize_plain",
                      "pool_pages_fingerprint_plain", "moe_experts_plain"):
            assert plain not in src, (path, plain)
    # and no fallback: the kernel wrappers hold no try/except
    for mod in (tfa, tfd, tdq, tkq, tpf, tmx):
        tree = ast.parse(open(mod.__file__).read())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), mod.__file__
