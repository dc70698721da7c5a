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
from neuronx_distributed_tpu_torch.kernels import flash_attention as tfa
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd
from neuronx_distributed_tpu_torch.models import llama as tllama
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
    fails: every port module imports, and a tiny CPU model generates and
    serves."""
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
        assert not any(k.split(".")[0] in {FORBIDDEN!r} and sys.modules[k] is not None
                       for k in sys.modules)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


def test_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.LlamaForCausalLM(tllama.tiny_llama())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tllama.LlamaForCausalLM(tllama.tiny_llama(), device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_take_plain_path_only_for_cpu_tensors():
    q = torch.randn(1, 4, 2, 8)
    k = torch.randn(1, 4, 1, 8)
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_dkdv, tfa.flash_attention_dq,
                tfd.flash_decode_fwd, tfd.paged_flash_decode_fwd)
    before = [f.launches for f in counters]
    out, lse = tfa.flash_attention_fwd(q, k, k)
    delta = (out * q).sum(-1).transpose(1, 2)
    tfa.flash_attention_dkdv(q, k, k, q, lse, delta)
    tfa.flash_attention_dq(q, k, k, q, lse, delta)
    tfd.flash_decode_fwd(q[:, :1], k, k, torch.tensor([3]))
    tfd.paged_flash_decode_fwd(q[:, :1], k.reshape(2, 2, 1, 8), k.reshape(2, 2, 1, 8),
                               torch.tensor([[1, 0]], dtype=torch.int32), torch.tensor([1]),
                               page_size=2)
    assert [f.launches for f in counters] == before
    # the plain versions are called from their own wrappers and nowhere else
    # in the package (chip_smoke.py calls them only to check the kernels)
    for path in _sources():
        if os.path.basename(path) in ("chip_smoke.py", "flash_attention.py", "flash_decode.py"):
            continue
        with open(path) as f:
            src = f.read()
        for plain in ("flash_attention_plain", "flash_attention_dkdv_plain",
                      "flash_attention_dq_plain", "flash_decode_plain",
                      "paged_flash_decode_plain"):
            assert plain not in src, (path, plain)
    # and no fallback: the kernel wrappers hold no try/except
    for mod in (tfa, tfd):
        tree = ast.parse(open(mod.__file__).read())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), mod.__file__
