"""Carry JAX Llama weights across (no JAX counterpart): the flax param tree,
as nested dicts of numpy arrays, becomes the port's state dict.

Flax ``kernel`` leaves are ``(in, out)``; torch ``weight`` is ``(out, in)``.
Both layer layouts of the JAX model are read: unscanned ``layers_<i>`` and
``scan_layers=True``'s ``layers/layer/...`` with a leading layer axis
(``llama.py:373-383``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from neuronx_distributed_tpu_torch.models.llama import LlamaConfig

# per-layer flax path (below the layer node) -> port name (below the layer)
_LAYER_LEAVES = {
    ("input_norm", "weight"): "input_norm.weight",
    ("attn", "qkv", "q_proj", "kernel"): "attn.qkv.q_proj.weight",
    ("attn", "qkv", "k_proj", "kernel"): "attn.qkv.k_proj.weight",
    ("attn", "qkv", "v_proj", "kernel"): "attn.qkv.v_proj.weight",
    ("attn", "o_proj", "kernel"): "attn.o_proj.weight",
    ("post_attn_norm", "weight"): "post_attn_norm.weight",
    ("mlp", "gate_proj", "kernel"): "mlp.gate_proj.weight",
    ("mlp", "up_proj", "kernel"): "mlp.up_proj.weight",
    ("mlp", "down_proj", "kernel"): "mlp.down_proj.weight",
}


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _tensor(arr: np.ndarray, kernel: bool) -> torch.Tensor:
    arr = np.asarray(arr, dtype=np.float32)
    return torch.from_numpy(np.array(arr.T if kernel else arr, order="C"))


def flax_to_torch(params_np, config: LlamaConfig) -> Dict[str, torch.Tensor]:
    """State dict (fp32 CPU tensors) for ``LlamaForCausalLM(config)`` from
    the JAX ``LlamaForCausalLM`` params (``{"params": ...}`` or the inner
    tree). ``load_state_dict`` then casts each weight to its stored dtype —
    the same rounding as the JAX ``astype`` before use."""
    tree = params_np.get("params", params_np)
    mdl = tree["model"]
    sd = {
        "model.embed.weight": _tensor(_leaf(mdl, ("embed", "embedding")), False),
        "model.final_norm.weight": _tensor(_leaf(mdl, ("final_norm", "weight")), False),
        "lm_head.weight": _tensor(_leaf(tree, ("lm_head", "kernel")), True),
    }
    scanned = "layers" in mdl
    for i in range(config.num_layers):
        for path, name in _LAYER_LEAVES.items():
            if scanned:
                arr = _leaf(mdl, ("layers", "layer") + path)[i]
            else:
                arr = _leaf(mdl, (f"layers_{i}",) + path)
            sd[f"model.layers.{i}.{name}"] = _tensor(arr, path[-1] == "kernel")
    return sd
