"""Carry JAX Llama, Medusa, Mixtral, GPT-NeoX, CodeGen and DBRX weights
across (no JAX counterpart): the flax param tree, as nested dicts of numpy
arrays, becomes the port's state dict.

Flax ``kernel`` leaves are ``(in, out)``; torch ``weight`` is ``(out, in)``.
Both layer layouts of the JAX model are read: unscanned ``layers_<i>`` and
``scan_layers=True``'s ``layers/layer/...`` with a leading layer axis
(``llama.py:373-383``). A quantized tree (``quantize_param_tree``'s output:
an int8/fp8 ``kernel`` with a ``scale`` beside it) keeps its codes, bit for
bit, as the weight of a model built with the same ``quantization`` config;
its ``(1, out)`` scale becomes ``(out,)`` (a per-tensor scale stays a
scalar). A Mixtral's expert stacks ``moe/experts/{gate,up,down}_proj``
``(E, in, out)`` become ``(E, out, in)``, their ``<name>_scale`` ``(E, 1,
out)`` becomes ``(E, out)`` (per tensor ``(E,)`` stays), and the router
``moe/router/weight`` ``(H, E)`` becomes ``(E, H)``. The GPT-style
families' LayerNorms (``<norm>/ln/{scale,bias}``) become ``<norm>.weight``
and ``.bias``, a linear's ``bias`` its ``.bias``; their layers
(``layers_<i>``, CodeGen's and DBRX's ``blocks_<i>``) become
``model.layers.<i>``, and the top-level ``embed``/``final_norm`` move
under ``model.``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from neuronx_distributed_tpu_torch.models.llama import LlamaConfig

# per-layer flax path (below the layer node) -> port name (below the layer):
# the norms and attention every family shares, then Llama's dense MLP
_ATTN_LEAVES = {
    ("input_norm", "weight"): "input_norm.weight",
    ("attn", "qkv", "q_proj", "kernel"): "attn.qkv.q_proj.weight",
    ("attn", "qkv", "k_proj", "kernel"): "attn.qkv.k_proj.weight",
    ("attn", "qkv", "v_proj", "kernel"): "attn.qkv.v_proj.weight",
    ("attn", "o_proj", "kernel"): "attn.o_proj.weight",
    ("post_attn_norm", "weight"): "post_attn_norm.weight",
}
_LAYER_LEAVES = {
    **_ATTN_LEAVES,
    ("mlp", "gate_proj", "kernel"): "mlp.gate_proj.weight",
    ("mlp", "up_proj", "kernel"): "mlp.up_proj.weight",
    ("mlp", "down_proj", "kernel"): "mlp.down_proj.weight",
}
_EXPERT_LEAVES = ("gate_proj", "up_proj", "down_proj")


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _tensor(arr: np.ndarray, kernel: bool) -> torch.Tensor:
    arr = np.asarray(arr, dtype=np.float32)
    return torch.from_numpy(np.array(np.swapaxes(arr, -1, -2) if kernel else arr, order="C"))


def _codes(arr: np.ndarray) -> torch.Tensor:
    """An int8 or fp8 e4m3 kernel (..., in, out) as the port's (..., out,
    in) codes, bit for bit (numpy has no fp8: its bytes cross as uint8)."""
    arr = np.ascontiguousarray(np.swapaxes(np.asarray(arr), -1, -2))
    if arr.dtype == np.int8:
        return torch.from_numpy(arr)
    if arr.dtype.name != "float8_e4m3fn":
        raise TypeError(f"quantized kernel of dtype {arr.dtype}")
    return torch.from_numpy(arr.view(np.uint8)).view(torch.float8_e4m3fn)


def _linear_entries(node, name: str, index=None) -> Dict[str, torch.Tensor]:
    """The port's entries of one flax linear ``node`` (``{"kernel"}``, or
    ``{"kernel", "scale"}`` when quantized) under ``name`` (``...weight``);
    ``index`` picks a layer of a scanned stack."""
    def leaf(key):
        arr = np.asarray(node[key])
        return arr if index is None else arr[index]

    bias = {}
    if "bias" in node:
        bias = {name[: -len("weight")] + "bias": _tensor(leaf("bias"), False)}
    if "scale" not in node:
        return {name: _tensor(leaf("kernel"), True), **bias}
    scale = np.asarray(leaf("scale"), dtype=np.float32)
    return {name: _codes(leaf("kernel")),
            name[: -len("weight")] + "scale": torch.from_numpy(
                np.array(scale.reshape(-1) if scale.ndim else scale)), **bias}


def flax_to_torch(params_np, config: LlamaConfig) -> Dict[str, torch.Tensor]:
    """State dict (fp32 CPU tensors, quantized codes and f32 scales for a
    quantized tree) for ``LlamaForCausalLM(config)`` from the JAX
    ``LlamaForCausalLM`` params (``{"params": ...}`` or the inner tree). ``load_state_dict`` then casts each weight to its stored dtype —
    the same rounding as the JAX ``astype`` before use."""
    tree = params_np.get("params", params_np)
    mdl = tree["model"]
    sd = _base_entries(tree)
    for i, layer, index in _layers(mdl, config.num_layers):
        sd.update(_layer_entries(layer, i, index, _LAYER_LEAVES))
    return sd


def _base_entries(tree) -> Dict[str, torch.Tensor]:
    """The embedding, the final norm and lm_head."""
    mdl = tree["model"]
    return {
        "model.embed.weight": _tensor(_leaf(mdl, ("embed", "embedding")), False),
        "model.final_norm.weight": _tensor(_leaf(mdl, ("final_norm", "weight")), False),
        **_linear_entries(tree["lm_head"], "lm_head.weight"),
    }


def _layers(mdl, num_layers: int):
    """``(i, layer node, index)`` of each layer: unscanned ``layers_<i>``
    (index None) or ``scan_layers=True``'s ``layers/layer`` (index i)."""
    scanned = "layers" in mdl
    for i in range(num_layers):
        yield (i, mdl["layers"]["layer"], i) if scanned else (i, mdl[f"layers_{i}"], None)


def _layer_entries(layer, i: int, index, leaves) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, name in leaves.items():
        if path[-1] == "kernel":
            node = layer
            for key in path[:-1]:
                node = node[key]
            sd.update(_linear_entries(node, f"model.layers.{i}.{name}", index))
        else:
            arr = _leaf(layer, path)
            sd[f"model.layers.{i}.{name}"] = _tensor(arr if index is None else arr[index], False)
    return sd


def _stack_entries(node, key: str, name: str, index=None) -> Dict[str, torch.Tensor]:
    """The port's entries of one expert stack ``node[key]`` (E, in, out),
    and of its ``<key>_scale`` when quantized, under ``name``."""
    def leaf(k):
        arr = np.asarray(node[k])
        return arr if index is None else arr[index]

    if key + "_scale" not in node:
        return {name: _tensor(leaf(key), True)}
    scale = np.asarray(leaf(key + "_scale"), dtype=np.float32)
    scale = scale[:, 0, :] if scale.ndim == 3 else scale  # (E, 1, out) -> (E, out)
    return {name: _codes(leaf(key)), name + "_scale": torch.from_numpy(np.array(scale))}


def mixtral_flax_to_torch(params_np, config) -> Dict[str, torch.Tensor]:
    """State dict for ``MixtralForCausalLM(config)`` from the JAX
    ``MixtralForCausalLM`` params (either layer layout; a quantized tree's
    codes bit for bit, as :func:`flax_to_torch`). fp32 CPU tensors, which
    ``load_state_dict`` casts to the stored dtype (a trainable model's fp32
    masters take them as they are); a JAX gradient tree of the same params
    maps leaf by leaf onto the port's ``.grad`` names."""
    tree = params_np.get("params", params_np)
    sd = _base_entries(tree)
    for i, layer, index in _layers(tree["model"], config.num_layers):
        sd.update(_layer_entries(layer, i, index, _ATTN_LEAVES))
        router = _leaf(layer, ("moe", "router", "weight"))
        sd[f"model.layers.{i}.moe.router.weight"] = _tensor(
            router if index is None else router[index], True)
        experts = layer["moe"]["experts"]
        for key in _EXPERT_LEAVES:
            sd.update(_stack_entries(experts, key, f"model.layers.{i}.moe.experts.{key}", index))
    return sd


def medusa_flax_to_torch(params_np, config: LlamaConfig,
                         num_medusa_heads: int) -> Dict[str, torch.Tensor]:
    """State dict for ``MedusaForCausalLM(config, num_medusa_heads)`` from
    the JAX ``MedusaForCausalLM`` params: the base tree under ``model`` and
    ``lm_head`` (either layer layout, :func:`flax_to_torch`), then each
    head's ``medusa_{i}/proj/{kernel,bias}`` and ``medusa_head_{i}/kernel``."""
    tree = params_np.get("params", params_np)
    sd = flax_to_torch(tree, config)
    for i in range(num_medusa_heads):
        sd[f"medusa_{i}.proj.weight"] = _tensor(_leaf(tree, (f"medusa_{i}", "proj", "kernel")),
                                                True)
        sd[f"medusa_{i}.proj.bias"] = _tensor(_leaf(tree, (f"medusa_{i}", "proj", "bias")),
                                              False)
        sd[f"medusa_head_{i}.weight"] = _tensor(_leaf(tree, (f"medusa_head_{i}", "kernel")),
                                                True)
    return sd


def _ln_entries(node, name: str) -> Dict[str, torch.Tensor]:
    """A flax ``LayerNorm`` node (``{"ln": {"scale"[, "bias"]}}``) as the
    port's ``<name>.weight`` (and ``.bias``)."""
    ln = node["ln"]
    out = {f"{name}.weight": _tensor(_leaf(ln, ("scale",)), False)}
    if "bias" in ln:
        out[f"{name}.bias"] = _tensor(_leaf(ln, ("bias",)), False)
    return out


def _gpt_entries(tree, layer_key: str, num_layers: int, per_layer) -> Dict[str, torch.Tensor]:
    """The flat trees of the GPT-style families (embed, ``<layer_key>_<i>``,
    final_norm, lm_head at the top): ``per_layer(node, prefix)`` gives each
    layer's entries."""
    tree = tree.get("params", tree)
    sd = {"model.embed.weight": _tensor(_leaf(tree, ("embed", "embedding")), False),
          **_ln_entries(tree["final_norm"], "model.final_norm"),
          **_linear_entries(tree["lm_head"], "lm_head.weight")}
    for i in range(num_layers):
        sd.update(per_layer(tree[f"{layer_key}_{i}"], f"model.layers.{i}"))
    return sd


def _attn_mlp_entries(node, prefix: str, norms) -> Dict[str, torch.Tensor]:
    """``ParallelSelfAttention`` (``attn/qkv/{q,k,v}_proj``, ``attn/o_proj``),
    ``ParallelMLP`` (``mlp/{up,down}``) and the LayerNorms ``norms``."""
    sd = {}
    for norm in norms:
        sd.update(_ln_entries(node[norm], f"{prefix}.{norm}"))
    for proj in ("q_proj", "k_proj", "v_proj"):
        sd.update(_linear_entries(node["attn"]["qkv"][proj], f"{prefix}.attn.qkv.{proj}.weight"))
    sd.update(_linear_entries(node["attn"]["o_proj"], f"{prefix}.attn.o_proj.weight"))
    for proj in ("up", "down"):
        sd.update(_linear_entries(node["mlp"][proj], f"{prefix}.mlp.{proj}.weight"))
    return sd


def gpt_neox_flax_to_torch(params_np, config) -> Dict[str, torch.Tensor]:
    """State dict for ``GPTNeoXForCausalLM(config)`` from the JAX
    ``GPTNeoXForCausalLM`` params (fp32 CPU tensors, which
    ``load_state_dict`` casts to the stored dtype)."""
    return _gpt_entries(params_np, "layers", config.num_layers,
                        lambda node, p: _attn_mlp_entries(node, p, ("input_norm", "post_attn_norm")))


def codegen_flax_to_torch(params_np, config) -> Dict[str, torch.Tensor]:
    """State dict for ``CodeGenForCausalLM(config)`` from the JAX
    ``CodeGenForCausalLM`` params (``blocks_<i>``; lm_head's bias too)."""
    return _gpt_entries(params_np, "blocks", config.num_layers,
                        lambda node, p: _attn_mlp_entries(node, p, ("input_norm",)))


def dbrx_flax_to_torch(params_np, config) -> Dict[str, torch.Tensor]:
    """State dict for ``DbrxForCausalLM(config)`` from the JAX
    ``DbrxForCausalLM`` params (``blocks_<i>``; a quantized tree's codes bit
    for bit, as :func:`mixtral_flax_to_torch`)."""
    def block(node, p):
        sd = {**_ln_entries(node["norm_1"], f"{p}.norm_1"),
              **_ln_entries(node["norm_2"], f"{p}.norm_2")}
        for proj in ("q_proj", "k_proj", "v_proj"):
            sd.update(_linear_entries(node["attn"]["qkv"][proj], f"{p}.attn.qkv.{proj}.weight"))
        sd.update(_linear_entries(node["attn"]["o_proj"], f"{p}.attn.o_proj.weight"))
        sd[f"{p}.moe.router.weight"] = _tensor(_leaf(node, ("moe", "router", "weight")), True)
        for key in _EXPERT_LEAVES:
            sd.update(_stack_entries(node["moe"]["experts"], key, f"{p}.moe.experts.{key}"))
        return sd

    return _gpt_entries(params_np, "blocks", config.num_layers, block)
