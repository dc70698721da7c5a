"""Quantize and dequantize primitives (counterpart of
``neuronx_distributed_tpu/quantization/utils.py``).

The port's weights are torch's ``(out, in)``, flax's kernels ``(in, out)``:
a per-channel scale reduces the contraction dim either way, so it has one
entry per output channel. ``jnp.round`` and ``torch.round`` both round half
to even, and both frameworks cast f32 to fp8 e4m3 to nearest even, so the
codes here equal ``quantize_param_tree``'s bit for bit. JAX's
``dequantize`` (``utils.py:120``) is ``kernels/dequantize.py``'s plain
version.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from neuronx_distributed_tpu_torch.quantization.config import (
    QuantizationConfig,
    QuantizationType,
)


def absmax_scale(w: torch.Tensor, cfg: QuantizationConfig) -> torch.Tensor:
    """Symmetric abs-max scale (JAX ``absmax_scale``, ``utils.py:84``) of a
    weight ``(out, in)``: a scalar per tensor, or ``(out, 1)`` per output
    channel (every other dim reduced), in f32."""
    w = w.to(torch.float32).abs()
    if cfg.quantization_type == QuantizationType.PER_TENSOR_SYMMETRIC:
        amax = w.amax()
    else:
        amax = w.amax(dim=tuple(range(1, w.dim())), keepdim=True)
    return amax.clamp_min(1e-12) / cfg.quantized_dtype.max_value


def direct_cast_quantize(w: torch.Tensor, cfg: QuantizationConfig,
                         scale: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` of a float weight (JAX ``direct_cast_quantize``,
    ``utils.py:101``): ``w / scale`` clipped to the dtype's bound, rounded
    half to even for int8, cast to nearest for fp8."""
    if scale is None:
        scale = absmax_scale(w, cfg)
    qmax = cfg.quantized_dtype.max_value
    scaled = (w.to(torch.float32) / scale).clamp(-qmax, qmax)
    dt = cfg.quantized_dtype.torch_dtype
    q = torch.round(scaled).to(dt) if dt == torch.int8 else scaled.to(dt)
    return q, scale


# the raw 3-D expert stacks of ``modules/moe/expert_mlps.py`` (JAX's
# ``expert_leaves``, ``utils.py:151``)
EXPERT_LEAVES = ("gate_proj", "up_proj", "down_proj")


def scale_name(name: str) -> str:
    """The scale entry beside a selected weight: ``<prefix>.scale`` for a
    ``<prefix>.weight``, ``<name>_scale`` for an expert stack (JAX's
    ``scale`` / ``<name>_scale`` naming, ``utils.py:173``)."""
    if name.rpartition(".")[2] == "weight":
        return name[: -len("weight")] + "scale"
    return name + "_scale"


def is_quantized_state_dict(state_dict: Dict[str, torch.Tensor]) -> bool:
    """Whether a state dict already carries quantized weights: a scale
    entry beside some weight or expert stack (the structure
    :func:`quantize_state_dict` emits; JAX ``is_quantized_tree``,
    ``utils.py:31``)."""
    return any(_selected(name, t) and scale_name(name) in state_dict
               for name, t in state_dict.items())


def _selected(name: str, t: torch.Tensor) -> bool:
    """Every linear weight of 2 dims or more, lm_head included, and every
    3-D expert stack; never the embedding nor a MoE router (JAX keeps the
    router float, ``tests/quantization/test_quantized_model.py:159``)."""
    leaf = name.rpartition(".")[2]
    if leaf == "weight":
        return (t.dim() >= 2 and not name.endswith("embed.weight")
                and not name.endswith("router.weight"))
    return leaf in EXPERT_LEAVES and t.dim() >= 3


@torch.no_grad()
def quantize_weight(w: torch.Tensor, cfg: QuantizationConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes, scale)`` of one weight ``(..., out, in)``: every leading
    slice (an expert of a stack) quantized on its own, as JAX's
    ``quantize_param_tree`` does (``utils.py:188-204``). Per channel the
    scale reduces the contraction dim only, ``(..., out)``; per tensor the
    two matrix dims, ``(...)`` (a scalar for a 2-D weight)."""
    a = w.to(torch.float32).abs()
    dims = (-2, -1) if cfg.quantization_type == QuantizationType.PER_TENSOR_SYMMETRIC else (-1,)
    s = a.amax(dim=dims, keepdim=True).clamp_min(1e-12) / cfg.quantized_dtype.max_value
    q, _ = direct_cast_quantize(w, cfg, scale=s)
    return q, s.reshape(w.shape[:-len(dims)])


@torch.no_grad()
def quantize_state_dict(state_dict: Dict[str, torch.Tensor], cfg: QuantizationConfig
                        ) -> Dict[str, torch.Tensor]:
    """A new state dict where every linear weight (lm_head included, the
    embedding and a MoE router never) and every expert stack becomes its
    codes (``cfg``'s dtype, ``(..., out, in)``) with a scale entry beside it
    (f32: ``(..., out)`` per channel, ``(...)`` per tensor; see
    :func:`scale_name`); every other entry is the caller's own tensor. The
    port's ``quantize_param_tree`` (``utils.py:124``). A dict that already
    holds the scale of a selected weight raises, as JAX does for a
    quantized tree (``utils.py:176-185``)."""
    out = {}
    for name, t in state_dict.items():
        if not _selected(name, t):
            out.setdefault(name, t)
            continue
        sname = scale_name(name)
        if sname in state_dict:
            raise ValueError(f"state dict already has {sname!r} beside {name!r} "
                             "(already quantized?); cannot attach the quantization scale")
        out[name], out[sname] = quantize_weight(t, cfg)
    return out
