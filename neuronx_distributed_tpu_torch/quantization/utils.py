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


def _scale_name(weight_name: str) -> str:
    return weight_name[: -len("weight")] + "scale"


def is_quantized_state_dict(state_dict: Dict[str, torch.Tensor]) -> bool:
    """Whether a state dict already carries quantized weights: a ``scale``
    entry beside some ``weight`` (the structure :func:`quantize_state_dict`
    emits; JAX ``is_quantized_tree``, ``utils.py:31``)."""
    return any(name.endswith(".weight") and _scale_name(name) in state_dict
               for name in state_dict)


def _selected(name: str, t: torch.Tensor) -> bool:
    """Every 2-D linear weight, lm_head included; never the embedding."""
    return name.endswith(".weight") and t.dim() == 2 and not name.endswith("embed.weight")


@torch.no_grad()
def quantize_state_dict(state_dict: Dict[str, torch.Tensor], cfg: QuantizationConfig
                        ) -> Dict[str, torch.Tensor]:
    """A new state dict where every 2-D linear weight, lm_head included
    and the embedding never, becomes its codes (``cfg``'s dtype, ``(out, in)``) with a ``scale`` entry beside it
    (f32, ``(out,)`` per channel or ``()`` per tensor); every other entry is
    the caller's own tensor. The port's ``quantize_param_tree``
    (``utils.py:124``). A dict that already holds the scale of a selected
    weight raises, as JAX does for a quantized tree (``utils.py:176-185``)."""
    out = {}
    for name, t in state_dict.items():
        if not _selected(name, t):
            out.setdefault(name, t)
            continue
        scale_name = _scale_name(name)
        if scale_name in state_dict:
            raise ValueError(f"state dict already has {scale_name!r} beside {name!r} "
                             "(already quantized?); cannot attach the quantization scale")
        q, s = direct_cast_quantize(t, cfg)
        out[name] = q
        out[scale_name] = s.reshape(-1) if s.dim() else s
    return out
