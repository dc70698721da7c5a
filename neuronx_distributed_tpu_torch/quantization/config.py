"""Quantization config (counterpart of
``neuronx_distributed_tpu/quantization/config.py``).

Two levels, as in JAX:

* :class:`QuantizationConfig` — the per-weight qconfig the linears and
  ``quantize_state_dict`` speak (dtype and scale scheme).
* :class:`QuantConfig` — the serving knob
  (``ServingEngine(quantize=QuantConfig(weights="int8", kv="int8"))``):
  weight-only int8/fp8 on every linear (Llama, Mixtral) and every MoE
  expert stack, and an int8 paged KV pool with a scale per (page,
  kv-head). It lowers to a
  :class:`QuantizationConfig` for the weights with
  :meth:`QuantConfig.weight_qconfig`.

The JAX config's ``channel_dim``/``batch_dim`` (its standalone quantized
layers; a stack's scales follow ``quantize_param_tree``'s fixed rule, one
per leading slice and output channel) and ``use_int8_matmul``/``use_static_act_scale``
(the int8 x int8 product, off in ``weight_qconfig``) are not ported.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class QuantizationType(str, enum.Enum):
    PER_TENSOR_SYMMETRIC = "per_tensor_symmetric"
    PER_CHANNEL_SYMMETRIC = "per_channel_symmetric"


class QuantizedDtype(str, enum.Enum):
    INT8 = "int8"
    FP8E4M3 = "f8e4m3"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {QuantizedDtype.INT8: torch.int8,
                QuantizedDtype.FP8E4M3: torch.float8_e4m3fn}[self]

    @property
    def max_value(self) -> float:
        """The symmetric clamp bound."""
        return {QuantizedDtype.INT8: 127.0, QuantizedDtype.FP8E4M3: 448.0}[self]


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """Typed qconfig (JAX ``QuantizationConfig``, ``config.py:49``)."""

    quantization_type: QuantizationType = QuantizationType.PER_CHANNEL_SYMMETRIC
    quantized_dtype: QuantizedDtype = QuantizedDtype.INT8


# the serving-level spellings ServingEngine(quantize=) accepts
_WEIGHT_DTYPES = {"int8": QuantizedDtype.INT8, "fp8": QuantizedDtype.FP8E4M3}
_KV_DTYPES = ("int8",)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """What the serving engine quantizes (JAX ``QuantConfig``,
    ``config.py:87``).

    ``weights``: ``"int8"`` / ``"fp8"`` / ``None`` — every linear weight
    (lm_head included, the embedding not) quantized once at engine
    construction with per-channel symmetric scales; each product
    dequantizes its weight and runs a dense GEMM
    (``quantization/layers.py``).

    ``kv``: ``"int8"`` / ``None`` — the paged KV pool (needs
    ``kv_page_size=``) stores int8 pages with a scale per (page, kv-head);
    decode attention reads them straight from the pool (K5q)."""

    weights: Optional[str] = "int8"
    kv: Optional[str] = None

    def __post_init__(self):
        if self.weights is not None and self.weights not in _WEIGHT_DTYPES:
            raise ValueError(f"unknown weight quantization {self.weights!r} "
                             f"(expected one of {sorted(_WEIGHT_DTYPES)} or None)")
        if self.kv is not None and self.kv not in _KV_DTYPES:
            raise ValueError(f"unknown KV quantization {self.kv!r} "
                             f"(expected one of {sorted(_KV_DTYPES)} or None)")
        if self.weights is None and self.kv is None:
            raise ValueError("QuantConfig quantizes nothing (weights=None, kv=None) — "
                             "pass quantize=None instead")

    def weight_qconfig(self) -> Optional[QuantizationConfig]:
        """The per-weight config of the weight side: per-channel symmetric
        scales (JAX ``weight_qconfig``, ``config.py:132``)."""
        if self.weights is None:
            return None
        return QuantizationConfig(QuantizationType.PER_CHANNEL_SYMMETRIC,
                                  _WEIGHT_DTYPES[self.weights])
