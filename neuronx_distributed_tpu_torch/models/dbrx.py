"""DBRX (counterpart of ``neuronx_distributed_tpu/models/dbrx.py``).

ParallelEmbedding -> N x (bias-free LayerNorm -> GQA attention ->
bias-free LayerNorm -> fine-grained MoE: 16 experts, top-4, SwiGLU) ->
bias-free LayerNorm -> LM head, at tp = 1. The attention block is the Llama
port's through :meth:`DbrxConfig.as_llama`, the MoE the port's
``modules/moe`` (the Mixtral stack at DBRX's geometry: a decode step of at
most 8 tokens on MX, prefills on the blockwise route). The model is the
Mixtral port's with these blocks: ``forward`` returns ``(logits, aux)``,
``aux`` the router losses summed over layers in train mode and zeros in
prefill and decode modes (ROADMAP §3); :meth:`loss` adds them weighted by
``router_aux_loss_coef`` and ``router_z_loss_coef``; ``remat`` and the
router jitter and token shuffle behave as Mixtral's. With
``config.quantization`` the linears, lm_head and the expert stacks hold
int8/fp8 codes (JAX ``tests/quantization/test_quantized_model.py:270``).
``models/convert.py dbrx_flax_to_torch`` carries JAX weights across
(``blocks_<i>`` become ``model.layers.<i>``); :func:`init_params` fills
random ones from a seed on the model's device, weight by weight.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from neuronx_distributed_tpu_torch.models.llama import (
    LlamaAttention,
    LlamaConfig,
    _linear,
    _weights,
)
from neuronx_distributed_tpu_torch.models.mixtral import (
    MixtralForCausalLM,
    MixtralModel,
    init_params,
)
from neuronx_distributed_tpu_torch.modules.attention import rope_frequencies
from neuronx_distributed_tpu_torch.modules.layer_norm import LayerNorm
from neuronx_distributed_tpu_torch.modules.moe import MoE
from neuronx_distributed_tpu_torch.parallel.layers import ColumnParallelLinear, ParallelEmbedding
from neuronx_distributed_tpu_torch.quantization.config import QuantizationConfig
from neuronx_distributed_tpu_torch.utils.device import resolve_device

__all__ = ["DbrxBlock", "DbrxConfig", "DbrxForCausalLM", "DbrxModel", "dbrx_base", "init_params",
           "tiny_dbrx"]


@dataclasses.dataclass(frozen=True)
class DbrxConfig:
    vocab_size: int = 100352
    hidden_size: int = 6144
    intermediate_size: int = 10752  # per-expert ffn
    num_layers: int = 40
    num_heads: int = 48
    num_kv_heads: int = 8
    max_seq_len: int = 32768
    rope_theta: float = 5e5
    num_experts: int = 16
    top_k: int = 4
    capacity_factor: Optional[float] = None
    router_aux_loss_coef: float = 0.05
    router_z_loss_coef: float = 0.0
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    # what remat keeps (llama.REMAT_POLICIES)
    remat_policy: Optional[str] = None
    # weight-only serving quantization (the Mixtral and Llama contract)
    quantization: Optional[QuantizationConfig] = None

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_heads

    def as_llama(self) -> LlamaConfig:
        """The attention-relevant view, for the Llama attention block."""
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size, num_layers=self.num_layers,
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            max_seq_len=self.max_seq_len, rope_theta=self.rope_theta, dtype=self.dtype,
            param_dtype=self.param_dtype, remat=False, quantization=self.quantization)


def dbrx_base(**over) -> DbrxConfig:
    return DbrxConfig(**over)


def tiny_dbrx(**over) -> DbrxConfig:
    """The shrunk test config (the JAX ``tiny_dbrx``)."""
    return DbrxConfig(**{**dict(
        vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=2,
        num_heads=8, num_kv_heads=4, max_seq_len=64, num_experts=8, top_k=2,
        dtype=torch.float32,
    ), **over})


class DbrxBlock(nn.Module):
    def __init__(self, config: DbrxConfig, device, trainable: bool = False):
        super().__init__()
        cfg = config
        llama = cfg.as_llama()
        norm = dict(eps=cfg.layer_norm_eps, use_bias=False, **_weights(llama, device, trainable))
        self.norm_1 = LayerNorm(cfg.hidden_size, **norm)
        self.attn = LlamaAttention(llama, device, trainable)
        self.norm_2 = LayerNorm(cfg.hidden_size, **norm)
        self.moe = MoE(cfg.num_experts, cfg.hidden_size, cfg.intermediate_size, top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor, dtype=cfg.dtype,
                       param_dtype=cfg.param_dtype, device=device, trainable=trainable,
                       quantization_config=cfg.quantization)

    def forward(self, x, freqs, positions, mode, cache, layer, q_pos=None, segment_ids=None,
                padding_mask=None, attn_mask=None, deterministic: bool = True, generator=None):
        """``(x, aux)`` as ``MixtralDecoderLayer.forward``."""
        x = x + self.attn(self.norm_1(x), freqs, positions, mode, cache, layer, q_pos,
                          segment_ids, padding_mask, attn_mask)
        out, aux = self.moe(self.norm_2(x), deterministic, generator, with_aux=mode == "train")
        if aux is None:
            return x + out, None
        return x + out, torch.stack([aux["load_balancing_loss"], aux["router_z_loss"]])


class DbrxModel(nn.Module):
    """The backbone without the LM head: ``(hidden, aux)``, by
    ``MixtralModel.forward`` over DBRX blocks. That forward reads
    ``config`` (``remat``, ``remat_policy`` and ``mode_inputs``' fields),
    ``embed``, ``layers``, ``final_norm`` and ``freqs``."""

    def __init__(self, config: DbrxConfig, device, trainable: bool = False):
        super().__init__()
        cfg = self.config = config
        w = _weights(cfg.as_llama(), device, trainable)
        self.embed = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size, **w)
        self.layers = nn.ModuleList(DbrxBlock(cfg, device, trainable)
                                    for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, use_bias=False, **w)
        self.register_buffer(
            "freqs", rope_frequencies(cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta, device),
            persistent=False)

    forward = MixtralModel.forward


class DbrxForCausalLM(nn.Module):
    """The causal LM (JAX ``DbrxForCausalLM`` :153): ``MixtralForCausalLM``'s
    forward, loss and serving surface over :class:`DbrxModel`. They read
    ``model``, ``lm_head`` and ``config`` (``loss``: the two router loss
    coefficients)."""

    def __init__(self, config: DbrxConfig, device=None, trainable: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.trainable = trainable
        self.model = DbrxModel(config, device, trainable)
        self.lm_head = ColumnParallelLinear(config.hidden_size, config.vocab_size,
                                            use_bias=False,
                                            **_linear(config.as_llama(), device, trainable))

    device = MixtralForCausalLM.device
    new_cache = MixtralForCausalLM.new_cache
    new_paged_cache = MixtralForCausalLM.new_paged_cache
    forward = MixtralForCausalLM.forward
    loss = MixtralForCausalLM.loss
