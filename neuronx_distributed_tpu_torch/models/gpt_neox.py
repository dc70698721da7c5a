"""GPT-NeoX (counterpart of ``neuronx_distributed_tpu/models/gpt_neox.py``).

ParallelEmbedding -> N x (LayerNorm -> multi-head attention with partial
rotary and biased projections; LayerNorm -> biased MLP with exact-erf GELU)
-> LayerNorm -> LM head without bias, at tp = 1. The residual is parallel,
``x + attn(ln1(x)) + mlp(ln2(x))``, unless ``use_parallel_residual=False``
(JAX ``:56-85``). GPT-NeoX-20B's head dim is 96: its attention runs the
head_dim-96 builds of K1, K4 and K5 (``kernels/_build.py HEAD_DIMS``).

The serving surface is ``LlamaForCausalLM``'s (``device``,
``new_cache``/``new_paged_cache``, ``forward(input_ids, mode, cache,
positions, segment_ids, padding_mask, last_only, head_at, attn_mask)``,
``loss``) and the backbone's forward is ``LlamaModel``'s, over these
layers: the engine, ``generate`` and the caches serve it as they serve
Llama. ``models/convert.py gpt_neox_flax_to_torch`` carries JAX weights
across; :func:`init_params` fills random ones from a seed on the model's
device. Weights are stored frozen in the compute dtype (norms f32), or as
fp32 masters with ``trainable=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM, LlamaModel, _weights
from neuronx_distributed_tpu_torch.models.mixtral import init_params
from neuronx_distributed_tpu_torch.modules.attention import (
    ParallelMLP,
    ParallelSelfAttention,
    rope_frequencies,
    rotary_dims,
)
from neuronx_distributed_tpu_torch.modules.layer_norm import LayerNorm
from neuronx_distributed_tpu_torch.parallel.layers import ColumnParallelLinear, ParallelEmbedding
from neuronx_distributed_tpu_torch.utils.device import resolve_device

__all__ = ["GPTNeoXConfig", "GPTNeoXLayer", "GPTNeoXModel", "GPTNeoXForCausalLM",
           "gpt_neox_20b", "init_params", "tiny_gpt_neox"]


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig:
    vocab_size: int = 50432
    hidden_size: int = 6144
    intermediate_size: int = 24576
    num_layers: int = 44
    num_heads: int = 64
    max_seq_len: int = 2048
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    # what remat keeps (llama.REMAT_POLICIES)
    remat_policy: Optional[str] = None

    @property
    def head_dim_(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        """Multi-head attention: a kv-head a q-head (the caches' width)."""
        return self.num_heads


def gpt_neox_20b(**over) -> GPTNeoXConfig:
    return GPTNeoXConfig(**over)


def tiny_gpt_neox(**over) -> GPTNeoXConfig:
    """The shrunk test config (the JAX ``tiny_gpt_neox``)."""
    return GPTNeoXConfig(**{**dict(
        vocab_size=256, hidden_size=64, intermediate_size=256, num_layers=2,
        num_heads=8, max_seq_len=64, dtype=torch.float32,
    ), **over})


class GPTNeoXLayer(nn.Module):
    def __init__(self, config: GPTNeoXConfig, device, trainable: bool = False):
        super().__init__()
        cfg = self.config = config
        w = _weights(cfg, device, trainable)
        self.input_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **w)
        self.attn = ParallelSelfAttention(cfg.hidden_size, cfg.num_heads, causal=True,
                                          use_bias=True, rotary_pct=cfg.rotary_pct, **w)
        self.post_attn_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **w)
        self.mlp = ParallelMLP(cfg.hidden_size, cfg.intermediate_size, activation="gelu",
                               use_bias=True, **w)

    def forward(self, x, freqs, positions, mode, cache, layer, q_pos=None, segment_ids=None,
                padding_mask=None, attn_mask=None):
        attn = self.attn(self.input_norm(x), freqs, positions, mode, cache, layer, q_pos,
                         segment_ids, padding_mask, attn_mask)
        if self.config.use_parallel_residual:
            return x + attn + self.mlp(self.post_attn_norm(x))
        x = x + attn
        return x + self.mlp(self.post_attn_norm(x))


class GPTNeoXModel(nn.Module):
    """The backbone without the LM head (final-normed hidden states);
    ``freqs`` is the RoPE table of the rotary channels alone."""

    def __init__(self, config: GPTNeoXConfig, device, trainable: bool = False):
        super().__init__()
        cfg = self.config = config
        w = _weights(cfg, device, trainable)
        self.embed = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size, **w)
        self.layers = nn.ModuleList(GPTNeoXLayer(cfg, device, trainable)
                                    for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **w)
        rot = rotary_dims(cfg.head_dim_, cfg.rotary_pct)
        self.register_buffer("freqs", rope_frequencies(rot, cfg.max_seq_len, cfg.rope_theta,
                                                       device), persistent=False)

    forward = LlamaModel.forward


class GPTNeoXForCausalLM(nn.Module):
    """The causal LM (JAX ``GPTNeoXForCausalLM`` :88). Construction places
    every weight on ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, config: GPTNeoXConfig, device=None, trainable: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.trainable = trainable
        self.model = GPTNeoXModel(config, device, trainable)
        self.lm_head = ColumnParallelLinear(config.hidden_size, config.vocab_size, use_bias=False,
                                            **_weights(config, device, trainable))

    device = LlamaForCausalLM.device
    new_cache = LlamaForCausalLM.new_cache
    new_paged_cache = LlamaForCausalLM.new_paged_cache
    forward = LlamaForCausalLM.forward
    loss = LlamaForCausalLM.loss
