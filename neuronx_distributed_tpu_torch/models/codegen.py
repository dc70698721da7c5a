"""CodeGen 2.5 (counterpart of ``neuronx_distributed_tpu/models/codegen.py``).

ParallelEmbedding -> N x (one LayerNorm feeding both branches: multi-head
attention with partial rotary over ``rotary_dim`` channels and no bias, and
a biased MLP with tanh GELU, summed in parallel, ``x + attn(ln(x)) +
mlp(ln(x))``) -> LayerNorm -> LM head WITH bias, at tp = 1 (JAX
``:59-104``). CodeGen2.5-7B's head dim is 128. The rotary follows JAX's
half-split convention, not HF's interleaved CodeGen rotary.

The serving surface is ``LlamaForCausalLM``'s and the backbone's forward
``LlamaModel``'s, over these blocks, as for GPT-NeoX (``models/gpt_neox.py``).
``models/convert.py codegen_flax_to_torch`` carries JAX weights across
(``blocks_<i>`` become ``model.layers.<i>``); :func:`init_params` fills
random ones from a seed on the model's device.
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

__all__ = ["CodeGenBlock", "CodeGenConfig", "CodeGenForCausalLM", "CodeGenModel", "codegen25_7b",
           "init_params", "tiny_codegen"]


@dataclasses.dataclass(frozen=True)
class CodeGenConfig:
    vocab_size: int = 51200
    hidden_size: int = 4096
    intermediate_size: int = 16384
    num_layers: int = 32
    num_heads: int = 32
    max_seq_len: int = 2048
    rotary_dim: int = 64
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
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


def codegen25_7b(**over) -> CodeGenConfig:
    return CodeGenConfig(**over)


def tiny_codegen(**over) -> CodeGenConfig:
    """The shrunk test config (the JAX ``tiny_codegen``)."""
    return CodeGenConfig(**{**dict(
        vocab_size=256, hidden_size=64, intermediate_size=256, num_layers=2,
        num_heads=8, max_seq_len=64, rotary_dim=4, dtype=torch.float32,
    ), **over})


class CodeGenBlock(nn.Module):
    def __init__(self, config: CodeGenConfig, device, trainable: bool = False):
        super().__init__()
        cfg = config
        w = _weights(cfg, device, trainable)
        self.input_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **w)
        self.attn = ParallelSelfAttention(cfg.hidden_size, cfg.num_heads, causal=True,
                                          use_bias=False,
                                          rotary_pct=cfg.rotary_dim / cfg.head_dim_, **w)
        self.mlp = ParallelMLP(cfg.hidden_size, cfg.intermediate_size, activation="gelu_new",
                               use_bias=True, **w)

    def forward(self, x, freqs, positions, mode, cache, layer, q_pos=None, segment_ids=None,
                padding_mask=None, attn_mask=None):
        h = self.input_norm(x)
        attn = self.attn(h, freqs, positions, mode, cache, layer, q_pos, segment_ids,
                         padding_mask, attn_mask)
        return x + attn + self.mlp(h)


class CodeGenModel(nn.Module):
    """The backbone without the LM head (final-normed hidden states)."""

    def __init__(self, config: CodeGenConfig, device, trainable: bool = False):
        super().__init__()
        cfg = self.config = config
        w = _weights(cfg, device, trainable)
        self.embed = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size, **w)
        self.layers = nn.ModuleList(CodeGenBlock(cfg, device, trainable)
                                    for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **w)
        rot = rotary_dims(cfg.head_dim_, cfg.rotary_dim / cfg.head_dim_)
        self.register_buffer("freqs", rope_frequencies(rot, cfg.max_seq_len, cfg.rope_theta,
                                                       device), persistent=False)

    forward = LlamaModel.forward


class CodeGenForCausalLM(nn.Module):
    """The causal LM (JAX ``CodeGenForCausalLM`` :107): its LM head has a
    bias. Construction places every weight on ``device`` (CUDA unless
    ``device="cpu"``)."""

    def __init__(self, config: CodeGenConfig, device=None, trainable: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.trainable = trainable
        self.model = CodeGenModel(config, device, trainable)
        self.lm_head = ColumnParallelLinear(config.hidden_size, config.vocab_size, use_bias=True,
                                            **_weights(config, device, trainable))

    device = LlamaForCausalLM.device
    new_cache = LlamaForCausalLM.new_cache
    new_paged_cache = LlamaForCausalLM.new_paged_cache
    forward = LlamaForCausalLM.forward
    loss = LlamaForCausalLM.loss
