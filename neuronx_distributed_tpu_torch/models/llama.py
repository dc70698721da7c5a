"""Llama-2/3 (counterpart of ``neuronx_distributed_tpu/models/llama.py``).

ParallelEmbedding → N × (RMSNorm → GQA attention → RMSNorm → SwiGLU MLP) →
RMSNorm → LM head, at tp=1. ``mode`` is a call argument instead of a flax
module attribute: ``"train"`` (no cache), ``"prefill"`` (causal attention
that also writes the prompt K/V into a :class:`KVCache`), ``"decode"``
(append the step's K/V at the cache's device cursor, advance it in place,
and attend the cache through its own ``attend``: K4 on a row cache, K5 on a
:class:`PagedKVCache`). A model built
for serving stores its linears and embedding in the compute ``dtype`` the
JAX layers cast to, frozen; a model built with ``trainable=True`` keeps fp32
masters (``param_dtype``) that it casts before each product, as JAX does
(``parallel/layers.py``). Norms are fp32 either way; RMSNorm and RoPE
compute in f32 and attention inside the kernels in f32, as in JAX. With
``remat`` each decoder layer of a differentiated train-mode forward runs
under activation checkpointing (JAX ``nn.remat``, policy ``None``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from neuronx_distributed_tpu_torch.modules.attention import (
    KVCache,
    PagedKVCache,
    apply_rope,
    attention_op,
    prefill_positions,
    rope_frequencies,
)
from neuronx_distributed_tpu_torch.modules.qkv_linear import GQAQKVColumnParallelLinear
from neuronx_distributed_tpu_torch.modules.rms_norm import RMSNorm
from neuronx_distributed_tpu_torch.parallel.losses import parallel_cross_entropy
from neuronx_distributed_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    ParallelEmbedding,
    RowParallelLinear,
)
from neuronx_distributed_tpu_torch.utils.device import resolve_device

MODES = ("train", "prefill", "decode")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True  # activation checkpointing per decoder layer (training)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


def llama2_7b(**over) -> LlamaConfig:
    return LlamaConfig(**{**dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, num_kv_heads=32, max_seq_len=4096,
    ), **over})


def llama2_70b(**over) -> LlamaConfig:
    return LlamaConfig(**{**dict(
        vocab_size=32000, hidden_size=8192, intermediate_size=28672,
        num_layers=80, num_heads=64, num_kv_heads=8, max_seq_len=4096,
    ), **over})


def llama3_8b(**over) -> LlamaConfig:
    return LlamaConfig(**{**dict(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192,
        rope_theta=500000.0,
    ), **over})


def tiny_llama(**over) -> LlamaConfig:
    """4-layer shrunk config for tests (the JAX ``tiny_llama``)."""
    return LlamaConfig(**{**dict(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=4, num_heads=8, num_kv_heads=4, max_seq_len=128,
        dtype=torch.float32, remat=False,
    ), **over})


def _weights(cfg: LlamaConfig, device, trainable: bool) -> dict:
    """Storage options every weight of the model shares."""
    return dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device,
                trainable=trainable)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device, trainable: bool = False):
        super().__init__()
        cfg = self.config = config
        d = cfg.head_dim_
        w = _weights(cfg, device, trainable)
        self.qkv = GQAQKVColumnParallelLinear(
            cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, d, **w)
        self.o_proj = RowParallelLinear(cfg.num_heads * d, cfg.hidden_size, use_bias=False, **w)

    def forward(self, x, freqs, positions, mode: str, cache: Optional[KVCache],
                layer: int, q_pos=None, segment_ids=None, padding_mask=None):
        """``positions`` are the RoPE positions; ``q_pos`` (s,) the decode
        rows' cache columns (decode only)."""
        cfg = self.config
        d = cfg.head_dim_
        q, k, v = self.qkv(x)
        b, s = q.shape[0], q.shape[1]
        q = q.reshape(b, s, cfg.num_heads, d)
        k = k.reshape(b, s, cfg.num_kv_heads, d)
        v = v.reshape(b, s, cfg.num_kv_heads, d)
        q = apply_rope(q, freqs, positions)
        k = apply_rope(k, freqs, positions)
        if mode == "decode":
            cache.decode_write(layer, k, v)
            out = cache.attend(layer, q, q_pos)
        else:
            if mode == "prefill":
                cache.prefill_write(layer, k, v)
            out = attention_op(
                q, k, v, causal=True, mask=padding_mask, segment_ids=segment_ids
            )
        return self.o_proj(out.reshape(b, s, cfg.num_heads * d))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device, trainable: bool = False):
        super().__init__()
        cfg = config
        common = dict(use_bias=False, **_weights(cfg, device, trainable))
        self.gate_proj = ColumnParallelLinear(cfg.hidden_size, cfg.intermediate_size, **common)
        self.up_proj = ColumnParallelLinear(cfg.hidden_size, cfg.intermediate_size, **common)
        self.down_proj = RowParallelLinear(cfg.intermediate_size, cfg.hidden_size, **common)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device, trainable: bool = False):
        super().__init__()
        cfg = config
        norm = dict(eps=cfg.rms_eps, **_weights(cfg, device, trainable))
        self.input_norm = RMSNorm(cfg.hidden_size, **norm)
        self.attn = LlamaAttention(cfg, device, trainable)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, **norm)
        self.mlp = LlamaMLP(cfg, device, trainable)

    def forward(self, x, freqs, positions, mode, cache, layer, q_pos=None,
                segment_ids=None, padding_mask=None):
        x = x + self.attn(self.input_norm(x), freqs, positions, mode, cache,
                          layer, q_pos, segment_ids, padding_mask)
        return x + self.mlp(self.post_attn_norm(x))


class LlamaModel(nn.Module):
    """Backbone without the LM head."""

    def __init__(self, config: LlamaConfig, device, trainable: bool = False):
        super().__init__()
        cfg = self.config = config
        w = _weights(cfg, device, trainable)
        self.embed = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size, **w)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(cfg, device, trainable) for _ in range(cfg.num_layers)
        )
        self.final_norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_eps, **w)
        self.register_buffer(
            "freqs",
            rope_frequencies(cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta, device),
            persistent=False,
        )

    def forward(self, input_ids, mode: str = "train", cache: Optional[KVCache] = None,
                positions=None, segment_ids=None, padding_mask=None):
        if mode not in MODES:
            raise ValueError(f"unknown attention mode {mode!r}")
        if mode != "train" and cache is None:
            raise ValueError(f"mode {mode!r} needs a KVCache")
        b, s = input_ids.shape
        if s > self.config.max_seq_len:
            raise ValueError(f"prompt length {s} exceeds max_seq_len={self.config.max_seq_len}")
        x = self.embed(input_ids)
        q_pos = None
        if mode == "prefill":
            if positions is None and padding_mask is not None:
                positions = prefill_positions(padding_mask)
            cache.prefill_valid(padding_mask, s)
        elif mode == "decode":
            q_pos, positions = cache.decode_positions(s)
            cache.decode_valid(padding_mask, s)
            padding_mask = None  # persisted in the cache; attention reads kv_valid
        remat = self.config.remat and mode == "train" and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            args = (x, self.freqs, positions, mode, cache, i, q_pos, segment_ids, padding_mask)
            x = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
        if mode == "decode":
            # on the device, in place: a decode forward changes no host
            # state, so a captured step replays it at every column
            cache.advance(s)
        return self.final_norm(x)


class LlamaForCausalLM(nn.Module):
    """The causal LM. Construction places every weight on ``device`` (CUDA
    unless ``device="cpu"``); :func:`init_params` or ``load_state_dict``
    (see ``models/convert.py``) fills them. ``trainable=True`` builds fp32
    master weights that train (``trainer/``); the default builds frozen
    weights in the compute dtype for serving."""

    def __init__(self, config: LlamaConfig, device=None, trainable: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.trainable = trainable
        self.model = LlamaModel(config, device, trainable)
        self.lm_head = ColumnParallelLinear(config.hidden_size, config.vocab_size,
                                            use_bias=False,
                                            **_weights(config, device, trainable))

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def new_cache(self, batch: int) -> KVCache:
        """A zeroed row-per-batch cache for this model on its device."""
        cfg = self.config
        return KVCache.allocate(cfg.num_layers, batch, cfg.max_seq_len,
                                cfg.num_kv_heads, cfg.head_dim_, cfg.dtype, self.device)

    def new_paged_cache(self, batch: int, num_pages: int, page_size: int) -> PagedKVCache:
        """A zeroed paged cache for this model on its device: a pool of
        ``num_pages`` pages of ``page_size`` columns per layer and a
        ``(batch, max_seq_len // page_size)`` block table of null pages."""
        cfg = self.config
        return PagedKVCache.allocate(cfg.num_layers, batch, cfg.max_seq_len,
                                     cfg.num_kv_heads, cfg.head_dim_, cfg.dtype, self.device,
                                     num_pages=num_pages, page_size=page_size)

    def forward(self, input_ids, mode: str = "train", cache: Optional[KVCache] = None,
                positions=None, segment_ids=None, padding_mask=None,
                last_only: bool = False):
        """Logits (B, S, V); ``last_only`` computes the head on the last
        position alone (B, 1, V) — all a prefill's next token needs."""
        x = self.model(input_ids, mode, cache, positions, segment_ids, padding_mask)
        if last_only:
            x = x[:, -1:]
        return self.lm_head(x)

    def loss(self, input_ids, labels):
        """Mean next-token cross entropy of ``labels`` (JAX ``loss``,
        ``llama.py:420``)."""
        return parallel_cross_entropy(self(input_ids), labels).mean()


@torch.no_grad()
def init_params(model: LlamaForCausalLM, seed: int = 0) -> LlamaForCausalLM:
    """Random weights from ``seed`` on the model's own device: linears
    N(0, 1/fan_in) (the JAX lecun-normal scale, untruncated), embedding
    N(0, 1), norms 1."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("norm.weight"):
            p.fill_(1.0)
        elif name == "model.embed.weight":
            p.normal_(0.0, 1.0, generator=gen)
        elif p.ndim == 2:
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
        else:
            p.zero_()
    return model
