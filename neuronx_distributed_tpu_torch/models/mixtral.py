"""Mixtral (counterpart of ``neuronx_distributed_tpu/models/mixtral.py``).

ParallelEmbedding -> N x (RMSNorm -> GQA attention -> RMSNorm -> MoE with a
top-2 softmax router and SwiGLU experts) -> RMSNorm -> LM head, at tp = 1.
The attention block, the norms, the embedding and the caches are the Llama
port's, through :meth:`MixtralConfig.as_llama`; the keyword interface is
``LlamaForCausalLM``'s (``mode``, ``cache``, ``last_only``, ``head_at``),
so the serving engine, ``generate`` and the caches serve it as they serve
Llama. ``forward`` returns ``(logits, aux)``, ``aux`` the two router losses
summed over layers (JAX ``MixtralModel`` :173) in train mode; a prefill or
decode forward returns zeros there and computes neither loss.

A decode step of at most 8 tokens runs the experts' ``selective`` route
(MX on the card, MXq for quantized experts); a prefill and a 16-slot
decode step the ``blockwise`` route (``modules/moe/expert_mlps.py``). With
``config.quantization`` the linears, lm_head and the expert stacks hold
int8/fp8 codes with f32 scales; the routers, the embedding and the norms
stay float. Such a model serves only: :func:`quantize_model` makes one from a
float model, and :func:`init_params` fills one directly, a weight at a
time.

Training: ``MixtralForCausalLM(config, trainable=True)`` keeps fp32 masters
(expert stacks included) that each product casts to the compute dtype, the
routers in f32, as ``LlamaForCausalLM(trainable=True)`` does; :meth:`loss`
is the objective the train step differentiates (cross entropy plus the
weighted router losses), with the router jitter and the token shuffle on
under ``deterministic=False``, drawn from an explicit ``generator``. With
``config.remat`` each decoder layer of a differentiated train-mode forward
runs under activation checkpointing (JAX ``nn.remat``, ``:164``), by the
Llama port's ``remat_policy`` contexts; ``torch.utils.checkpoint`` restores
only the default generators, so a layer that draws runs on a copy of the
explicit generator's state taken at its start, and its recompute draws the
same jitter and permutation again (:class:`_Replay`). The expert routes'
backward: ``torch._grouped_mm``'s (blockwise), the einsums' (all experts,
capacity factor; a dropped slot gets no gradient); the selective route
differentiates on CPU tensors only (MX has no backward and raises under
autograd).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from neuronx_distributed_tpu_torch.models.llama import (
    LlamaAttention,
    LlamaConfig,
    LlamaForCausalLM,
    _linear,
    _weights,
    mode_inputs,
    quantize_model,
    remat_context_fn,
)
from neuronx_distributed_tpu_torch.modules.attention import KVCache, rope_frequencies
from neuronx_distributed_tpu_torch.modules.moe import MoE
from neuronx_distributed_tpu_torch.modules.rms_norm import RMSNorm
from neuronx_distributed_tpu_torch.parallel.layers import ColumnParallelLinear, ParallelEmbedding
from neuronx_distributed_tpu_torch.parallel.losses import parallel_cross_entropy
from neuronx_distributed_tpu_torch.quantization.config import QuantizationConfig
from neuronx_distributed_tpu_torch.utils.device import resolve_device

__all__ = ["MixtralConfig", "MixtralDecoderLayer", "MixtralModel", "MixtralForCausalLM",
           "init_params", "mixtral_8x7b", "quantize_model", "tiny_mixtral"]


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 1e6
    rms_eps: float = 1e-5
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: Optional[float] = None  # None: dropless
    expert_strategy: str = "auto"
    router_jitter_eps: float = 0.0
    router_aux_loss_coef: float = 0.02
    router_z_loss_coef: float = 0.0
    token_shuffle: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True  # activation checkpointing per decoder layer (training)
    # what remat keeps: None (nothing), "dots" or "dots_saveable" (llama.REMAT_POLICIES)
    remat_policy: Optional[str] = None
    # weight-only serving quantization of the linears, lm_head and the
    # expert stacks (per expert and output channel); the router stays float
    quantization: Optional[QuantizationConfig] = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def as_llama(self) -> LlamaConfig:
        """The attention-relevant view, for the Llama attention block."""
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size, num_layers=self.num_layers,
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            max_seq_len=self.max_seq_len, rope_theta=self.rope_theta, rms_eps=self.rms_eps,
            dtype=self.dtype, param_dtype=self.param_dtype, remat=False,
            quantization=self.quantization)


def mixtral_8x7b(**over) -> MixtralConfig:
    return MixtralConfig(**{**dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, num_experts=8, top_k=2,
    ), **over})


def tiny_mixtral(**over) -> MixtralConfig:
    """The shrunk test config (the JAX ``tiny_mixtral``)."""
    return MixtralConfig(**{**dict(
        vocab_size=256, hidden_size=64, intermediate_size=96,
        num_layers=2, num_heads=8, num_kv_heads=4, max_seq_len=128,
        num_experts=4, top_k=2, dtype=torch.float32, remat=False,
    ), **over})


class MixtralDecoderLayer(nn.Module):
    def __init__(self, config: MixtralConfig, device, trainable: bool = False):
        super().__init__()
        cfg = config
        llama = cfg.as_llama()
        norm = dict(eps=cfg.rms_eps, **_weights(llama, device, trainable))
        self.input_norm = RMSNorm(cfg.hidden_size, **norm)
        self.attn = LlamaAttention(llama, device, trainable)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, **norm)
        self.moe = MoE(cfg.num_experts, cfg.hidden_size, cfg.intermediate_size, top_k=cfg.top_k,
                       router_jitter_eps=cfg.router_jitter_eps,
                       capacity_factor=cfg.capacity_factor, expert_strategy=cfg.expert_strategy,
                       token_shuffle=cfg.token_shuffle, dtype=cfg.dtype,
                       param_dtype=cfg.param_dtype, device=device, trainable=trainable,
                       quantization_config=cfg.quantization)

    def forward(self, x, freqs, positions, mode, cache, layer, q_pos=None, segment_ids=None,
                padding_mask=None, attn_mask=None, deterministic: bool = True, generator=None):
        """``(x, aux)``, ``aux`` (2,) f32: this layer's balance and z-loss
        in train mode, None in prefill and decode modes."""
        x = x + self.attn(self.input_norm(x), freqs, positions, mode, cache, layer, q_pos,
                          segment_ids, padding_mask, attn_mask)
        out, aux = self.moe(self.post_attn_norm(x), deterministic, generator,
                            with_aux=mode == "train")
        if aux is None:
            return x + out, None
        return x + out, torch.stack([aux["load_balancing_loss"], aux["router_z_loss"]])


class _Replay:
    """A decoder layer that draws from a copy of ``generator``'s state taken
    when the forward reaches it, so the recompute of activation
    checkpointing draws the forward's jitter and permutation again
    (``torch.utils.checkpoint`` restores only the default generators, and a
    recompute that drew afresh would differentiate another forward without
    an error). :meth:`advance` then moves ``generator`` past the forward's
    draws: the layers draw what they would draw from ``generator`` itself."""

    def __init__(self, layer: nn.Module, generator: torch.Generator):
        self.layer, self.generator = layer, generator
        self.start = generator.get_state()
        self.end = None

    def __call__(self, *args):
        g = torch.Generator(device=self.generator.device)
        g.set_state(self.start)
        out = self.layer(*args, generator=g)
        self.end = g.get_state()
        return out

    def advance(self) -> None:
        self.generator.set_state(self.end)


class MixtralModel(nn.Module):
    """The backbone without the LM head: ``(hidden, aux)`` with ``aux`` =
    ``{"load_balancing_loss", "router_z_loss"}`` summed over layers in train
    mode, zeros in prefill and decode modes (no request reads them)."""

    def __init__(self, config: MixtralConfig, device, trainable: bool = False):
        super().__init__()
        cfg = self.config = config
        w = _weights(cfg.as_llama(), device, trainable)
        self.embed = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size, **w)
        self.layers = nn.ModuleList(MixtralDecoderLayer(cfg, device, trainable)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_eps, **w)
        self.register_buffer(
            "freqs",
            rope_frequencies(cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta, device),
            persistent=False,
        )

    def forward(self, input_ids, mode: str = "train", cache: Optional[KVCache] = None,
                positions=None, segment_ids=None, padding_mask=None, attn_mask=None,
                deterministic: bool = True, generator=None):
        positions, q_pos, padding_mask = mode_inputs(self.config, input_ids, mode, cache,
                                                     positions, padding_mask)
        x = self.embed(input_ids)
        aux = torch.zeros(2, dtype=torch.float32, device=x.device)
        remat = self.config.remat and mode == "train" and torch.is_grad_enabled()
        kw = {}
        if remat:
            context_fn = remat_context_fn(self.config.remat_policy)
            if context_fn is not None:
                kw["context_fn"] = context_fn
        for i, layer in enumerate(self.layers):
            args = (x, self.freqs, positions, mode, cache, i, q_pos, segment_ids, padding_mask,
                    attn_mask, deterministic)
            if not remat:
                x, a = layer(*args, generator=generator)
            elif deterministic or generator is None:
                # nothing drawn, or from the default generators, which
                # checkpoint restores itself
                x, a = checkpoint(layer, *args, use_reentrant=False, generator=generator, **kw)
            else:
                run = _Replay(layer, generator)
                x, a = checkpoint(run, *args, use_reentrant=False, **kw)
                run.advance()
            if a is not None:
                aux = aux + a
        if mode == "decode":
            # on the device, in place: a captured step replays it at every column
            cache.advance(input_ids.shape[1])
        return self.final_norm(x), {"load_balancing_loss": aux[0], "router_z_loss": aux[1]}


class MixtralForCausalLM(nn.Module):
    """The causal LM (JAX ``MixtralForCausalLM`` :231). Construction places
    every weight on ``device`` (CUDA unless ``device="cpu"``);
    :func:`init_params` or ``load_state_dict`` (``models/convert.py
    mixtral_flax_to_torch``) fills them. Weights are stored frozen in the
    compute dtype, the routers in f32; ``trainable=True`` builds fp32
    masters that train (``trainer/``), the routers f32 as well."""

    def __init__(self, config: MixtralConfig, device=None, trainable: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.trainable = trainable
        self.model = MixtralModel(config, device, trainable)
        self.lm_head = ColumnParallelLinear(config.hidden_size, config.vocab_size,
                                            use_bias=False,
                                            **_linear(config.as_llama(), device, trainable))

    device = LlamaForCausalLM.device
    new_cache = LlamaForCausalLM.new_cache
    new_paged_cache = LlamaForCausalLM.new_paged_cache

    def forward(self, input_ids, mode: str = "train", cache: Optional[KVCache] = None,
                positions=None, segment_ids=None, padding_mask=None, last_only: bool = False,
                head_at: Optional[int] = None, attn_mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """``(logits, aux)``: logits (B, S, V) (``last_only``: (B, 1, V) at
        the last position; ``head_at``: at that position alone, as
        ``LlamaForCausalLM.forward``), ``aux`` the router losses summed
        over layers (zeros outside train mode). ``deterministic=False`` turns the router jitter and the
        token shuffle on, drawn from ``generator``."""
        x, aux = self.model(input_ids, mode, cache, positions, segment_ids, padding_mask,
                            attn_mask, deterministic, generator)
        if last_only:
            x = x[:, -1:]
        elif head_at is not None:
            x = x[:, head_at:head_at + 1]
        return self.lm_head(x), aux

    def loss(self, input_ids, labels, segment_ids=None, loss_mask=None,
             deterministic: bool = True, generator: Optional[torch.Generator] = None):
        """Cross entropy plus the weighted router losses (JAX ``loss``
        :254). ``segment_ids``/``loss_mask``: packed documents (per-document
        attention, RoPE restarting at each document, masked boundary
        labels)."""
        from neuronx_distributed_tpu_torch.trainer.trainer import segment_positions

        cfg = self.config
        positions = segment_positions(segment_ids) if segment_ids is not None else None
        logits, aux = self(input_ids, positions=positions, segment_ids=segment_ids,
                           deterministic=deterministic, generator=generator)
        tok = parallel_cross_entropy(logits, labels)
        if loss_mask is not None:
            ce = (tok * loss_mask).sum() / loss_mask.sum().clamp_min(1)
        else:
            ce = tok.mean()
        return (ce + cfg.router_aux_loss_coef * aux["load_balancing_loss"]
                + cfg.router_z_loss_coef * aux["router_z_loss"])


def _fill(t: torch.Tensor, name: str, gen: torch.Generator) -> None:
    """One weight's seeded values, by :func:`init_params`'s rule."""
    if name == "model.embed.weight":
        t.normal_(0.0, 1.0, generator=gen)
    elif t.dim() >= 2:
        t.normal_(0.0, 1.0 / math.sqrt(t.shape[-1]), generator=gen)
    elif name.endswith(".weight"):  # a norm's scale
        t.fill_(1.0)
    else:  # a bias
        t.zero_()


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from ``seed`` on the model's own device: linears,
    routers and expert stacks N(0, 1/fan_in) (JAX's lecun-normal scale,
    untruncated; a stack's fan-in is one expert's), the embedding N(0, 1),
    norms 1 and biases 0, drawn weight by weight in state-dict order, for a
    Mixtral and for the other families (GPT-NeoX, CodeGen, DBRX: a 41 GB
    model is filled on the card with no host copy; a trainable model's
    fp32 masters as a serving model's stored weights). A quantized model
    draws each selected weight in the compute dtype, as the float model
    holds it, and stores its codes and scales (``quantize_weight``), so
    ``init_params(quantized)`` equals ``quantize_model(init_params(float))``
    bit for bit while one float weight at a time is in memory."""
    from neuronx_distributed_tpu_torch.quantization.utils import (
        _selected,
        quantize_weight,
        scale_name,
    )

    cfg = model.config
    qcfg = getattr(cfg, "quantization", None)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    sd = model.state_dict()
    scales = {scale_name(n) for n, t in sd.items() if _selected(n, t)}
    for name, t in sd.items():
        if name in scales:
            continue
        if qcfg is None or not _selected(name, t) or scale_name(name) not in sd:
            _fill(t, name, gen)
            continue
        w = torch.empty(t.shape, dtype=cfg.dtype, device=t.device)
        _fill(w, name, gen)
        q, s = quantize_weight(w, qcfg)
        del w
        t.copy_(q)
        sd[scale_name(name)].copy_(s)
    return model
