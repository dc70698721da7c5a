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
``config.quantization`` (a ``QuantizationConfig``) every linear, lm_head
included, holds int8/fp8 weights with f32 scales and dequantizes them for
each product (JAX ``llama.py:61``); the embedding stays in the compute
dtype. Such a model serves only (``ServingEngine(quantize=)`` builds one
from a float model). With
``remat`` each decoder layer of a differentiated train-mode forward runs
under activation checkpointing (JAX ``nn.remat``, ``_remat_layer_cls``):
``remat_policy`` None recomputes everything, ``"dots"`` keeps the outputs of
the products without batch dimensions (``mm``/``addmm``: the linears) and
``"dots_saveable"`` those of every product (``bmm`` too), through
``torch.utils.checkpoint``'s selective-checkpoint contexts. K1 is no torch
product: its output is recomputed under every policy, as JAX recomputes a
``pallas_call``. A policy only chooses what is kept, so the gradients are
policy None's bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

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
from neuronx_distributed_tpu_torch.quantization.config import QuantizationConfig
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
    # what remat keeps: None (nothing), "dots" or "dots_saveable" (REMAT_POLICIES)
    remat_policy: Optional[str] = None
    # weight-only serving quantization of every linear (not the embedding)
    quantization: Optional[QuantizationConfig] = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
# the ops whose outputs each policy keeps: JAX's
# dots_with_no_batch_dims_saveable and dots_saveable
REMAT_POLICIES = {None: (), "dots": _MM, "dots_saveable": _MM + _BATCHED}


def remat_context_fn(policy: Optional[str]):
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for a
    remat policy, or None for policy None (recompute everything)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; one of {sorted(map(str, REMAT_POLICIES))}")
    saved = REMAT_POLICIES[policy]
    if not saved:
        return None

    def keep(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, keep)


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


def _linear(cfg: LlamaConfig, device, trainable: bool) -> dict:
    """Storage options of the linears: the weights' plus the quantization
    config."""
    return dict(_weights(cfg, device, trainable), quantization_config=cfg.quantization)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device, trainable: bool = False):
        super().__init__()
        cfg = self.config = config
        d = cfg.head_dim_
        w = _linear(cfg, device, trainable)
        self.qkv = GQAQKVColumnParallelLinear(
            cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, d, **w)
        self.o_proj = RowParallelLinear(cfg.num_heads * d, cfg.hidden_size, use_bias=False, **w)

    def forward(self, x, freqs, positions, mode: str, cache: Optional[KVCache],
                layer: int, q_pos=None, segment_ids=None, padding_mask=None, attn_mask=None):
        """``positions`` are the RoPE positions; ``q_pos`` (s,) the decode
        rows' query positions and ``attn_mask`` (s, L) a tree mask that
        replaces their positional one (decode only)."""
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
            out = cache.write_attend(layer, q, k, v, q_pos, attn_mask)
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
        common = dict(use_bias=False, **_linear(cfg, device, trainable))
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
                segment_ids=None, padding_mask=None, attn_mask=None):
        x = x + self.attn(self.input_norm(x), freqs, positions, mode, cache,
                          layer, q_pos, segment_ids, padding_mask, attn_mask)
        return x + self.mlp(self.post_attn_norm(x))


def mode_inputs(config, input_ids, mode: str, cache: Optional[KVCache], positions,
                padding_mask):
    """A backbone forward's mode bookkeeping, before its layers run:
    ``(positions, q_pos, padding_mask)``. A prefill records the prompt's
    validity in the cache (RoPE positions from ``padding_mask`` unless
    given); a decode takes its query and RoPE positions from the cache's
    device cursor and records the step's validity, which attention then
    reads from the cache (so ``padding_mask`` becomes None)."""
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}")
    if mode != "train" and cache is None:
        raise ValueError(f"mode {mode!r} needs a KVCache")
    s = input_ids.shape[1]
    if s > config.max_seq_len:
        raise ValueError(f"prompt length {s} exceeds max_seq_len={config.max_seq_len}")
    q_pos = None
    if mode == "prefill":
        if positions is None and padding_mask is not None:
            positions = prefill_positions(padding_mask)
        cache.prefill_valid(padding_mask, s)
    elif mode == "decode":
        q_pos, positions = cache.decode_positions(s, positions)
        cache.decode_valid(padding_mask, s)
        padding_mask = None  # persisted in the cache; attention reads kv_valid
    return positions, q_pos, padding_mask


class LlamaModel(nn.Module):
    """Backbone without the LM head; returns the final-normed hidden states
    (B, S, hidden), which the heads read (the LM head, Medusa's heads).

    In decode mode, explicit ``positions`` (s,) and an ``attn_mask`` (s, L)
    make a Medusa tree step (JAX ``llama.py:274-287``): RoPE and the query
    positions follow ``positions``, the mask replaces the positional one,
    and the K/V still land at the cursor, which advances by s."""

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
                positions=None, segment_ids=None, padding_mask=None, attn_mask=None):
        positions, q_pos, padding_mask = mode_inputs(self.config, input_ids, mode, cache,
                                                     positions, padding_mask)
        x = self.embed(input_ids)
        remat = self.config.remat and mode == "train" and torch.is_grad_enabled()
        kw = {}
        if remat:
            context_fn = remat_context_fn(self.config.remat_policy)
            if context_fn is not None:
                kw["context_fn"] = context_fn
        for i, layer in enumerate(self.layers):
            args = (x, self.freqs, positions, mode, cache, i, q_pos, segment_ids, padding_mask,
                    attn_mask)
            x = checkpoint(layer, *args, use_reentrant=False, **kw) if remat else layer(*args)
        if mode == "decode":
            # on the device, in place: a decode forward changes no host
            # state, so a captured step replays it at every column
            cache.advance(input_ids.shape[1])
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
                                            **_linear(config, device, trainable))

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def new_cache(self, batch: int) -> KVCache:
        """A zeroed row-per-batch cache for this model on its device."""
        cfg = self.config
        return KVCache.allocate(cfg.num_layers, batch, cfg.max_seq_len,
                                cfg.num_kv_heads, cfg.head_dim_, cfg.dtype, self.device)

    def new_paged_cache(self, batch: int, num_pages: int, page_size: int,
                        kv_quant: Optional[str] = None) -> PagedKVCache:
        """A zeroed paged cache for this model on its device: a pool of
        ``num_pages`` pages of ``page_size`` columns per layer and a
        ``(batch, max_seq_len // page_size)`` block table of null pages;
        ``kv_quant="int8"`` makes the pool int8 with scales."""
        cfg = self.config
        return PagedKVCache.allocate(cfg.num_layers, batch, cfg.max_seq_len,
                                     cfg.num_kv_heads, cfg.head_dim_, cfg.dtype, self.device,
                                     num_pages=num_pages, page_size=page_size,
                                     kv_quant=kv_quant)

    def forward(self, input_ids, mode: str = "train", cache: Optional[KVCache] = None,
                positions=None, segment_ids=None, padding_mask=None,
                last_only: bool = False, head_at: Optional[int] = None, attn_mask=None):
        """Logits (B, S, V); ``last_only`` computes the head on the last
        position alone (B, 1, V) — all a prefill's next token needs — and
        ``head_at`` on position ``head_at`` alone (a right-padded suffix
        prefill's last real token). ``attn_mask``: a tree step's mask
        (:class:`LlamaModel`)."""
        x = self.model(input_ids, mode, cache, positions, segment_ids, padding_mask, attn_mask)
        if last_only:
            x = x[:, -1:]
        elif head_at is not None:
            x = x[:, head_at:head_at + 1]
        return self.lm_head(x)

    def loss(self, input_ids, labels):
        """Mean next-token cross entropy of ``labels`` (JAX ``loss``,
        ``llama.py:420``)."""
        return parallel_cross_entropy(self(input_ids), labels).mean()


_EARLY_EXIT_SCALED = ("attn.o_proj.", "mlp.down_proj.")


@torch.no_grad()
def early_exit_draft_params(state_dict, num_layers: int, draft_layers: int, eps: float):
    """The EARLY-EXIT draft pair on state dicts (JAX ``early_exit_draft_params``,
    ``llama.py:104``): ``(target, draft)`` where ``target`` is ``state_dict``
    with the residual contributions of layers ``draft_layers..num_layers-1``
    (their ``o_proj``/``down_proj`` weights) scaled by ``eps``, and
    ``draft`` the first ``draft_layers`` layers with the embedding, final
    norm and head shared. At ``eps=0`` draft and target are the same
    function; a larger ``eps`` degrades their agreement smoothly.

    The scaled weights are NEW tensors (``w * eps``): nothing is scaled in
    place, so the caller's tensors keep their bits (bf16 scaling does not
    round-trip). Every other entry is the caller's own tensor, in both
    dicts."""
    if not 0 < draft_layers < num_layers:
        raise ValueError(f"draft_layers must be in [1, {num_layers - 1}], got {draft_layers}")
    target, draft = {}, {}
    for name, t in state_dict.items():
        layer = int(name.split(".")[2]) if name.startswith("model.layers.") else None
        rest = name.split(".", 3)[3] if layer is not None else ""
        if layer is not None and layer >= draft_layers and rest.startswith(_EARLY_EXIT_SCALED):
            t = t * eps
        target[name] = t
        if layer is None or layer < draft_layers:
            draft[name] = state_dict[name]
    return target, draft


def _bind(model: nn.Module, tensors: dict) -> nn.Module:
    """Put ``tensors`` (a state dict of parameters, plus ``model.freqs``) in
    ``model`` as its own, by reference: no copy."""
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        if leaf in mod._parameters:
            mod._parameters[leaf] = t if isinstance(t, nn.Parameter) else nn.Parameter(
                t, requires_grad=False)
        else:
            mod._buffers[leaf] = t
    return model


def storage_ptrs(module: nn.Module) -> set:
    """The addresses of the storages behind a module's parameters and
    buffers: a view, a tied weight or a tensor bound by reference has its
    source's storage, and distinct storages never overlap."""
    return {t.untyped_storage().data_ptr()
            for t in itertools.chain(module.parameters(), module.buffers())
            if t.untyped_storage().nbytes()}


def shares_storage(a: nn.Module, b: nn.Module) -> bool:
    """Whether any tensor of module ``a`` shares device memory with one of
    module ``b``."""
    return not storage_ptrs(a).isdisjoint(storage_ptrs(b))


@torch.no_grad()
def copy_state_dict_(module: nn.Module, state_dict: dict, what: str = "params") -> None:
    """Write ``state_dict`` into ``module``'s own tensors IN PLACE
    (``copy_`` on the current stream; host or device sources): every
    ``data_ptr`` stays, so a captured program reads the new values. Every
    key, shape and dtype is checked before the first tensor is written: a
    refused dict leaves the module bit for bit as it was
    (``nn.Module.load_state_dict`` copies the matching tensors before it
    raises on a missing key)."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(own))
    if missing or unexpected:
        raise ValueError(f"{what}: the state dict does not match the model's: missing "
                         f"{missing[:4]}{'...' if len(missing) > 4 else ''}, unexpected "
                         f"{unexpected[:4]}{'...' if len(unexpected) > 4 else ''}")
    for name, dst in own.items():
        src = state_dict[name]
        if not isinstance(src, torch.Tensor):
            raise TypeError(f"{what}[{name!r}] is a {type(src).__name__}, not a tensor")
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            raise ValueError(f"{what}[{name!r}] is {src.dtype} {tuple(src.shape)}; the model "
                             f"holds {dst.dtype} {tuple(dst.shape)}")
    for name, dst in own.items():
        dst.copy_(state_dict[name])


def early_exit_draft(model: LlamaForCausalLM, draft_layers: int, eps: float):
    """The early-exit pair as models: ``(target, draft)``, two new
    :class:`LlamaForCausalLM` whose tensors ARE ``model``'s (no copy), but
    for the target's scaled ``o_proj``/``down_proj`` weights of layers
    ``draft_layers..`` (new tensors, :func:`early_exit_draft_params`); the
    draft runs the first ``draft_layers`` layers. ``model`` is left as it
    was. The pair is built on the ``meta`` device and bound to ``model``'s
    tensors, so it costs the scaled weights' memory alone."""
    cfg = model.config
    sd = model.state_dict(keep_vars=True)
    t_sd, d_sd = early_exit_draft_params(sd, cfg.num_layers, draft_layers, eps)
    freqs = {"model.freqs": model.model.freqs}
    target = _bind(LlamaForCausalLM(cfg, device="meta", trainable=model.trainable),
                   {**t_sd, **freqs})
    d_cfg = dataclasses.replace(cfg, num_layers=draft_layers)
    draft = _bind(LlamaForCausalLM(d_cfg, device="meta", trainable=model.trainable),
                  {**d_sd, **freqs})
    return target, draft


def quantize_model(model: LlamaForCausalLM, qcfg: QuantizationConfig) -> LlamaForCausalLM:
    """A serving model of ``model``'s class (a :class:`LlamaForCausalLM`,
    or a ``MixtralForCausalLM`` with its expert stacks) with ``qcfg``
    quantized weights made from the float ``model`` (the JAX engine's quantized clone and
    ``quantize_param_tree``, ``serving/engine.py:536-557``, which returns a
    fresh tree): every linear's codes and scales are new tensors
    (``quantize_state_dict``), the embedding and the norms are copies (a
    weight swap writes the quantized model in place and must not write
    ``model``'s); the RoPE table, never written, is ``model``'s own.
    ``model`` is left as it was."""
    from neuronx_distributed_tpu_torch.quantization.utils import quantize_state_dict

    if model.config.quantization is not None:
        raise ValueError("model already carries a quantization config")
    src = model.state_dict(keep_vars=True)
    sd = {name: t.detach().clone() if t is src.get(name) else t
          for name, t in quantize_state_dict(src, qcfg).items()}
    cfg = dataclasses.replace(model.config, quantization=qcfg)
    return _bind(type(model)(cfg, device="meta"), {**sd, "model.freqs": model.model.freqs})


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
