"""Autoregressive generation with a KV cache (counterpart of
``neuronx_distributed_tpu/inference/generate.py``).

One prefill writes the prompt K/V into a :class:`KVCache` and yields the
first token; then each decode step appends one token. PyTorch runs eagerly,
so the JAX ``lax.scan`` becomes a Python loop over device tensors: the EOS
done-mask and the tokens stay on the device and nothing is read back until
the caller reads the result. Sampling is counter-based
(``utils/sampling.py``): row ``b`` of a batch draws the stream of seed
``seed + b``, token ``t`` its index ``t`` — so a request sampled through the
serving engine with seed ``s`` reproduces ``generate(..., seed=s)``.

The building blocks (mode views, validation, the decode write mask, the
fused multi-token chunk :func:`chunked_decode_step`) are shared with the
continuous-batching engine in ``serving/``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.inference.utils import unwrap_logits
from neuronx_distributed_tpu_torch.modules.attention import cache_cursor
from neuronx_distributed_tpu_torch.utils.sampling import sample, sample_per_row


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None


def pack_padded_prompt(tokens, padded_len: int, pad_side: str = "left"):
    """Pack a token sequence into a ``(1, padded_len)`` ids/mask pair.
    ``"left"`` (the generate/engine prefill contract) right-aligns the
    content so the last real token sits at index -1; ``"right"`` puts it at
    index 0. Returns host ``np`` arrays (ids int32, mask bool)."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    p = tokens.size
    if p > padded_len:
        raise ValueError(f"{p} tokens do not fit a padded length of {padded_len}")
    if pad_side not in ("left", "right"):
        raise ValueError(f"unknown pad_side {pad_side!r}")
    ids = np.zeros((1, padded_len), np.int32)
    mask = np.zeros((1, padded_len), bool)
    sl = slice(padded_len - p, None) if pad_side == "left" else slice(0, p)
    ids[0, sl] = tokens
    mask[0, sl] = True
    return ids, mask


class _ModeView:
    """A mode-bound view of a model that shares its weights — the torch
    form of the JAX ``model.clone(mode=...)``."""

    def __init__(self, model, mode: str):
        self.model, self.mode = model, mode
        self.config = model.config

    def __call__(self, input_ids, **kwargs):
        return self.model(input_ids, mode=self.mode, **kwargs)


def serving_clones(model):
    """``(prefill, decode)`` mode views sharing the caller's weights."""
    return _ModeView(model, "prefill"), _ModeView(model, "decode")


def decode_write_mask(done: torch.Tensor) -> torch.Tensor:
    """Validity (B, 1) of the INCOMING decode token: finished rows feed
    filler tokens whose K/V must not become attendable context."""
    return torch.logical_not(done)[:, None]


def chunked_decode_step(decode_model, chunk_size: int, max_seq_len: int):
    """Build the fused multi-token decode step of the serving engine: up to
    ``chunk_size`` decode steps over every slot between two host reads.

    Returned callable::

        fn(cache, state) -> (toks, counts, executed)

    ``state`` holds per-slot device tensors — ``tok`` pending input tokens,
    ``seed`` request seeds, ``ntok`` tokens emitted so far (the sampling
    index), ``active``, ``remaining`` tokens left, ``temp``/``topk``/
    ``topp`` sampling sentinels, ``eos`` (-1 = none) — and is updated in
    place.

    Semantics mirror the JAX chunk step by step: decode with the write mask
    hiding finished rows' K/V, per-row sample, EOS/budget freezing of
    ``tok``/``ntok``/``remaining``. Steps stop at ``max_seq_len``. JAX also
    skips the model once every slot is frozen (``lax.cond``); that needs the
    device's answer, so here such steps run as masked no-ops (every write
    invalid, no state change) and the caller rewinds the cursor to
    ``start + max(counts)`` after its one read — the cursor lands exactly
    where the JAX chunk leaves it.

    ``toks`` is the (chunk_size, B) token block, ``counts`` (B,) how many
    of each slot's tokens are real (a prefix: freezing is monotone) and
    ``executed`` the host count of model steps that ran, no-ops included."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")

    def chunk_fn(cache, state):
        allowed = max(0, min(max_seq_len - cache_cursor(cache), chunk_size))
        tok, ntok, remaining = state["tok"], state["ntok"], state["remaining"]
        done = torch.logical_not(state["active"])
        eos = state["eos"]
        b = tok.shape[0]
        toks = torch.zeros((chunk_size, b), dtype=torch.int64, device=tok.device)
        emits = torch.zeros((chunk_size, b), dtype=torch.bool, device=tok.device)
        for i in range(allowed):
            logits = unwrap_logits(decode_model(
                tok[:, None], cache=cache, padding_mask=decode_write_mask(done),
                last_only=True,
            ))[:, -1]
            nxt = sample_per_row(logits, state["seed"], ntok, state["temp"],
                                 state["topk"], state["topp"])
            emit = torch.logical_not(done)
            remaining = remaining - emit.to(remaining.dtype)
            finished = emit & (((eos >= 0) & (nxt == eos)) | (remaining <= 0))
            tok = torch.where(emit, nxt, tok)
            ntok = ntok + emit.to(ntok.dtype)
            done = done | finished
            toks[i] = nxt
            emits[i] = emit
        state.update(tok=tok, ntok=ntok, remaining=remaining,
                     active=torch.logical_not(done))
        return toks, emits.sum(0), allowed

    return chunk_fn


def validate_generate_args(model, prompt_ids, max_new_tokens, attention_mask):
    """Host-side checks shared by `generate` and the engine's admission:
    capacity (prompt + new tokens within the cache) and the LEFT-padding
    contract of ``attention_mask``."""
    max_len = getattr(getattr(model, "config", None), "max_seq_len", None)
    if max_len is not None and prompt_ids.shape[1] + max_new_tokens > max_len:
        raise ValueError(
            f"prompt ({prompt_ids.shape[1]}) + max_new_tokens "
            f"({max_new_tokens}) exceeds the model's max_seq_len ({max_len})"
        )
    if attention_mask is not None:
        if tuple(attention_mask.shape) != tuple(prompt_ids.shape):
            raise ValueError(
                f"attention_mask shape {tuple(attention_mask.shape)} != prompt_ids "
                f"shape {tuple(prompt_ids.shape)}"
            )
        if not bool(torch.as_tensor(attention_mask)[:, -1].all()):
            raise ValueError(
                "attention_mask has invalid tokens in the LAST column — "
                "generate() requires LEFT padding (every row's final prompt "
                "token at index -1)"
            )


def generate(model, prompt_ids, config: GenerationConfig = GenerationConfig(),
             attention_mask=None, seed: int = 0) -> torch.Tensor:
    """Generate ``(B, max_new_tokens)`` token ids continuing ``prompt_ids``
    (B, S) on the model's device. ``attention_mask`` (B, S), True at valid
    tokens, serves LEFT-padded batches: the mask persists in the cache and
    RoPE positions restart at each row's first valid token. Row ``b`` samples
    with seed ``seed + b``."""
    cfg = config
    validate_generate_args(model, prompt_ids, cfg.max_new_tokens, attention_mask)
    device = model.device
    ids = torch.as_tensor(np.asarray(prompt_ids) if not torch.is_tensor(prompt_ids)
                          else prompt_ids).to(device=device, dtype=torch.int64)
    mask = (torch.as_tensor(attention_mask).to(device=device, dtype=torch.bool)
            if attention_mask is not None else None)
    prefill, decode = serving_clones(model)
    b = ids.shape[0]
    seeds = seed + torch.arange(b, dtype=torch.int64, device=device)

    def _sample(logits, index):
        return sample(logits, seeds, index, temperature=cfg.temperature,
                      top_k=cfg.top_k, top_p=cfg.top_p)

    cache = model.new_cache(b)
    with torch.no_grad():
        logits = unwrap_logits(prefill(ids, cache=cache, padding_mask=mask,
                                       last_only=True))[:, -1]
        tok = _sample(logits, 0)
        eos = cfg.eos_token_id
        done = tok == eos if eos is not None else torch.zeros_like(tok, dtype=torch.bool)
        toks = [tok]
        for t in range(1, cfg.max_new_tokens):
            logits = unwrap_logits(decode(tok[:, None], cache=cache,
                                          padding_mask=decode_write_mask(done),
                                          last_only=True))[:, -1]
            nxt = _sample(logits, t)
            if eos is not None:
                nxt = torch.where(done, eos, nxt)
                done = done | (nxt == eos)
            tok = nxt
            toks.append(nxt)
    return torch.stack(toks, dim=1)
