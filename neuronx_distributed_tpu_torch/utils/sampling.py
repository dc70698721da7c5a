"""On-device token sampling (counterpart of
``neuronx_distributed_tpu/utils/sampling.py``).

All functions take logits ``(..., V)`` and return int64 token ids
``(...,)``. Temperature → top-k filter → top-p filter → Gumbel-max sample,
as in the JAX module.

Randomness. ``jax.random`` keys cannot be reproduced in PyTorch, and a
``torch.Generator`` would tie a request's draws to the batch it happens to
share. The Gumbel noise here is COUNTER-BASED instead: the noise for vocab
column ``c`` of a row is a pure integer hash of ``(seed, index, c)``, where
``seed`` identifies the request and ``index`` is the position of the token
being sampled in its generated stream. So a request's draws depend on its
seed and token index only — never on its slot, its batch or the chunking —
which keeps the JAX invariant that a request served through the engine
samples exactly the stream of its solo ``generate()`` (on the same device:
the float ``log`` of the last step may round differently on CPU and GPU).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 tensors holding uint32 values, split
    in 16-bit halves so no intermediate overflows int64."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, index: Union[int, torch.Tensor],
                 vocab: int) -> torch.Tensor:
    """Standard Gumbel noise ``(B, vocab)`` float32 for rows with request
    ``seeds`` (B,) at token ``index`` (int or (B,)). Integer hashing only,
    so every device computes the same bits up to the final ``log``."""
    seeds = seeds.to(torch.int64)
    index = torch.as_tensor(index, dtype=torch.int64, device=seeds.device)
    index = index.expand_as(seeds)
    h = _mix32((seeds & _M32) ^ 0x9E3779B9)
    h = _mix32(h ^ ((seeds >> 32) & _M32))
    h = _mix32(h ^ (index & _M32))
    cols = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    x = _mix32(_mix32(h[:, None] ^ cols[None, :]) ^ 0x6A09E667)
    # 24 random bits → u in (0, 1), exclusive at both ends
    u = ((x >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def greedy(logits: torch.Tensor) -> torch.Tensor:
    # torch.argmax returns the first maximal index, as jnp.argmax does
    return torch.argmax(logits, dim=-1)


def _filter_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, float("-inf"), logits)


def _filter_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep the smallest prefix with cumulative prob >= p (always >= 1 token)
    cutoff_mask = cum - probs < p
    thresh = torch.where(cutoff_mask, sorted_logits, float("inf")).amin(
        -1, keepdim=True
    )
    return torch.where(logits < thresh, float("-inf"), logits)


def sample(
    logits: torch.Tensor,
    seeds: torch.Tensor,
    index: Union[int, torch.Tensor],
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """Sample one token per row of ``logits`` (B, V) with one Python-constant
    config; rows draw the noise of ``(seeds[b], index)``. The same tokens as
    :func:`sample_per_row` with that config broadcast per row."""
    if temperature == 0.0:
        return greedy(logits)
    x = logits.to(torch.float32) / temperature
    if top_k is not None and top_k > 0:
        x = _filter_top_k(x, top_k)
    if top_p is not None and top_p < 1.0:
        x = _filter_top_p(x, top_p)
    return torch.argmax(x + gumbel_noise(seeds, index, x.shape[-1]), dim=-1)


# --- per-row sampling (continuous-batching serving) ---------------------------
#
# The serving engine runs ONE decode step over all slots, so the sampling
# config is per-row tensor data. Sentinels as in the JAX module: top_k <= 0
# and top_p >= 1.0 disable a filter, temperature == 0.0 is greedy.

def sample_per_row(
    logits: torch.Tensor,
    seeds: torch.Tensor,
    index: Union[int, torch.Tensor],
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """Per-row tokens for logits (B, V) with per-row (B,) config tensors —
    the vectorized ``sample_row`` of the JAX module, with the same filter
    thresholds (k-th largest value / smallest top-p prefix)."""
    v = logits.shape[-1]
    greedy_tok = greedy(logits)
    temp = temperature.to(torch.float32)
    x = logits.to(torch.float32) / torch.where(temp == 0.0, 1.0, temp)[:, None]
    desc = torch.sort(x, dim=-1, descending=True).values
    k = top_k.to(torch.int64)
    kth = desc.gather(-1, (k.clamp(1, v) - 1)[:, None])
    cut_k = (k > 0)[:, None]
    x = torch.where(cut_k & (x < kth), float("-inf"), x)
    # the filter maps a down-set to -inf, so the filtered x sorted
    # descending is the filter applied to `desc` elementwise
    desc = torch.where(cut_k & (desc < kth), float("-inf"), desc)
    p = top_p.to(torch.float32)[:, None]
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_mask = cum - probs < p
    thresh = torch.where(cutoff_mask, desc, float("inf")).amin(-1, keepdim=True)
    x = torch.where((p < 1.0) & (x < thresh), float("-inf"), x)
    tok = torch.argmax(x + gumbel_noise(seeds, index, v), dim=-1)
    return torch.where(temp == 0.0, greedy_tok, tok)


def sample_row(
    logits: torch.Tensor,
    seed: int,
    index: int,
    temperature: float,
    top_k: int,
    top_p: float,
) -> torch.Tensor:
    """One row's token from ``logits`` (V,) with sentinel config — the
    engine's first-token sampler. Same tokens as :func:`sample_per_row`."""
    dev = logits.device
    return sample_per_row(
        logits[None],
        torch.tensor([seed], dtype=torch.int64, device=dev),
        index,
        torch.tensor([temperature], dtype=torch.float32, device=dev),
        torch.tensor([top_k], dtype=torch.int64, device=dev),
        torch.tensor([top_p], dtype=torch.float32, device=dev),
    )[0]
