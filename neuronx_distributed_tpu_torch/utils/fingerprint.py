"""The prefix cache's integrity fingerprint (counterpart of
``neuronx_distributed_tpu/utils/fingerprint.py``, its ``cache_fingerprint``,
``:127-155``; the host CRCs, the tree bit-mix and the per-page pool
fingerprints belong to later slices).

A stored prefix block is fingerprinted at insert and again at every reuse,
and the two must be equal bit for bit: corruption detection (bit flips), not
cryptographic integrity."""

from __future__ import annotations

import torch


def cache_fingerprint(cache) -> torch.Tensor:
    """The position-weighted sum over every leaf of a prefix block (a
    :class:`~neuronx_distributed_tpu_torch.modules.attention.KVCache`), a
    0-d float32 tensor on its device, never read here: per layer the JAX
    collection's leaves ``index`` (the token count ``index``), ``k``,
    ``kv_valid`` and ``v``, each summed with weight ``1 + column`` along
    the column axis, K and V by magnitude. A corrupted element or a shifted
    block changes the value.

    One reduction order, the same for a given shape on a given device, so
    recomputing it on the same data gives the same bits: the columns' sums
    of ``|K|`` and ``|V|`` in float32, then the weighted sum over layers and
    columns in float64, rounded to float32 once. The JAX package sums in
    float32 throughout; the two agree to float32 rounding."""
    w = 1.0 + torch.arange(cache.max_seq_len, dtype=torch.float64, device=cache.valid.device)
    per_col = sum(x.abs().sum(dim=(-2, -1), dtype=torch.float32).to(torch.float64)
                  for x in (cache.k, cache.v))                  # (layers, B, cols)
    layers = cache.k.shape[0]
    total = ((per_col * w).sum()
             + layers * ((cache.valid.to(torch.float64) * w).sum() + cache.index))
    return total.to(torch.float32)
