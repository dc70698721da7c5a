"""Integrity fingerprints (counterpart of
``neuronx_distributed_tpu/utils/fingerprint.py``: the host CRCs
``page_fingerprint``, ``:66``, and ``bytes_fingerprint``, ``:77``;
``cache_fingerprint``, ``:127-155``; ``pool_pages_fingerprint``, ``:158``,
with its bit mix and constants; ``tree_fingerprint``, ``:119``, with
``_uint32_bits``, ``:96``, and ``_leaf_fingerprint``, ``:111``).

A stored prefix block (a row entry's copy, or a paged entry's pool pages) is
fingerprinted at insert and again at every reuse, and the two must be equal
bit for bit; a page spilled to the host tier carries the CRC-32 of its bytes,
checked before it goes back to the pool. Corruption detection (bit flips,
rot), not cryptographic integrity."""

from __future__ import annotations

import zlib
from typing import Sequence, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.kernels.page_fingerprint import (  # noqa: F401
    FINGERPRINT_PRIME,
    FINGERPRINT_SEED,
    pool_pages_fingerprint_fwd,
)
from neuronx_distributed_tpu_torch.kernels.tree_fingerprint import tree_fingerprint_fwd


def raw_bytes(block) -> np.ndarray:
    """The bytes of a host block in C order, as a uint8 array: a CPU tensor
    of any dtype (``Tensor.numpy()`` refuses bf16, so through a byte view) or
    a numpy array."""
    if isinstance(block, torch.Tensor):
        t = block.contiguous()
        return t.reshape(-1).view(torch.uint8).numpy() if t.numel() else np.empty(0, np.uint8)
    return np.ascontiguousarray(block).reshape(-1).view(np.uint8)


def page_fingerprint(blocks) -> int:
    """CRC-32 chained over a page's per-leaf blocks in storage order (JAX
    ``page_fingerprint``): ``blocks`` is the host tier's ``[(leaf name,
    block)]`` page representation."""
    fp = 0
    for _, block in blocks:
        fp = zlib.crc32(raw_bytes(block), fp)
    return fp


def bytes_fingerprint(data, fp: int = 0) -> int:
    """CRC-32 of raw bytes, chainable (pass the previous value as ``fp``)."""
    return zlib.crc32(data, fp)


def tree_fingerprint(tree) -> torch.Tensor:
    """One uint32 over every tensor of ``tree`` (JAX ``tree_fingerprint``),
    a 0-d int64 tensor on their device, never read here: each leaf's bits
    mixed with odd position weights ``2i + 1`` and summed mod 2^32, the
    leaves combined as ``total * PRIME + leaf`` in the CALLER's order (a
    sequence of tensors, or a mapping's values in its iteration order).
    Through ``kernels/tree_fingerprint.py``: TF on the card, the plain
    version on the CPU.

    On the same leaves in the same order it equals JAX's value bit for bit.
    The port's fingerprint of its own state dict does NOT equal JAX's of
    the flax tree: a Flax ``kernel`` is (in, out) where a torch ``weight``
    is (out, in), the mix depends on position, and the two trees order
    their leaves otherwise. That equality is no goal: the port's values are
    only ever compared with other port values (the router's vote)."""
    leaves = list(tree.values()) if isinstance(tree, dict) else list(tree)
    return tree_fingerprint_fwd(leaves)


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


def jax_layer_order(num_layers: int) -> Tuple[int, ...]:
    """The layers in the order the JAX package's pool tree flattens them:
    its unscanned layers are dict keys ``layers_<i>``, flattened in sorted
    key order, so ``layers_10`` comes before ``layers_2``."""
    return tuple(sorted(range(num_layers), key=lambda i: f"layers_{i}"))


def pool_leaves(cache) -> tuple:
    """The page-carrying leaves of a :class:`~neuronx_distributed_tpu_torch.
    modules.attention.PagedKVCache` in the JAX package's order within a
    layer (sorted keys: ``k``, ``k_scale``, ``v``, ``v_scale``; the scales
    only on an int8 pool), each (num_layers, num_pages, *page)."""
    if cache.k_scale is None:
        return cache.k, cache.v
    return cache.k, cache.k_scale, cache.v, cache.v_scale


def pool_pages_fingerprint(cache, page_ids: Sequence[int]) -> torch.Tensor:
    """Per-page content fingerprints of pool pages ``page_ids`` (JAX
    ``pool_pages_fingerprint``): an (N,) int64 device tensor of uint32
    values, never read here. Each page-carrying leaf's page is bit-mixed on
    its own (``kernels/page_fingerprint.py``; PF on the card) and the leaves
    combine in the JAX package's order: layers by sorted ``layers_<i>`` key,
    then ``k``, ``k_scale``, ``v``, ``v_scale``. So the values equal JAX's
    for its unscanned layout (``scan_layers=False``); a scanned JAX pool
    holds one leaf over all layers and gives other values. The ids go to
    the device as a host-to-device copy, no read."""
    ids = torch.as_tensor(list(page_ids), dtype=torch.int64, device=cache.k.device)
    return pool_pages_fingerprint_fwd(pool_leaves(cache), ids,
                                      jax_layer_order(cache.k.shape[0]))
