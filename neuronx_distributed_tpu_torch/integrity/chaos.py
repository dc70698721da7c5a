"""Deterministic bit flips for the ``flip_bits`` chaos schedules
(counterpart of ``neuronx_distributed_tpu/integrity/chaos.py``:
``flip_array_bit``, ``flip_leaf_bit`` ``:48``, ``flip_tree_bit`` ``:89``).

The flip is ``byte[byte_index] ^= 1 << bit`` of a buffer's raw bytes; by
default bit 0 of byte 0, the least significant mantissa bit of the first
element: numerically almost invisible, which is the silent corruption a
bit-level fingerprint must catch where no logit guard would.

JAX's arrays are immutable, so its hands return a flipped COPY that the
engine binds. The port flips IN PLACE on the device (a one-byte xor, no host
read): the serving engine's captured programs read fixed addresses, so a
rebound copy would never be served, and HBM rot stays where it lands until
the replica is fenced. The per-device replicated flip
(``flip_replicated_leaf_on_device``) has no counterpart: a port engine
serves one device."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["flip_array_bit", "flip_leaf_bit", "flip_tree_bit"]


def flip_array_bit(host_array: np.ndarray, byte_index: int = 0, bit: int = 0) -> np.ndarray:
    """A copy of ``host_array`` with one bit of its raw bytes flipped (dtype
    and shape kept), as JAX's."""
    a = np.ascontiguousarray(host_array)
    raw = bytearray(a.tobytes())
    raw[byte_index % max(len(raw), 1)] ^= (1 << bit)
    return np.frombuffer(bytes(raw), dtype=a.dtype).reshape(np.shape(host_array))


def flip_leaf_bit(leaf: torch.Tensor, byte_index: int = 0, bit: int = 0) -> torch.Tensor:
    """Flip one bit of ``leaf``'s raw bytes IN PLACE, on its device (no
    host read); returns ``leaf``. It must be contiguous and not empty."""
    if not leaf.is_contiguous() or leaf.numel() == 0:
        raise ValueError(f"flip_leaf_bit needs a contiguous non-empty tensor, got "
                         f"{tuple(leaf.shape)} (contiguous {leaf.is_contiguous()})")
    raw = leaf.detach().reshape(-1).view(torch.uint8)
    i = byte_index % raw.numel()
    raw[i:i + 1].bitwise_xor_(1 << bit)
    return leaf


def flip_tree_bit(leaves: Sequence[torch.Tensor], leaf_index: int = 0) -> torch.Tensor:
    """Flip one bit of the ``leaf_index``-th tensor of ``leaves`` (the
    caller's fixed order) in place; returns that tensor."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("flip_tree_bit needs at least one tensor")
    return flip_leaf_bit(leaves[leaf_index % len(leaves)])
