"""Per-page pool fingerprints (no Pallas counterpart: XLA fuses JAX's
``pool_pages_fingerprint``, ``utils/fingerprint.py:158``, into one jitted
program, ``serving/engine.py:3026``).

For each page id ``page_ids[n]`` and each page-carrying pool leaf (the
leaves handed in, in order within a layer: K, then an int8 pool's K scale,
V, V scale), the leaf's page is read as the bit pattern of each element,
zero-extended to 32 bits (bf16 16 bits, int8 8, f32 32), and reduced to the
wrapping uint32 sum of ``bits(x_i) * ((i << 1) | 1)``, ``i`` the element's
position in the page flattened as ``(page_size, Hkv, D)``. The pages'
values then combine as ``total = total * PRIME + leaf_fp``, from ``SEED``,
walking the layers in ``layer_order`` and the leaves in the order given.
Integer sums wrap mod 2^32 whatever their order, so the kernel equals the
plain version bit for bit.

``pool_pages_fingerprint_fwd`` launches PF of ``csrc/page_fingerprint.cu``
for CUDA tensors (a block a (page, layer, leaf), then an ordered combine a
page: two kernels, one launch counted) and runs
:func:`pool_pages_fingerprint_plain` for CPU tensors. The values are int64
tensors holding the uint32 fingerprints (0 <= value < 2^32).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from neuronx_distributed_tpu_torch.observability.programs import metered

FINGERPRINT_SEED = 0x9E3779B9
FINGERPRINT_PRIME = 0x01000193
_MASK = 0xFFFFFFFF


def element_bits(x: torch.Tensor) -> torch.Tensor:
    """Each element's bit pattern as int64, zero-extended: bool and 8-bit
    types widen, 16- and 32-bit types are reinterpreted as unsigned, 64-bit
    types fold high ^ low (JAX ``_uint32_bits``, ``utils/fingerprint.py:86``)."""
    if x.dtype == torch.bool:
        return x.to(torch.int64)
    size = x.element_size()
    if size == 1:
        return x.view(torch.uint8).to(torch.int64)
    if size == 2:
        return x.view(torch.int16).to(torch.int64) & 0xFFFF
    if size == 4:
        return x.view(torch.int32).to(torch.int64) & _MASK
    u = x.view(torch.int64)
    return ((u >> 32) ^ u) & _MASK


def pool_pages_fingerprint_plain(leaves: Sequence[torch.Tensor], page_ids: torch.Tensor,
                                 layer_order: Sequence[int]) -> torch.Tensor:
    """(N,) int64 fingerprints of pages ``page_ids`` (N,) of the pool
    ``leaves``, each (L, P, *page), in int64 arithmetic masked to 32 bits:
    products masked before the sum, so no sum overflows."""
    n = page_ids.shape[0]
    per_layer = []
    for layer in range(leaves[0].shape[0]):
        fps = []
        for leaf in leaves:
            bits = element_bits(leaf[layer].index_select(0, page_ids).reshape(n, -1))
            w = 2 * torch.arange(bits.shape[1], dtype=torch.int64, device=bits.device) + 1
            fps.append(((bits * w) & _MASK).sum(dim=1) & _MASK)
        per_layer.append(fps)
    total = torch.full((n,), FINGERPRINT_SEED, dtype=torch.int64, device=page_ids.device)
    for layer in layer_order:
        for fp in per_layer[layer]:
            total = (total * FINGERPRINT_PRIME + fp) & _MASK
    return total


@functools.lru_cache(maxsize=None)
def _lib():
    from neuronx_distributed_tpu_torch.kernels import _build

    fn = _build.load("page_fingerprint").nxd_page_fingerprint_fwd
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    fn.restype = i
    # 4 leaf bases, their byte strides and element counts and sizes, the
    # ids, the order, the scratch and the output, the counts, the stream
    fn.argtypes = [vp] * 4 + [ll, vp, vp, vp, vp, i, i, i, vp]
    return fn


@functools.lru_cache(maxsize=None)
def _order_tensor(order: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(order, dtype=torch.int32, device=device)


def _kernel_call(leaves, page_ids, layer_order) -> torch.Tensor:
    from neuronx_distributed_tpu_torch.kernels import _build

    dev = page_ids.device
    if not 1 <= len(leaves) <= 4:
        raise ValueError(f"PF takes 1 to 4 pool leaves, got {len(leaves)}")
    num_layers, num_pages = leaves[0].shape[:2]
    for leaf in leaves:
        if (leaf.device != dev or leaf.shape[:2] != (num_layers, num_pages)
                or not leaf.is_contiguous() or leaf.element_size() not in (1, 2, 4)):
            raise ValueError(f"PF takes contiguous ({num_layers}, {num_pages}, ...) pool leaves of "
                             f"1-, 2- or 4-byte elements on the ids' device, got "
                             f"{leaf.dtype} {tuple(leaf.shape)} on {leaf.device}")
    if page_ids.dtype != torch.int64 or page_ids.dim() != 1 or not page_ids.is_contiguous():
        raise ValueError("page_ids must be a contiguous 1-D int64 tensor")
    order = tuple(int(x) for x in layer_order)
    if sorted(order) != list(range(num_layers)):
        raise ValueError(f"layer_order must order the {num_layers} layers, got {order}")
    n = page_ids.shape[0]
    out = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return out
    partial = torch.empty((n, num_layers, len(leaves)), dtype=torch.int32, device=dev)
    meta = (ctypes.c_longlong * 16)()
    ptrs = [None] * 4
    for j, leaf in enumerate(leaves):
        es = leaf.element_size()
        ptrs[j] = leaf.data_ptr()
        meta[4 * j:4 * j + 4] = (leaf.stride(0) * es, leaf.stride(1) * es,
                                 leaf[0, 0].numel(), es)
    err = _lib()(*ptrs, meta, page_ids.data_ptr(), _order_tensor(order, dev).data_ptr(),
                 partial.data_ptr(), out.data_ptr(), len(leaves), n, num_layers,
                 _build.stream_ptr(dev))
    _build.check(err, "pool_pages_fingerprint_fwd")
    return out


def _pf_cost(leaves, page_ids, layer_order):
    """PF's count for the program ledger: each page of each leaf read
    once (integer work: no FLOPs)."""
    n = page_ids.numel()
    return 0.0, sum(n * leaf.shape[0] * leaf[0, 0].numel() * leaf.element_size()
                    for leaf in leaves) + 8 * n


@metered("page_fingerprint", _pf_cost)
def pool_pages_fingerprint_fwd(leaves: Sequence[torch.Tensor], page_ids: torch.Tensor,
                               layer_order: Sequence[int]) -> torch.Tensor:
    """The fingerprints of :func:`pool_pages_fingerprint_plain`. CUDA
    tensors launch PF (contiguous leaves of 1-, 2- or 4-byte elements; ids
    within the pool, unchecked: checking would read the device) or raise;
    CPU tensors run the plain version. ``launches`` counts the calls that
    launched PF."""
    if page_ids.device.type == "cpu":
        return pool_pages_fingerprint_plain(leaves, page_ids, layer_order)
    out = _kernel_call(leaves, page_ids, layer_order)
    pool_pages_fingerprint_fwd.launches += 1
    return out


pool_pages_fingerprint_fwd.launches = 0
