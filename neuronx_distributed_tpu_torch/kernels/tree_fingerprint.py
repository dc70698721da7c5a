"""One fingerprint over a sequence of tensors (no Pallas counterpart: XLA
fuses JAX's ``tree_fingerprint``, ``utils/fingerprint.py:119``, into one
jitted program, ``serving/engine.py:1865``).

For each leaf, in the order given, the elements ``x_i`` (``i`` the position
in the leaf flattened in C order) reduce to the wrapping uint32 sum of
``bits(x_i) * ((i << 1) | 1)``: ``bits`` the element's pattern
zero-extended to 32 bits (bool and 8-bit types 8 bits, 16-bit types 16,
32-bit types 32; a 64-bit element folds high ^ low). The leaves combine as
``total = total * PRIME + leaf_fp`` from ``SEED``. Integer sums wrap mod
2^32 whatever their order, so the kernel equals the plain version bit for
bit.

:class:`TreeFingerprint` holds a fixed sequence of tensors: on the card it
builds TF's device tables once (``csrc/tree_fingerprint.cu``: the leaves'
addresses, sizes and widths, and the work items, 1 MiB of one leaf each)
and each call launches TF once (two kernels: the items, then the ordered
combine; one launch counted), so a probe costs one launch and the caller's
one read of the result. The tables hold addresses: a tensor rebound since
(another ``data_ptr``) rebuilds them at the next call. CPU tensors run
:func:`tree_fingerprint_plain`. Values are 0-d int64 tensors holding the
uint32 fingerprint (0 <= value < 2^32), never read here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from neuronx_distributed_tpu_torch.observability.programs import kernel_cost
from neuronx_distributed_tpu_torch.kernels.page_fingerprint import (
    FINGERPRINT_PRIME,
    FINGERPRINT_SEED,
    element_bits,
)

_MASK = 0xFFFFFFFF
# the plain version's chunk: int64 temporaries of a few chunks' elements
PLAIN_CHUNK = 1 << 24


def leaf_fingerprint_plain(leaf: torch.Tensor, chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """One leaf's wrapping uint32 position-weighted bit sum as a 0-d int64
    tensor on its device: int64 ops, each product masked to 32 bits before
    the sum, a chunk of ``chunk`` elements at a time with the global position
    carried, so the temporaries stay bounded."""
    flat = leaf.reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=leaf.device)
    for s in range(0, flat.numel(), chunk):
        bits = element_bits(flat[s:s + chunk])
        w = (2 * torch.arange(s, s + bits.numel(), dtype=torch.int64, device=leaf.device) + 1) & _MASK
        # a 32 x 32-bit product may wrap int64; its low 32 bits stay exact
        total = (total + ((bits * w) & _MASK).sum()) & _MASK
    return total


def tree_fingerprint_plain(leaves: Sequence[torch.Tensor], chunk: int = PLAIN_CHUNK,
                           device=None) -> torch.Tensor:
    """The fingerprint of ``leaves`` in the order given, a 0-d int64 tensor
    on their device (``device`` for an empty sequence; default the CPU)."""
    leaves = list(leaves)
    dev = leaves[0].device if leaves else torch.device(device or "cpu")
    total = torch.full((), FINGERPRINT_SEED, dtype=torch.int64, device=dev)
    for leaf in leaves:
        total = (total * FINGERPRINT_PRIME + leaf_fingerprint_plain(leaf, chunk)) & _MASK
    return total


@functools.lru_cache(maxsize=None)
def _lib():
    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load("tree_fingerprint")
    fn = lib.nxd_tree_fingerprint_fwd
    vp = ctypes.c_void_p
    fn.restype = ctypes.c_int
    # the leaf and item tables, the two scratches, the output, the leaf
    # count, the item count, the stream
    fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_longlong, vp]
    lib.nxd_tree_fingerprint_item_bytes.restype = ctypes.c_longlong
    lib.nxd_tree_fingerprint_item_bytes.argtypes = []
    return fn, int(lib.nxd_tree_fingerprint_item_bytes())


def tree_bytes(leaves: Sequence[torch.Tensor]) -> int:
    """The bytes TF reads: every element of every leaf once."""
    return sum(t.numel() * t.element_size() for t in leaves)


class TreeFingerprint:
    """TF over a fixed sequence of tensors (all on one device). On the card
    the device tables are built at construction (and again if a tensor was
    rebound); each call launches TF once and returns the 0-d int64
    fingerprint. On the CPU each call runs the plain version."""

    def __init__(self, leaves: Sequence[torch.Tensor]):
        self.leaves = list(leaves)
        devs = {t.device for t in self.leaves}
        if len(devs) > 1:
            raise ValueError(f"TF fingerprints the leaves of one device, got {sorted(map(str, devs))}")
        self.device = devs.pop() if devs else torch.device("cpu")
        self._ptrs = None
        if self.device.type == "cuda":
            self._build_tables()

    def _build_tables(self) -> None:
        for t in self.leaves:
            if not t.is_contiguous() or t.element_size() not in (1, 2, 4, 8):
                raise ValueError(f"TF takes contiguous leaves of 1-, 2-, 4- or 8-byte elements, "
                                 f"got {t.dtype} {tuple(t.shape)} (contiguous "
                                 f"{t.is_contiguous()})")
        _, item_bytes = _lib()
        leaf_rows, item_rows = [], []
        for j, t in enumerate(self.leaves):
            per_item = item_bytes // t.element_size()
            item_rows += [(j, e0) for e0 in range(0, t.numel(), per_item)]
            leaf_rows.append((t.data_ptr(), t.numel(), t.element_size(), len(item_rows)))
        dev = self.device
        self._leaf_table = torch.tensor(leaf_rows or [(0, 0, 1, 0)], dtype=torch.int64, device=dev)
        self._item_table = torch.tensor(item_rows or [(0, 0)], dtype=torch.int64, device=dev)
        self._n_items = len(item_rows)
        self._partial = torch.empty((max(self._n_items, 1),), dtype=torch.int32, device=dev)
        self._leaf_fp = torch.empty((max(len(self.leaves), 1),), dtype=torch.int32, device=dev)
        self._ptrs = [t.data_ptr() for t in self.leaves]

    @property
    def nbytes(self) -> int:
        return tree_bytes(self.leaves)

    def __call__(self) -> torch.Tensor:
        # the ledger's count: every byte of the tree read once, no FLOPs
        with kernel_cost("tree_fingerprint", 0.0, self.nbytes + 8):
            return self._run()

    def _run(self) -> torch.Tensor:
        if self.device.type != "cuda":
            return tree_fingerprint_plain(self.leaves, device=self.device)
        from neuronx_distributed_tpu_torch.kernels import _build

        if self._ptrs != [t.data_ptr() for t in self.leaves]:
            self._build_tables()  # a leaf was rebound: its address changed
        out = torch.empty((), dtype=torch.int64, device=self.device)
        fn, _ = _lib()
        err = fn(self._leaf_table.data_ptr(), self._item_table.data_ptr(),
                 self._partial.data_ptr(), self._leaf_fp.data_ptr(), out.data_ptr(),
                 len(self.leaves), self._n_items, _build.stream_ptr(self.device))
        _build.check(err, "tree_fingerprint_fwd")
        tree_fingerprint_fwd.launches += 1
        return out


def tree_fingerprint_fwd(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fingerprint of :func:`tree_fingerprint_plain`, a 0-d int64
    tensor. CUDA tensors launch TF (contiguous leaves of 1-, 2-, 4- or 8-byte
    elements; the tables built for this call) or raise; CPU tensors run the
    plain version. ``launches`` counts the calls that launched TF."""
    return TreeFingerprint(leaves)()


tree_fingerprint_fwd.launches = 0
