"""The host page tier behind the device page pool (counterpart of
``neuronx_distributed_tpu/serving/tiering.py``, ``HostPageStore``).

Without a second tier a cold prefix entry under page pressure is evicted and
its prefill redone at its next hit: an eviction cliff at the pool's
capacity. :class:`HostPageStore` turns it into a slope: the engine's reclaim
valve spills a cold entry's pages here (one gather a pool leaf on the card,
one batched copy into this store's host memory, one sync), and the admission
pre-pass brings matched pages back while the hitting request still queues.

Integrity: every stored page carries the CRC-32 of its bytes
(``utils/fingerprint.page_fingerprint``), computed at put from the host copy
that is stored. :meth:`HostPageStore.verify` recomputes it before a prefetch
writes anything back; one corrupted page rejects the whole fetch and the
engine falls back to a full prefill, which rebuilds the same pages.

Storage: a page is ``[(leaf name, block)]`` over the pool's leaves (``k``,
``v``, and ``k_scale``/``v_scale`` on an int8 pool), the page axis of a
block at ``block.ndim - 4``. The store packs each page into one row of a
host ARENA, ``max_pages`` rows of :attr:`PageLayout.row_nbytes` bytes, the
leaves back to back in order; the arena is allocated once (at construction
when the layout is given, as the engine does; else at the first put), in
pinned memory on request, so that the copies to and from the card run
asynchronously and nothing pins memory on the serving path or during a
graph capture. Pages are keyed by MINTED host ids, never by the device page
ids, which recycle as soon as a spill frees them. A row whose bytes a
prefetch is still copying to the card is fenced by that copy's event and
not reused before it completes."""

from __future__ import annotations

import math
import time
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from neuronx_distributed_tpu_torch.utils.fingerprint import raw_bytes

__all__ = ["HostPageStore", "PageLayout"]

_ALIGN = 16  # byte alignment of each leaf's block within a row


class PageLayout:
    """How one page's leaf blocks pack into a row of bytes: ``leaves`` is
    ``[(name, block shape, dtype)]`` with the block's page axis
    (``ndim - 4``) of size 1. Each leaf starts at a 16-byte boundary."""

    def __init__(self, leaves: Sequence[Tuple[str, Tuple[int, ...], torch.dtype]]):
        self.leaves = tuple((name, tuple(int(d) for d in shape), dtype)
                            for name, shape, dtype in leaves)
        self.offsets, self.sizes = [], []
        off = 0
        for _, shape, dtype in self.leaves:
            nb = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            self.offsets.append(off)
            self.sizes.append(nb)
            off += -(-nb // _ALIGN) * _ALIGN
        self.row_nbytes = off
        self.nbytes = sum(self.sizes)  # a page's bytes, padding excluded

    @classmethod
    def of(cls, items) -> "PageLayout":
        """The layout of ``[(name, block)]`` items (any page count)."""
        leaves = []
        for name, block in items:
            shape = list(block.shape)
            shape[block.ndim - 4] = 1
            leaves.append((name, tuple(shape), block.dtype))
        return cls(leaves)

    def __eq__(self, other) -> bool:
        return isinstance(other, PageLayout) and self.leaves == other.leaves

    def leaf_rows(self, rows: torch.Tensor, j: int) -> torch.Tensor:
        """Leaf ``j`` of every row of ``rows`` (uint8, (n, row_nbytes)) as an
        (n, *block shape without its page axis) view of the leaf's dtype."""
        _, shape, dtype = self.leaves[j]
        off, nb = self.offsets[j], self.sizes[j]
        pax = len(shape) - 4
        inner = shape[:pax] + shape[pax + 1:]
        return rows[:, off:off + nb].view(dtype).view((rows.shape[0],) + inner)

    def pack(self, items, rows: torch.Tensor) -> None:
        """Write ``items`` (page axis of size n) into ``rows`` (n rows, on
        the items' device): one copy a leaf."""
        for j, (_, block) in enumerate(items):
            self.leaf_rows(rows, j).copy_(block.movedim(block.ndim - 4, 0))

    def unpack(self, rows: torch.Tensor):
        """``[(name, block)]`` of ``rows``, each block with its page axis
        of size n (copies)."""
        return [(name, self.leaf_rows(rows, j).movedim(0, len(shape) - 4).clone())
                for j, (name, shape, _) in enumerate(self.leaves)]

    def fingerprint(self, row: torch.Tensor) -> int:
        """The page's CRC-32, chained over its leaves in order (= JAX
        ``page_fingerprint`` over the page's blocks)."""
        data = raw_bytes(row)
        fp = 0
        for off, nb in zip(self.offsets, self.sizes):
            fp = zlib.crc32(data[off:off + nb], fp)
        return fp


def _runs(slots: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Maximal runs of consecutive slots: ``(first slot, first index, length)``."""
    out: List[Tuple[int, int, int]] = []
    for i, s in enumerate(slots):
        if out and out[-1][0] + out[-1][2] == s:
            out[-1] = (out[-1][0], out[-1][1], out[-1][2] + 1)
        else:
            out.append((s, i, 1))
    return out


class _HostPage:
    __slots__ = ("pid", "slot", "fingerprint", "nbytes")

    def __init__(self, pid: int, slot: int, fingerprint: int, nbytes: int):
        self.pid = pid      # the device page id this was spilled from
        self.slot = slot    # its arena row
        self.fingerprint = fingerprint
        self.nbytes = nbytes


class HostPageStore:
    """Bounded host store of spilled KV pool pages (JAX ``HostPageStore``).

    ``max_pages`` is a hard bound: a spill that does not fit is the caller's
    cue to degrade to plain eviction. ``layout`` (a :class:`PageLayout`)
    allocates the arena now; ``pin_memory`` pins it (the card's engine).
    The walls of the host work, for the record: ``copy_s`` (puts: the pack
    and the copy into the arena, the sync included), ``crc_s`` (puts'
    CRCs) and ``verify_s``."""

    def __init__(self, max_pages: int, layout: Optional[PageLayout] = None,
                 pin_memory: bool = False):
        if max_pages < 1:
            raise ValueError(f"max_pages must be >= 1, got {max_pages}")
        self.max_pages = max_pages
        self.pin_memory = pin_memory
        self.layout: Optional[PageLayout] = None
        self.arena: Optional[torch.Tensor] = None
        self._pages: "OrderedDict[int, _HostPage]" = OrderedDict()
        self._free: List[int] = list(range(max_pages))
        self._fenced: List[Tuple[object, List[int]]] = []  # (copy event, rows) in flight
        self._next_id = 1
        self.pages_spilled_total = 0
        self.pages_fetched_total = 0
        self.pages_dropped_total = 0
        self.spill_bytes_total = 0
        self.fetch_bytes_total = 0
        self.verify_failures_total = 0
        self.copy_s = self.crc_s = self.verify_s = 0.0
        if layout is not None:
            self._allocate(layout)

    def _allocate(self, layout: PageLayout) -> None:
        self.layout = layout
        self.arena = torch.empty((self.max_pages, layout.row_nbytes), dtype=torch.uint8,
                                 pin_memory=self.pin_memory)

    # --- capacity -----------------------------------------------------------

    @property
    def used_pages(self) -> int:
        return len(self._pages)

    @property
    def free_pages(self) -> int:
        return self.max_pages - len(self._pages)

    @property
    def nbytes(self) -> int:
        """Host bytes of the resident pages (the ledger's host resident)."""
        return sum(p.nbytes for p in self._pages.values())

    @property
    def arena_nbytes(self) -> int:
        return 0 if self.arena is None else self.arena.numel()

    def __len__(self) -> int:
        return len(self._pages)

    def _take_rows(self, n: int) -> List[int]:
        """``n`` arena rows, a run of consecutive rows where one is free.
        Rows fenced by a finished copy return first; when still short, wait
        for the oldest copies in flight."""
        for f in [f for f in self._fenced if f[0].query()]:
            self._fenced.remove(f)
            self._free.extend(f[1])
        while len(self._free) < n and self._fenced:
            ev, rows = self._fenced.pop(0)
            ev.synchronize()
            self._free.extend(rows)
        self._free.sort()
        for i in range(len(self._free) - n + 1):
            if self._free[i + n - 1] - self._free[i] == n - 1:
                rows = self._free[i:i + n]
                del self._free[i:i + n]
                return rows
        rows, self._free = self._free[:n], self._free[n:]
        return rows

    # --- spill / fetch ------------------------------------------------------

    def put(self, pids: Sequence[int], items) -> Tuple[int, ...]:
        """Store ``len(pids)`` pages: ``items`` is ``[(leaf name, block)]``
        with each block's page axis of size ``len(pids)``, on the host or
        on the card (``PagedCacheManager.spill_pages``). The pages are
        packed into rows where the blocks live and copied into the arena (on
        the card: one copy a run of consecutive rows, then one sync), then
        fingerprinted from the stored bytes. Returns the minted host ids in
        page order; raises when the store lacks room (nothing stored)."""
        n = len(pids)
        if n > self.free_pages:
            raise ValueError(f"host tier full: {n} pages offered, {self.free_pages} free")
        layout = PageLayout.of(items)
        if self.layout is None:
            self._allocate(layout)
        elif layout != self.layout:
            raise ValueError("pages of another layout than the store's")
        t0 = time.perf_counter()
        dev = items[0][1].device
        packed = torch.empty((n, layout.row_nbytes), dtype=torch.uint8, device=dev)
        layout.pack(items, packed)
        rows = self._take_rows(n)
        for s0, i0, k in _runs(rows):
            self.arena[s0:s0 + k].copy_(packed[i0:i0 + k], non_blocking=dev.type == "cuda")
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()  # the spill's one sync
        t1 = time.perf_counter()
        host_ids: List[int] = []
        for pid, row in zip(pids, rows):
            page = _HostPage(int(pid), row, layout.fingerprint(self.arena[row]), layout.nbytes)
            hid = self._next_id
            self._next_id += 1
            self._pages[hid] = page
            host_ids.append(hid)
            self.pages_spilled_total += 1
            self.spill_bytes_total += page.nbytes
        self.copy_s += t1 - t0
        self.crc_s += time.perf_counter() - t1
        return tuple(host_ids)

    def fetch(self, host_ids: Sequence[int]):
        """The arena rows of the pages at ``host_ids`` in id order, as runs
        of consecutive rows (views, for a copy to the card), and their
        bytes: ``([rows (k, row_nbytes)], nbytes)``. Read-only: the pages stay
        resident until the caller drops them."""
        pages = [self._require(h) for h in host_ids]
        runs = [self.arena[s0:s0 + k] for s0, _, k in _runs([p.slot for p in pages])]
        nbytes = sum(p.nbytes for p in pages)
        self.pages_fetched_total += len(pages)
        self.fetch_bytes_total += nbytes
        return runs, nbytes

    def get(self, host_ids: Sequence[int]):
        """The pages at ``host_ids`` as ``([(leaf name, block)], nbytes)``,
        each block with its page axis of size ``len(host_ids)``, in id order
        (copies; JAX ``get``)."""
        runs, nbytes = self.fetch(host_ids)
        return self.layout.unpack(torch.cat(runs)), nbytes

    def verify(self, host_ids: Sequence[int]) -> bool:
        """Recompute every page's CRC against its stored bytes before a
        prefetch writes anything back. False when any page is missing or
        differs: the caller rejects the WHOLE fetch."""
        t0 = time.perf_counter()
        ok = True
        for h in host_ids:
            page = self._pages.get(h)
            if page is None or self.layout.fingerprint(self.arena[page.slot]) != page.fingerprint:
                ok = False
        if not ok:
            self.verify_failures_total += 1
        self.verify_s += time.perf_counter() - t0
        return ok

    def drop(self, host_ids: Sequence[int], after=None) -> None:
        """Release pages (fetched back, or their entry evicted); unknown ids
        are skipped. ``after`` (a CUDA event) fences their rows until the
        copy it marks has completed."""
        rows = []
        for h in host_ids:
            page = self._pages.pop(h, None)
            if page is not None:
                self.pages_dropped_total += 1
                rows.append(page.slot)
        if after is not None and rows:
            self._fenced.append((after, rows))
        else:
            self._free.extend(rows)

    def clear(self) -> int:
        n = len(self._pages)
        self.drop(list(self._pages))
        return n

    # --- chaos / invariants -------------------------------------------------

    def corrupt(self, host_id: int) -> None:
        """Flip one byte of a stored page's first block in place (host-RAM
        bit rot, ``poison_host_page``'s hand); :meth:`verify` must catch it."""
        page = self._require(host_id)
        self.arena[page.slot, self.layout.offsets[0]].bitwise_xor_(0xFF)

    def contains(self, host_ids: Sequence[int]) -> bool:
        return all(h in self._pages for h in host_ids)

    def check(self) -> None:
        """The host tier's half of the leak invariant: occupancy within the
        budget, every arena row exactly one of free, fenced or holding one
        page, every page's byte count its layout's. AssertionError."""
        assert len(self._pages) <= self.max_pages, (
            f"host tier over budget: {len(self._pages)} > {self.max_pages}")
        held = [p.slot for p in self._pages.values()]
        fenced = [s for _, rows in self._fenced for s in rows]
        rows = held + fenced + self._free
        assert sorted(rows) == list(range(self.max_pages)), (
            f"arena rows not exactly one of free/fenced/held: held {sorted(held)}, fenced "
            f"{sorted(fenced)}, free {sorted(self._free)}")
        for hid, page in self._pages.items():
            assert page.nbytes == self.layout.nbytes, (
                f"host page {hid}: recorded {page.nbytes} bytes, holds {self.layout.nbytes}")

    def summary(self) -> Dict[str, int]:
        """Flat scalars for a halt post-mortem."""
        return {
            "host_pages_used": self.used_pages,
            "host_pages_max": self.max_pages,
            "host_bytes": self.nbytes,
            "host_pages_spilled_total": self.pages_spilled_total,
            "host_pages_fetched_total": self.pages_fetched_total,
            "host_pages_dropped_total": self.pages_dropped_total,
            "host_spill_bytes_total": self.spill_bytes_total,
            "host_fetch_bytes_total": self.fetch_bytes_total,
            "host_verify_failures_total": self.verify_failures_total,
        }

    def _require(self, host_id: int) -> _HostPage:
        page = self._pages.get(host_id)
        if page is None:
            raise KeyError(f"host page {host_id} is not resident")
        return page
