"""Paged KV cache for the serving engine: block-table slots over a
ref-counted page pool (counterpart of
``neuronx_distributed_tpu/serving/paging.py``, what the engine calls:
``PageAllocator`` without page sharing or quarantine, ``PagedCacheManager``
without prefix pins, staged contexts, export/import, spill/prefetch,
``seed_row``, slot quarantine or ``kv_quant``, which belong to later slices
together with their callers).

The row-per-slot manager (``serving/cache_manager.py``) charges every slot a
full ``max_seq_len`` row of device memory whatever its request uses. Here:

* :class:`PageAllocator` owns a fixed pool of ``num_pages`` KV pages
  (``page_size`` cache columns each), free-listed and ref-counted. Page 0 is
  the reserved NULL page — never allocated, the target of every unmapped
  block-table entry, never attendable.
* :class:`PagedCacheManager` is the slot manager over a
  :class:`~neuronx_distributed_tpu_torch.modules.attention.PagedKVCache`.
  Each slot holds a block-table row; the host table (numpy) is
  authoritative and is uploaded to the cache's device table whenever it
  changes (admission, decode-window growth, free, reset) — a host→device
  copy, never a read, so a steady decode chunk still costs one host read.
  The model writes K/V in place through the device table and attends
  straight from the pool (K5); validity and the shared cursor stay
  logical, so token streams equal the row engine's. As in the row manager,
  the host sets the cursor's mirror (admission, the rewind after a chunk,
  reset), which writes the device cursor; the table copy and the cursor
  write happen between chunks, outside the captured decode step.
* Every admission page-aligns its context START (the cursor target is
  bumped by fewer than ``page_size`` columns; gap columns stay invalid):
  the alignment the prefix-cache slice shares whole pages on. The left
  padding of a prefill bucket falls into unmapped pages, i.e. page 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from neuronx_distributed_tpu_torch.modules.attention import (
    PagedKVCache,
    reset_cache,
    reset_cache_slot,
)


class PageExhausted(RuntimeError):
    """The pool has fewer free pages than an allocation needs. Admission
    accounting makes this unreachable on the conservative path; the eager
    path treats it as the page-pressure wall (preempt-and-rewind)."""


class PageAllocator:
    """Host-side owner of the physical page pool: free list + ref counts.

    A page is exactly one of: RESERVED (page 0, the null page), FREE (on the
    free list, refcount absent) or REFERENCED (mapped by a block table; the
    refcount is the number of holders, 1 while nothing shares pages)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is reserved), got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(1, num_pages))
        self._refs: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        """Usable pages: everything but the null page (referenced or free
        alike)."""
        return self.num_pages - 1

    def refcount(self, pid: int) -> int:
        return self._refs.get(pid, 0)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages off the free list, each born with refcount 1
        (the caller's mapping). Raises :class:`PageExhausted` when short."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise PageExhausted(f"need {n} pages, {len(self._free)} free (capacity {self.capacity})")
        ids = [self._free.pop(0) for _ in range(n)]
        for pid in ids:
            self._refs[pid] = 1
        return ids

    def deref(self, pid: int) -> None:
        """Drop one holder; the last drop returns the page to the free list."""
        c = self._refs.get(pid)
        if c is None:
            raise ValueError(f"page {pid} is not live (cannot deref)")
        if c > 1:
            self._refs[pid] = c - 1
            return
        del self._refs[pid]
        self._free.append(pid)
        self._free.sort()


class PagedCacheManager:
    """Host-side owner of a :class:`PagedKVCache` plus the slot and
    block-table bookkeeping — the page-granular sibling of
    ``SlotCacheManager`` (same ``cursor``/``acquire``/``admit``/``free``/
    ``update_after_decode``/``reset`` surface; the engine drives either
    through one code path). :meth:`for_model` binds a cache for a model;
    without one the manager keeps the books alone (the allocator tests)."""

    def __init__(self, num_slots: int, max_seq_len: int, page_size: int,
                 num_pages: Optional[int] = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_seq_len % page_size != 0:
            raise ValueError(f"max_seq_len ({max_seq_len}) must be a multiple of "
                             f"page_size ({page_size})")
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.page_size = page_size
        self.pages_per_row = max_seq_len // page_size
        if num_pages is None:
            # the row manager's exact memory (every slot a full row) plus the
            # null page: paging is then a pure layout change; smaller pools
            # buy the packing
            num_pages = num_slots * self.pages_per_row + 1
        self.alloc = PageAllocator(num_pages)
        self.cache: Optional[PagedKVCache] = None
        self._free = list(range(num_slots))
        self._tables = np.zeros((num_slots, self.pages_per_row), np.int32)
        self._slot_start: List[Optional[int]] = [None] * num_slots

    @classmethod
    def for_model(cls, model, num_slots: int, page_size: int,
                  num_pages: Optional[int] = None) -> "PagedCacheManager":
        """A manager with a zeroed paged cache for ``model`` on its device."""
        mgr = cls(num_slots, model.config.max_seq_len, page_size, num_pages)
        mgr.cache = model.new_paged_cache(num_slots, mgr.alloc.num_pages, page_size)
        return mgr

    # --- accounting ---------------------------------------------------------

    @property
    def cursor(self) -> int:
        return self.cache.index if self.cache is not None else 0

    @property
    def nbytes(self) -> int:
        """Device bytes of the pools and the block table (0 without a cache)."""
        if self.cache is None:
            return 0
        c = self.cache
        return sum(t.numel() * t.element_size() for t in (c.k, c.v, c.block_table))

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def pages_mapped(self) -> int:
        return int((self._tables != 0).sum())

    def acquire(self) -> int:
        return self._free.pop(0)

    # --- page math ----------------------------------------------------------

    def aligned_target(self, base: int, p: int) -> int:
        """Smallest cursor >= ``base`` placing a p-token context's first
        token on a page boundary (``(target - p) % page_size == 0``). Costs
        fewer than page_size gap columns, invisible to the math."""
        return base + (-(base - p)) % self.page_size

    def page_span(self, lo_col: int, hi_col: int) -> int:
        """Pages overlapped by columns [lo_col, hi_col)."""
        hi_col = min(hi_col, self.max_seq_len)
        if hi_col <= lo_col:
            return 0
        return -(-hi_col // self.page_size) - lo_col // self.page_size

    def active_spans(self) -> List[int]:
        """Start column of every slot holding a context (the admission
        projection's per-slot page-span inputs)."""
        return [s for s in self._slot_start if s is not None]

    def unmapped_pages(self, slot: int, lo_col: int, hi_col: int) -> int:
        """Pages over columns [lo_col, hi_col) that ``slot`` has not mapped."""
        ps = self.page_size
        hi = min(self.pages_per_row, -(-hi_col // ps))
        return int((self._tables[slot, lo_col // ps:hi] == 0).sum()) if hi_col > lo_col else 0

    def context_pages(self, start: int, p: int, lo_col: int, hi_col: int) -> int:
        """Pages a context of ``p`` columns admitted at ``start`` maps (its
        own) plus those over columns [lo_col, hi_col) outside them."""
        ps = self.page_size
        own_end = start // ps + -(-p // ps)
        lo = max(lo_col // ps, own_end)
        hi = min(self.pages_per_row, -(-hi_col // ps))
        return own_end - start // ps + max(0, hi - lo)

    def available_pages(self) -> int:
        """Pages an admission can claim now: the free list (nothing is
        reclaimable without a prefix store)."""
        return self.alloc.free_pages

    def slot_pages(self, slot: int) -> List[int]:
        row = self._tables[slot]
        return [int(p) for p in row[row != 0]]

    # --- state transitions --------------------------------------------------

    def _upload_tables(self) -> None:
        if self.cache is not None:
            self.cache.upload_table(self._tables)

    def admit(self, slot: int, padded_len: int, cursor: Optional[int] = None,
              p: Optional[int] = None) -> PagedKVCache:
        """Place a prefill of ``padded_len`` columns, ``p`` of them real
        context (default all), into ``slot``: allocate and map pages for the
        context columns [cursor - p, cursor), clear the slot's validity, set
        the shared cursor (default: keep, but at least ``padded_len``,
        page-aligned) and return the view the prefill writes through. Its
        left padding lands in unmapped pages, i.e. page 0. Raises
        :class:`PageExhausted` before changing anything."""
        p = padded_len if p is None else p
        ps = self.page_size
        target = (self.aligned_target(max(self.cursor, padded_len), p)
                  if cursor is None else cursor)
        if target < padded_len:
            raise ValueError(f"cursor {target} < padded prefill length {padded_len}: the "
                             "prompt's last token cannot land left of its own start")
        start = target - p
        if start % ps != 0:
            raise ValueError(f"context start {start} not page-aligned (page_size {ps}) — "
                             "use aligned_target for the cursor")
        if (self._tables[slot] != 0).any():
            raise ValueError(f"slot {slot} still maps pages (not freed?)")
        own = self.alloc.alloc(-(-p // ps))
        self._tables[slot, start // ps:start // ps + len(own)] = own
        self._slot_start[slot] = start
        self._upload_tables()
        reset_cache_slot(self.cache, slot)
        self.cache.index = target
        return self.cache.view(slice(slot, slot + 1), target - padded_len)

    def ensure_decode_window(self, active_slots: Sequence[int], width: int) -> bool:
        """Map pages under every active slot's next write window (columns
        ``[cursor, cursor + width)``) before a chunk dispatch. False when
        the pool cannot cover it — the page-pressure wall (the engine
        preempts and rewinds, as at the cursor wall)."""
        if self.cache is None or len(active_slots) == 0:
            return True
        ps = self.page_size
        lo = self.cursor // ps
        hi = min(self.pages_per_row, -(-(self.cursor + width) // ps))
        need = [(int(s), j) for s in active_slots for j in range(lo, hi)
                if self._tables[int(s), j] == 0]
        if not need:
            return True
        try:
            ids = self.alloc.alloc(len(need))
        except PageExhausted:
            return False
        for (s, j), pid in zip(need, ids):
            self._tables[s, j] = pid
        self._upload_tables()
        return True

    def free(self, slot: int) -> None:
        """Clear the slot's validity, deref every page it maps and return the
        slot to the rotation."""
        if self.cache is not None:
            reset_cache_slot(self.cache, slot)
        for pid in self.slot_pages(slot):
            self.alloc.deref(pid)
        self._tables[slot] = 0
        self._slot_start[slot] = None
        self._upload_tables()
        if slot not in self._free:
            self._free.append(slot)
            self._free.sort()

    def release_all_slots(self) -> None:
        """Return every slot to the free list (host bookkeeping only, for
        callers about to :meth:`reset`)."""
        self._free = list(range(self.num_slots))

    def update_after_decode(self, start: int, steps: int) -> None:
        """Set the cursor (mirror and device) after a decode chunk that
        began at ``start`` and consumed ``steps`` columns."""
        self.cache.index = start + steps

    def reset(self) -> None:
        """Rewind the cursor, invalidate every slot and release every
        block-table mapping (drain / preemption)."""
        for slot in range(self.num_slots):
            for pid in self.slot_pages(slot):
                self.alloc.deref(pid)
            self._slot_start[slot] = None
        self._tables[:] = 0
        if self.cache is not None:
            reset_cache(self.cache)
            self._upload_tables()

    # --- invariants ---------------------------------------------------------

    def check(self) -> None:
        """The page-leak/ref-count invariant: every page is exactly one of
        free / table-mapped / reserved, ref counts reconcile with the
        mappers, no slot double-maps a page, and the free list is
        duplicate-free. AssertionError naming the offending page."""
        a = self.alloc
        free = set(a._free)
        assert len(free) == len(a._free), "free list has duplicates"
        assert 0 not in free and 0 not in a._refs, "reserved null page 0 entered circulation"
        mapped: Dict[int, int] = {}
        for s in range(self.num_slots):
            row = [int(p) for p in self._tables[s] if p != 0]
            assert len(row) == len(set(row)), f"slot {s} double-maps a page: {row}"
            for pid in row:
                mapped[pid] = mapped.get(pid, 0) + 1
        for pid in range(1, a.num_pages):
            expect = mapped.get(pid, 0)
            have = a.refcount(pid)
            assert have == expect, f"page {pid}: refcount {have} != mapped({expect})"
            assert (pid in free) != (expect > 0), (
                f"page {pid} is not exactly one of free/referenced: "
                f"free={pid in free} refs={have}"
            )
