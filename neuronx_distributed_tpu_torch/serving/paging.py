"""Paged KV cache for the serving engine: block-table slots over a
ref-counted page pool (counterpart of
``neuronx_distributed_tpu/serving/paging.py``, what the engine calls:
``PageAllocator`` with page sharing and quarantine, ``PagedCacheManager``
with prefix pins, copy-on-write admission, ``kv_quant``, page and slot
quarantine and recovery, the host page tier's spill and prefetch, and the
disaggregated handoff's staged contexts with export and import).

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
  bumped by fewer than ``page_size`` columns; gap columns stay invalid), so
  whole context pages are shareable. The left padding of a prefill bucket
  falls into unmapped pages, i.e. page 0.
* Prefix sharing is copy-on-write by construction: a prefix entry PINS the
  whole context pages of the slot that inserted it (a reference each); a
  hit maps them under its first context columns with their refcounts up,
  and allocates its own pages for the rest. The port writes K/V in place
  through the table, and every write lands past the shared pages: the
  suffix and the decode steps write at or past the page-floored match.
  :meth:`PagedCacheManager.assert_writable` checks it before every write
  window (a pinned page under one raises). ``PageAllocator.copy_bytes``
  counts KV bytes duplicated on reuse: sharing never adds to it.
* ``kv_quant="int8"`` allocates an int8 pool with a scale per (page,
  kv-head) (``PagedKVCache``); every page the manager hands out is zeroed
  first (codes and scales), so a recycled page's old rows never enter its
  scale. Host accounting (tables, refs, pins) is the float pool's.
* Page-granular fault domains: a poisoned page is QUARANTINED out of the
  pool (:meth:`PageAllocator.quarantine`): never free again, never mapped
  again; the requests whose tables map it are requeued by the engine, and
  a referenced page leaves circulation when its last reference drops. A
  poisoned slot readback retires the slot's exclusively owned pages; the
  slot index itself stays in the rotation.
* The host page tier (``serving/tiering.py``): :meth:`PagedCacheManager.
  spill_pages` gathers a cold entry's pages out of the pool (one
  ``index_select`` a leaf; the store copies them to host memory with one
  sync), :meth:`PagedCacheManager.prefetch_pages` writes host pages back
  into fresh pages on a TIER STREAM of the manager's own (one host-to-device
  copy, one ``index_copy_`` a leaf), so the copy overlaps the main stream's
  work. The tier stream waits for the main stream first (fresh pages may
  still be zeroed there); the main stream waits for the prefetch's event
  before anything touches those pages again (:meth:`PagedCacheManager.
  sync_tier`: at a mapping, a spill, an unpin). A prefetched page is born
  pinned and held (:meth:`PagedCacheManager.hold_prefetched`) until its
  queued request consumes it: a held page is neither free nor reclaimable.
* The disaggregated handoff (``serving/disagg.py``): a prefill worker
  STAGES a context in the pool with no slot bound
  (:meth:`PagedCacheManager.stage_context`: fresh pages held by the
  staging, written by the worker's prefill through a scratch block-table
  row of its own, so the pages hold the bytes a coupled prefill of the same
  prompt writes, codes and scales of an int8 pool included);
  :meth:`PagedCacheManager.map_staged` binds them to a slot as a page-table
  operation (the holds become the table's references; zero KV bytes move).
  Between distinct pools :meth:`PagedCacheManager.export_pages` and
  :meth:`PagedCacheManager.import_pages` copy the pages, and the import is
  charged to ``copy_bytes``. Recovery voids every staging.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from neuronx_distributed_tpu_torch.modules.attention import (
    PagedKVCache,
    reset_cache,
    reset_cache_slot,
)
from neuronx_distributed_tpu_torch.serving.tiering import PageLayout
from neuronx_distributed_tpu_torch.utils.fingerprint import pool_leaves


@dataclasses.dataclass
class StagedContext:
    """A prefilled context parked in the pool with NO slot bound: the
    disaggregated handoff's unit (JAX ``StagedContext``, ``paging.py:83``).
    ``page_ids`` hold the context's K/V page-aligned from the first page's
    row 0 (so :meth:`PagedCacheManager.map_staged` can bind them at any
    page-aligned cursor: K/V content is position-relative); the staging
    holds one reference a page until a handoff transfers it to a slot's
    block table or :meth:`PagedCacheManager.release_staged` drops it."""

    page_ids: Tuple[int, ...]
    p: int        # real context tokens staged
    padded: int   # the prefill bucket the context was computed at


@dataclasses.dataclass
class ExportedContext:
    """A staged context in transfer form between DISTINCT pools (JAX
    ``ExportedContext``, ``paging.py:100``): its pages' blocks per pool leaf
    (``k``, ``v`` and an int8 pool's scales, in the host tier's leaf order),
    each ``(num_layers, n_pages, *page)``. The import is a real copy,
    charged to ``PageAllocator.copy_bytes``."""

    items: list   # [(leaf name, block)]
    n_pages: int
    p: int
    padded: int

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for _, b in self.items)


class PageExhausted(RuntimeError):
    """The pool has fewer free pages than an allocation needs. Admission
    accounting makes this unreachable on the conservative path; the eager
    path treats it as the page-pressure wall (preempt-and-rewind)."""


class PageAllocator:
    """Host-side owner of the physical page pool: free list + ref counts.

    A page is exactly one of: RESERVED (page 0, the null page), FREE (on the
    free list, refcount absent), REFERENCED (mapped by >= 1 block table
    and/or pinned by >= 1 prefix entry; the refcount is the sum) or
    QUARANTINED (poisoned, out of circulation for good; a referenced page
    that is quarantined leaves circulation when its last ref drops).
    ``copy_bytes`` counts KV bytes physically duplicated on prefix reuse:
    the zero-copy contract is that it STAYS 0."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is reserved), got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(1, num_pages))
        self._refs: Dict[int, int] = {}
        self._quarantined: set = set()
        self.copy_bytes = 0  # never incremented by sharing

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def referenced_pages(self) -> int:
        """Pages with at least one holder (a mapping or a pin; JAX
        ``referenced_pages``)."""
        return len(self._refs)

    @property
    def pages_quarantined(self) -> int:
        return len(self._quarantined)

    @property
    def capacity(self) -> int:
        """Usable pages: everything but the null page and the quarantined
        ones (referenced or free alike)."""
        return self.num_pages - 1 - len(self._quarantined)

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

    def ref(self, pid: int) -> None:
        """One more holder of an already-live page (a share or a pin)."""
        if pid not in self._refs:
            raise ValueError(f"page {pid} is not live (cannot ref)")
        self._refs[pid] += 1

    def deref(self, pid: int) -> None:
        """Drop one holder; the last drop returns the page to the free list
        (or retires it, if it was quarantined while referenced)."""
        c = self._refs.get(pid)
        if c is None:
            raise ValueError(f"page {pid} is not live (cannot deref)")
        if c > 1:
            self._refs[pid] = c - 1
            return
        del self._refs[pid]
        if pid not in self._quarantined:
            self._free.append(pid)
            self._free.sort()

    def quarantine(self, pid: int) -> None:
        """Take a page out of circulation for good (poisoned content). A
        free page leaves the free list now; a referenced page keeps its
        holders' bookkeeping (the caller requeues them) and retires when
        the last ref drops."""
        if pid <= 0 or pid >= self.num_pages:
            raise ValueError(f"page {pid} outside pool [1, {self.num_pages})")
        self._quarantined.add(pid)
        if pid in self._free:
            self._free.remove(pid)

    def release_all(self) -> None:
        """Drop every reference (all mappings and pins are void); the
        quarantined pages stay out of circulation."""
        for pid in list(self._refs):
            del self._refs[pid]
            if pid not in self._quarantined:
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
        self._pins: Dict[int, int] = {}  # page -> prefix entries pinning it
        # pages a queued request's prefetch claimed (each also pinned)
        self._prefetch_hold: set = set()
        # page -> the event of the prefetch still writing it on the tier stream
        self._tier_events: Dict[int, object] = {}
        self._tier_stream = None
        # page -> staging holds of contexts awaiting a handoff
        self._staged: Dict[int, int] = {}
        # page-pressure valve: evicts one unpinned prefix entry, True when it
        # freed something (the engine installs it)
        self.reclaim: Optional[Callable[[], bool]] = None
        self.prefix_pages_shared_total = 0

    @classmethod
    def for_model(cls, model, num_slots: int, page_size: int,
                  num_pages: Optional[int] = None,
                  kv_quant: Optional[str] = None) -> "PagedCacheManager":
        """A manager with a zeroed paged cache for ``model`` on its device
        (an int8 pool with ``kv_quant="int8"``)."""
        mgr = cls(num_slots, model.config.max_seq_len, page_size, num_pages)
        mgr.cache = model.new_paged_cache(num_slots, mgr.alloc.num_pages, page_size, kv_quant)
        return mgr

    # --- accounting ---------------------------------------------------------

    @property
    def cursor(self) -> int:
        return self.cache.index if self.cache is not None else 0

    @property
    def nbytes(self) -> int:
        """Device bytes of the pools, an int8 pool's scales and the block
        table (0 without a cache)."""
        if self.cache is None:
            return 0
        c = self.cache
        return sum(t.numel() * t.element_size()
                   for t in (c.k, c.v, c.k_scale, c.v_scale, c.block_table) if t is not None)

    @property
    def page_nbytes(self) -> int:
        """Device bytes of one page across layers: K and V, and an int8
        pool's two scales (0 without a cache)."""
        if self.cache is None:
            return 0
        c = self.cache
        return sum(t[:, 0].numel() * t.element_size()
                   for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def pages_mapped(self) -> int:
        return int((self._tables != 0).sum())

    @property
    def usable_slots(self) -> int:
        """Every slot: a paged engine quarantines pages, never a slot index."""
        return self.num_slots

    @property
    def quarantined_slots(self) -> list:
        return []

    @property
    def pages_quarantined(self) -> int:
        return self.alloc.pages_quarantined

    @property
    def degraded(self) -> bool:
        """Capacity shrunk for good (poisoned pages retired)."""
        return self.alloc.pages_quarantined > 0

    def acquire(self) -> int:
        return self._free.pop(0)

    def quarantine(self, slot: int) -> None:
        """A poisoned slot readback, page-granular (JAX ``quarantine``,
        ``paging.py:575``): the slot's EXCLUSIVELY owned pages retire from
        the pool (their content is suspect); shared or pinned pages predate
        the slot and survive; the slot index stays in the rotation (the
        caller's :meth:`free` returns it)."""
        row = self._tables[slot]
        for pid in {int(p) for p in row[row != 0]}:
            if self.alloc.refcount(pid) == 1 and self._pins.get(pid, 0) == 0:
                self.alloc.quarantine(pid)

    def quarantine_page(self, pid: int) -> List[int]:
        """Retire one poisoned page from the pool; returns the slots whose
        tables map it now, copy-on-write sharers included (the caller
        requeues exactly those)."""
        self.alloc.quarantine(pid)
        return [s for s in range(self.num_slots) if (self._tables[s] == pid).any()]

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

    def reclaimable_pages(self) -> int:
        """Pages an eviction (or a spill to the host tier) could free now:
        pinned by prefix entries, mapped by no slot, not quarantined and not
        held by a prefetch (JAX ``reclaimable_pages``, ``paging.py:618``: a
        queued request is about to map those)."""
        return sum(1 for pid, pins in self._pins.items()
                   if pins > 0 and self.alloc.refcount(pid) == pins
                   and pid not in self.alloc._quarantined and pid not in self._prefetch_hold)

    def available_pages(self) -> int:
        """Pages an admission can claim now: the free list plus what evicting
        every unpinned-by-flight prefix entry could reclaim. Prefetch-held
        pages are neither (the fit math counts them as claimed)."""
        return self.alloc.free_pages + self.reclaimable_pages()

    def _alloc_pages(self, n: int) -> List[int]:
        """``n`` fresh pages, pulling the reclaim valve (evicting unpinned
        prefix entries) while the free list is short."""
        while self.alloc.free_pages < n and self.reclaim is not None:
            if not self.reclaim():
                break
        ids = self.alloc.alloc(n)
        if self.cache is not None:
            self.cache.clear_pages(ids)
        return ids

    def slot_pages(self, slot: int) -> List[int]:
        row = self._tables[slot]
        return [int(p) for p in row[row != 0]]

    # --- prefix pins (copy-on-write) ----------------------------------------

    def pin_pages(self, ids: Sequence[int]) -> None:
        """A prefix entry takes a reference on each page: the slot's own
        context pages become shared storage, zero copies."""
        for pid in ids:
            self.alloc.ref(int(pid))
            self._pins[int(pid)] = self._pins.get(int(pid), 0) + 1

    def unpin_pages(self, ids: Sequence[int]) -> None:
        self.sync_tier(ids)  # a freed page may be written next on the main stream
        for pid in ids:
            pid = int(pid)
            pins = self._pins.get(pid, 0)
            if pins <= 1:
                self._pins.pop(pid, None)
            else:
                self._pins[pid] = pins - 1
            self.alloc.deref(pid)

    def hold_prefetched(self, ids: Sequence[int]) -> None:
        """Mark freshly prefetched (pinned) pages as claimed by a queued
        request: not reclaimable until released (JAX ``hold_prefetched``)."""
        self._prefetch_hold.update(int(pid) for pid in ids)

    def release_prefetched(self, ids: Sequence[int]) -> None:
        """Drop prefetch holds (a no-op for pages without one)."""
        self._prefetch_hold.difference_update(int(pid) for pid in ids)

    def prefetch_held(self, ids: Sequence[int]) -> bool:
        """Whether ANY of ``ids`` is held by a prefetch (the reclaim valve
        skips such entries)."""
        return any(int(pid) in self._prefetch_hold for pid in ids)

    def pages_live(self, ids: Sequence[int]) -> bool:
        """Reuse-time validation of a paged prefix entry's accounting: every
        page still allocated, pinned and not quarantined (the engine checks
        the content by fingerprint after this)."""
        return all(self.alloc.refcount(int(pid)) > 0 and self._pins.get(int(pid), 0) > 0
                   and int(pid) not in self.alloc._quarantined for pid in ids)

    def slot_context_pages(self, slot: int, n: int) -> List[int]:
        """The first ``n`` context pages of a slot (insert-on-miss pins
        exactly these)."""
        start = self._slot_start[slot]
        if start is None:
            raise ValueError(f"slot {slot} holds no context")
        lo = start // self.page_size
        ids = [int(p) for p in self._tables[slot, lo:lo + n]]
        if any(p == 0 for p in ids):
            raise ValueError(f"slot {slot} pages {ids} include unmapped entries")
        return ids

    def assert_writable(self, slots: Sequence[int], lo_col: int, hi_col: int) -> None:
        """No pinned page lies under columns [lo_col, hi_col) of ``slots``:
        a write there would change a prefix entry's content. Raises
        AssertionError naming the page."""
        ps = self.page_size
        lo, hi = lo_col // ps, min(self.pages_per_row, -(-hi_col // ps))
        for s in slots:
            for pid in self._tables[int(s), lo:hi]:
                if self._pins.get(int(pid), 0):
                    raise AssertionError(f"slot {int(s)} would write pinned page {int(pid)} "
                                         f"(columns [{lo_col}, {hi_col}))")

    # --- state transitions --------------------------------------------------

    def _upload_tables(self) -> None:
        if self.cache is not None:
            self.cache.upload_table(self._tables)

    def admit(self, slot: int, padded_len: int, cursor: Optional[int] = None,
              p: Optional[int] = None, shared_ids: Sequence[int] = (),
              m_shared: int = 0) -> PagedKVCache:
        """Place a prefill of ``padded_len`` columns, ``p`` of them real
        context (default all), into ``slot``: map ``shared_ids`` (a
        copy-on-write prefix hit's pages, refcounts up, zero KV bytes moved)
        under the first ``m_shared`` context columns, allocate and map own
        pages for the rest of the context columns [cursor - p, cursor),
        clear the slot's validity, set the shared cursor (default: keep, but
        at least ``padded_len``, page-aligned) and return the view the
        prefill writes through. Its left padding lands in unmapped pages,
        i.e. page 0. Raises :class:`PageExhausted` before changing
        anything."""
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
        if m_shared % ps != 0 or m_shared > p:
            raise ValueError(f"m_shared ({m_shared}) must be a page multiple <= p ({p})")
        n_sh = m_shared // ps
        if len(shared_ids) < n_sh:
            raise ValueError(f"{n_sh} shared pages needed, got {len(shared_ids)}")
        self.sync_tier(shared_ids[:n_sh])
        if (self._tables[slot] != 0).any():
            raise ValueError(f"slot {slot} still maps pages (not freed?)")
        own = self._alloc_pages(-(-(p - m_shared) // ps))
        s0 = start // ps
        for j in range(n_sh):
            self.alloc.ref(int(shared_ids[j]))
            self._tables[slot, s0 + j] = int(shared_ids[j])
        self.prefix_pages_shared_total += n_sh
        self._tables[slot, s0 + n_sh:s0 + n_sh + len(own)] = own
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
        if need:
            try:
                ids = self._alloc_pages(len(need))
            except PageExhausted:
                return False
            for (s, j), pid in zip(need, ids):
                self._tables[s, j] = pid
            self._upload_tables()
        self.assert_writable(active_slots, self.cursor, self.cursor + width)
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

    def recover(self) -> None:
        """After a failed decode dispatch whose requests are requeued (JAX
        ``recover``, ``paging.py:1180``): every slot back in the rotation,
        every block-table mapping dropped, the storage reset IN PLACE,
        cursor 0, every staged context and prefetch hold void (JAX :1194-1200). Prefix pins are the
        engine's to resolve: when the failed chunk's steps ran, it clears
        the store, whose eviction hook releases the pins."""
        self.release_all_slots()
        self.reset()
        # staged contexts are VOID (JAX :1194-1199): their holder sees
        # staged_live() False and re-prefills; no hold may block the pool
        for pid, holds in list(self._staged.items()):
            for _ in range(holds):
                self.alloc.deref(pid)
        self._staged.clear()
        self._prefetch_hold.clear()

    def update_after_decode(self, start: int, steps: int) -> None:
        """Set the cursor (mirror and device) after a decode chunk that
        began at ``start`` and consumed ``steps`` columns."""
        self.cache.index = start + steps

    def reset(self) -> None:
        """Rewind the cursor, invalidate every slot and release every
        block-table mapping (drain / preemption): pages flow back to the
        free list unless a prefix pin keeps them, and pinned pages keep
        their content, so the entries stay servable."""
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
        free / referenced (table-mapped, prefix-pinned or staged) /
        quarantined / reserved, ref counts reconcile with the mappers plus
        the pins plus the staging holds, no
        slot double-maps a page, and the free list is duplicate-free; so a
        quarantined page is neither free nor mappable once its holders let
        go. AssertionError naming the offending page."""
        a = self.alloc
        free = set(a._free)
        assert len(free) == len(a._free), "free list has duplicates"
        assert 0 not in free and 0 not in a._refs and 0 not in self._pins, (
            "reserved null page 0 entered circulation")
        mapped: Dict[int, int] = {}
        for s in range(self.num_slots):
            row = [int(p) for p in self._tables[s] if p != 0]
            assert len(row) == len(set(row)), f"slot {s} double-maps a page: {row}"
            for pid in row:
                mapped[pid] = mapped.get(pid, 0) + 1
        for pid in range(1, a.num_pages):
            expect = mapped.get(pid, 0) + self._pins.get(pid, 0) + self._staged.get(pid, 0)
            have = a.refcount(pid)
            assert have == expect, (f"page {pid}: refcount {have} != mapped({mapped.get(pid, 0)})"
                                    f" + pinned({self._pins.get(pid, 0)})"
                                    f" + staged({self._staged.get(pid, 0)})")
            states = [pid in free, expect > 0, pid in a._quarantined and expect == 0]
            assert sum(states) == 1, (
                f"page {pid} is not exactly one of free/referenced/quarantined: "
                f"free={pid in free} refs={have} quarantined={pid in a._quarantined}"
            )
        # a prefetch hold is an overlay on a PINNED page, never a reference
        # of its own (JAX paging.py:1274-1279)
        for pid in self._prefetch_hold:
            assert self._pins.get(pid, 0) > 0, (
                f"page {pid} carries a prefetch hold but no prefix pin")

    # --- the host page tier -------------------------------------------------

    def page_layout(self) -> PageLayout:
        """One pool page's leaves as the host tier stores them: ``k``, ``v``
        (and ``k_scale``/``v_scale`` on an int8 pool) in the JAX package's
        sorted-key order, each block (num_layers, 1, *page)."""
        c = self.cache
        leaves = pool_leaves(c)
        names = ("k", "v") if len(leaves) == 2 else ("k", "k_scale", "v", "v_scale")
        return PageLayout([(name, (t.shape[0], 1) + tuple(t.shape[2:]), t.dtype)
                           for name, t in zip(names, leaves)])

    def sync_tier(self, ids: Sequence[int]) -> None:
        """Make the main stream wait for the prefetches still writing pages
        ``ids`` on the tier stream (a device-side wait, no host sync)."""
        events = {id(ev): ev for ev in (self._tier_events.pop(int(p), None) for p in ids)
                  if ev is not None}
        for ev in events.values():
            torch.cuda.current_stream(self.cache.k.device).wait_event(ev)

    def spill_pages(self, ids: Sequence[int]):
        """The device half of a spill (JAX ``spill_pages``,
        ``paging.py:1055-1089``): the pinned prefix pages ``ids`` gathered
        out of every pool leaf in storage form (K and V pages, an int8
        pool's scales too), one ``index_select`` on the page axis a leaf,
        enqueued on the main stream and read by nothing here. Returns
        ``([(leaf name, block (num_layers, n, *page))], nbytes)``;
        ``HostPageStore.put`` copies the batch into its host arena with one
        sync, the spill's one host read."""
        if self.cache is None:
            raise RuntimeError("spill needs an allocated pool")
        self.sync_tier(ids)
        c = self.cache
        idx = torch.as_tensor([int(p) for p in ids], dtype=torch.long, device=c.k.device)
        items = [(name, leaf.index_select(1, idx))
                 for (name, _, _), leaf in zip(self.page_layout().leaves, pool_leaves(c))]
        return items, sum(b.numel() * b.element_size() for _, b in items)

    def prefetch_pages(self, rows, n_pages: int):
        """The device half of a prefetch (JAX ``prefetch_pages``,
        ``paging.py:1091-1118``): ``n_pages`` fresh pages (the reclaim valve
        may run), then ``rows`` (the host tier's packed page rows in page
        order, as runs) copied to the card and scattered into every pool
        leaf with one ``index_copy_`` on the page axis. On the card all of it
        runs on the tier stream after it waits for the main stream, and
        nothing waits for it here: it overlaps whatever the main stream runs
        next. Each page's born reference is adopted as a prefix pin. Not
        charged to ``copy_bytes`` (that meter is the pool's copy-on-write
        sharing). Returns ``(page ids, the copy's event or None)``; the
        event also fences the pages until :meth:`sync_tier`."""
        if self.cache is None:
            raise RuntimeError("prefetch needs an allocated pool")
        ids = self._alloc_pages(n_pages)
        c, layout = self.cache, self.page_layout()
        dev, done = c.k.device, None
        scope = contextlib.nullcontext()
        if dev.type == "cuda":
            if self._tier_stream is None:
                self._tier_stream = torch.cuda.Stream(dev)
            self._tier_stream.wait_stream(torch.cuda.current_stream(dev))
            scope = torch.cuda.stream(self._tier_stream)
        with scope:  # staging allocated on the stream that reads it
            staged = torch.empty((n_pages, layout.row_nbytes), dtype=torch.uint8, device=dev)
            i = 0
            for run in rows:
                staged[i:i + len(run)].copy_(run, non_blocking=dev.type == "cuda")
                i += len(run)
            idx = torch.as_tensor(ids, dtype=torch.long).to(dev, non_blocking=True)
            for j, leaf in enumerate(pool_leaves(c)):
                leaf.index_copy_(1, idx, layout.leaf_rows(staged, j).movedim(0, 1))
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record(self._tier_stream)
        for pid in ids:
            # alloc bore the page at refcount 1; that reference IS the pin
            self._pins[int(pid)] = self._pins.get(int(pid), 0) + 1
            if done is not None:
                self._tier_events[int(pid)] = done
        return [int(pid) for pid in ids], done

    # --- the disaggregated handoff ------------------------------------------

    def staging_row(self) -> PagedKVCache:
        """A scratch block-table row over this pool for a prefill worker
        (one a worker, made once): its own table of ``pages_per_row + 1``
        pages and its own validity, the pool's storage. A staged prefill
        writes through it, never through a slot, so the captured decode
        step keeps reading the same ``num_slots`` rows at the same
        addresses."""
        if self.cache is None:
            raise RuntimeError("staging needs an allocated pool")
        c, ps = self.cache, self.page_size
        n_log = self.pages_per_row + 1  # room for the left padding's gap
        dev = c.k.device
        return PagedKVCache(c.k, c.v, torch.zeros((1, n_log * ps), dtype=torch.bool, device=dev),
                            torch.zeros((1, n_log), dtype=torch.int32, device=dev), ps,
                            k_scale=c.k_scale, v_scale=c.v_scale)

    def stage_context(self, row: PagedKVCache, p: int, padded: int):
        """Park a context of ``p`` tokens, prefilled at bucket ``padded``,
        in the pool with no slot bound (JAX ``stage_context``,
        ``paging.py:901``): ``ceil(p / page_size)`` fresh pages, each held
        once by the staging, mapped in the worker's scratch ``row``
        (:meth:`staging_row`) so that the context starts at a page boundary
        and its left padding lands in unmapped pages (the null page).
        Returns ``(staged, view)``: the prefill writes through ``view``
        exactly as a coupled prefill writes through a slot's view, so the
        pages receive the same bytes (the page-relative layout, and an int8
        pool's write windows, are the same). A prefill that fails must
        :meth:`release_staged`."""
        if p < 1 or p > padded:
            raise ValueError(f"bad staged context length p={p} (padded {padded})")
        ps = self.page_size
        n = -(-p // ps)
        ids = self._alloc_pages(n)
        for pid in ids:
            self._staged[pid] = self._staged.get(pid, 0) + 1
        c0 = -(-(padded - p) // ps) * ps  # the context's first column, page-aligned
        table = np.zeros((1, row.block_table.shape[1]), np.int32)
        table[0, c0 // ps:c0 // ps + n] = ids
        row.upload_table(table)
        row.valid.zero_()
        return (StagedContext(tuple(int(i) for i in ids), p, padded),
                row.view(slice(0, 1), c0 + p - padded))

    def staged_live(self, staged: StagedContext) -> bool:
        """Whether a staged context's pages are all still held and not
        quarantined (JAX ``staged_live``): a recovery or a page quarantine
        between staging and handoff voids it, and the caller re-prefills."""
        return bool(staged.page_ids) and all(
            self._staged.get(int(pid), 0) > 0 and int(pid) not in self.alloc._quarantined
            for pid in staged.page_ids)

    def map_staged(self, slot: int, staged: StagedContext, cursor: int) -> None:
        """Bind a staged context to ``slot`` at ``cursor`` as a PAGE-TABLE
        operation (JAX ``map_staged``, ``paging.py:941``): the staging holds
        become the slot's table references (no refcount motion, no KV byte
        moves, ``copy_bytes`` untouched); the table is uploaded, the slot's
        validity set to the context's columns and the shared cursor moved,
        each written in place into the tensors the captured decode step
        reads. The context start ``cursor - p`` must be page-aligned."""
        if not self.staged_live(staged):
            raise ValueError("staged context is no longer live (pool recovery or page "
                             "quarantine voided it) — re-prefill")
        p, ps = staged.p, self.page_size
        start = cursor - p
        if start < 0 or start % ps != 0:
            raise ValueError(f"handoff cursor {cursor} puts the context start at {start} — "
                             f"not page-aligned (page_size {ps})")
        if (self._tables[slot] != 0).any():
            raise ValueError(f"slot {slot} still maps pages (not freed?)")
        s0 = start // ps
        for j, pid in enumerate(staged.page_ids):
            pid = int(pid)
            holds = self._staged.get(pid, 0)  # the staging hold becomes the mapping
            if holds <= 1:
                self._staged.pop(pid, None)
            else:
                self._staged[pid] = holds - 1
            self._tables[slot, s0 + j] = pid
        self._slot_start[slot] = start
        self._upload_tables()
        valid = self.cache.valid[slot]
        valid.zero_()
        valid[start:cursor] = True
        self.cache.index = cursor
        staged.page_ids = ()

    def release_staged(self, staged: StagedContext) -> None:
        """Drop an unconsumed staged context (JAX ``release_staged``): the
        holds go and unshared pages return to the free list. Pages whose
        hold a recovery already voided are skipped (a deref there would take
        a reference from a page since given to another request)."""
        for pid in staged.page_ids:
            pid = int(pid)
            holds = self._staged.get(pid, 0)
            if holds <= 0:
                continue
            if holds == 1:
                self._staged.pop(pid, None)
            else:
                self._staged[pid] = holds - 1
            self.alloc.deref(pid)
        staged.page_ids = ()

    def export_pages(self, staged: StagedContext) -> ExportedContext:
        """A staged context's pages read out of every pool leaf in storage
        form (JAX ``export_pages``, ``paging.py:1009``; one
        ``index_select`` on the page axis a leaf, as :meth:`spill_pages`),
        for a DISTINCT pool to import."""
        if not self.staged_live(staged):
            raise ValueError("staged context is no longer live")
        c = self.cache
        idx = torch.as_tensor([int(p) for p in staged.page_ids], dtype=torch.long,
                              device=c.k.device)
        items = [(name, leaf.index_select(1, idx))
                 for (name, _, _), leaf in zip(self.page_layout().leaves, pool_leaves(c))]
        return ExportedContext(items=items, n_pages=len(staged.page_ids), p=staged.p,
                               padded=staged.padded)

    def import_pages(self, exported: ExportedContext) -> StagedContext:
        """Write exported pages into THIS pool as a fresh staged context
        (JAX ``import_pages``, ``paging.py:1030``): fresh pages, one
        ``index_copy_`` on the page axis a leaf (a device-to-device copy
        between two pools on the card), charged to ``alloc.copy_bytes``,
        the meter that proves the shared-pool handoff moved nothing."""
        if self.cache is None:
            raise RuntimeError("import_pages needs an allocated pool")
        names = [name for name, _, _ in self.page_layout().leaves]
        if [name for name, _ in exported.items] != names:
            raise ValueError(f"exported leaves {[n for n, _ in exported.items]} do not match "
                             f"this pool's {names}")
        ids = self._alloc_pages(exported.n_pages)
        for pid in ids:
            self._staged[pid] = self._staged.get(pid, 0) + 1
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.cache.k.device)
        for (_, block), leaf in zip(exported.items, pool_leaves(self.cache)):
            leaf.index_copy_(1, idx, block.to(leaf.device))
        self.alloc.copy_bytes += exported.nbytes
        return StagedContext(tuple(int(i) for i in ids), exported.p, exported.padded)
