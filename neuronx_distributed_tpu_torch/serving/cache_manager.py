"""Slot-level KV-cache management and the prefix store (counterpart of
``neuronx_distributed_tpu/serving/cache_manager.py``: ``SlotCacheManager``,
and ``PrefixEntry``/``PrefixCache``, host code copied from
``cache_manager.py:284-571`` without the host tier's fields and the tier
attribution, which belong to a later slice).

The engine owns ONE :class:`KVCache` shaped ``(num_slots, max_seq_len)`` per
layer, allocated once and updated in place. Batch rows are request slots;
the column layout is the shared-cursor scheme:

* ``index`` is a single write cursor shared by every slot, kept on the
  device (``cursor``, which the decode steps read and advance) with a host
  mirror; the host is the authority between chunks: admission, the rewind
  after a chunk and reset set the mirror, which writes the device cursor
  (a host→device write, never a read);
* a newly admitted prompt, padded to ``padded_len``, is placed so its last
  token sits at column ``cursor - 1`` — the JAX engine rolls a prefill row
  right by ``cursor - padded_len`` (``_admit_row``); here the prefill writes
  straight into those columns of the slot, after the slot's whole validity
  row is cleared, which leaves the same layout;
* columns a slot does not cover are ``kv_valid=False``; attention masking
  and RoPE positions run off validity counts, so gaps are invisible;
* freeing a slot clears its validity row; draining rewinds the cursor;
* a quarantined slot (a poisoned readback) leaves the rotation for good:
  freed, it never rejoins the free list (JAX ``cache_manager.py:145-151``).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from neuronx_distributed_tpu_torch.modules.attention import (
    KVCache,
    reset_cache,
    reset_cache_slot,
)


def _admit_row(cache: KVCache, slot: int, padded_len: int, cursor: int) -> KVCache:
    """Prepare ``slot`` for a prompt padded to ``padded_len`` whose last
    token lands at column ``cursor - 1``: clear the slot's validity, set the
    shared cursor (mirror and device), and return the view whose column 0
    is column ``cursor - padded_len`` of the slot (the prefill writes
    through it)."""
    reset_cache_slot(cache, slot)
    cache.index = cursor
    return cache.view(slice(slot, slot + 1), cursor - padded_len)


class SlotCacheManager:
    """Owner of the engine's cache and slot free list."""

    def __init__(self, num_slots: int, cache: KVCache):
        self.num_slots = num_slots
        self.cache = cache
        self._free = list(range(num_slots))
        self._quarantined: set = set()

    @property
    def cursor(self) -> int:
        return self.cache.index

    @property
    def nbytes(self) -> int:
        """Device bytes of the row cache: K, V and validity."""
        c = self.cache
        return sum(t.numel() * t.element_size() for t in (c.k, c.v, c.valid))

    @property
    def slot_nbytes(self) -> int:
        """Device bytes of one slot's row (the HBM ledger's unit)."""
        return self.nbytes // self.num_slots

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def usable_slots(self) -> int:
        """Slots still in the rotation (not quarantined)."""
        return self.num_slots - len(self._quarantined)

    @property
    def quarantined_slots(self) -> list:
        return sorted(self._quarantined)

    def acquire(self) -> int:
        return self._free.pop(0)

    def quarantine(self, slot: int) -> None:
        """Take ``slot`` out of the rotation for good (a poisoned readback:
        its row is suspect). The caller clears the engine's slot state."""
        self._quarantined.add(slot)
        if slot in self._free:
            self._free.remove(slot)

    def admit(self, slot: int, padded_len: int, cursor: Optional[int] = None) -> KVCache:
        """Place a prefill of ``padded_len`` columns into ``slot``; ``cursor``
        (default: keep, but never below ``padded_len``) becomes the shared
        write cursor. Returns the view the prefill writes through."""
        target = max(self.cursor, padded_len) if cursor is None else cursor
        if target < padded_len:
            raise ValueError(
                f"cursor {target} < padded prefill length {padded_len}: the "
                "prompt's last token cannot land left of its own start"
            )
        return _admit_row(self.cache, slot, padded_len, target)

    def free(self, slot: int) -> None:
        """Clear the slot's validity and return it to the free list; a
        quarantined slot is cleared but never rejoins the rotation."""
        reset_cache_slot(self.cache, slot)
        if slot not in self._quarantined and slot not in self._free:
            self._free.append(slot)
            self._free.sort()

    def release_all_slots(self) -> None:
        """Return every slot but the quarantined ones to the free list (host
        bookkeeping only, for callers about to :meth:`reset`)."""
        self._free = [s for s in range(self.num_slots) if s not in self._quarantined]

    def recover(self) -> None:
        """After a failed decode dispatch whose requests are requeued (JAX
        ``recover``, ``cache_manager.py:236``): every slot back in the
        rotation and the storage reset IN PLACE, cursor 0. Nothing in the
        port consumes the cache, so the storage always survives, and the
        captured decode step keeps reading these very buffers."""
        self.release_all_slots()
        self.reset()

    def update_after_decode(self, start: int, steps: int) -> None:
        """Set the cursor (mirror and device) after a decode chunk that
        began at ``start`` and consumed ``steps`` columns."""
        self.cache.index = start + steps

    def reset(self) -> None:
        """Rewind the cursor and invalidate every slot (drain/preemption)."""
        reset_cache(self.cache)


# --- host-managed prefix KV cache ---------------------------------------------


def prefix_leaves(tree) -> tuple:
    """The tensors of a stored prefix block (a :class:`KVCache` from
    ``extract_cache_prefix``), or none for a paged entry."""
    return () if tree is None else (tree.k, tree.v, tree.valid)


@dataclasses.dataclass(eq=False)  # identity: entries are compared as objects
class PrefixEntry:
    """One stored prompt prefix: ``tokens`` (the full token path, length
    ``m``), its compact device KV block ``tree`` (``bucket`` columns, token
    0 at column 0: a COPY made at insert time, never a view of the engine's
    cache), the integrity ``fingerprint`` (a device scalar, read only at
    reuse) and leaf ``shapes`` recorded at insert, and ``refs``, the pin
    count that protects an entry backing an in-flight suffix prefill from
    eviction. A PAGED entry holds no copy (``tree`` is None): ``page_ids``
    are the ref-counted pool pages its tokens live in, mapped
    copy-on-write into a hitting slot's block table, and ``page_fp`` their
    per-page content fingerprints at insert (a device int64 vector,
    ``utils/fingerprint.pool_pages_fingerprint``), which every reuse
    recomputes and compares bit for bit: a bit flip leaves the page
    accounting healthy, and only the content check sees it."""

    tokens: Tuple[int, ...]
    tree: Any
    bucket: int
    fingerprint: Any
    shapes: Tuple[Tuple[int, ...], ...]
    refs: int = 0
    page_ids: Optional[Tuple[int, ...]] = None
    page_fp: Any = None
    # the host page tier (JAX cache_manager.py:316-323): a SPILLED entry's
    # pages live in the engine's HostPageStore under these ids and
    # ``page_ids`` is None; the entry stays in the trie, and a prefetch
    # re-homes it (host_ids -> page_ids) before any slot maps it. A live
    # paged entry has exactly one of the two
    host_ids: Optional[Tuple[int, ...]] = None
    # where the entry's NEXT hit is attributed: "host" from a spill until
    # the hit that a prefetch made possible is recorded, then "device"
    hit_tier: str = "device"

    @property
    def m(self) -> int:
        return len(self.tokens)


class _TrieNode:
    __slots__ = ("children", "entry")

    def __init__(self):
        self.children: Dict[int, "_TrieNode"] = {}
        self.entry: Optional[PrefixEntry] = None


class PrefixCache:
    """Host-managed, ref-counted, LRU-evicted store of prompt-prefix KV
    blocks, keyed by a token trie.

    The serving engine consults it at admission: the longest stored prefix
    of the incoming context (capped at ``context - 1``: at least one token
    must run so the admission has next-token logits to sample from) is
    seeded into the slot and only the uncached tail is prefilled. A stored
    entry's first ``d`` columns serve ANY context sharing its first ``d``
    tokens, so one long entry covers every shorter shared prefix: lookup
    walks the trie to the deepest reachable node and uses any entry beneath
    it.

    Matches shorter than ``min_match`` tokens are misses, and contexts
    shorter than ``min_match`` are never stored. ``max_entries=0`` disables
    the cache entirely (the engine then runs the full-prefill path).

    Eviction is LRU over entries (hits, covers and inserts refresh recency)
    and NEVER frees a pinned entry (``refs > 0``); if every entry is pinned
    the store temporarily overflows rather than corrupt an in-flight
    admission. The engine owns the counters; this class reports what each
    call did."""

    def __init__(self, max_entries: int = 32, min_match: int = 8):
        if min_match < 1:
            raise ValueError(f"min_match must be >= 1, got {min_match}")
        self.max_entries = max_entries
        self.min_match = min_match
        self._root = _TrieNode()
        self._lru: "OrderedDict[Tuple[int, ...], PrefixEntry]" = OrderedDict()
        # called with each entry as it leaves the store (LRU eviction,
        # forced eviction, clear): the paged engine releases the entry's
        # pool page refs here, so a dropped entry never leaks pages
        self.on_evict: Optional[Any] = None

    # --- introspection ------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.max_entries > 0

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def entries(self):
        """Stored entries, least-recently-used first."""
        return list(self._lru.values())

    @property
    def tokens_stored(self) -> int:
        return sum(e.m for e in self._lru.values())

    @property
    def nbytes(self) -> int:
        """Device bytes of stored entry copies (paged entries hold page ids,
        whose bytes the pool accounts for)."""
        return sum(t.numel() * t.element_size()
                   for e in self._lru.values() for t in prefix_leaves(e.tree))

    def _walk(self, tokens) -> Tuple[_TrieNode, int]:
        """Deepest trie node reachable along ``tokens`` and its depth. Every
        live node has an entry in its subtree (eviction prunes entry-less
        childless chains), so reaching depth ``d`` means some stored entry
        shares the first ``d`` tokens."""
        node, depth = self._root, 0
        for t in tokens:
            nxt = node.children.get(int(t))
            if nxt is None:
                break
            node, depth = nxt, depth + 1
        return node, depth

    @staticmethod
    def _subtree_entry(node: _TrieNode) -> Optional[PrefixEntry]:
        stack = [node]
        while stack:
            n = stack.pop()
            if n.entry is not None:
                return n.entry
            stack.extend(n.children.values())
        return None

    def match_len(self, tokens) -> int:
        """Read-only longest USABLE match length for ``tokens`` (0 below
        ``min_match``): the scheduler's effective-prefill-cost peek; no LRU
        state moves."""
        if not self.enabled:
            return 0
        _, depth = self._walk(tokens)
        use = min(depth, len(tokens) - 1)
        return use if use >= self.min_match else 0

    # --- lookup / insert ----------------------------------------------------

    def peek(self, tokens) -> Optional[Tuple[PrefixEntry, int]]:
        """``(entry, m_use)``, the entry whose first ``m_use`` columns are the
        reusable prefix KV, or ``None`` on a miss (no match, or a match
        shorter than ``min_match``); no LRU motion."""
        if not self.enabled:
            return None
        node, depth = self._walk(tokens)
        m_use = min(depth, len(tokens) - 1)
        if m_use < self.min_match:
            return None
        entry = self._subtree_entry(node)
        if entry is None:  # unreachable for a live trie
            return None
        return entry, m_use

    def lookup(self, tokens) -> Optional[Tuple[PrefixEntry, int]]:
        """:meth:`peek` that refreshes the matched entry's recency; the
        caller pins it (:meth:`pin`) for the duration of the suffix
        prefill."""
        hit = self.peek(tokens)
        if hit is not None:
            self._lru.move_to_end(hit[0].tokens)
        return hit

    def covers(self, tokens) -> bool:
        """Whether some stored entry already extends (or equals) ``tokens``:
        inserting them again would add nothing. Refreshes the covering entry
        so the hot prefix stays resident."""
        if not self.enabled:
            return False
        node, depth = self._walk(tokens)
        if depth < len(tokens):
            return False
        entry = self._subtree_entry(node)
        if entry is not None:
            self._lru.move_to_end(entry.tokens)
        return entry is not None

    def insert(self, tokens, tree, fingerprint,
               bucket: int) -> Tuple[Optional[PrefixEntry], int]:
        """Store a prefix block. Returns ``(entry, n_evicted)``; the entry is
        ``None`` when the insert was skipped (disabled, too short, or
        already covered). Evicts least-recently-used UNPINNED entries until
        the store fits ``max_entries``."""
        key = tuple(int(t) for t in tokens)
        if not self.enabled or len(key) < self.min_match:
            return None, 0
        if self.covers(key):
            return None, 0
        entry = PrefixEntry(tokens=key, tree=tree, bucket=bucket, fingerprint=fingerprint,
                            shapes=tuple(tuple(t.shape) for t in prefix_leaves(tree)))
        node = self._root
        for t in key:
            node = node.children.setdefault(t, _TrieNode())
        node.entry = entry
        self._lru[key] = entry
        evicted = 0
        while len(self._lru) > self.max_entries:
            victim = next((e for e in self._lru.values() if e.refs == 0 and e is not entry),
                          None)
            if victim is None:  # everything pinned: overflow, never corrupt
                break
            self.evict_entry(victim)
            evicted += 1
        return entry, evicted

    # --- pins / eviction ----------------------------------------------------

    def pin(self, entry: PrefixEntry) -> None:
        entry.refs += 1

    def release(self, entry: PrefixEntry) -> None:
        entry.refs = max(0, entry.refs - 1)

    def release_all(self) -> None:
        """Drop every pin: no suffix prefill survives a preemption or a
        reset, so no pin may either (a leaked ref would block eviction
        forever)."""
        for e in self._lru.values():
            e.refs = 0

    def evict_entry(self, entry: PrefixEntry) -> bool:
        """Remove one entry (LRU eviction, or forced: validation failure),
        pruning the trie chain it leaves behind."""
        if self._lru.pop(entry.tokens, None) is None:
            return False
        if self.on_evict is not None:
            self.on_evict(entry)
        path = [self._root]
        for t in entry.tokens:
            nxt = path[-1].children.get(t)
            if nxt is None:
                return True  # trie already pruned past here
            path.append(nxt)
        path[-1].entry = None
        for depth in range(len(path) - 1, 0, -1):
            node = path[depth]
            if node.entry is None and not node.children:
                del path[depth - 1].children[entry.tokens[depth - 1]]
            else:
                break
        return True

    def clear(self) -> int:
        """Drop everything; returns how many entries were dropped."""
        n = len(self._lru)
        if self.on_evict is not None:
            for e in self._lru.values():
                self.on_evict(e)
        self._root = _TrieNode()
        self._lru = OrderedDict()
        return n
