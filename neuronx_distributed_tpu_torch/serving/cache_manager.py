"""Slot-level KV-cache management (counterpart of
``neuronx_distributed_tpu/serving/cache_manager.py``, ``SlotCacheManager``
only; the prefix store belongs to a later slice).

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
* freeing a slot clears its validity row; draining rewinds the cursor.
"""

from __future__ import annotations

from typing import Optional

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

    @property
    def cursor(self) -> int:
        return self.cache.index

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        return self._free.pop(0)

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
        """Clear the slot's validity and return it to the free list."""
        reset_cache_slot(self.cache, slot)
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
        """Rewind the cursor and invalidate every slot (drain/preemption)."""
        reset_cache(self.cache)
