"""RoPE, the attention dispatcher, the KV caches and decode attention
(counterpart of ``neuronx_distributed_tpu/modules/attention.py``, the subset
the serving path runs: cp = 1, row and paged caches, no prefix store).

The JAX cache is a flax ``cache`` collection that each program returns
updated (the engine donates it so XLA updates it in place). Here the cache is
a :class:`KVCache` (row per slot) or a :class:`PagedKVCache` (page pool and
block table) of explicit tensors that the model updates IN PLACE — the
PyTorch counterpart of donation. Its write cursor lives on the device (a
0-d int64 tensor, as the JAX collection's ``index``) with a host mirror
beside it: a decode step reads and advances only the device cursor, so a
step captured once in a CUDA graph writes the right columns at every
replay. The model's attention layer calls the cache's own
:meth:`KVCache.attend`, so one model serves both layouts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from neuronx_distributed_tpu_torch.kernels.flash_attention import flash_attention
from neuronx_distributed_tpu_torch.kernels.flash_decode import (
    flash_decode_attention,
    paged_flash_decode_attention,
    paged_gather_leaf,
)

NEG_INF = -1e30


# --- RoPE ---------------------------------------------------------------------

def rope_frequencies(head_dim: int, max_seq_len: int, theta: float,
                     device=None) -> torch.Tensor:
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    return torch.outer(t, inv_freq)  # (S, D/2)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, H, D); freqs: (max_S, D/2); positions: (B, S) int or None."""
    if positions is None:
        f = freqs[: x.shape[1]][None, :, None, :]
    else:
        f = freqs[positions][:, :, None, :]
    cos, sin = torch.cos(f), torch.sin(f)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- attention dispatch -------------------------------------------------------

def xla_attention(q, k, v, causal: bool = True, mask: Optional[torch.Tensor] = None,
                  segment_ids: Optional[torch.Tensor] = None,
                  kv_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain golden (JAX ``xla_attention``): q (B, S, H, D), k/v (B, Sk,
    Hkv, D); ``mask`` (B, Sk) True at valid keys; ``segment_ids`` restrict
    attention to equal ids. Causal is bottom-right aligned."""
    b, sq, h, d = q.shape
    hkv, sk = k.shape[2], k.shape[1]
    qg = q.to(torch.float32).reshape(b, sq, hkv, h // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    scores = scores / torch.sqrt(torch.tensor(float(d)))
    if causal:
        cmask = torch.tril(torch.ones((sq, sk), dtype=torch.bool, device=q.device),
                           diagonal=sk - sq)
        scores = torch.where(cmask, scores, NEG_INF)
    if mask is not None:
        scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    if segment_ids is not None:
        ks = kv_segment_ids if kv_segment_ids is not None else segment_ids
        smask = segment_ids[:, :, None] == ks[:, None, :]
        scores = torch.where(smask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(b, sq, h, d).to(q.dtype)


def attention_op(q, k, v, causal: bool = True, impl: str = "flash",
                 mask: Optional[torch.Tensor] = None,
                 segment_ids: Optional[torch.Tensor] = None,
                 kv_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch (cp = 1): ``"flash"`` (default) calls the flash kernel's
    wrapper, ``"xla"`` the plain golden. The padding ``mask`` (B, Sk) folds
    into segment ids exactly as the JAX dispatcher does (``attention.py:
    103-115``): padding = segment ``-1``."""
    if impl not in ("flash", "xla"):
        raise ValueError(f"unknown attention impl {impl!r} (expected 'flash' or 'xla')")
    if kv_segment_ids is not None and segment_ids is None:
        raise ValueError(
            "kv_segment_ids requires segment_ids (query-side ids) — got only "
            "the key side, which would silently drop the mask"
        )
    q_seg = segment_ids
    k_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids
    if mask is not None:
        minus1 = torch.tensor(-1, dtype=torch.int32, device=mask.device)
        if k_seg is None and q.shape[1] == k.shape[1]:
            q_seg = k_seg = torch.where(mask, torch.zeros_like(minus1), minus1)
        elif k_seg is not None and k_seg is q_seg and q.shape[1] == k.shape[1]:
            q_seg = k_seg = torch.where(mask, q_seg.to(torch.int32), minus1)
        elif k_seg is not None:
            k_seg = torch.where(mask, k_seg.to(torch.int32), minus1)
        else:  # cross-length mask with no segments: the einsum path
            return xla_attention(q, k, v, causal=causal, mask=mask)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, segment_ids=q_seg,
                               kv_segment_ids=k_seg)
    return xla_attention(q, k, v, causal=causal, segment_ids=q_seg,
                         kv_segment_ids=k_seg)


# --- KV cache -----------------------------------------------------------------

def prefill_positions(padding_mask: torch.Tensor) -> torch.Tensor:
    """RoPE positions for a left-padded prompt (B, S): restart at each row's
    first valid token; padding positions clamp to 0."""
    return torch.clamp(torch.cumsum(padding_mask.to(torch.int64), dim=1) - 1, min=0)


def valid_count_below(kv_valid: torch.Tensor, cur) -> torch.Tensor:
    """Per-row count of valid cache slots strictly below write index ``cur``
    (a host int or a device tensor, which is never read) — each row's true
    sequence length."""
    cols = torch.arange(kv_valid.shape[1], device=kv_valid.device)
    return (kv_valid & (cols < cur)).sum(dim=1, dtype=torch.int64)


class KVCache:
    """Explicit cache tensors, updated in place by the model.

    ``k``/``v`` (num_layers, B, L, Hkv, D); ``valid`` (B, L) bool —
    prefill records the padding mask, decode appends per-step validity;
    ``cursor`` the shared write cursor, a 0-d int64 device tensor, and
    ``index`` its host mirror. The JAX collection holds a ``kv_valid`` and
    an ``index`` per layer, always equal; here the model writes the one
    shared copy once per step, before its layers.

    A decode step reads and advances only ``cursor`` (index ops on the
    device, no slice at a host int), so it is the same device program at
    every column. Setting ``index`` writes the mirror and then the device
    cursor (a host→device write, never a read): admission, rewinds and
    resets go through it. Whatever runs decode steps keeps the mirror with
    :meth:`advance_mirror`, since the steps never touch host state."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                 index: int = 0):
        self.k, self.v, self.valid = k, v, valid
        self.cursor = torch.zeros((), dtype=torch.int64, device=valid.device)
        # column ids 0..L-1, made once: the decode step's index arithmetic
        self._cols = torch.arange(valid.shape[1], device=valid.device)
        self._step_cols = None  # (s,) columns of this step's writes, set once per forward
        self.index = index

    @property
    def index(self) -> int:
        """The host mirror of the write cursor."""
        return self._index

    @index.setter
    def index(self, n: int) -> None:
        self._index = int(n)
        self.cursor.fill_(self._index)

    def advance_mirror(self, n: int) -> None:
        """Move the host mirror ``n`` columns after decode steps that moved
        the device cursor themselves (no device write)."""
        self._index += n

    @classmethod
    def allocate(cls, num_layers: int, b: int, max_seq_len: int, hkv: int,
                 d: int, dtype: torch.dtype, device) -> "KVCache":
        # zeros, not empty: masked columns still enter P·V with weight 0,
        # and uninitialized memory could hold NaN
        shape = (num_layers, b, max_seq_len, hkv, d)
        return cls(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros((b, max_seq_len), dtype=torch.bool, device=device),
        )

    @property
    def max_seq_len(self) -> int:
        return self.valid.shape[1]

    def view(self, rows: slice, start: int) -> "KVCache":
        """A cache whose column 0 is column ``start`` of batch ``rows`` of
        this one — writes through it land in this cache (the engine's
        prefill writes a slot's prompt straight into its columns). It has a
        cursor of its own."""
        return KVCache(self.k[:, rows, start:], self.v[:, rows, start:],
                       self.valid[rows, start:])

    def prefill_valid(self, padding_mask: Optional[torch.Tensor], s: int) -> None:
        """Record the prompt's validity at columns [0, s); cursor = s."""
        self.valid[:, :s] = (
            padding_mask.to(torch.bool) if padding_mask is not None else True
        )
        self.index = s

    def prefill_write(self, layer: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write one layer's prompt K/V at columns [0, s)."""
        s = k.shape[1]
        self.k[layer, :, :s] = k
        self.v[layer, :, :s] = v

    def decode_positions(self, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(slot positions (s,) int32, rope positions (B, s)): slots continue
        at the device cursor, RoPE continues each row's true sequence. The
        bound is checked against the host mirror, which the caller keeps."""
        if self.index + s > self.max_seq_len:
            raise ValueError(f"decode step of {s} past the cache end ({self.index} + {s} > "
                             f"{self.max_seq_len})")
        steps = self._cols[:s]
        self._step_cols = self.cursor + steps
        rope_pos = valid_count_below(self.valid, self.cursor)[:, None] + steps[None]
        return self._step_cols.to(torch.int32), rope_pos

    def decode_valid(self, padding_mask: Optional[torch.Tensor], s: int) -> None:
        """Validity (B, s) of the INCOMING tokens at the cursor; finished
        rows pass False so their filler K/V never becomes attendable."""
        b = self.valid.shape[0]
        if padding_mask is not None and tuple(padding_mask.shape) != (b, s):
            raise ValueError(
                f"decode padding_mask must cover the incoming step tokens "
                f"(shape {(b, s)}), got {tuple(padding_mask.shape)}"
            )
        mask = (padding_mask.to(torch.bool) if padding_mask is not None
                else torch.ones((b, s), dtype=torch.bool, device=self.valid.device))
        self.valid.index_copy_(1, self._step_cols, mask)

    def decode_write(self, layer: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append one layer's decode K/V at the cursor (the model advances
        the cursor once, after its last layer)."""
        self.k[layer].index_copy_(1, self._step_cols, k)
        self.v[layer].index_copy_(1, self._step_cols, v)

    def advance(self, s: int) -> None:
        """Move the device cursor ``s`` columns, in place (the end of a
        decode forward)."""
        self.cursor.add_(s)

    def attend(self, layer: int, q: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
        """Decode attention of q (B, s, H, D) at cache columns ``q_pos``
        against this layer's rows: K4's wrapper."""
        return decode_attention(q, self.k[layer], self.v[layer], q_pos, kv_valid=self.valid)


class PagedKVCache(KVCache):
    """A paged cache, updated in place by the model: ``k``/``v`` are page
    POOLS (num_layers, num_pages, page_size, Hkv, D), zero-initialised;
    ``block_table`` (B, n_log) int32 on the device maps logical page j of
    row b to a pool page (0 = the reserved null page, never attendable);
    ``valid`` (B, n_log * page_size) and the cursor stay LOGICAL, exactly as
    in :class:`KVCache` (the JAX paged collection keeps ``kv_valid`` and
    ``index`` logical too, ``modules/attention.py:502-518``). The host owns
    the table (``serving/paging.py``) and uploads it with
    :meth:`upload_table`.

    Writes land IN PLACE in the pool page under each logical column,
    through the table. The JAX chunk instead gathers the logical view,
    writes it and scatters the write window back (``gather_cache_pages`` /
    ``scatter_cache_window``, ``inference/generate.py:165-186``) because its
    arrays are immutable; here nothing needs a round trip. Columns whose page
    is unmapped (left padding, masked no-op steps, idle rows) land in page 0.

    Decode attends straight from the pool through the table (K5). ``col0``
    is the logical column this object's column 0 maps to (a slot's prefill
    view, :meth:`view`)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                 block_table: torch.Tensor, page_size: int, index: int = 0, col0: int = 0):
        super().__init__(k, v, valid, index)
        self.block_table, self.page_size, self.col0 = block_table, page_size, col0
        self._dst = None  # (pages, rows) of this step's writes, set once per forward

    @classmethod
    def allocate(cls, num_layers: int, b: int, max_seq_len: int, hkv: int, d: int,
                 dtype: torch.dtype, device, num_pages: int,
                 page_size: int = 16) -> "PagedKVCache":
        if page_size < 1 or max_seq_len % page_size:
            raise ValueError(f"max_seq_len ({max_seq_len}) must be a multiple of "
                             f"page_size ({page_size})")
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is reserved), got {num_pages}")
        # zeros, as KVCache: masked columns still enter P·V with weight 0
        shape = (num_layers, num_pages, page_size, hkv, d)
        return cls(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros((b, max_seq_len), dtype=torch.bool, device=device),
            torch.zeros((b, max_seq_len // page_size), dtype=torch.int32, device=device),
            page_size,
        )

    def upload_table(self, tables) -> None:
        """Copy the host's block tables (B, n_log) into the device table, in
        place (views of it stay current): a host→device copy, no read."""
        self.block_table.copy_(torch.as_tensor(tables, dtype=torch.int32))

    def view(self, rows: slice, start: int) -> "PagedKVCache":
        """The cache of batch ``rows`` whose column 0 is logical column
        ``start``; writes through it land in this cache's pool and validity."""
        return PagedKVCache(self.k, self.v, self.valid[rows, start:], self.block_table[rows],
                            self.page_size, col0=self.col0 + start)

    def _address(self, cols: torch.Tensor) -> None:
        """Physical (page, row) of this object's columns ``cols`` (a device
        tensor) in every row, for the writes of the forward about to run."""
        cols = cols + self.col0
        self._dst = (self.block_table[:, cols // self.page_size].long(), cols % self.page_size)

    def prefill_valid(self, padding_mask: Optional[torch.Tensor], s: int) -> None:
        super().prefill_valid(padding_mask, s)
        self._address(self._cols[:s])

    def decode_positions(self, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
        pos, rope_pos = super().decode_positions(s)
        self._address(self._step_cols)
        return pos, rope_pos

    def decode_write(self, layer: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write one layer's K/V (B, s, Hkv, D) at the columns the forward
        addressed (:meth:`prefill_valid` or :meth:`decode_positions`)."""
        pages, rows = self._dst
        self.k[layer][pages, rows] = k
        self.v[layer][pages, rows] = v

    prefill_write = decode_write

    def attend(self, layer: int, q: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
        """Decode attention of q (B, s, H, D) at logical columns ``q_pos``
        straight from this layer's pools: K5's wrapper."""
        return paged_flash_decode_attention(q, self.k[layer], self.v[layer], self.block_table,
                                            q_pos, self.valid, self.page_size)


def gather_cache_pages(cache: PagedKVCache, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The logical (B, L, Hkv, D) K and V views of one layer of a paged
    cache (JAX ``gather_cache_pages``, ``modules/attention.py:502``):
    unmapped logical pages surface null-page content in columns ``valid``
    masks. A copy, for the tests and the on-card checks."""
    return (paged_gather_leaf(cache.k[layer], cache.block_table, cache.page_size),
            paged_gather_leaf(cache.v[layer], cache.block_table, cache.page_size))


# --- slot helpers (serving) ---------------------------------------------------

def reset_cache_slot(cache: KVCache, slot: int) -> None:
    """Free one batch row: clear its validity so nothing in it stays
    attendable. K/V storage stays; the next admission overwrites it."""
    cache.valid[slot] = False


def reset_cache(cache: KVCache) -> None:
    """Clear every slot's validity and rewind the cursor, mirror and device
    (drain/preempt)."""
    cache.valid.zero_()
    cache.index = 0


def decode_attention(q, k_cache, v_cache, q_pos, kv_valid=None) -> torch.Tensor:
    """Attention of q (B, s, H, D) rows at positions ``q_pos`` (s,) against
    the cache (B, L, Hkv, D), each row masked at its own position and by
    ``kv_valid`` (B, L). Always the flash-decode kernel's wrapper."""
    return flash_decode_attention(q, k_cache, v_cache, q_pos, kv_valid)
