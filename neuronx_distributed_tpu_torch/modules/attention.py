"""RoPE, the attention dispatcher, the KV caches and decode attention
(counterpart of ``neuronx_distributed_tpu/modules/attention.py``, the subset
the serving path runs: cp = 1, row and paged caches, and the prefix cache's
extract and seed), and the GPT-style blocks the other decoder families
stand on: :class:`ParallelSelfAttention` (partial rotary, biased
projections) and :class:`ParallelMLP`.

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

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neuronx_distributed_tpu_torch.kernels.flash_attention import flash_attention
from neuronx_distributed_tpu_torch.kernels.flash_decode import (
    flash_decode_attention,
    paged_flash_decode_attention,
    paged_gather_leaf,
    paged_read_pages_leaf_dequant,
    qpaged_write_attend_fwd,
)
from neuronx_distributed_tpu_torch.kernels.kv_quant import window_requantize_fwd, write_window
from neuronx_distributed_tpu_torch.modules.qkv_linear import GQAQKVColumnParallelLinear
from neuronx_distributed_tpu_torch.parallel.layers import ColumnParallelLinear, RowParallelLinear

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

    def decode_positions(self, s: int, positions: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(query positions (s,) int32, rope positions (B, s)): slots continue
        at the device cursor, RoPE continues each row's true sequence. With
        explicit ``positions`` (s,) (a Medusa tree step) both follow the
        caller, as in JAX (``attention.py:234-243``); the writes still land
        at the cursor. The bound is checked against the host mirror, which
        the caller keeps."""
        if self.index + s > self.max_seq_len:
            raise ValueError(f"decode step of {s} past the cache end ({self.index} + {s} > "
                             f"{self.max_seq_len})")
        steps = self._cols[:s]
        self._step_cols = self.cursor + steps
        if positions is not None:
            pos = positions.reshape(-1)
            return pos.to(torch.int32), pos.to(torch.int64)[None].expand(self.valid.shape[0], s)
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

    def window_keeper(self, s: int) -> Callable[[], None]:
        """A callable that puts back what a write of ``s`` columns at the
        cursor changes outside those columns, saved now: nothing here (a
        row cache writes only its columns). A masked warm-up calls it after
        its write."""
        return lambda: None

    def attend(self, layer: int, q: torch.Tensor, q_pos: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decode attention of q (B, s, H, D) at cache columns ``q_pos``
        against this layer's rows: K4's wrapper, or with a tree ``mask``
        (s, L) the masked torch-op path (:func:`decode_attention`)."""
        return decode_attention(q, self.k[layer], self.v[layer], q_pos, kv_valid=self.valid,
                                mask=mask)

    def write_attend(self, layer: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A decode layer's cache work: write its K/V (:meth:`decode_write`),
        then attend (:meth:`attend`)."""
        self.decode_write(layer, k, v)
        return self.attend(layer, q, q_pos, mask)


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
    is the logical column this object's column 0 maps to (a slot's view,
    :meth:`view`, which prefills and suffix prefills write through), and
    ``row_valid`` the validity of the whole logical rows, which K5 reads
    beside the table.

    An int8 pool (``kv_quant="int8"``; JAX ``PagedCacheManager(kv_quant=)``,
    ``paging.py:723-760``) holds int8 ``k``/``v`` and the scale pools
    ``k_scale``/``v_scale`` (num_layers, num_pages, 1, Hkv, 1) in the
    compute dtype, one scale a (page, kv-head). A write re-quantizes every
    page it touches, by JAX's ``scatter_cache_window`` rule
    (``modules/attention.py:544-593``): the page dequantized, the new rows
    put in, the page quantized again (``quantize_page_block``; a prefill's
    write is one QW launch a layer on the card, :func:`window_requantize_fwd`,
    a decode step's is folded into its attention); pages outside the write
    keep their bits. JAX re-quantizes a decode chunk's
    window once, at the chunk's end, and attends the chunk's own tokens in
    float; here each step's write quantizes, since K5q reads the pool, so
    the stream does not depend on the chunk size. The page manager zeroes a
    page when it maps it (:meth:`clear_pages`), so a page's scale sees the
    rows JAX's page would hold and no earlier request's. Decode attends the
    pool through K5q, and a decode layer writes and attends in one call
    (:meth:`write_attend`: K5q with the write folded in on the card)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                 block_table: torch.Tensor, page_size: int, index: int = 0, col0: int = 0,
                 row_valid: Optional[torch.Tensor] = None,
                 k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None):
        super().__init__(k, v, valid, index)
        self.block_table, self.page_size, self.col0 = block_table, page_size, col0
        self.row_valid = valid if row_valid is None else row_valid
        self.k_scale, self.v_scale = k_scale, v_scale
        self._dst = None  # (pages, rows) of this step's writes, set once per forward
        # an int8 pool's write: the first column (logical, a (1,) device
        # tensor) and the column count, set with _dst; the window's pages
        # are made from them when a write first asks (:attr:`_win`)
        self._c0, self._n_cols, self._window = None, 0, None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def allocate(cls, num_layers: int, b: int, max_seq_len: int, hkv: int, d: int,
                 dtype: torch.dtype, device, num_pages: int,
                 page_size: int = 16, kv_quant: Optional[str] = None) -> "PagedKVCache":
        if page_size < 1 or max_seq_len % page_size:
            raise ValueError(f"max_seq_len ({max_seq_len}) must be a multiple of "
                             f"page_size ({page_size})")
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is reserved), got {num_pages}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown KV quantization {kv_quant!r} (expected 'int8' or None)")
        # zeros, as KVCache: masked columns still enter P·V with weight 0
        shape = (num_layers, num_pages, page_size, hkv, d)
        pool = torch.int8 if kv_quant else dtype
        scales = {}
        if kv_quant:
            sshape = (num_layers, num_pages, 1, hkv, 1)
            scales = dict(k_scale=torch.zeros(sshape, dtype=dtype, device=device),
                          v_scale=torch.zeros(sshape, dtype=dtype, device=device))
        return cls(
            torch.zeros(shape, dtype=pool, device=device),
            torch.zeros(shape, dtype=pool, device=device),
            torch.zeros((b, max_seq_len), dtype=torch.bool, device=device),
            torch.zeros((b, max_seq_len // page_size), dtype=torch.int32, device=device),
            page_size, **scales,
        )

    def upload_table(self, tables) -> None:
        """Copy the host's block tables (B, n_log) into the device table, in
        place (views of it stay current): a host→device copy, no read."""
        self.block_table.copy_(torch.as_tensor(tables, dtype=torch.int32))

    def view(self, rows: slice, start: int) -> "PagedKVCache":
        """The cache of batch ``rows`` whose column 0 is logical column
        ``start``; writes through it land in this cache's pool and validity."""
        return PagedKVCache(self.k, self.v, self.valid[rows, start:], self.block_table[rows],
                            self.page_size, col0=self.col0 + start,
                            row_valid=self.row_valid[rows], k_scale=self.k_scale,
                            v_scale=self.v_scale)

    def _address(self, cols: torch.Tensor) -> None:
        """Physical (page, row) of this object's columns ``cols`` (a device
        tensor) in every row, for the writes of the forward about to run;
        an int8 pool keeps the first column (logical) and the count for its
        write window (:attr:`_win`; the columns are consecutive). Device
        tensors only, from the table and the cursor: a captured step
        replays it."""
        cols = cols + self.col0
        ps = self.page_size
        self._dst = (self.block_table[:, cols // ps].long(), cols % ps)
        if self.quantized:
            self._c0, self._n_cols, self._window = cols[:1], cols.numel(), None

    @property
    def _win(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """An int8 pool's write window of the addressed columns, QW's input
        (``kernels/kv_quant.py write_window``: the physical pages of the
        logical pages the columns can touch, past the table's end the null
        page, and the first column's place in them), made once a forward.
        The fused decode route (:meth:`write_attend`) reads the table in
        the kernel and never asks."""
        if self._window is None:
            self._window = write_window(self.block_table, self._c0, self._n_cols,
                                        self.page_size)
        return self._window

    def prefill_valid(self, padding_mask: Optional[torch.Tensor], s: int) -> None:
        super().prefill_valid(padding_mask, s)
        self._address(self._cols[:s])

    def decode_positions(self, s: int, positions: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        pos, rope_pos = super().decode_positions(s, positions)
        self._address(self._step_cols)
        return pos, rope_pos

    def decode_write(self, layer: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write one layer's K/V (B, s, Hkv, D) at the columns the forward
        addressed (:meth:`prefill_valid` or :meth:`decode_positions`); on an
        int8 pool, re-quantize the pages of the write window, K and V in one
        call (:func:`window_requantize_fwd`, QW on the card). Rows that
        share the null page write it in any order; nothing reads it."""
        if self.quantized:
            pages, w0 = self._win
            window_requantize_fwd(self.k[layer], self.v[layer], self.k_scale[layer],
                                  self.v_scale[layer], pages, w0, k, v)
            return
        pages, rows = self._dst
        self.k[layer][pages, rows] = k
        self.v[layer][pages, rows] = v

    prefill_write = decode_write

    def window_keeper(self, s: int) -> Callable[[], None]:
        """On an int8 pool a write of ``s`` columns at the cursor
        re-quantizes its window's pages, valid rows included: their codes
        and scales (every layer; device ops, no host read) are saved now
        and the callable writes them back. Other pools as
        :meth:`KVCache.window_keeper`."""
        if not self.quantized:
            return super().window_keeper(s)
        ids = write_window(self.block_table, self.cursor.reshape(1) + self.col0, s,
                           self.page_size)[0].reshape(-1)
        leaves = (self.k, self.v, self.k_scale, self.v_scale)
        saved = [t[:, ids] for t in leaves]

        def restore() -> None:
            for t, x in zip(leaves, saved):
                t[:, ids] = x

        return restore

    def clear_pages(self, ids) -> None:
        """Zero pages ``ids`` of an int8 pool, codes and scales, in every
        layer (the page manager maps them next)."""
        if not self.quantized or len(ids) == 0:
            return
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.k.device)
        for t in (self.k, self.v, self.k_scale, self.v_scale):
            t[:, idx] = 0

    def attend(self, layer: int, q: torch.Tensor, q_pos: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decode attention of q (B, s, H, D) at this object's columns
        ``q_pos`` straight from this layer's pools, over the whole logical
        rows: K5's wrapper (K5q on an int8 pool). A tree ``mask`` needs a
        row cache (Medusa decodes solo, on a row cache, in JAX as here)."""
        if mask is not None:
            raise ValueError("tree attention (a decode mask) runs on a row KVCache")
        if self.col0:
            q_pos = q_pos + self.col0
        scales = (dict(k_scale=self.k_scale[layer], v_scale=self.v_scale[layer])
                  if self.quantized else {})
        return paged_flash_decode_attention(q, self.k[layer], self.v[layer], self.block_table,
                                            q_pos, self.row_valid, self.page_size, **scales)

    def write_attend(self, layer: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`decode_write` then :meth:`attend`; on an int8 pool in one
        call, :func:`qpaged_write_attend_fwd` (K5q with the write folded in
        on the card: one launch a layer, no QW), which reads the window's
        pages from the table and the first column."""
        if not self.quantized or mask is not None:
            return super().write_attend(layer, q, k, v, q_pos, mask)
        if self.col0:
            q_pos = q_pos + self.col0
        return qpaged_write_attend_fwd(q, k, v, self.k[layer], self.v[layer], self.k_scale[layer],
                                       self.v_scale[layer], self.block_table, q_pos,
                                       self.row_valid, self._c0, self.page_size)[0]

    def dequantized_row(self, page_ids, m: int, length: int) -> KVCache:
        """A batch-1 float row cache of ``length`` columns whose first ``m``
        hold the first ``m`` tokens of int8 pool pages ``page_ids``,
        dequantized (JAX ``_seed_from_pages``, ``paging.py:324-369``): valid
        there, invalid after, its cursor at ``m``. A copy; the pool is only
        read."""
        n_layers, _, _, hkv, d = self.k.shape
        row = KVCache.allocate(n_layers, 1, length, hkv, d, self.k_scale.dtype, self.k.device)
        ids = torch.as_tensor(page_ids, dtype=torch.long, device=self.k.device)
        for dst, pool, scale in ((row.k, self.k, self.k_scale), (row.v, self.v, self.v_scale)):
            dst[:, 0, :m] = paged_read_pages_leaf_dequant(pool, scale, ids, self.page_size)[:, :m]
        row.valid[:, :m] = True
        row.index = m
        return row


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


def invalidate_cache_window(cache: KVCache, start, keep: torch.Tensor) -> None:
    """Per-row invalidation of a just-written column window, in place (JAX
    ``invalidate_cache_window``, ``attention.py:410``): the speculative
    round's acceptance primitive. For every row ``b`` clear validity at
    columns ``[start + keep[b], ∞)`` of ``cache``, ANDed, so it only ever
    narrows: the rejected draft columns become permanent invalid gap
    columns, which attention masks and RoPE positions skip (both run off
    validity counts). K/V stay as they are.

    ``start`` is the round's first column (the device cursor's value before
    the round, a 0-d tensor, or a host int) and ``keep`` a (B,) device
    tensor; nothing is read on the host, so a captured round replays it at
    every cursor. On a :class:`PagedKVCache` the clear lands in
    ``row_valid``, the whole logical rows K5 reads, at the object's columns
    shifted by ``col0`` (a slot view's ``valid`` is a window of them)."""
    if isinstance(cache, PagedKVCache):
        valid, start = cache.row_valid, start + cache.col0
    else:
        valid = cache.valid
    cols = torch.arange(valid.shape[1], device=valid.device)[None]
    cut = (cols >= start + keep.to(torch.int64)[:, None]) & (cols >= start)
    valid.logical_and_(torch.logical_not(cut))


def extract_cache_prefix(cache: KVCache, start: int, m: int, bucket: int) -> KVCache:
    """Copy the ``m`` columns starting at ``start`` of a (batch-1) cache into
    a COMPACT prefix block of ``bucket`` columns (JAX
    ``extract_cache_prefix``, ``attention.py:348``): token 0 of the prefix
    at column 0, K/V zero and validity False past ``m``, its cursor at
    ``m`` (the block's token count, which the fingerprint reads). A fresh
    copy, never a view of the cache, so identical prefixes give identical
    blocks whatever bucket their donor prefill used."""
    if start < 0 or start + m > cache.max_seq_len or m > bucket:
        raise ValueError(f"columns [{start}, {start + m}) do not fit a {cache.max_seq_len}-"
                         f"column cache and a {bucket}-column block")
    n_layers, b, _, hkv, d = cache.k.shape
    block = KVCache.allocate(n_layers, b, bucket, hkv, d, cache.k.dtype, cache.k.device)
    block.k[:, :, :m] = cache.k[:, :, start:start + m]
    block.v[:, :, :m] = cache.v[:, :, start:start + m]
    block.valid[:, :m] = cache.valid[:, start:start + m]
    block.index = m
    return block


def seed_cache_prefix(cache: KVCache, prefix: Optional[KVCache], m: int, start: int) -> None:
    """Seed ``cache`` (the admitted slot's view) with the first ``m`` tokens
    of a stored prefix at columns ``[start, start + m)`` (JAX
    ``seed_cache_prefix``, ``attention.py:379``): every other column of the
    view invalid, its cursor at ``start + m``, where a suffix prefill's
    writes continue and whose RoPE positions continue at the prefix's valid
    count. The JAX program builds a fresh row and the engine rolls it into
    the slot; the port's prefills write in place, so ``prefix``, a stored
    block, is copied straight into the slot (read, never aliased). With
    ``prefix=None`` the cache is a paged view whose block table already maps
    the stored pages under those columns (a copy-on-write hit, JAX
    ``seed_row``): no K/V moves, and the prefix's columns are valid."""
    if start < 0 or start + m > cache.max_seq_len:
        raise ValueError(f"{m} prefix columns at {start} do not fit the cache")
    cache.valid.zero_()
    if prefix is None:
        cache.valid[:, start:start + m] = True
    else:
        cache.k[:, :, start:start + m] = prefix.k[:, :, :m]
        cache.v[:, :, start:start + m] = prefix.v[:, :, :m]
        cache.valid[:, start:start + m] = prefix.valid[:, :m]
    cache.index = start + m


def decode_attention(q, k_cache, v_cache, q_pos, kv_valid=None,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q (B, s, H, D) rows at positions ``q_pos`` (s,) against
    the cache (B, L, Hkv, D), each row masked at its own position and by
    ``kv_valid`` (B, L): the flash-decode kernel's wrapper. ``mask`` (s, L)
    REPLACES the positional mask (a Medusa tree step: each node attends the
    prefix and its ancestors) and runs :func:`tree_decode_attention`, as
    JAX keeps its einsum for tree steps (``modules/attention.py:738``)."""
    if mask is not None:
        return tree_decode_attention(q, k_cache, v_cache, mask, kv_valid)
    return flash_decode_attention(q, k_cache, v_cache, q_pos, kv_valid)


def _f32_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` summed in f32. bf16 operands on the card multiply
    on the tensor cores with an f32 result (each product of two bf16 values
    is exact in f32, so this is the f32 product); anything else in f32."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def tree_decode_attention(q, k_cache, v_cache, mask: torch.Tensor,
                          kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked decode attention in torch ops, f32 inside (the counterpart of
    the einsum JAX runs for tree steps, ``kernels/ring_attention.py:59
    _block_attn`` at one block): q (B, s, H, D) against the whole cache (B,
    L, Hkv, D); ``mask`` (s, L) True where a row may attend, ANDed with
    ``kv_valid`` (B, L). A row with nothing to attend gives 0.

    Every score of a layer is built at once, (B·Hkv, group·s, L), with the
    cache read in place at B = 1 (a copy of the (B, Hkv, L, D) layout
    above). Scores are f32 sums of the q·k products; P stays f32 and, for a
    bf16 cache, enters P·V as bf16 hi + lo (``P - hi`` rounded again: P to
    about 2^-17 relative), so both products run on bf16 operands with f32
    sums (``_f32_bmm``), as the multi-row K4 path does."""
    b, s, h, d = q.shape
    length, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qt = q.reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4).reshape(b * hkv, g * s, d)
    kt = k_cache.transpose(1, 2).reshape(b * hkv, length, d)
    vt = v_cache.transpose(1, 2).reshape(b * hkv, length, d)
    scores = (_f32_bmm(qt, kt.transpose(1, 2)) / (d ** 0.5)).view(b, hkv, g, s, length)
    ok = mask[None] if kv_valid is None else mask[None] & kv_valid[:, None]  # (B|1, s, L)
    scores.masked_fill_(torch.logical_not(ok)[:, None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    p.masked_fill_(torch.logical_not(ok.any(dim=-1))[:, None, None, :, None], 0.0)
    p = p.view(b * hkv, g * s, length)
    if vt.dtype == torch.bfloat16:
        hi = p.to(torch.bfloat16)
        num = _f32_bmm(hi, vt) + _f32_bmm((p - hi.to(torch.float32)).to(torch.bfloat16), vt)
    else:
        num = _f32_bmm(p, vt)
    return num.view(b, hkv, g, s, d).permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


# --- the GPT-style blocks (GPT-NeoX, CodeGen) ------------------------------------

def rotary_dims(head_dim: int, rotary_pct: float) -> int:
    """The leading channels of each head that take RoPE (JAX ``_rope``,
    ``attention.py:802-816``): ``int(head_dim * rotary_pct)`` made even; 0
    (``rotary_pct`` <= 0) disables RoPE."""
    if rotary_pct <= 0.0:
        return 0
    rot = int(head_dim * rotary_pct)
    return rot - rot % 2


class ParallelSelfAttention(nn.Module):
    """Multi-head self-attention, a kv-head a head (JAX
    ``ParallelSelfAttention``, ``attention.py:778-886``), tp = 1. RoPE, in
    JAX's half-split convention, on the first :func:`rotary_dims` channels
    of each head, from the
    ``freqs`` table the model builds for that width (GPT-NeoX's
    ``rotary_pct``; CodeGen's ``rotary_dim / head_dim``; 0 disables it).
    ``use_bias`` biases q/k/v and ``o_proj``. The modes and arguments are
    :class:`~neuronx_distributed_tpu_torch.models.llama.LlamaAttention`'s:
    train (K1, ``causal`` or not), prefill (K1, causal, the prompt's K/V
    written to the cache) and decode (the cache's ``write_attend``: K4 or
    K5); the model's ``mode_inputs`` supplies the positions. The cache
    modes need ``causal``."""

    def __init__(self, hidden_size: int, num_heads: int, causal: bool = False,
                 use_bias: bool = True, rotary_pct: float = 0.0,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 device=None, trainable: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d = hidden_size // num_heads
        self.rot = rotary_dims(d, rotary_pct)
        self.causal = causal
        w = dict(dtype=dtype, param_dtype=param_dtype, device=device, trainable=trainable)
        self.qkv = GQAQKVColumnParallelLinear(hidden_size, num_heads, num_heads, d,
                                              use_bias=use_bias, **w)
        self.o_proj = RowParallelLinear(num_heads * d, hidden_size, use_bias=use_bias, **w)

    def _rope(self, x: torch.Tensor, freqs, positions) -> torch.Tensor:
        r = self.rot
        if not r:
            return x
        return torch.cat([apply_rope(x[..., :r], freqs, positions), x[..., r:]], dim=-1)

    def forward(self, x, freqs, positions, mode: str, cache: Optional[KVCache], layer: int,
                q_pos=None, segment_ids=None, padding_mask=None, attn_mask=None):
        """``x`` (B, S, hidden); ``freqs`` (max_seq_len, rot / 2); the rest
        as ``LlamaAttention.forward``."""
        if mode != "train" and not self.causal:
            raise ValueError("KV-cache modes require causal attention")
        h, d = self.num_heads, self.head_dim
        q, k, v = self.qkv(x)
        b, s = q.shape[0], q.shape[1]
        q = self._rope(q.reshape(b, s, h, d), freqs, positions)
        k = self._rope(k.reshape(b, s, h, d), freqs, positions)
        v = v.reshape(b, s, h, d)
        if mode == "decode":
            out = cache.write_attend(layer, q, k, v, q_pos, attn_mask)
        else:
            if mode == "prefill":
                cache.prefill_write(layer, k, v)
            out = attention_op(q, k, v, causal=self.causal, mask=padding_mask,
                               segment_ids=segment_ids)
        return self.o_proj(out.reshape(b, s, h * d))


# JAX ``ParallelMLP``'s activations (``attention.py:907-912``)
ACTIVATIONS = {
    "gelu": F.gelu,  # exact erf
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


class ParallelMLP(nn.Module):
    """Up, the activation, down, each linear biased when ``use_bias`` (JAX
    ``ParallelMLP``, ``attention.py:889-922``): every step in the compute
    dtype, as JAX's."""

    def __init__(self, hidden_size: int, intermediate_size: int, activation: str = "gelu",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None, trainable: bool = False):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; one of {sorted(ACTIVATIONS)}")
        self.act = ACTIVATIONS[activation]
        w = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype, device=device,
                 trainable=trainable)
        self.up = ColumnParallelLinear(hidden_size, intermediate_size, **w)
        self.down = RowParallelLinear(intermediate_size, hidden_size, **w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.act(self.up(x)))
