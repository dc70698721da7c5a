"""RoPE, the attention dispatcher, the KV cache and decode attention
(counterpart of ``neuronx_distributed_tpu/modules/attention.py``, the subset
the serving path runs: cp = 1, no paging, no prefix store).

The JAX cache is a flax ``cache`` collection that each program returns
updated (the engine donates it so XLA updates it in place). Here the cache is
a :class:`KVCache` of explicit tensors that the model updates IN PLACE — the
PyTorch counterpart of donation — and its write cursor is a host ``int``
(the JAX engine mirrors the device cursor on the host anyway).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from neuronx_distributed_tpu_torch.kernels.flash_attention import flash_attention
from neuronx_distributed_tpu_torch.kernels.flash_decode import flash_decode_attention

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


def valid_count_below(kv_valid: torch.Tensor, cur: int) -> torch.Tensor:
    """Per-row count of valid cache slots strictly below write index ``cur``
    — each row's true sequence length."""
    return kv_valid[:, :cur].sum(dim=1, dtype=torch.int64)


class KVCache:
    """Explicit cache tensors, updated in place by the model.

    ``k``/``v`` (num_layers, B, L, Hkv, D); ``valid`` (B, L) bool —
    prefill records the padding mask, decode appends per-step validity;
    ``index`` the shared write cursor (host int). The JAX collection holds a
    ``kv_valid`` and an ``index`` per layer, always equal; here the model
    writes the one shared copy once per step, before its layers."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                 index: int = 0):
        self.k, self.v, self.valid, self.index = k, v, valid, index

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
        prefill writes a slot's prompt straight into its columns)."""
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
        at the write cursor, RoPE continues each row's true sequence."""
        cur = self.index
        if cur + s > self.max_seq_len:
            raise ValueError(f"decode step of {s} past the cache end ({cur} + {s} > {self.max_seq_len})")
        dev = self.valid.device
        pos = torch.arange(cur, cur + s, dtype=torch.int32, device=dev)
        steps = torch.arange(s, dtype=torch.int64, device=dev)
        rope_pos = valid_count_below(self.valid, cur)[:, None] + steps[None]
        return pos, rope_pos

    def decode_valid(self, padding_mask: Optional[torch.Tensor], s: int) -> None:
        """Validity (B, s) of the INCOMING tokens at the cursor; finished
        rows pass False so their filler K/V never becomes attendable."""
        b, cur = self.valid.shape[0], self.index
        if padding_mask is not None and tuple(padding_mask.shape) != (b, s):
            raise ValueError(
                f"decode padding_mask must cover the incoming step tokens "
                f"(shape {(b, s)}), got {tuple(padding_mask.shape)}"
            )
        self.valid[:, cur:cur + s] = (
            padding_mask.to(torch.bool) if padding_mask is not None else True
        )

    def decode_write(self, layer: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append one layer's decode K/V at the cursor (the model advances
        the cursor once, after its last layer)."""
        cur, s = self.index, k.shape[1]
        self.k[layer, :, cur:cur + s] = k
        self.v[layer, :, cur:cur + s] = v


# --- slot helpers (serving) ---------------------------------------------------

def reset_cache_slot(cache: KVCache, slot: int) -> None:
    """Free one batch row: clear its validity so nothing in it stays
    attendable. K/V storage stays; the next admission overwrites it."""
    cache.valid[slot] = False


def cache_cursor(cache: KVCache) -> int:
    """The shared write cursor."""
    return cache.index


def reset_cache(cache: KVCache) -> None:
    """Clear every slot's validity and rewind the cursor (drain/preempt)."""
    cache.valid.zero_()
    cache.index = 0


def decode_attention(q, k_cache, v_cache, q_pos, kv_valid=None) -> torch.Tensor:
    """Attention of q (B, s, H, D) rows at positions ``q_pos`` (s,) against
    the cache (B, L, Hkv, D), each row masked at its own position and by
    ``kv_valid`` (B, L). Always the flash-decode kernel's wrapper."""
    return flash_decode_attention(q, k_cache, v_cache, q_pos, kv_valid)
