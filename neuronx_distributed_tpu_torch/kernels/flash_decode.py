"""Flash decode: cached attention for serving (counterpart of
``neuronx_distributed_tpu/kernels/flash_decode.py``: the row layout, the
paged transport, the paged kernel and the quantized pages).

``flash_decode_fwd`` launches the hand-written CUDA kernel K4 of
``csrc/flash_decode.cu`` (it replaces the Pallas ``_decode_kernel``/
``_flash_decode_call``, ``flash_decode.py:233,285``) for CUDA tensors and
runs :func:`flash_decode_plain` for CPU tensors. On the card every decode
step launches it, at any cache length: the JAX package's 1024-column
threshold was a TPU trade against XLA's einsum. K4 splits the cache length
into ranges, one block each, and merges their partial results by LSE in a
second kernel: :func:`flash_decode_split_plain` and
:func:`merge_decode_partials` are that arithmetic in plain PyTorch, for the
tests. Above 32 rows per kv-head (R = group x s: a prefix-cache hit's suffix
prefill, s tokens at once) the same source runs its multi-row path: one
block per 64-row tile (whole tokens of every head of the group) walks its
rows' live length in 64-column tiles, both products on ``wgmma``, no split
and no merge; :func:`flash_decode_rows_plan` states its tile plan and
:func:`flash_decode_plain` is its plain version too.

``paged_flash_decode_fwd`` launches K5 of the same source (it replaces
``_paged_decode_kernel``/``paged_flash_decode_attention``,
``flash_decode.py:481,532``): K4's tile loop reading K/V straight from a page
pool through a block table, equal bit for bit to K4 on the gathered view.
For CPU tensors it runs :func:`paged_flash_decode_plain`, the gather
(:func:`paged_gather_leaf`) followed by :func:`flash_decode_plain`.

An int8 pool (``ServingEngine(quantize=QuantConfig(kv="int8"))``) holds int8
pages with a scale per (page, kv-head) in the compute dtype
(:func:`quantize_page_block`). ``paged_flash_decode_fwd(..., k_scale=,
v_scale=)`` attends it through K5q of the same source: K5's ranges and
merge (R <= 32), turning each int8 element into ``bf16(q * scale)`` where
the products read it. It computes JAX's gather-dequantize
(:func:`paged_gather_leaf_dequant`)
and K4, which the JAX engine runs for a quantized pool. Its plain version
is :func:`paged_flash_decode_plain_q`, and K5q through a table equals K4 on
the dequantized gathered view bit for bit. A decode step over such a pool
writes, then attends: :func:`qpaged_write_attend_fwd` launches K5q with the
write folded in (each range's block re-quantizes its share of the write
window, QW's function, before it attends), one launch a layer where QW and
K5q took two; its plain version is :func:`qpaged_write_attend_plain`.

K4 and K5 are built twice from their source: for head_dim 128 and for
head_dim 96 (GPT-NeoX-20B, ``_build.HEAD_DIMS``); a
wrapper loads the build of q's head dim and raises for any other. The 96
build's launches are counted apart, in the wrapper's ``d96``. K5q reads
128-column int8 pages and takes head_dim 128 alone.
"""

from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from neuronx_distributed_tpu_torch.observability.programs import metered

from neuronx_distributed_tpu_torch.kernels.dequantize import dequantize_plain
from neuronx_distributed_tpu_torch.kernels._build import head_dim_counter

NEG_INF = -1e30


def flash_decode_plain(q, k_cache, v_cache, q_pos, kv_valid=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch (f32), mirroring the einsum
    path of ``decode_attention`` (``attention.py:762-775`` via
    ``ring_attention._block_attn``): ``(out (B, s, H, D) in q.dtype, lse
    (B, Hkv, R) f32)`` with rows folded as ``r = g * s + t``."""
    b, s, h, d = q.shape
    hkv, L = k_cache.shape[2], k_cache.shape[1]
    g = h // hkv
    qt = q.to(torch.float32).transpose(1, 2).reshape(b, hkv, g, s, d)
    kt = k_cache.to(torch.float32).transpose(1, 2)
    vt = v_cache.to(torch.float32).transpose(1, 2)
    q_pos = q_pos.reshape(-1)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qt, kt) * (1.0 / math.sqrt(d))
    k_pos = torch.arange(L, device=q.device)
    live = (q_pos[:, None] >= k_pos[None, :])[None, None, None]
    if kv_valid is not None:
        live = live & kv_valid.to(torch.bool)[:, None, None, None, :]
    scores = torch.where(live, scores, NEG_INF)
    m = scores.amax(-1)
    safe_m = torch.where(m > NEG_INF / 2, m, 0.0)
    p = torch.where(scores > NEG_INF / 2, torch.exp(scores - safe_m[..., None]), 0.0)
    l = p.sum(-1)
    num = torch.einsum("bhgqk,bhkd->bhgqd", p, vt)
    out = num / l.clamp_min(1e-20)[..., None]
    lse = torch.where(l > 0, safe_m + torch.log(l.clamp_min(1e-30)), NEG_INF)
    out = out.reshape(b, h, s, d).transpose(1, 2).to(q.dtype)
    return out, lse.reshape(b, hkv, g * s)


def merge_decode_partials(outs, lses) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge decode results over disjoint column ranges by their LSE: the
    JAX length split's rule (``per_rank``, ``flash_decode.py:442-453``).
    ``outs`` are (B, s, H, D) outputs and ``lses`` (B, Hkv, R) f32, one of
    each per range, in range order: ``m = max lse``, ``w = exp(lse - m)``
    (0 where ``lse <= NEG_INF / 2``), ``out = sum w o / max(sum w, 1e-30)``
    and ``lse = m + log(sum w)``, -1e30 where no range was live. Returns
    ``(out in outs[0].dtype, lse f32)``. The kernels' merge (K4, K5) is this
    rule in f32; the port calls it only in tests."""
    b, s, h, d = outs[0].shape
    hkv, r = lses[0].shape[1:]
    lse = torch.stack([x.to(torch.float32) for x in lses])       # (n, B, Hkv, R)
    m = lse.amax(0)
    safe = torch.where(m > NEG_INF / 2, m, 0.0)
    w = torch.where(lse > NEG_INF / 2, torch.exp(lse - safe), 0.0)
    den = w.sum(0)
    # (n, B, Hkv, G, s) -> (n, B, s, H): row r = g * s + t is q-head hk * G + g, token t
    wq = w.reshape(-1, b, hkv, r // s, s).permute(0, 1, 4, 2, 3).reshape(-1, b, s, h, 1)
    num = (torch.stack([o.to(torch.float32) for o in outs]) * wq).sum(0)
    denq = den.reshape(b, hkv, r // s, s).permute(0, 3, 1, 2).reshape(b, s, h, 1)
    out = num / denq.clamp_min(1e-30)
    lse_out = torch.where(den > 0, safe + torch.log(den.clamp_min(1e-30)), NEG_INF)
    return out.to(outs[0].dtype), lse_out


def flash_decode_split_plain(q, k_cache, v_cache, q_pos, kv_valid=None, split_cols: int = 256
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' split-length arithmetic in plain PyTorch: K4's function
    computed as :func:`flash_decode_plain` (f32) over each range of
    ``split_cols`` cache columns, merged by :func:`merge_decode_partials`.
    Equal to :func:`flash_decode_plain` up to f32 rounding; the port calls
    it only in tests."""
    L = k_cache.shape[1]
    q_pos = q_pos.reshape(-1)
    outs, lses = [], []
    for c0 in range(0, L, split_cols):
        c1 = min(c0 + split_cols, L)
        o, lse = flash_decode_plain(
            q.to(torch.float32), k_cache[:, c0:c1], v_cache[:, c0:c1], q_pos - c0,
            None if kv_valid is None else kv_valid[:, c0:c1])
        outs.append(o)
        lses.append(lse)
    out, lse = merge_decode_partials(outs, lses)
    return out.to(q.dtype), lse


@functools.lru_cache(maxsize=None)
def _decode_lib(d: int = 128) -> SimpleNamespace:
    """``csrc/flash_decode.cu``'s build for head dim ``d`` (128, or 96:
    ``_build.HEAD_DIMS``; ValueError for any other)
    loaded once: its entry points with their argument types, and the
    constants the wrappers check and size with."""
    from neuronx_distributed_tpu_torch.kernels import _build

    lib = _build.load(_build.head_dim_lib("flash_decode", d))
    i, ll, vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    k4, k5 = lib.nxd_flash_decode_fwd, lib.nxd_paged_flash_decode_fwd
    k5q, k5qw = lib.nxd_qpaged_flash_decode_fwd, lib.nxd_qpaged_write_attend_fwd
    k4.restype = k5.restype = k5q.restype = k5qw.restype = i
    k4.argtypes = [vp] * 9 + [i] * 5 + [ll] * 13 + [ctypes.c_float, vp]
    k5.argtypes = [vp] * 10 + [i] * 7 + [ll] * 14 + [ctypes.c_float, vp]
    k5q.argtypes = [vp] * 12 + [i] * 7 + [ll] * 18 + [ctypes.c_float, vp]
    k5qw.argtypes = [vp] * 15 + [i] * 7 + [ll] * 24 + [ctypes.c_float, vp]
    return SimpleNamespace(k4=k4, k5=k5, k5q=k5q, k5qw=k5qw,
                           head_dim=lib.nxd_flash_decode_head_dim(),
                           max_rows=lib.nxd_flash_decode_max_rows(),
                           split_cols=lib.nxd_flash_decode_split_cols(),
                           row_tile=lib.nxd_flash_decode_row_tile(),
                           row_tile_cols=lib.nxd_flash_decode_row_tile_cols())


def _checked(what, q, k, v, q_pos, kv_valid, L, kv_dtype=torch.bfloat16):
    """The argument checks K4, K5 and K5q share: bf16 q and ``kv_dtype``
    k/v (int8 for K5q) on q's device with unit-stride, 16-byte aligned
    head dims, head_dim 128 or 96, a group of at most 32 q-heads per kv-head (the
    split path's 32 rows hold every head of a group at s = 1), one position
    per query token, a row-contiguous (B, L) validity mask. Returns
    (library, rows per kv-head, q_pos int32, kv_valid bool)."""
    b, s, h, d = q.shape
    for name, t, dt in (("q", q, torch.bfloat16), ("k", k, kv_dtype), ("v", v, kv_dtype)):
        if t.dtype != dt or t.device != q.device:
            raise TypeError(f"{what} takes {dt} {name} on q's device, got {t.dtype} on {t.device}")
        if (t.stride(-1) != 1 or any(st * t.element_size() % 16 for st in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must have a unit-stride, 16-byte aligned head dim")
    lib = _decode_lib(d)
    if d != lib.head_dim:
        raise RuntimeError(f"flash_decode library for head_dim {d} reports {lib.head_dim}")
    g = h // k.shape[2]
    if g > lib.max_rows:
        raise ValueError(f"{what} takes at most {lib.max_rows} q-heads per kv-head, got {g}")
    q_pos = q_pos.reshape(-1).to(torch.int32).contiguous()
    if q_pos.device != q.device or q_pos.numel() != s:
        raise ValueError("q_pos must hold one position per query token, on q's device")
    if kv_valid is not None:
        if kv_valid.shape != (b, L) or kv_valid.stride(1) != 1:
            raise ValueError(f"kv_valid must be a row-contiguous ({b}, {L}) mask")
        kv_valid = kv_valid.to(torch.bool)
    return lib, g * s, q_pos, kv_valid


def _workspace(lib, b, hkv, r, L, device):
    """The kernels' per-range partials in one f32 allocation: O (n, B, Hkv,
    R, D), then LSE (n, B, Hkv, R), one range per ``split_cols`` columns of
    L (the host knows L, never the live bound), then the (B, Hkv, R) LSE the
    call returns. Uninitialised: the ranges write every entry the merge
    reads. The multi-row path (R > ``max_rows``) keeps no partials: the
    allocation is that LSE alone. Returns that LSE (a view, which keeps the
    allocation alive) and the pointers to the partial O and LSE."""
    n = -(-L // lib.split_cols) * b * hkv * r if r <= lib.max_rows else 0
    work = torch.empty(n * (lib.head_dim + 1) + b * hkv * r, dtype=torch.float32,
                       device=device)
    lse = work[n * (lib.head_dim + 1):].view(b, hkv, r)
    return lse, work.data_ptr(), work.data_ptr() + 4 * n * lib.head_dim


def _kernel_call(q, k_cache, v_cache, q_pos, kv_valid):
    from neuronx_distributed_tpu_torch.kernels import _build

    b, s, h, d = q.shape
    L, hkv = k_cache.shape[1], k_cache.shape[2]
    lib, r, q_pos, kv_valid = _checked("flash decode kernel", q, k_cache, v_cache, q_pos,
                                       kv_valid, L)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse, work_o, work_lse = _workspace(lib, b, hkv, r, L, q.device)
    err = lib.k4(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lse.data_ptr(), q_pos.data_ptr(),
        kv_valid.data_ptr() if kv_valid is not None else None, work_o, work_lse,
        b, s, h, hkv, L,
        *q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *out.stride()[:3], kv_valid.stride(0) if kv_valid is not None else 0,
        1.0 / math.sqrt(d), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_decode_fwd")
    return out, lse


def _decode_cost(b: int, s: int, h: int, d: int, cols: int, hkv: int, kv_esize: int,
                 q_esize: int, extra: int = 0):
    """K4/K5/K5q's count for the program ledger (``chip_smoke.py
    decode_bound``, on shapes: every column the call is handed counts, as a
    static cost analysis counts a program's shapes, not its data): 4 D
    FLOPs a (row, column) pair a q-head; q, K and V, the validity, out and
    the f32 LSE once each, plus ``extra`` (tables, scales)."""
    return (4.0 * b * s * h * cols * d,
            2 * q_esize * b * s * h * d + 2 * kv_esize * b * cols * hkv * d + b * cols
            + 4 * b * s * h + extra)


def _k4_cost(q, k_cache, v_cache, q_pos, kv_valid=None):
    b, s, h, d = q.shape
    return _decode_cost(b, s, h, d, k_cache.shape[1], k_cache.shape[2], k_cache.element_size(),
                        q.element_size())


@metered("flash_decode", _k4_cost)
def flash_decode_fwd(q, k_cache, v_cache, q_pos, kv_valid=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of cached decode attention: q (B, s, H, D) rows at
    cache positions ``q_pos`` (s,) against the cache (B, L, Hkv, D); each row
    attends slots ``<=`` its position, minus slots where ``kv_valid`` (B, L)
    is False. CUDA tensors launch the kernel (bf16, head_dim 128 or 96) or raise;
    CPU tensors run the plain version. ``launches`` counts the calls that
    launched K4 (its range grid and its merge, or its multi-row kernel: one
    launch each call), ``multi_row_launches`` those of them that took the
    multi-row path (more than 32 rows per kv-head), both for the head_dim-128
    build; ``d96`` holds the 96 build's."""
    if q.shape[2] % k_cache.shape[2] != 0:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k_cache.shape[2]}")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, q_pos, kv_valid)
    out = _kernel_call(q, k_cache, v_cache, q_pos, kv_valid)
    counter = head_dim_counter(flash_decode_fwd, q.shape[-1])
    counter.launches += 1
    counter.multi_row_launches += _multi_row(q, k_cache)
    return out


flash_decode_fwd.launches = flash_decode_fwd.multi_row_launches = 0
flash_decode_fwd.d96 = SimpleNamespace(launches=0, multi_row_launches=0)


def _multi_row(q, cache) -> bool:
    """Whether a call with these shapes takes the kernels' multi-row path."""
    return q.shape[1] * (q.shape[2] // cache.shape[2]) > _decode_lib(q.shape[-1]).max_rows


ROWS_TILE = 64       # rows a block of the multi-row path: T = 64 // group whole tokens
ROWS_TILE_COLS = 64  # cache columns a tile of the multi-row path


def flash_decode_rows_plan(q_pos, kv_valid, L: int, group: int, b: int = 1, hkv: int = 1
                           ) -> dict:
    """The multi-row path's plan (R = group x s > 32), as
    ``csrc/flash_decode.cu`` ``decode_rows`` makes it, in plain PyTorch.

    A block takes one row tile of ``T = ROWS_TILE // group`` tokens of every
    head of a group (local row ``g * T + j`` is token ``t0 + j`` of q-head
    ``hk * group + g``) of one (kv-head, slot). The blocks run in ``order``
    (row tile, kv-head, slot), the latest row tiles first; the grid and the
    order come from the shapes alone. There is no length split. A tile's
    bound is its largest position + 1 (capped at L); column tile ``j``
    (``ROWS_TILE_COLS`` columns) is visited when it holds a column below the
    bound that ``kv_valid`` (B, L) marks live, and masked when one of its
    columns is dead (invalid, at or past the bound or past L) or lies past
    the tile's smallest position. Returns ``tokens`` (T), ``order`` (n, 3)
    int64, ``bound`` (B, n_rt), ``visited`` and ``masked`` (B, n_rt, n_ct)
    bool with ``n_ct = ceil(L / ROWS_TILE_COLS)``."""
    q_pos = torch.as_tensor(q_pos).reshape(-1).long()
    s = q_pos.numel()
    tokens = ROWS_TILE // group
    n_rt, n_ct = -(-s // tokens), -(-L // ROWS_TILE_COLS)
    x = torch.arange(n_rt * hkv * b)
    order = torch.stack([n_rt - 1 - x // (hkv * b), x % (hkv * b) // b, x % b], 1)
    real = (torch.arange(n_rt * tokens) < s).reshape(n_rt, tokens)   # past s: no token
    tile_pos = torch.nn.functional.pad(q_pos, (0, n_rt * tokens - s)).reshape(n_rt, tokens)
    bound = torch.where(real, tile_pos, -1).amax(1).add(1).clamp(max=L)   # (n_rt,)
    pmin = torch.where(real, tile_pos, torch.iinfo(torch.long).max).amin(1)
    cols = torch.arange(n_ct * ROWS_TILE_COLS)
    valid = (torch.ones(b, L, dtype=torch.bool) if kv_valid is None
             else torch.as_tensor(kv_valid).to(torch.bool).cpu())
    valid = torch.nn.functional.pad(valid, (0, n_ct * ROWS_TILE_COLS - L))
    live = valid[:, None, :] & (cols[None, None, :] < bound[None, :, None])  # (B, n_rt, cols)
    live = live.reshape(b, n_rt, n_ct, ROWS_TILE_COLS)
    last = torch.arange(n_ct) * ROWS_TILE_COLS + ROWS_TILE_COLS - 1
    masked = ~live.all(-1) | (last[None, None, :] > pmin[None, :, None])
    return dict(tokens=tokens, order=order, bound=bound.expand(b, n_rt),
                visited=live.any(-1), masked=masked)


def flash_decode_attention(q, k_cache, v_cache, q_pos: torch.Tensor,
                           kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cached decode attention output (B, s, H, D) — the JAX public API."""
    return flash_decode_fwd(q, k_cache, v_cache, q_pos, kv_valid)[0]


# --- paged KV: the block-table transport and K5 --------------------------------
#
# A paged cache stores K/V as a POOL of fixed-size pages (..., P, page_size,
# Hkv, D) plus a per-slot block table (B, n_log) int32 mapping logical page j
# of slot b to a physical pool page; page 0 is the reserved null page that
# every unmapped entry points at, whose columns ``kv_valid`` must mask.


def paged_gather_leaf(pool: torch.Tensor, block_table: torch.Tensor,
                      page_size: int) -> torch.Tensor:
    """The logical cache view (..., B, n_log * page_size, Hkv, D) of one pool
    leaf (..., P, page_size, Hkv, D): slot b's logical columns
    ``[j * page_size, (j + 1) * page_size)`` read physical page
    ``block_table[b, j]`` (JAX ``paged_gather_leaf``, ``flash_decode.py:74``).
    A copy: the ``"gather"`` attention route and the plain version read it."""
    pax = pool.dim() - 4
    b, n_log = block_table.shape
    out = pool.index_select(pax, block_table.reshape(-1).to(torch.long))
    return out.reshape(*pool.shape[:pax], b, n_log * page_size, *pool.shape[pax + 2:])


def paged_flash_decode_plain(q, k_pool, v_pool, block_table, q_pos, kv_valid=None,
                             page_size: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's arithmetic in plain PyTorch: gather the logical view through the
    block table, then :func:`flash_decode_plain`."""
    k = paged_gather_leaf(k_pool, block_table, page_size)
    v = paged_gather_leaf(v_pool, block_table, page_size)
    return flash_decode_plain(q, k, v, q_pos, kv_valid)


def _paged_kernel_call(q, k_pool, v_pool, block_table, q_pos, kv_valid, page_size):
    from neuronx_distributed_tpu_torch.kernels import _build

    b, s, h, d = q.shape
    hkv = k_pool.shape[2]
    n_log = block_table.shape[1]
    if page_size < 1 or 128 % page_size:
        raise ValueError(f"paged flash decode kernel takes a page_size dividing 128, got {page_size}")
    if (block_table.dtype != torch.int32 or block_table.device != q.device
            or block_table.shape[0] != b or block_table.stride(1) != 1):
        raise ValueError(f"block_table must be a row-contiguous ({b}, n_log) int32 tensor on q's device")
    lib, r, q_pos, kv_valid = _checked("paged flash decode kernel", q, k_pool, v_pool, q_pos,
                                       kv_valid, n_log * page_size)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse, work_o, work_lse = _workspace(lib, b, hkv, r, n_log * page_size, q.device)
    err = lib.k5(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        lse.data_ptr(), q_pos.data_ptr(),
        kv_valid.data_ptr() if kv_valid is not None else None, block_table.data_ptr(),
        work_o, work_lse,
        b, s, h, hkv, n_log, page_size.bit_length() - 1, k_pool.shape[0],
        *q.stride()[:3], *k_pool.stride()[:3], *v_pool.stride()[:3],
        *out.stride()[:3], kv_valid.stride(0) if kv_valid is not None else 0,
        block_table.stride(0), 1.0 / math.sqrt(d), _build.stream_ptr(q.device),
    )
    _build.check(err, "paged_flash_decode_fwd")
    return out, lse


def _k5_cost(q, k_pool, v_pool, block_table, q_pos, kv_valid=None, page_size: int = 16,
             k_scale=None, v_scale=None):
    b, s, h, d = q.shape
    scales = 0 if k_scale is None else 2 * b * block_table.shape[1] * k_scale[0].numel() * 2
    return _decode_cost(b, s, h, d, block_table.shape[1] * page_size, k_pool.shape[2],
                        k_pool.element_size(), q.element_size(),
                        extra=block_table.numel() * block_table.element_size() + scales)


@metered("paged_flash_decode", _k5_cost)
def paged_flash_decode_fwd(q, k_pool, v_pool, block_table, q_pos, kv_valid=None,
                           page_size: int = 16, k_scale=None, v_scale=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of paged cached decode attention: q (B, s, H, D) rows
    at logical positions ``q_pos`` (s,) attend each slot's cache read
    straight from the single-layer pools ``k_pool``/``v_pool`` (P,
    page_size, Hkv, D) through ``block_table`` (B, n_log) int32, masked by
    ``kv_valid`` (B, n_log * page_size). Table entries must be pool page ids
    (the page manager hands out nothing else); page 0's columns must be
    masked. CUDA tensors launch K5 (bf16, head_dim 128 or 96, page_size dividing
    128) or raise; CPU tensors run the plain version. ``launches`` counts
    the calls that launched K5 (its range grid and its merge, or its
    multi-row kernel: one launch each call), ``multi_row_launches`` those
    of them that took the multi-row path, both for the head_dim-128 build
    (``d96`` holds the 96 build's). With ``k_scale``/``v_scale`` (P,
    1, Hkv, 1) the pools are int8 and the call goes to
    :func:`qpaged_flash_decode_fwd` (K5q), which counts its own launches."""
    if q.shape[2] % k_pool.shape[2] != 0:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k_pool.shape[2]}")
    if k_pool.dim() != 4 or k_pool.shape[1] != page_size or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools must be (P, {page_size}, Hkv, D) and alike, got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    if k_scale is not None or v_scale is not None:
        return qpaged_flash_decode_fwd(q, k_pool, v_pool, k_scale, v_scale, block_table, q_pos,
                                       kv_valid, page_size)
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pool, v_pool, block_table, q_pos, kv_valid,
                                        page_size)
    out = _paged_kernel_call(q, k_pool, v_pool, block_table, q_pos, kv_valid, page_size)
    counter = head_dim_counter(paged_flash_decode_fwd, q.shape[-1])
    counter.launches += 1
    counter.multi_row_launches += _multi_row(q, k_pool)
    return out


paged_flash_decode_fwd.launches = paged_flash_decode_fwd.multi_row_launches = 0
paged_flash_decode_fwd.d96 = SimpleNamespace(launches=0, multi_row_launches=0)


def paged_flash_decode_attention(q, k_pool, v_pool, block_table, q_pos: torch.Tensor,
                                 kv_valid: Optional[torch.Tensor] = None,
                                 page_size: int = 16, k_scale=None, v_scale=None
                                 ) -> torch.Tensor:
    """Paged cached decode attention output (B, s, H, D) — the JAX public
    API (``paged_flash_decode_attention``, ``flash_decode.py:532``); with
    ``k_scale``/``v_scale``, over an int8 pool (K5q)."""
    return paged_flash_decode_fwd(q, k_pool, v_pool, block_table, q_pos, kv_valid,
                                  page_size, k_scale, v_scale)[0]


# --- quantized KV pages: the helpers and K5q ---------------------------------
#
# An int8 pool leaf (..., P, page_size, Hkv, D) has a scale leaf (..., P, 1,
# Hkv, 1) in the compute dtype beside it (JAX ``paging.py:723-760``): a
# page's kv-head h holds ``bf16(q * scale)``.

KV_QMAX = 127.0  # int8 symmetric clamp bound


def quantize_page_block(pages: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float page blocks (..., n, page_size, Hkv, D) as int8 with a
    symmetric scale per (page, kv-head), (..., n, 1, Hkv, 1) in the
    blocks' dtype (JAX ``quantize_page_block``, ``flash_decode.py:187``).
    The scale is computed in f32 and CAST to the blocks' dtype before the
    pages are quantized, so a dequantize-requantize round trip with an
    unchanged absmax gives the same codes. Both divisions are correctly
    rounded on every device: the bound is a tensor, since PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal instead."""
    pf = pages.to(torch.float32)
    amax = pf.abs().amax(dim=(-3, -1), keepdim=True)
    qmax = torch.full((), KV_QMAX, dtype=torch.float32, device=pf.device)
    scale = (amax.clamp_min(1e-12) / qmax).to(pages.dtype)
    q = torch.round(pf / scale.to(torch.float32)).clamp(-KV_QMAX, KV_QMAX).to(torch.int8)
    return q, scale


def paged_read_pages_leaf(pool: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """``n`` physical pages of one pool leaf as one contiguous block (...,
    n * page_size, Hkv, D) (JAX ``paged_read_pages_leaf``,
    ``flash_decode.py:160``). A copy."""
    pax = pool.dim() - 4
    out = pool.index_select(pax, page_ids.reshape(-1).to(torch.long))
    return out.reshape(*pool.shape[:pax], -1, *pool.shape[pax + 2:])


def paged_gather_leaf_dequant(pool_q: torch.Tensor, pool_scale: torch.Tensor,
                              block_table: torch.Tensor, page_size: int) -> torch.Tensor:
    """The DEQUANTIZED logical view (..., B, n_log * page_size, Hkv, D) of
    an int8 pool leaf, in the scale leaf's dtype (JAX
    ``paged_gather_leaf_dequant``, ``flash_decode.py:201``)."""
    col = pool_q.dim() - 4 + 1
    q = paged_gather_leaf(pool_q, block_table, page_size)
    s = paged_gather_leaf(pool_scale, block_table, 1).repeat_interleave(page_size, dim=col)
    return dequantize_plain(q, s, s.dtype)


def paged_read_pages_leaf_dequant(pool_q: torch.Tensor, pool_scale: torch.Tensor,
                                  page_ids: torch.Tensor, page_size: int) -> torch.Tensor:
    """``n`` physical pages of an int8 pool leaf as one contiguous
    DEQUANTIZED block (..., n * page_size, Hkv, D) in the scale leaf's
    dtype (JAX ``paged_read_pages_leaf_dequant``, ``flash_decode.py:218``):
    a copy-on-write prefix hit's view of its shared pages."""
    pax = pool_q.dim() - 4
    q = paged_read_pages_leaf(pool_q, page_ids)
    s = paged_read_pages_leaf(pool_scale, page_ids).repeat_interleave(page_size, dim=pax)
    return dequantize_plain(q, s, s.dtype)


def paged_flash_decode_plain_q(q, k_pool, v_pool, k_scale, v_scale, block_table, q_pos,
                               kv_valid=None, page_size: int = 16
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5q's arithmetic in plain PyTorch: the dequantized logical view
    (:func:`paged_gather_leaf_dequant`), then :func:`flash_decode_plain`."""
    k = paged_gather_leaf_dequant(k_pool, k_scale, block_table, page_size)
    v = paged_gather_leaf_dequant(v_pool, v_scale, block_table, page_size)
    return flash_decode_plain(q, k, v, q_pos, kv_valid)


def _qpaged_kernel_call(q, k_pool, v_pool, k_scale, v_scale, block_table, q_pos, kv_valid,
                        page_size, write=None):
    """K5q's launch; with ``write`` = (k_new, v_new, w0), K5q with the write
    (``csrc/flash_decode.cu nxd_qpaged_write_attend_fwd``)."""
    from neuronx_distributed_tpu_torch.kernels import _build

    b, s, h, d = q.shape
    hkv, n_log = k_pool.shape[2], block_table.shape[1]
    if d != 128:
        raise ValueError(f"K5q is built for head_dim 128, got {d}")
    if page_size < 1 or 128 % page_size:
        raise ValueError(f"K5q takes a page_size dividing 128, got {page_size}")
    if (block_table.dtype != torch.int32 or block_table.device != q.device
            or block_table.shape[0] != b or block_table.stride(1) != 1):
        raise ValueError(f"block_table must be a row-contiguous ({b}, n_log) int32 tensor on q's device")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (t is None or t.dtype != torch.bfloat16 or t.device != q.device
                or tuple(t.shape) != (k_pool.shape[0], 1, hkv, 1)):
            raise ValueError(f"{name} must be a bf16 ({k_pool.shape[0]}, 1, {hkv}, 1) tensor on "
                             "q's device")
    L = n_log * page_size
    lib, r, q_pos, kv_valid = _checked("K5q", q, k_pool, v_pool, q_pos, kv_valid, L,
                                       kv_dtype=torch.int8)
    if r > lib.max_rows:
        raise ValueError(f"K5q takes at most {lib.max_rows} rows per kv-head (group x s), got {r}")
    rows, row_strides = (), ()
    if write is not None:
        k_new, v_new, w0 = write
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if t.dtype != torch.bfloat16 or t.device != q.device or tuple(t.shape) != (b, s, hkv, d):
                raise TypeError(f"K5q with the write takes {name} as bf16 {(b, s, hkv, d)} on q's "
                                f"device, got {t.dtype} {tuple(t.shape)} on {t.device}")
            if (t.stride(-1) != 1 or t.data_ptr() % 16
                    or any(st * t.element_size() % 16 for st in t.stride()[:-1])):
                raise ValueError(f"{name} must have a unit-stride, 16-byte aligned head dim")
        if w0.dtype != torch.int64 or w0.device != q.device or w0.numel() != 1:
            raise ValueError("w0 must be one int64 on q's device")
        rows = (k_new.data_ptr(), v_new.data_ptr(), w0.data_ptr())
        row_strides = (*k_new.stride()[:3], *v_new.stride()[:3])
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse, work_o, work_lse = _workspace(lib, b, hkv, r, L, q.device)
    err = (lib.k5qw if write is not None else lib.k5q)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), lse.data_ptr(), q_pos.data_ptr(),
        kv_valid.data_ptr() if kv_valid is not None else None, block_table.data_ptr(),
        work_o, work_lse, *rows,
        b, s, h, hkv, n_log, page_size.bit_length() - 1, k_pool.shape[0],
        *q.stride()[:3], *k_pool.stride()[:3], *v_pool.stride()[:3],
        k_scale.stride(0), k_scale.stride(2), v_scale.stride(0), v_scale.stride(2),
        *out.stride()[:3], kv_valid.stride(0) if kv_valid is not None else 0,
        block_table.stride(0), *row_strides, 1.0 / math.sqrt(d), _build.stream_ptr(q.device),
    )
    _build.check(err, "qpaged_write_attend_fwd" if write is not None else "qpaged_flash_decode_fwd")
    return out, lse


def _k5q_cost(q, k_pool, v_pool, k_scale, v_scale, block_table, q_pos, kv_valid=None,
              page_size: int = 16):
    return _k5_cost(q, k_pool, v_pool, block_table, q_pos, kv_valid, page_size, k_scale, v_scale)


@metered("qpaged_flash_decode", _k5q_cost)
def qpaged_flash_decode_fwd(q, k_pool, v_pool, k_scale, v_scale, block_table, q_pos,
                            kv_valid=None, page_size: int = 16
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of paged decode attention over int8 pools ``k_pool``/
    ``v_pool`` (P, page_size, Hkv, D) with their scales (P, 1, Hkv, 1) in
    the compute dtype; otherwise as :func:`paged_flash_decode_fwd`. CUDA
    tensors launch K5q (bf16 q and scales, head_dim 128, at most 32 rows
    per kv-head) or raise; CPU tensors run :func:`paged_flash_decode_plain_q`.
    ``launches`` counts the calls that launched K5q's range grid and its
    merge: this wrapper's and :func:`qpaged_write_attend_fwd`'s, whose range
    kernel is K5q's with the write in front."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain_q(q, k_pool, v_pool, k_scale, v_scale, block_table,
                                          q_pos, kv_valid, page_size)
    out = _qpaged_kernel_call(q, k_pool, v_pool, k_scale, v_scale, block_table, q_pos,
                              kv_valid, page_size)
    qpaged_flash_decode_fwd.launches += 1
    return out


qpaged_flash_decode_fwd.launches = 0


# --- the int8 pool's decode step: the write folded into K5q --------------------


def qpaged_write_attend_plain(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, block_table,
                              q_pos, kv_valid, w0, page_size: int = 16
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5q with the write in plain PyTorch: the write window of the new rows
    (``kernels/kv_quant.py write_window`` from the table and ``w0``, the
    logical column of their first token) re-quantized in place
    (``window_requantize_plain``), then :func:`paged_flash_decode_plain_q`
    over the pools as they now stand."""
    from neuronx_distributed_tpu_torch.kernels.kv_quant import write_window, window_requantize_plain

    pages, first = write_window(block_table, w0, k_new.shape[1], page_size)
    window_requantize_plain(k_pool, v_pool, k_scale, v_scale, pages, first, k_new, v_new)
    return paged_flash_decode_plain_q(q, k_pool, v_pool, k_scale, v_scale, block_table, q_pos,
                                      kv_valid, page_size)


def _qwa_cost(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, block_table, q_pos, kv_valid,
              w0, page_size: int = 16):
    """K5q's count plus QW's for its window, each once (the formulas of
    :func:`_k5q_cost` and ``kv_quant._qw_cost``)."""
    from neuronx_distributed_tpu_torch.kernels.kv_quant import qw_bytes, window_pages

    flops, nbytes = _k5q_cost(q, k_pool, v_pool, k_scale, v_scale, block_table, q_pos, kv_valid,
                              page_size)
    n_win = window_pages(k_new.shape[1], page_size)
    return flops, nbytes + qw_bytes(k_pool, k_scale, k_new, v_new, q.shape[0] * n_win)


@metered("qpaged_write_attend", _qwa_cost)
def qpaged_write_attend_fwd(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, block_table,
                            q_pos, kv_valid, w0, page_size: int = 16
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decode step over int8 pools: the new rows ``k_new``/``v_new`` (B,
    s, Hkv, D) written at logical columns ``w0 + t`` of every slot (``w0``
    one int64 tensor: the write cursor), every page of the write window
    re-quantized as :func:`~neuronx_distributed_tpu_torch.kernels.kv_quant.
    window_requantize_fwd` does (in place), then ``(out, lse)`` of
    :func:`qpaged_flash_decode_fwd` over the pools as they now stand. CUDA
    tensors launch K5q with the write (one range grid that writes, then
    attends, and K5q's merge: QW then K5q bit for bit on every page but the
    null page, which this route does not write; at most 32 rows per
    kv-head) or raise; CPU tensors run :func:`qpaged_write_attend_plain`.
    ``launches`` counts the calls that launched it; each also counts in
    :func:`qpaged_flash_decode_fwd`'s ``launches``."""
    if q.device.type == "cpu":
        return qpaged_write_attend_plain(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                                         block_table, q_pos, kv_valid, w0, page_size)
    out = _qpaged_kernel_call(q, k_pool, v_pool, k_scale, v_scale, block_table, q_pos, kv_valid,
                              page_size, write=(k_new, v_new, w0))
    qpaged_write_attend_fwd.launches += 1
    qpaged_flash_decode_fwd.launches += 1
    return out


qpaged_write_attend_fwd.launches = 0
