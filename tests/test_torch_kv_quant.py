"""The int8 page pool's write (CPU): ``kernels/kv_quant.py``, QW's plain
version, against the JAX package's ``scatter_cache_window``
(``neuronx_distributed_tpu/modules/attention.py:544``) on a quantized pool,
bit for bit on every page but the null page 0, which rows whose window
runs past their table share and write in any order.

The port writes through ``PagedKVCache`` (``view``, ``_address``,
``decode_write``): its window is one page for one column, else
``(s - 1) // page_size + 2`` pages from the first column's page, pages past
the table's end going to the null page. JAX's window is two pages or more,
clamped to the table's end; a page in JAX's window that the write does not
reach is dequantized and quantized again, which gives back its bits (the
scale is cast to the pool's dtype before the codes are taken), so both
write the same pages."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd
from neuronx_distributed_tpu_torch.kernels import kv_quant as tkq
from neuronx_distributed_tpu_torch.modules.attention import KVCache, PagedKVCache

torch.set_num_threads(1)

jattn = importlib.import_module("neuronx_distributed_tpu.modules.attention")
jfd = importlib.import_module("neuronx_distributed_tpu.kernels.flash_decode")

B, HKV, D, PS, N_LOG, N_PAGES = 3, 2, 8, 16, 24, 80
_NP = {torch.float32: np.float32, torch.bfloat16: jnp.bfloat16}


def _pool_cache(rng, dtype, col, s, magnitude):
    """An int8 pool of random pages behind a table of random pages (row 2
    maps only its first 20 logical pages: its window past them lands in
    the null page); with ``magnitude="fall"`` the rows at window columns
    ``[col, col + s)`` hold 50x values, so their page's absmax falls when
    the write replaces them."""
    cache = PagedKVCache.allocate(1, B, N_LOG * PS, HKV, D, dtype, "cpu", N_PAGES, PS,
                                  kv_quant="int8")
    table = rng.permutation(np.arange(1, N_PAGES))[:B * N_LOG].reshape(B, N_LOG).astype(np.int32)
    table[2, 20:] = 0
    for pool, scale in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
        rows = rng.normal(size=(N_PAGES, PS, HKV, D)).astype(np.float32)
        if magnitude == "fall":
            for b in range(B):
                for c in range(col, col + s):
                    rows[table[b, c // PS], c % PS] *= 50.0
        q, sc = tfd.quantize_page_block(torch.from_numpy(rows).to(dtype))
        pool[0].copy_(q)
        scale[0].copy_(sc)
    cache.upload_table(table)
    return cache, table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,col,magnitude", [
    (1, 37, "same"),      # a decode step mid-page
    (1, 48, "rise"),      # the first column of a page; its absmax rises
    (13, 21, "same"),     # a window across two pages from mid-page
    (300, 45, "same"),    # a 300-token prefill window from mid-page
    (6, 90, "fall"),      # the written rows held their pages' absmax
    (3, 381, "same"),     # the table's last page: the window runs past its end
    (17, 367, "rise"),    # three pages, the last past the table's end
])
def test_window_requantize_equals_jax_scatter_cache_window(dtype, s, col, magnitude):
    rng = np.random.default_rng(s * 1000 + col)
    cache, table = _pool_cache(rng, dtype, col, s, magnitude)
    x = {n: rng.normal(size=(B, s, HKV, D)).astype(np.float32) * (50.0 if magnitude == "rise"
                                                                  else 1.0) for n in ("k", "v")}
    before = {n: getattr(cache, n)[0].clone() for n in ("k", "v", "k_scale", "v_scale")}
    view = cache.view(slice(None), col)
    view._address(view._cols[:s])
    n = tkq.window_requantize_fwd.launches
    view.decode_write(0, torch.from_numpy(x["k"]).to(dtype), torch.from_numpy(x["v"]).to(dtype))
    assert tkq.window_requantize_fwd.launches == n  # CPU tensors: the plain version

    jt = jnp.asarray(table)
    pool = {"attn": {n: jnp.asarray(before[n].float().numpy()).astype(_NP[dtype])
                     if n.endswith("scale") else jnp.asarray(before[n].numpy())
                     for n in before}}
    logical = {"attn": {}}
    for name in ("k", "v"):
        view_ = jfd.paged_gather_leaf_dequant(pool["attn"][name], pool["attn"][name + "_scale"],
                                              jt, PS)
        logical["attn"][name] = view_.at[:, col:col + s].set(
            jnp.asarray(x[name]).astype(_NP[dtype]))
    out = jattn.scatter_cache_window({"pages": jt, "pool": pool}, logical, PS, col, s)["pool"]
    written = set()
    for name in ("k", "v"):
        got_q, got_s = getattr(cache, name)[0], getattr(cache, name + "_scale")[0]
        np.testing.assert_array_equal(got_q[1:].numpy(), np.asarray(out["attn"][name])[1:])
        np.testing.assert_array_equal(
            got_s[1:].float().numpy(),
            np.asarray(out["attn"][name + "_scale"][1:].astype(jnp.float32)))
        changed = (got_q != before[name]).flatten(1).any(1) | (
            got_s != before[name + "_scale"]).flatten(1).any(1)
        written |= set(torch.nonzero(changed[1:]).flatten().add(1).tolist())
    # the pages under the written columns, and no others, changed
    want = {int(table[b, c // PS]) for b in range(B) for c in range(col, col + s)} - {0}
    assert written == want
    if magnitude != "same":
        page = int(table[0, col // PS])
        moved = cache.k_scale[0, page].float() / before["k_scale"][page].float()
        assert bool((moved > 2).all() if magnitude == "rise" else (moved < 0.5).all())


def test_window_requantize_plain_writes_both_leaves_in_place():
    """``window_requantize_plain`` on the pool tensors themselves: K and V
    leaves each take their own rows, and the pool objects are not rebound."""
    rng = np.random.default_rng(0)
    cache, table = _pool_cache(rng, torch.float32, 30, 2, "same")
    k = torch.from_numpy(rng.normal(size=(B, 2, HKV, D)).astype(np.float32))
    ptrs = [t.data_ptr() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)]
    pages = torch.as_tensor(table[:, 1:3], dtype=torch.long)
    tkq.window_requantize_plain(cache.k[0], cache.v[0], cache.k_scale[0], cache.v_scale[0],
                                pages, torch.tensor([14]), k, -k)
    assert ptrs == [t.data_ptr() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)]
    for name, x in (("k", k), ("v", -k)):
        view = tfd.paged_gather_leaf_dequant(getattr(cache, name)[0],
                                             getattr(cache, name + "_scale")[0],
                                             torch.as_tensor(table), PS)
        # one int8 step of the new page scale at most
        scale = getattr(cache, name + "_scale")[0][pages[:, 0]].reshape(B, 1, HKV, 1)
        assert bool(((view[:, 30:32] - x).abs() <= scale * 0.5 + 1e-6).all())


# --- the decode step's write folded into K5q: qpaged_write_attend ------------

WB, WH, WD = 4, 4, 16  # slots (the last one free), q-heads, head dim of the fused-route cases


def _write_case(rng, s, col, magnitude):
    """An fp32 int8 pool (``WB`` slots of ``N_LOG`` pages of ``PS``, ``HKV``
    kv-heads) behind a scrambled table: row 2 maps its first 20 logical
    pages only, row 3 is a free slot (no page, no valid column); random
    pages, quantized; kv_valid random below the window, the window's
    mapped columns valid. ``magnitude`` as in :func:`_pool_cache`."""
    L = N_LOG * PS
    cache = PagedKVCache.allocate(1, WB, L, HKV, WD, torch.float32, "cpu", N_PAGES, PS,
                                  kv_quant="int8")
    table = np.zeros((WB, N_LOG), np.int32)
    table[:3] = rng.permutation(np.arange(1, N_PAGES))[:3 * N_LOG].reshape(3, N_LOG)
    table[2, 20:] = 0
    for pool, scale in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
        rows = rng.normal(size=(N_PAGES, PS, HKV, WD)).astype(np.float32)
        if magnitude == "fall":
            for c in range(col, min(col + s, L)):
                rows[table[1, c // PS], c % PS] *= 50.0
        q, sc = tfd.quantize_page_block(torch.from_numpy(rows))
        pool[0].copy_(q)
        scale[0].copy_(sc)
    cache.upload_table(table)
    mapped = np.repeat(table, PS, axis=1) != 0
    valid = (rng.random((WB, L)) > 0.2) & mapped
    valid[:, col:col + s] = mapped[:, col:col + s]
    valid[:, col + s:] = False
    cache.row_valid.copy_(torch.from_numpy(valid))
    return cache, table, valid


@pytest.mark.parametrize("s,col,magnitude", [
    (1, 37, "same"),      # a decode step mid-page
    (1, 47, "rise"),      # at a page's last row; its absmax rises
    (4, 61, "same"),      # the verify window across a page boundary
    (4, 254, "fall"),     # ... across a 256-column range (and page) boundary; absmax falls
    (4, 380, "rise"),     # the table's last page: the window runs past the table's end
    (4, 316, "same"),     # row 2's window runs past its 20 mapped pages
])
def test_qpaged_write_attend_plain_equals_jax(s, col, magnitude):
    """``qpaged_write_attend_plain`` (K5q with the write's plain version, and
    the wrapper on CPU tensors) against the JAX package's route for a
    quantized pool: the window re-quantized by ``scatter_cache_window``,
    then ``paged_gather_leaf_dequant`` and the Pallas decode kernel in
    interpret mode. Pools and scales bit for bit on every page but the null
    page; the output within K5q's CPU limit, 1e-5 (``test_torch_quant.py``)
    of the V rows' scale (50 where the new rows are 50x: f32 sums of
    convex weights times V, in another order). Row 3 is a free slot, row
    2's window can fall past its pages."""
    rng = np.random.default_rng(s * 1000 + col)
    cache, table, valid = _write_case(rng, s, col, magnitude)
    scale_x = 50.0 if magnitude == "rise" else 1.0
    x = {n: rng.normal(size=(WB, s, HKV, WD)).astype(np.float32) * scale_x for n in ("k", "v")}
    q = rng.normal(size=(WB, s, WH, WD)).astype(np.float32)
    pos = np.arange(col, col + s, dtype=np.int32)
    before = {n: getattr(cache, n)[0].clone() for n in ("k", "v", "k_scale", "v_scale")}
    n = tfd.qpaged_write_attend_fwd.launches
    got, got_lse = tfd.qpaged_write_attend_fwd(
        torch.from_numpy(q), torch.from_numpy(x["k"]), torch.from_numpy(x["v"]), cache.k[0],
        cache.v[0], cache.k_scale[0], cache.v_scale[0], cache.block_table, torch.from_numpy(pos),
        cache.row_valid, torch.tensor([col]), PS)
    assert tfd.qpaged_write_attend_fwd.launches == n  # CPU tensors: the plain version

    jt = jnp.asarray(table)
    pool = {"attn": {k: jnp.asarray(t.numpy()) for k, t in before.items()}}
    logical = {"attn": {}}
    for name in ("k", "v"):
        view_ = jfd.paged_gather_leaf_dequant(pool["attn"][name], pool["attn"][name + "_scale"],
                                              jt, PS)
        logical["attn"][name] = view_.at[:, col:col + s].set(jnp.asarray(x[name]))
    out = jattn.scatter_cache_window({"pages": jt, "pool": pool}, logical, PS, col, s)["pool"]
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(cache, name)[0][1:].numpy(),
                                      np.asarray(out["attn"][name])[1:])
    want = jfd.flash_decode_attention(
        jnp.asarray(q),
        jfd.paged_gather_leaf_dequant(out["attn"]["k"], out["attn"]["k_scale"], jt, PS),
        jfd.paged_gather_leaf_dequant(out["attn"]["v"], out["attn"]["v_scale"], jt, PS),
        jnp.asarray(pos), jnp.asarray(valid), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 * scale_x, rtol=0)
    assert not got[3].any() and bool((got_lse[3] == tfd.NEG_INF).all())  # the free slot
    if magnitude != "same":
        b = 0 if magnitude == "rise" else 1
        page = int(table[b, col // PS])
        moved = cache.k_scale[0, page] / before["k_scale"][page]
        assert bool((moved > 2).all() if magnitude == "rise" else (moved < 0.5).all())


def _caches(kind, rng, s, col):
    """Two equal caches of ``kind`` ("row", "paged" or "int8") of 2 slots,
    one layer, a cursor at ``col`` with ``s`` columns addressed; random
    contents, every column below the window valid."""
    L, n_pages = 8 * PS, 20
    out = []
    table = rng.permutation(np.arange(1, n_pages))[:2 * 8].reshape(2, 8).astype(np.int32)
    codes = rng.normal(size=(n_pages, PS, HKV, WD)).astype(np.float32)
    rows = rng.normal(size=(2, L, HKV, WD)).astype(np.float32)
    for _ in range(2):
        if kind == "row":
            cache = KVCache.allocate(1, 2, L, HKV, WD, torch.float32, "cpu")
            cache.k[0].copy_(torch.from_numpy(rows))
            cache.v[0].copy_(torch.from_numpy(-rows))
        else:
            cache = PagedKVCache.allocate(1, 2, L, HKV, WD, torch.float32, "cpu", n_pages, PS,
                                          kv_quant="int8" if kind == "int8" else None)
            if kind == "int8":
                qc, sc = tfd.quantize_page_block(torch.from_numpy(codes))
                cache.k[0].copy_(qc)
                cache.v[0].copy_(-qc)
                cache.k_scale[0].copy_(sc)
                cache.v_scale[0].copy_(sc)
            else:
                cache.k[0].copy_(torch.from_numpy(codes))
                cache.v[0].copy_(torch.from_numpy(-codes))
            cache.upload_table(table)
        cache.valid[:, :col] = True
        cache.index = col
        out.append(cache)
    return out


@pytest.mark.parametrize("kind", ["row", "paged", "int8"])
@pytest.mark.parametrize("s,col", [(1, 37), (4, 46)])
def test_write_attend_equals_decode_write_then_attend(kind, s, col):
    """A decode layer's ``write_attend`` (the fused route on an int8 pool)
    leaves the cache and returns what ``decode_write`` then ``attend``
    do, on row, paged and int8 caches."""
    rng = np.random.default_rng(col + s)
    a, b = _caches(kind, rng, s, col)
    q = torch.from_numpy(rng.normal(size=(2, s, WH, WD)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, s, HKV, WD)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, s, HKV, WD)).astype(np.float32))
    outs = []
    for i, cache in enumerate((a, b)):
        pos, _ = cache.decode_positions(s)
        cache.decode_valid(None, s)
        if i == 0:
            outs.append(cache.write_attend(0, q, k, v, pos))
        else:
            cache.decode_write(0, k, v)
            outs.append(cache.attend(0, q, pos))
    assert torch.equal(outs[0], outs[1])
    names = ("k", "v", "valid") + (("k_scale", "v_scale") if kind == "int8" else ())
    for name in names:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
