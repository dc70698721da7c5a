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
from neuronx_distributed_tpu_torch.modules.attention import PagedKVCache

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
