"""Per-page pool fingerprints (``utils/fingerprint.pool_pages_fingerprint``,
the plain version of PF) against the JAX package's
``pool_pages_fingerprint``, bit for bit (CPU).

The JAX pool is the tree its paged engine holds: one ``layers_<i>`` dict an
unscanned layer, each with ``index``, ``k``, ``kv_valid`` and ``v`` (and on
an int8 pool ``k_scale``/``v_scale``). The port's pools carry the same
values as (num_layers, num_pages, ...) tensors. Twelve layers, so the
sorted-key order (``layers_10`` before ``layers_2``) shows; f32, bf16 and
int8 pools with scales, page ids scrambled and repeated; every single-bit
flip in one page changes that page's value and no other. bf16 values are
the upper halves of f32 normals (finite: JAX's gather on the CPU rewrites a
NaN's payload, which a fingerprint of bits would see; K/V pools hold no
NaN)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.utils.fingerprint import pool_pages_fingerprint as jax_pool_fp
from neuronx_distributed_tpu_torch.kernels.page_fingerprint import (
    element_bits,
    pool_pages_fingerprint_fwd,
    pool_pages_fingerprint_plain,
)
from neuronx_distributed_tpu_torch.modules.attention import PagedKVCache
from neuronx_distributed_tpu_torch.utils.fingerprint import (
    jax_layer_order,
    pool_leaves,
    pool_pages_fingerprint,
)

torch.set_num_threads(1)

L, P, PS, HKV, D = 12, 9, 4, 2, 8


def _bf16_bits(rng, shape):
    """bf16 bit patterns (as uint16) of finite values."""
    x = (rng.standard_normal(shape) * 8).astype(np.float32)
    return (x.view(np.uint32) >> 16).astype(np.uint16)


def _pools(kind: str, seed: int = 0):
    """numpy (L, P, PS, HKV, D) K and V (and (L, P, 1, HKV, 1) scales on an
    int8 pool) in the pool's dtype (bf16 as uint16 bit patterns)."""
    rng = np.random.default_rng(seed)
    shape = (L, P, PS, HKV, D)
    if kind == "f32":
        return {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    if kind == "bf16":
        return {n: _bf16_bits(rng, shape) for n in ("k", "v")}
    out = {n: rng.integers(-127, 128, size=shape).astype(np.int8) for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        out[n] = _bf16_bits(rng, (L, P, 1, HKV, 1))
    return out


def _jnp(x):
    return jnp.asarray(x).view(jnp.bfloat16) if x.dtype == np.uint16 else jnp.asarray(x)


def _torch(x):
    return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16) if x.dtype == np.uint16 \
        else torch.from_numpy(x)


def _jax_tree(pools):
    """The JAX paged engine's pool tree for these pools."""
    layers = {}
    for i in range(L):
        attn = {"index": jnp.zeros((), jnp.int32), "kv_valid": jnp.zeros((2, 16), bool)}
        attn.update({n: _jnp(a[i]) for n, a in pools.items()})
        layers[f"layers_{i}"] = {"attn": attn}
    return {"model": layers}


def _port_cache(pools):
    t = {n: _torch(a) for n, a in pools.items()}
    return PagedKVCache(t["k"], t["v"], torch.zeros((2, 16), dtype=torch.bool),
                        torch.zeros((2, 4), dtype=torch.int32), PS,
                        k_scale=t.get("k_scale"), v_scale=t.get("v_scale"))


IDS = [7, 1, 3, 3, 8, 2, 1, 5]  # scrambled, with repeats


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_plain_equals_jax_pool_pages_fingerprint(kind):
    pools = _pools(kind)
    want = np.asarray(jax_pool_fp(_jax_tree(pools), jnp.asarray(IDS, jnp.int32)))
    got = pool_pages_fingerprint(_port_cache(pools), IDS)
    assert got.dtype == torch.int64
    assert got.numpy().astype(np.uint32).tolist() == want.astype(np.uint32).tolist()
    assert (got >= 0).all() and (got < 2**32).all()
    # the repeats read the same page: equal values
    assert got[2] == got[3] and got[1] == got[6]


def test_layer_order_is_the_sorted_key_order():
    assert jax_layer_order(12) == (0, 1, 10, 11, 2, 3, 4, 5, 6, 7, 8, 9)
    pools = _pools("f32", seed=3)
    leaves = pool_leaves(_port_cache(pools))
    ids = torch.tensor(IDS)
    ordered = pool_pages_fingerprint_plain(leaves, ids, jax_layer_order(L))
    numeric = pool_pages_fingerprint_plain(leaves, ids, tuple(range(L)))
    assert not torch.equal(ordered, numeric)  # the combine is order-sensitive


def test_int8_pool_leaves_include_the_scales_in_key_order():
    cache = _port_cache(_pools("int8"))
    assert [t.dtype for t in pool_leaves(cache)] == [torch.int8, torch.bfloat16, torch.int8,
                                                     torch.bfloat16]
    # a scale's bits count: flipping one changes only its page
    before = pool_pages_fingerprint(cache, range(P))
    cache.v_scale.view(torch.int16)[4, 6, 0, 1, 0] ^= 1 << 3
    after = pool_pages_fingerprint(cache, range(P))
    assert [i for i in range(P) if before[i] != after[i]] == [6]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_every_single_bit_flip_changes_only_its_page(kind):
    """Every bit of page 4 in layer 10 of every leaf, flipped on its own,
    moves page 4's value; at the first, a middle and the last byte of the
    page in layers 0, 10 and 11, no other page's value moves."""
    cache = _port_cache(_pools(kind, seed=5))
    base = pool_pages_fingerprint(cache, range(P))
    page = 4
    for leaf in pool_leaves(cache):
        raw = leaf.view(torch.uint8)
        flat = raw[10, page].reshape(-1)
        for byte in range(flat.numel()):
            for bit in range(8):
                flat[byte] ^= 1 << bit
                now = pool_pages_fingerprint(cache, [page])
                flat[byte] ^= 1 << bit
                assert now[0] != base[page], (leaf.dtype, byte, bit)
        for layer in (0, 10, L - 1):
            flat = raw[layer, page].reshape(-1)
            for byte in (0, flat.numel() // 2 + 1, flat.numel() - 1):
                flat[byte] ^= 1 << 7
                now = pool_pages_fingerprint(cache, range(P))
                flat[byte] ^= 1 << 7
                changed = [i for i in range(P) if now[i] != base[i]]
                assert changed == [page], (leaf.dtype, layer, byte, changed)
    assert torch.equal(pool_pages_fingerprint(cache, range(P)), base)


def test_element_bits_zero_extend():
    x = torch.tensor([-1.0, 2.0], dtype=torch.bfloat16)
    assert element_bits(x).tolist() == [0xBF80, 0x4000]
    assert element_bits(torch.tensor([-1, 5], dtype=torch.int8)).tolist() == [255, 5]
    assert element_bits(torch.tensor([-0.0], dtype=torch.float32)).tolist() == [0x80000000]


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_no_launch():
    cache = _port_cache(_pools("bf16"))
    before = pool_pages_fingerprint_fwd.launches
    out = pool_pages_fingerprint_fwd(pool_leaves(cache), torch.tensor(IDS), jax_layer_order(L))
    assert pool_pages_fingerprint_fwd.launches == before
    assert torch.equal(out, pool_pages_fingerprint(cache, IDS))
