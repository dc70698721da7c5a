"""The split-length decode arithmetic of K4 and K5 (CPU).

On the card K4 and K5 cut the cache length into ranges of columns, one
block per range, and merge the ranges' partial outputs by their LSE.
``flash_decode_split_plain`` is that arithmetic in plain PyTorch; here it is
held to ``flash_decode_plain`` and to the JAX package's own length split
(``flash_decode_attention`` with tp = 4 > hkv = 2, which splits L over tp
and merges by the same rule; run as
``tests/kernels/test_flash_decode.py::test_tp_splits_cache_length`` runs
it: interpret mode on the virtual CPU mesh).

Inputs are f32 from a numpy seed at ``tiny_llama``-like widths (hkv = 2,
h = 8, D = 128). Tolerance 2e-5 absolute, the JAX test's own: both sides
compute f32 softmaxes over the same columns in other summation orders and
merge them in f32 (values O(1))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.kernels.flash_decode import flash_decode_attention as jax_flash_decode
from neuronx_distributed_tpu.parallel import mesh as mesh_lib
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd

torch.set_num_threads(1)

ATOL = 2e-5
B, L, H, HKV, D = 3, 256, 8, 2, 128


def _case(s: int, seed: int):
    """Slot 0: left padding over the first 140 columns (whole 64-column
    splits dead); slot 1: random gaps and a masked stretch that covers the
    split [64, 128); slot 2: idle, no live column. Positions end at 199, so
    the split [192, 256) holds 8 live columns and the rest of L is dead."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, s, H, D)).astype(np.float32)
    kc = rng.normal(size=(B, L, HKV, D)).astype(np.float32)
    vc = rng.normal(size=(B, L, HKV, D)).astype(np.float32)
    pos = np.arange(200 - s, 200, dtype=np.int32)
    valid = rng.random((B, L)) > 0.25
    valid[0, :140] = False
    valid[1, 64:128] = False
    valid[2] = False
    return q, kc, vc, pos, valid


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("split_cols", [16, 64, 100, 256])
@pytest.mark.parametrize("s", [1, 2])
def test_split_plain_matches_one_pass_plain(s, split_cols):
    """Ranges of 16 to 256 columns (one range: no merge at all; 100: the
    last range ragged) against the one-pass plain version, out and LSE."""
    q, kc, vc, pos, valid = (_t(x) for x in _case(s, 10 * s + split_cols))
    got, lse = tfd.flash_decode_split_plain(q, kc, vc, pos, valid, split_cols)
    want, wlse = tfd.flash_decode_plain(q, kc, vc, pos, valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), wlse.numpy(), atol=ATOL, rtol=1e-6)
    assert np.all(got.numpy()[2] == 0.0) and np.all(lse.numpy()[2] == tfd.NEG_INF)


@pytest.mark.parametrize("s", [1, 2])
def test_split_plain_matches_jax_tp_length_split(s):
    """tp = 4 > hkv = 2: the JAX package splits L = 256 into four ranges of
    64 and merges them by LSE; so does ``flash_decode_split_plain`` at
    ``split_cols`` 64. The idle slot comes out exactly 0 on both sides."""
    q, kc, vc, pos, valid = _case(s, 7 + s)
    jv = jnp.asarray(valid)
    jpos = jnp.asarray(pos)
    mesh_lib.initialize_model_parallel(tensor_model_parallel_size=4)
    try:
        want = jax.jit(lambda q, kc, vc: jax_flash_decode(q, kc, vc, jpos, kv_valid=jv, block_l=32))(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc))
        want = np.asarray(want)
    finally:
        mesh_lib.destroy_model_parallel()
    got, lse = tfd.flash_decode_split_plain(_t(q), _t(kc), _t(vc), _t(pos), _t(valid), 64)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.all(want[2] == 0.0) and np.all(got.numpy()[2] == 0.0)
    assert np.all(lse.numpy()[2] == tfd.NEG_INF)


def test_merge_gives_dead_ranges_no_weight():
    """A range whose LSE is -1e30 contributes nothing, whatever its output
    holds; a single live range passes through unchanged."""
    rng = np.random.default_rng(0)
    s = 1
    live = _t(rng.normal(size=(2, s, H, D)).astype(np.float32))
    junk = torch.full_like(live, 1e6)
    lse = _t(rng.normal(size=(2, HKV, H // HKV * s)).astype(np.float32))
    dead = torch.full_like(lse, tfd.NEG_INF)
    out, got_lse = tfd.merge_decode_partials([junk, live, junk], [dead, lse, dead])
    torch.testing.assert_close(out, live, atol=0, rtol=0)
    torch.testing.assert_close(got_lse, lse, atol=0, rtol=0)
    out, got_lse = tfd.merge_decode_partials([junk, junk], [dead, dead])
    assert torch.all(out == 0) and torch.all(got_lse == tfd.NEG_INF)
