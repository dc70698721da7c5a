"""The tree fingerprint (``utils/fingerprint.py tree_fingerprint``; TF's
plain version, ``kernels/tree_fingerprint.py``) against the JAX package's
``tree_fingerprint`` on the cases of ``tests/integrity/test_fingerprint.py``
:84-138: the same numpy leaves, in JAX's leaf order (sorted keys), give the
same uint32 bit for bit (tolerance: none). JAX's 64-bit case (:122) is red
on this tree (its x64 switch), so 64-bit leaves are held to a numpy
reference of the documented rule instead (high ^ low, then the same mix).
The chaos hands (``integrity/chaos.py``) are held to JAX's
``flip_array_bit`` byte for byte, and the in-place flip to the copy."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.integrity.chaos import flip_array_bit as jflip_array_bit
from neuronx_distributed_tpu.utils.fingerprint import FINGERPRINT_PRIME as JPRIME
from neuronx_distributed_tpu.utils.fingerprint import FINGERPRINT_SEED as JSEED
from neuronx_distributed_tpu.utils.fingerprint import tree_fingerprint as jtree_fingerprint
from neuronx_distributed_tpu_torch.integrity.chaos import flip_array_bit, flip_leaf_bit, flip_tree_bit
from neuronx_distributed_tpu_torch.kernels.tree_fingerprint import (
    TreeFingerprint,
    tree_bytes,
    tree_fingerprint_fwd,
    tree_fingerprint_plain,
)
from neuronx_distributed_tpu_torch.utils.fingerprint import (
    FINGERPRINT_PRIME,
    FINGERPRINT_SEED,
    tree_fingerprint,
)

torch.set_num_threads(1)


def _np_tree():
    """JAX's ``_tree`` as numpy leaves (bf16 through ml_dtypes)."""
    rng = np.random.default_rng(7)
    return {
        "w": rng.standard_normal((4, 8)).astype(np.float32),
        "b": rng.standard_normal((8,)).astype(np.float32),
        "h": rng.standard_normal((3, 3)).astype(ml_dtypes.bfloat16),
        "i": rng.integers(-5, 5, (6,), dtype=np.int32),
        "q": rng.integers(0, 255, (4,), dtype=np.uint8),
        "m": np.asarray([True, False, True]),
    }


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _both(tree: dict):
    """(port, JAX) fingerprints of one dict of numpy leaves, the port's
    leaves in JAX's flatten order (sorted keys)."""
    port = int(tree_fingerprint([_torch(tree[k]) for k in sorted(tree)]))
    jax_fp = int(jtree_fingerprint({k: jnp.asarray(v) for k, v in tree.items()}))
    return port, jax_fp


def test_constants_are_jax_s():
    assert (FINGERPRINT_SEED, FINGERPRINT_PRIME) == (JSEED, JPRIME)


def test_tree_fingerprint_equals_jax_deterministic_uint32():
    """JAX :84: deterministic, a uint32, and here = JAX's value."""
    port, jax_fp = _both(_np_tree())
    assert port == jax_fp and 0 <= port < 2 ** 32
    again = tree_fingerprint([_torch(v) for _, v in sorted(_np_tree().items())])
    assert again.dtype == torch.int64 and again.dim() == 0 and int(again) == port


@pytest.mark.parametrize("leaf", ["w", "h", "i", "q", "m"])
def test_tree_fingerprint_sees_one_flipped_bit(leaf):
    """JAX :92: the lowest bit of one element changes the value, in every
    dtype family; flipped and clean both equal JAX's."""
    t = _np_tree()
    clean = _both(t)
    t[leaf] = jflip_array_bit(t[leaf])
    flipped = _both(t)
    assert clean[0] == clean[1] and flipped[0] == flipped[1]
    assert flipped[0] != clean[0]


def test_tree_fingerprint_position_sensitive():
    """JAX :107: a swap of two elements moves the value."""
    a = {"x": np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)}
    b = {"x": np.asarray([2.0, 1.0, 3.0, 4.0], np.float32)}
    pa, pb = _both(a), _both(b)
    assert pa[0] == pa[1] and pb[0] == pb[1] and pa[0] != pb[0]


def test_tree_fingerprint_leaf_order_sensitive():
    """JAX :113: the same leaves in the other order give another value (the
    caller's order, here; JAX's sorted keys there)."""
    x = np.asarray([1.0, 2.0], np.float32)
    y = np.asarray([3.0, 4.0], np.float32)
    assert _both({"a": x, "b": y})[0] == _both({"a": x, "b": y})[1]
    assert _both({"a": y, "b": x})[0] == _both({"a": y, "b": x})[1]
    assert _both({"a": x, "b": y})[0] != _both({"a": y, "b": x})[0]
    assert int(tree_fingerprint({"a": _torch(x), "b": _torch(y)})) == _both({"a": x, "b": y})[0]


def _numpy_reference(leaves) -> int:
    """The documented rule in numpy uint64 arithmetic: 64-bit elements fold
    high ^ low, narrower ones zero-extend; weights 2i + 1; sums and the
    combine mod 2^32."""
    total = FINGERPRINT_SEED
    for a in leaves:
        a = np.ascontiguousarray(a).reshape(-1)
        size = a.dtype.itemsize
        u = a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[size]).astype(np.uint64)
        if size == 8:
            u = (u >> np.uint64(32)) ^ (u & np.uint64(0xFFFFFFFF))
        w = 2 * np.arange(a.size, dtype=np.uint64) + 1
        leaf = int(((u * w) & np.uint64(0xFFFFFFFF)).sum() & np.uint64(0xFFFFFFFF))
        total = (total * FINGERPRINT_PRIME + leaf) & 0xFFFFFFFF
    return total


def test_tree_fingerprint_64bit_folds_high_and_low():
    """JAX :122's case against the numpy reference (JAX's is red here):
    both halves of a 64-bit word are live."""
    base = np.arange(4, dtype=np.int64)
    high, low = base.copy(), base.copy()
    high[0] ^= 1 << 40
    low[0] ^= 1

    def fp(a):
        return int(tree_fingerprint([torch.from_numpy(a)]))

    for a in (base, high, low, np.random.default_rng(3).standard_normal(9)):
        assert fp(a) == _numpy_reference([a])
    assert fp(base) != fp(high) and fp(base) != fp(low)


def test_empty_tree_is_seed():
    """JAX :138."""
    assert int(tree_fingerprint({})) == FINGERPRINT_SEED == int(jtree_fingerprint({}))
    assert FINGERPRINT_SEED % 2 == 1 and FINGERPRINT_PRIME % 2 == 1


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32", "float8_e4m3fn"])
def test_plain_chunks_carry_the_position(dtype):
    """The plain version in chunks of 7 elements = one pass = JAX's, for the
    widths TF serves (int8 codes, bf16, f32 scales and norms, fp8 codes)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((5, 13)).astype(np.float32)).to(getattr(torch, dtype)) \
        if dtype != "int8" else torch.from_numpy(rng.integers(-128, 127, (5, 13)).astype(np.int8))
    one = int(tree_fingerprint_plain([x]))
    assert int(tree_fingerprint_plain([x], chunk=7)) == one
    host = x.contiguous().view(torch.uint8).numpy().view({1: np.uint8, 2: np.uint16,
                                                           4: np.uint32}[x.element_size()])
    assert one == _numpy_reference([host])


def test_fwd_on_cpu_is_plain_and_counts_no_launch():
    leaves = [_torch(v) for _, v in sorted(_np_tree().items())]
    before = tree_fingerprint_fwd.launches
    assert int(tree_fingerprint_fwd(leaves)) == int(tree_fingerprint_plain(leaves))
    prog = TreeFingerprint(leaves)
    assert int(prog()) == int(tree_fingerprint_plain(leaves))
    assert tree_fingerprint_fwd.launches == before
    assert prog.nbytes == tree_bytes(leaves) == sum(v.nbytes for v in _np_tree().values())


def test_chaos_hands_equal_jax():
    """``flip_array_bit`` = JAX's byte for byte; the port's in-place flip of
    a tensor = that copy; ``flip_tree_bit`` flips the first leaf only."""
    t = _np_tree()
    for k, v in t.items():
        for byte_index, bit in ((0, 0), (3, 5)):
            np.testing.assert_array_equal(flip_array_bit(v, byte_index, bit).view(np.uint8),
                                          jflip_array_bit(v, byte_index, bit).view(np.uint8))
        if v.dtype != np.bool_:
            x = _torch(v)
            flip_leaf_bit(x)
            np.testing.assert_array_equal(x.view(torch.uint8).numpy(),
                                          np.ascontiguousarray(jflip_array_bit(v)).view(np.uint8))
    a, b = torch.zeros(4), torch.ones(4)
    flip_tree_bit([a, b])
    assert a.view(torch.int32)[0].item() == 1 and torch.equal(b, torch.ones(4))
    with pytest.raises(ValueError):
        flip_leaf_bit(torch.zeros(4, 4).t())
