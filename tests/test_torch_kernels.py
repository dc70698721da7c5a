"""The port's kernel modules against the Pallas kernels (CPU).

On the CPU the port's wrappers run their plain versions; the Pallas kernels
run in interpret mode, as the JAX package's own tests run them. Inputs are
fp32, made with numpy from a seed. Tolerance 1e-5 absolute: both sides
compute the same f32 softmax, in different summation orders (online and
blockwise in Pallas, one pass here) — ~1e-7 relative per sum, values O(1).

The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
holds them against the plain versions there."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.modules import attention as jattn
from neuronx_distributed_tpu_torch.kernels import flash_attention as tfa
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd
from neuronx_distributed_tpu_torch.modules import attention as tattn

torch.set_num_threads(1)

# the JAX `kernels` package re-exports functions under these module names
jfa = importlib.import_module("neuronx_distributed_tpu.kernels.flash_attention")
jfd = importlib.import_module("neuronx_distributed_tpu.kernels.flash_decode")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5


def _qkv(rng, b, s, h, hkv, d, sk=None):
    sk = sk or s
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    return q, k, v


def _left_pad_segments(lengths, s):
    seg = np.full((len(lengths), s), -1, np.int32)
    for i, n in enumerate(lengths):
        seg[i, s - n:] = 0
    return seg


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,hkv,segments", [
    (16, 4, 4, False),   # MHA
    (16, 4, 2, False),   # GQA
    (13, 4, 2, True),    # GQA, uneven S, left padding as segments
    (16, 8, 2, True),
])
def test_flash_attention_plain_matches_pallas(causal, s, h, hkv, segments):
    rng = np.random.default_rng(s * 10 + h + hkv)
    b, d = 2, 16
    q, k, v = _qkv(rng, b, s, h, hkv, d)
    seg = _left_pad_segments([s, s - 5], s) if segments else None
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               segment_ids=None if seg is None else jnp.asarray(seg),
                               interpret=True)
    jseg = None if seg is None else jnp.asarray(seg)
    _, want_lse = jfa._flash_fwd(
        jnp.swapaxes(jnp.asarray(q), 1, 2), jnp.swapaxes(jnp.asarray(k), 1, 2),
        jnp.swapaxes(jnp.asarray(v), 1, 2), causal, s, s, True, q_seg=jseg, k_seg=jseg,
    )
    before = tfa.flash_attention_fwd.launches
    got, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal,
                                       segment_ids=None if seg is None else _t(seg))
    assert tfa.flash_attention_fwd.launches == before  # CPU: plain version, no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=ATOL, rtol=1e-6)


def test_attention_op_folds_padding_mask_into_segments():
    """Prefill's path: the padding mask becomes segment -1 and rides the
    flash wrapper; rows of real tokens equal the plain einsum golden."""
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 12, 4, 2, 16)
    mask = _left_pad_segments([12, 7], 12) == 0
    got = tattn.attention_op(_t(q), _t(k), _t(v), mask=_t(mask))
    want = tattn.xla_attention(_t(q), _t(k), _t(v), mask=_t(mask))
    np.testing.assert_allclose(got.numpy()[mask], want.numpy()[mask], atol=ATOL, rtol=0)
    jgot = jattn.attention_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              impl="flash", mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(jgot)[mask], atol=ATOL, rtol=0)


def test_flash_attention_fully_masked_row_is_zero():
    """A row whose segment matches no key: O = 0, LSE ~ -1e30 (the TPU
    kernel's guard), as in Pallas."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 1, 8, 2, 2, 16)
    qseg = np.zeros((1, 8), np.int32)
    qseg[0, 3] = 7
    kseg = np.zeros((1, 8), np.int32)
    got, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), segment_ids=_t(qseg),
                                       kv_segment_ids=_t(kseg))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               segment_ids=jnp.asarray(qseg), kv_segment_ids=jnp.asarray(kseg),
                               interpret=True)
    assert np.all(got.numpy()[0, 3] == 0) and np.all(lse.numpy()[0, :, 3] < -1e29)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("s,h,hkv,L,q0", [
    (1, 4, 4, 64, 40),    # MHA, bound 41 < L
    (1, 8, 2, 64, 63),    # GQA, full length
    (4, 8, 2, 48, 20),    # speculative-width window, bound 24 < L
    (4, 4, 1, 32, 3),     # rows before any valid slot: fully masked
])
def test_flash_decode_plain_matches_pallas(s, h, hkv, L, q0):
    rng = np.random.default_rng(L + s + h)
    b, d = 3, 16
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, L, hkv, d)).astype(np.float32)
    vc = rng.normal(size=(b, L, hkv, d)).astype(np.float32)
    pos = np.arange(q0, q0 + s, dtype=np.int32)
    valid = rng.random((b, L)) > 0.3   # gaps
    valid[1, :5] = False                # left padding of a short prompt
    if q0 < 5:
        valid[2, :q0 + s] = False       # row 2 sees no live slot at all
    want = jfd.flash_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.asarray(pos), jnp.asarray(valid), interpret=True)
    g = h // hkv
    qt = jnp.swapaxes(jnp.asarray(q), 1, 2).reshape(b, hkv, g * s, d)
    _, want_lse = jfd._flash_decode_call(
        qt, jnp.swapaxes(jnp.asarray(kc), 1, 2), jnp.swapaxes(jnp.asarray(vc), 1, 2),
        jnp.tile(jnp.asarray(pos), (g,)), jnp.asarray(valid), 0, True, 512,
    )
    before = tfd.flash_decode_fwd.launches
    got, lse = tfd.flash_decode_fwd(_t(q), _t(kc), _t(vc), _t(pos), _t(valid))
    assert tfd.flash_decode_fwd.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=ATOL, rtol=1e-6)
    # and the public decode path of the attention module
    np.testing.assert_allclose(
        tattn.decode_attention(_t(q), _t(kc), _t(vc), _t(pos), _t(valid)).numpy(),
        np.asarray(want), atol=ATOL, rtol=0)
