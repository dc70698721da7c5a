"""The port's kernel modules against the Pallas kernels (CPU).

On the CPU the port's wrappers run their plain versions; the Pallas kernels
run in interpret mode, as the JAX package's own tests run them. Inputs are
fp32, made with numpy from a seed. Tolerance 1e-5 absolute: both sides
compute the same f32 softmax, in different summation orders (online and
blockwise in Pallas, one pass here) — ~1e-7 relative per sum, values O(1).
The backward (dK, dV, dQ) sums up to 16 keys or queries of O(10) terms
each: 5e-5 absolute.

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


BWD_ATOL = 5e-5


def _bwd_inputs(seed, b, s, h, hkv, d, causal, q_seg, k_seg):
    """Numpy q/k/v/dO and the Pallas forward's LSE plus delta = rowsum(dO * O)
    (as ``_flash_bwd`` forms it), in the JAX (B, H, S, D) layout."""
    rng = np.random.default_rng(seed)
    q, k, v = _qkv(rng, b, s, h, hkv, d)
    do = rng.normal(size=(b, s, h, d)).astype(np.float32)
    qt, kt, vt, dot = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v, do))
    jq = None if q_seg is None else jnp.asarray(q_seg)
    jk = None if k_seg is None else jnp.asarray(k_seg)
    out, lse = jfa._flash_fwd(qt, kt, vt, causal, 8, 8, True, q_seg=jq, k_seg=jk)
    delta = jnp.sum(dot * out, axis=-1, keepdims=True)
    return (q, k, v, do), (qt, kt, vt, dot, lse, delta, jq, jk)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("segments", ["none", "packed", "padding", "masked_row"])
def test_flash_attention_backward_plain_matches_pallas(causal, segments):
    """K2/K3's plain versions against ``_flash_dkdv``/``_flash_dq`` in
    interpret mode: GQA (H=4, Hkv=2); packed documents; left padding as
    segment -1; a query row whose segment matches no key (LSE ~ -1e30, its
    P must be exactly 0)."""
    b, s, h, hkv, d = 2, 16, 4, 2, 16
    q_seg = k_seg = None
    if segments == "packed":
        q_seg = k_seg = np.array([[0] * 5 + [1] * 7 + [2] * 4, [3] * 16], np.int32)
    elif segments == "padding":
        q_seg = k_seg = _left_pad_segments([16, 11], s)
    elif segments == "masked_row":
        q_seg = np.zeros((b, s), np.int32)
        q_seg[0, 5] = q_seg[1, 0] = 9
        k_seg = np.zeros((b, s), np.int32)
    (q, k, v, do), (qt, kt, vt, dot, lse, delta, jq, jk) = _bwd_inputs(
        s + hkv + causal, b, s, h, hkv, d, causal, q_seg, k_seg)
    want_dk, want_dv = jfa._flash_dkdv(qt, kt, vt, dot, lse, delta, causal, 8, 8, True,
                                       q_seg=jq, k_seg=jk)
    want_dq = jfa._flash_dq(qt, kt, vt, dot, lse, delta, causal, 8, 8, True, q_seg=jq, k_seg=jk)
    args = (_t(q), _t(k), _t(v), _t(do), _t(np.array(lse)[..., 0]),
            _t(np.array(delta)[..., 0]), causal,
            None if q_seg is None else _t(q_seg), None if k_seg is None else _t(k_seg))
    n2, n3 = tfa.flash_attention_dkdv.launches, tfa.flash_attention_dq.launches
    dk, dv = tfa.flash_attention_dkdv(*args)
    dq = tfa.flash_attention_dq(*args)
    assert (tfa.flash_attention_dkdv.launches, tfa.flash_attention_dq.launches) == (n2, n3)
    for got, want in ((dk, want_dk), (dv, want_dv), (dq, want_dq)):
        np.testing.assert_allclose(got.numpy(), np.swapaxes(np.asarray(want), 1, 2),
                                   atol=BWD_ATOL, rtol=0)
    if segments == "masked_row":
        assert np.all(np.asarray(lse)[0, :, 5] < -1e29)
        assert np.all(dq.numpy()[0, 5] == 0) and np.all(np.isfinite(dk.numpy()))


@pytest.mark.parametrize("segments", [False, True])
def test_flash_attention_function_gradients_equal_autograd_of_plain(segments):
    """The autograd Function (K1 forward, K2/K3 backward; their plain
    versions on CPU tensors) gives the gradients torch.autograd takes
    through ``flash_attention_plain``."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _qkv(rng, 2, 13, 4, 2, 16))
    seg = _t(np.array([[0] * 6 + [1] * 7, [-1] * 4 + [0] * 9], np.int32)) if segments else None
    g = _t(rng.normal(size=(2, 13, 4, 16)).astype(np.float32))
    out = tfa.flash_attention(q, k, v, causal=True, segment_ids=seg)
    assert out.grad_fn is not None and "FlashAttentionFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = tfa.flash_attention_plain(q, k, v, True, seg)[0]
    want = torch.autograd.grad(ref, (q, k, v), g)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=ATOL, rtol=0)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=BWD_ATOL, rtol=0)


def test_flash_attention_without_grad_runs_the_bare_forward():
    """Serving (no input requires grad, or under no_grad) calls K1's wrapper
    directly: no autograd node is recorded."""
    rng = np.random.default_rng(8)
    q, k, v = (_t(x) for x in _qkv(rng, 1, 8, 2, 1, 16))
    assert tfa.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert tfa.flash_attention(q.requires_grad_(), k, v).grad_fn is None
