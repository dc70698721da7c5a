"""The port's CUDA kernels on the card (``cuda`` marker; they skip without a
GPU). This file imports only the port and torch, so it runs on a GPU machine
without flax; the repository's ``tests/conftest.py`` imports the JAX
package, so run it there with::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances (bf16 on both sides). Outputs, elementwise: |out - ref| <=
2^-7 |ref| + c * (P|V|) + 1e-5, where 2^-7 |ref| is one bf16 ulp of O (both
sides round O last) and P|V| is the plain version on |V|, which bounds any
difference in a row's P·V sum: K1 rounds P to bf16 for that product (2^-9
per term), so c = 2^-8; K4 keeps P in f32, so c = 2^-12. LSE 5e-4 — f32 on
both sides, exp-sums in a different order."""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.kernels import flash_attention as tfa
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)


def _assert_out_close(got, want, pv, c):
    want = want.float()
    limit = 2.0 ** -7 * want.abs() + c * pv.float() + 1e-5
    ratio = float(((got.float() - want).abs() / limit).max())
    assert ratio <= 1.0, f"output error at {ratio:.3g}x its limit"


@pytest.mark.cuda
@pytest.mark.parametrize("causal,pad", [(True, 37), (True, 0), (False, 0)])
def test_flash_attention_kernel_matches_plain(cuda, causal, pad):
    q, k, v = _rnd(cuda, 2, 200, 8, 128), _rnd(cuda, 2, 200, 2, 128), _rnd(cuda, 2, 200, 2, 128)
    seg = torch.zeros(2, 200, dtype=torch.int32, device="cuda")
    seg[1, :pad] = -1
    n = tfa.flash_attention_fwd.launches
    got, lse = tfa.flash_attention_fwd(q, k, v, causal, seg)
    assert tfa.flash_attention_fwd.launches == n + 1
    want, wlse = tfa.flash_attention_plain(q, k, v, causal, seg)
    pv = tfa.flash_attention_plain(q, k, v.abs(), causal, seg)[0]
    _assert_out_close(got, want, pv, 2.0 ** -8)
    torch.testing.assert_close(lse, wlse, atol=5e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_cross_length(cuda, causal):
    """Sk != S (causal is top-left aligned, as in the TPU kernel)."""
    q, k, v = _rnd(cuda, 1, 130, 4, 128), _rnd(cuda, 1, 300, 1, 128), _rnd(cuda, 1, 300, 1, 128)
    got, lse = tfa.flash_attention_fwd(q, k, v, causal)
    want, wlse = tfa.flash_attention_plain(q, k, v, causal)
    pv = tfa.flash_attention_plain(q, k, v.abs(), causal)[0]
    _assert_out_close(got, want, pv, 2.0 ** -8)
    torch.testing.assert_close(lse, wlse, atol=5e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("s,bound,h", [(1, 251, 8), (2, 300, 8), (4, 129, 8), (4, 200, 16)])
def test_flash_decode_kernel_matches_plain(cuda, s, bound, h):
    """R = group * s rows per kv-head from 4 up to the kernel's 32."""
    kc, vc = _rnd(cuda, 3, 300, 2, 128), _rnd(cuda, 3, 300, 2, 128)
    q = _rnd(cuda, 3, s, h, 128)
    pos = torch.arange(bound - s, bound, dtype=torch.int32, device="cuda")
    valid = torch.rand(3, 300, generator=cuda, device="cuda") > 0.2
    valid[2, :bound] = False  # a row with no live slot: O = 0, LSE = -1e30
    n = tfd.flash_decode_fwd.launches
    got, lse = tfd.flash_decode_fwd(q, kc, vc, pos, valid)
    assert tfd.flash_decode_fwd.launches == n + 1
    want, wlse = tfd.flash_decode_plain(q, kc, vc, pos, valid)
    pv = tfd.flash_decode_plain(q, kc, vc.abs(), pos, valid)[0]
    _assert_out_close(got, want, pv, 2.0 ** -12)
    torch.testing.assert_close(lse, wlse, atol=5e-4, rtol=1e-4)
    assert float(got[2].abs().max()) == 0.0


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q32 = torch.randn(1, 16, 4, 128, device="cuda")
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q32, q32[:, :, :2], q32[:, :, :2])
    q64 = _rnd(cuda, 1, 16, 4, 64)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q64, q64[:, :, :2], q64[:, :, :2])


@pytest.mark.cuda
def test_engine_on_card_goes_through_both_kernels(cuda):
    """A small bf16 Llama with head_dim 128 served on the card: every
    request finishes and both kernels launch."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    engine = ServingEngine(model, num_slots=3, decode_chunk_size=4)
    rng = np.random.default_rng(0)
    n1, n4 = tfa.flash_attention_fwd.launches, tfd.flash_decode_fwd.launches
    reqs = [engine.submit(rng.integers(1, 1000, size=n), GenerationConfig(12, temperature=0.0))
            for n in (5, 40, 130)]
    engine.run()
    assert all(len(r.tokens) == 12 and all(0 <= t < 1000 for t in r.tokens) for r in reqs)
    assert tfa.flash_attention_fwd.launches - n1 == 3 * cfg.num_layers
    assert tfd.flash_decode_fwd.launches > n4
