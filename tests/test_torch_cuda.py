"""The port's CUDA kernels on the card (``cuda`` marker; they skip without a
GPU). This file imports only the port and torch, so it runs on a GPU machine
without flax; the repository's ``tests/conftest.py`` imports the JAX
package, so run it there with::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances (bf16 on both sides). Outputs, elementwise: |out - ref| <=
2^-7 |ref| + c * (P|V|) + 1e-5, where 2^-7 |ref| is one bf16 ulp of O (both
sides round O last) and P|V| is the plain version on |V|, which bounds any
difference in a row's P·V sum: K1 rounds P to bf16 for that product (2^-9
per term), so c = 2^-8; K4 and K5 keep P in f32, so c = 2^-12. LSE 5e-4 —
f32 on both sides, exp-sums in a different order. K5 must equal K4 on the
gathered view bit for bit (the same tiles in the same order). Backward (K2, K3), the same
form with the sum of term magnitudes in place of P|V| (P|dO| for dV,
|dS||Q| for dK, |dS||K| for dQ, dS = P (dP - delta) scale): they round P
and dS to bf16
for their products (2^-9 per term), so c = 2^-8."""

import ctypes

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


def _paged_case(gen, s, ps, h=8, hkv=2, b=3, L=384, bound=341):
    """q, pools, a numpy-seeded scrambled block table (unmapped pages -> the
    null page, filled with large garbage), positions and kv_valid with left
    padding and gaps that stops at each slot's mapped columns."""
    n_log = L // ps
    n_pages = b * n_log + 1
    q = _rnd(gen, b, s, h, 128)
    kp, vp = _rnd(gen, n_pages, ps, hkv, 128), _rnd(gen, n_pages, ps, hkv, 128)
    kp[0].mul_(50.0)
    vp[0].mul_(50.0)
    rng = np.random.default_rng(ps + s)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, n_log), np.int32)
    valid = torch.rand(b, n_log * ps, generator=gen, device="cuda") > 0.2
    for i in range(b):
        lo, hi = 5 * i, -(-bound // ps) - 2 * i
        table[i, lo:hi] = perm[i * n_log:i * n_log + hi - lo]
        valid[i, :lo * ps + 3] = False
        valid[i, hi * ps:] = False
    pos = torch.arange(bound - s, bound, dtype=torch.int32, device="cuda")
    return q, kp, vp, torch.from_numpy(table).cuda(), pos, valid


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("s", [1, 2])
def test_paged_flash_decode_kernel_matches_plain(cuda, s, ps):
    q, kp, vp, bt, pos, valid = _paged_case(cuda, s, ps)
    n = tfd.paged_flash_decode_fwd.launches
    got, lse = tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    assert tfd.paged_flash_decode_fwd.launches == n + 1
    want, wlse = tfd.paged_flash_decode_plain(q, kp, vp, bt, pos, valid, ps)
    pv = tfd.paged_flash_decode_plain(q, kp, vp.abs(), bt, pos, valid, ps)[0]
    _assert_out_close(got, want, pv, 2.0 ** -12)
    torch.testing.assert_close(lse, wlse, atol=5e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_kernel_equals_k4_on_gathered_view_and_ignores_null_page(cuda, ps):
    q, kp, vp, bt, pos, valid = _paged_case(cuda, 2, ps)
    got, lse = tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    row, row_lse = tfd.flash_decode_fwd(q, tfd.paged_gather_leaf(kp, bt, ps),
                                        tfd.paged_gather_leaf(vp, bt, ps), pos, valid)
    assert torch.equal(got, row) and torch.equal(lse, row_lse)
    kp[0].normal_(generator=cuda)
    vp[0].normal_(generator=cuda).mul_(-1e3)
    again, again_lse = tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    assert torch.equal(got, again) and torch.equal(lse, again_lse)


def _split_case(gen, s, L, bound, b=4, h=8, hkv=2, gaps=True):
    """q and a row cache of ``L`` columns with positions ending at
    ``bound - 1``; slot 0 live everywhere up to the bound (gaps aside),
    slot 1 left-padded over its first 600 columns (whole 256-column ranges
    and 64-column tiles dead), slot 2 idle (no live column: O = 0, LSE =
    -1e30), slot 3 live only in its last 40 columns before the bound."""
    q = _rnd(gen, b, s, h, 128)
    kc, vc = _rnd(gen, b, L, hkv, 128), _rnd(gen, b, L, hkv, 128)
    pos = torch.arange(bound - s, bound, dtype=torch.int32, device="cuda")
    valid = (torch.rand(b, L, generator=gen, device="cuda") > 0.15 if gaps
             else torch.ones(b, L, dtype=torch.bool, device="cuda"))
    valid[1, :600] = False
    valid[2] = False
    valid[3, :max(bound - 40, 0)] = False
    return q, kc, vc, pos, valid


def _paged_view(gen, kc, vc, valid, ps=16):
    """Pools, a numpy-seeded scrambled table and the same kv_valid for a row
    cache: logical pages holding a valid column map to pool pages with
    their columns; the rest point at the null page, filled with garbage."""
    b, L, hkv, d = kc.shape
    n_log = L // ps
    kp, vp = _rnd(gen, b * n_log + 1, ps, hkv, d).mul_(50.0), _rnd(gen, b * n_log + 1, ps, hkv, d).mul_(50.0)
    mapped = valid.reshape(b, n_log, ps).any(-1).cpu().numpy()
    perm = iter(np.random.default_rng(L + b).permutation(np.arange(1, b * n_log + 1)).tolist())
    table = np.zeros((b, n_log), np.int32)
    for i in range(b):
        for j in np.flatnonzero(mapped[i]):
            table[i, j] = page = next(perm)
            kp[page] = kc[i, j * ps:(j + 1) * ps]
            vp[page] = vc[i, j * ps:(j + 1) * ps]
    return kp, vp, torch.from_numpy(table).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("L,bound", [
    (300, 251),    # two ranges, the bound inside the first tile of the second
    (300, 300),    # the bound at L: a ragged last range
    (4352, 4100),  # 17 ranges, the bound mid-tile
    (4352, 2048),  # the bound on a range edge: ranges 8.. exit at once
    (4352, 2049),  # one column past it
])
@pytest.mark.parametrize("s", [1, 2, 8])
def test_flash_decode_kernels_split_the_length(cuda, s, L, bound):
    """K4 and K5 at one range and many, R = 4, 8 and 32 (group 4): against
    their plain versions; two runs bitwise equal; K5 through a scrambled
    table bitwise equal to K4 on the gathered view; one launch per call."""
    q, kc, vc, pos, valid = _split_case(cuda, s, L, bound)
    n4, n5 = tfd.flash_decode_fwd.launches, tfd.paged_flash_decode_fwd.launches
    got, lse = tfd.flash_decode_fwd(q, kc, vc, pos, valid)
    again, again_lse = tfd.flash_decode_fwd(q, kc, vc, pos, valid)
    assert tfd.flash_decode_fwd.launches == n4 + 2
    assert torch.equal(got, again) and torch.equal(lse, again_lse)
    want, wlse = tfd.flash_decode_plain(q, kc, vc, pos, valid)
    pv = tfd.flash_decode_plain(q, kc, vc.abs(), pos, valid)[0]
    _assert_out_close(got, want, pv, 2.0 ** -12)
    torch.testing.assert_close(lse, wlse, atol=5e-4, rtol=1e-4)
    assert float(got[2].abs().max()) == 0.0 and bool((lse[2] == tfd.NEG_INF).all())
    ps = 16
    Lp = -(-L // ps) * ps
    if Lp != L:  # the paged cache holds whole pages: pad the row view with dead columns
        pad = Lp - L
        kc, vc = (torch.cat([x, _rnd(cuda, x.shape[0], pad, *x.shape[2:])], 1) for x in (kc, vc))
        valid = torch.cat([valid, torch.zeros(valid.shape[0], pad, dtype=torch.bool, device="cuda")], 1)
    kp, vp, bt = _paged_view(cuda, kc, vc, valid, ps)
    paged, paged_lse = tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    paged2, paged2_lse = tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    assert tfd.paged_flash_decode_fwd.launches == n5 + 2
    assert torch.equal(paged, paged2) and torch.equal(paged_lse, paged2_lse)
    row, row_lse = tfd.flash_decode_fwd(q, tfd.paged_gather_leaf(kp, bt, ps),
                                        tfd.paged_gather_leaf(vp, bt, ps), pos, valid)
    assert torch.equal(paged, row) and torch.equal(paged_lse, row_lse)
    pwant, pwlse = tfd.paged_flash_decode_plain(q, kp, vp, bt, pos, valid, ps)
    ppv = tfd.paged_flash_decode_plain(q, kp, vp.abs(), bt, pos, valid, ps)[0]
    _assert_out_close(paged, pwant, ppv, 2.0 ** -12)
    torch.testing.assert_close(paged_lse, pwlse, atol=5e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["left_padding", "unmapped_pages", "idle_slots"])
def test_flash_decode_kernels_with_dead_ranges(cuda, case):
    """Whole 256-column ranges dead: left padding over the first 1100
    columns of every slot; pages unmapped in the middle of every slot (the
    null page, garbage, under them); every slot but one idle. K4 and K5
    against their plain versions, K5 = K4 on the gathered view, and the
    output blind to what the dead columns hold."""
    L, bound, s = 4096, 3001, 1
    q, kc, vc, pos, valid = _split_case(cuda, s, L, bound, gaps=False)
    if case == "left_padding":
        valid[:, :1100] = False
    elif case == "unmapped_pages":
        valid[:, 512:2304] = False
    else:
        valid[1:] = False
    got, lse = tfd.flash_decode_fwd(q, kc, vc, pos, valid)
    want, wlse = tfd.flash_decode_plain(q, kc, vc, pos, valid)
    pv = tfd.flash_decode_plain(q, kc, vc.abs(), pos, valid)[0]
    _assert_out_close(got, want, pv, 2.0 ** -12)
    torch.testing.assert_close(lse, wlse, atol=5e-4, rtol=1e-4)
    dead = ~valid[:, :, None, None]
    kc2 = torch.where(dead, _rnd(cuda, *kc.shape) * -300.0, kc)
    vc2 = torch.where(dead, _rnd(cuda, *vc.shape) * 300.0, vc)
    other, other_lse = tfd.flash_decode_fwd(q, kc2, vc2, pos, valid)
    assert torch.equal(got, other) and torch.equal(lse, other_lse)
    kp, vp, bt = _paged_view(cuda, kc, vc, valid)
    paged, paged_lse = tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, 16)
    assert torch.equal(paged, got) and torch.equal(paged_lse, lse)


@pytest.mark.cuda
def test_flash_decode_kernels_do_not_spill(cuda):
    """``ptxas -v`` for csrc/flash_decode.cu: no decode kernel or merge
    spills to local memory."""
    from neuronx_distributed_tpu_torch.kernels import _build

    report = _build.resource_report("flash_decode")
    entries = [line for line in report.splitlines() if "Compiling entry function" in line]
    assert len(entries) == 10, report  # K4 and K5 at R <= 4, 8, 16, 32, and their merges
    spills = [line for line in report.splitlines() if "spill" in line]
    assert len(spills) >= len(entries), report
    assert all("0 bytes spill stores, 0 bytes spill loads" in line for line in spills), report


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q32 = torch.randn(1, 16, 4, 128, device="cuda")
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q32, q32[:, :, :2], q32[:, :, :2])
    q64 = _rnd(cuda, 1, 16, 4, 64)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q64, q64[:, :, :2], q64[:, :, :2])
    q, kp, vp, bt, pos, valid = _paged_case(cuda, 1, 16)
    n = tfd.paged_flash_decode_fwd.launches
    with pytest.raises(TypeError):  # f32 pools
        tfd.paged_flash_decode_fwd(q, kp.float(), vp.float(), bt, pos, valid, 16)
    with pytest.raises(ValueError):  # a page size that does not divide the 128-column tile
        pool = _rnd(cuda, 4, 12, 2, 128)
        tfd.paged_flash_decode_fwd(q, pool, pool, bt[:, :2], pos, valid[:, :24], 12)
    with pytest.raises(ValueError):  # an int64 table
        tfd.paged_flash_decode_fwd(q, kp, vp, bt.long(), pos, valid, 16)
    with pytest.raises(ValueError):  # head_dim 64
        pool = _rnd(cuda, 4, 16, 2, 64)
        tfd.paged_flash_decode_fwd(_rnd(cuda, 3, 1, 8, 64), pool, pool, bt, pos, valid, 16)
    assert tfd.paged_flash_decode_fwd.launches == n  # nothing refused was counted


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


@pytest.mark.cuda
def test_paged_engine_on_card_goes_through_k5(cuda, monkeypatch):
    """A small bf16 Llama with head_dim 128 behind a paged engine on the
    card: K5 runs once per layer per executed decode step, K4 never; with
    K4 on the gathered view patched in for K5, the tokens are the same."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params
    from neuronx_distributed_tpu_torch.modules import attention as tattn
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    def gathered(q, k_pool, v_pool, block_table, q_pos, kv_valid=None, page_size=16):
        return tfd.flash_decode_attention(q, tfd.paged_gather_leaf(k_pool, block_table, page_size),
                                          tfd.paged_gather_leaf(v_pool, block_table, page_size),
                                          q_pos, kv_valid)

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 1000, size=n) for n in (5, 40, 130, 17)]
    streams = []
    for attention in ("fused", "gather"):
        engine = ServingEngine(model, num_slots=3, decode_chunk_size=4, kv_page_size=16,
                               kv_num_pages=40)
        n4, n5 = tfd.flash_decode_fwd.launches, tfd.paged_flash_decode_fwd.launches
        reqs = [engine.submit(p, GenerationConfig(12, temperature=0.0)) for p in prompts]
        if attention == "gather":
            monkeypatch.setattr(tattn, "paged_flash_decode_attention", gathered)
        engine.run()
        executed = engine.metrics.executed_steps * cfg.num_layers
        if attention == "fused":
            assert (tfd.paged_flash_decode_fwd.launches - n5, tfd.flash_decode_fwd.launches - n4) == (executed, 0)
        else:
            assert (tfd.paged_flash_decode_fwd.launches - n5, tfd.flash_decode_fwd.launches - n4) == (0, executed)
        assert all(len(r.tokens) == 12 and all(0 <= t < 1000 for t in r.tokens) for r in reqs)
        engine.cache.check()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


def _bwd_case(gen, b, s, h, hkv, seg, causal, strided=False):
    """Inputs of K2/K3; ``strided`` makes q and dout slices of a wider
    (B, S, H + 2, D) tensor, so their row stride is not H * D."""
    wide = 2 if strided else 0
    q, do = (_rnd(gen, b, s, h + wide, 128)[:, :, wide // 2:wide // 2 + h] for _ in range(2))
    k, v = _rnd(gen, b, s, hkv, 128), _rnd(gen, b, s, hkv, 128)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, seg)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _bwd_limit_ratio(got, want, mag):
    want = want.float()
    limit = 2.0 ** -7 * want.abs() + 2.0 ** -8 * mag + 1e-5
    return float(((got.float() - want).abs() / limit).max())


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,hkv,segments,causal,strided", [
    (64, 8, 2, None, True, False),          # one tile, below K3's 128 rows
    (200, 8, 2, None, True, False),         # ragged, between tiles
    (256, 8, 2, "packed", True, False),
    (130, 8, 2, "padding", True, False),
    (200, 8, 2, None, False, False),
    (384, 4, 4, None, True, False),         # group 1 (Hkv = H)
    (384, 32, 4, "packed", True, False),    # group 8
    (1000, 8, 2, "padding", False, False),  # not a multiple of 64 or 128
    (1000, 32, 4, "packed", True, False),
    (64, 4, 4, "packed", False, False),
    (200, 8, 2, None, True, True),          # q/dout row stride (H + 2) * D
    (384, 8, 2, "padding", True, True),
])
def test_flash_attention_backward_kernels_match_plain(cuda, s, h, hkv, segments, causal, strided):
    """K2 and K3 against their plain versions at the edges of their tiles
    (64-row K2 stages, 128-row K3 blocks, 128-key tiles): GQA groups 1, 4
    and 8, causal or not, ragged S, packed documents and left padding,
    strided q/dout; two runs give the same bits."""
    b = 2
    seg = None
    if segments is not None:
        seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        if segments == "packed":
            seg[:, s * 7 // 20:] = 1
            seg[1, s * 3 // 4:] = 2
        else:
            seg[1, :37] = -1
    q, k, v, do, lse, delta = _bwd_case(cuda, b, s, h, hkv, seg, causal, strided)
    args = (q, k, v, do, lse, delta, causal, seg)
    n2, n3 = tfa.flash_attention_dkdv.launches, tfa.flash_attention_dq.launches
    dk, dv = tfa.flash_attention_dkdv(*args)
    dq = tfa.flash_attention_dq(*args)
    assert (tfa.flash_attention_dkdv.launches, tfa.flash_attention_dq.launches) == (n2 + 1, n3 + 1)
    rk, rv = tfa.flash_attention_dkdv_plain(*args)
    rq = tfa.flash_attention_dq_plain(*args)
    p, ds = tfa.backward_scores(*args, seg)
    g = h // hkv
    ds = ds.abs()  # dS carries the softmax scale already
    mag_v = torch.einsum("bhgqk,bqhgd->bkhd", p, do.float().abs().reshape(b, s, hkv, g, 128))
    mag_k = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().abs().reshape(b, s, hkv, g, 128))
    mag_q = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float().abs()).reshape(b, s, h, 128)
    for name, got, want, mag in (("dk", dk, rk, mag_k), ("dv", dv, rv, mag_v), ("dq", dq, rq, mag_q)):
        ratio = _bwd_limit_ratio(got, want, mag)
        assert ratio <= 1.0, f"{name} at {ratio:.3g}x its limit"
    dk2, dv2 = tfa.flash_attention_dkdv(*args)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, tfa.flash_attention_dq(*args))


def _selftest_lib():
    from neuronx_distributed_tpu_torch.kernels import _build

    return _build.load("hopper_selftest"), _build


@pytest.mark.cuda
@pytest.mark.parametrize("rows,row", [(64, 0), (128, 37), (128, 150)])
def test_tma_tile_lands_through_the_swizzle(cuda, rows, row):
    """hopper.cuh's tensor map, TMA load and 128-byte swizzle: a tile of a
    strided (B, S, H, 128) view (three heads of a five-head tensor) read
    back through the swizzle formula equals torch's slice, and rows past S
    arrive as zeros."""
    lib, build = _selftest_lib()
    x = _rnd(cuda, 2, 200, 5, 128)[:, :, 1:4]
    out = torch.full((rows, 128), 7.0, dtype=torch.bfloat16, device="cuda")
    fn = lib.nxd_selftest_tma_tile
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    st = (ctypes.c_longlong * 3)(*x.stride()[:3])
    build.check(fn(x.data_ptr(), 2, 200, 3, st, rows, row, 2, 1, out.data_ptr(),
                   build.stream_ptr(x.device)), "selftest_tma_tile")
    n = min(rows, 200 - row)
    want = torch.zeros_like(out)
    want[:n] = x[1, row:row + n, 2]
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("integers", [False, True])
def test_wgmma_products_match_matmul(cuda, n, integers):
    """hopper.cuh's products against torch.matmul in f32 on the same bf16
    tiles: S = A B1^T (SS, both K-major, the descriptors walking both
    64-column halves), then C = bf16(S) B2 with bf16(S) handed from the
    accumulators to the A registers and B2 read MN-major (RS, transposed
    B). Normal tiles within f32 summation order (S) and one bf16 rounding
    of S (C); integer tiles, whose every sum is exact, bit for bit."""
    lib, build = _selftest_lib()
    if integers:
        a, b1 = (torch.randint(-1, 2, shape, generator=cuda, device="cuda").to(torch.bfloat16)
                 for shape in ((64, 128), (n, 128)))
        b2 = torch.randint(-2, 3, (n, 128), generator=cuda, device="cuda").to(torch.bfloat16)
    else:
        a, b1, b2 = _rnd(cuda, 64, 128), _rnd(cuda, n, 128), _rnd(cuda, n, 128)
    s = torch.empty(64, n, device="cuda")
    c = torch.empty(64, 128, device="cuda")
    fn = lib.nxd_selftest_wgmma
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    build.check(fn(a.data_ptr(), b1.data_ptr(), b2.data_ptr(), n, s.data_ptr(), c.data_ptr(),
                   build.stream_ptr(a.device)), "selftest_wgmma")
    ref_s = torch.matmul(a.float(), b1.float().T)
    ref_c = torch.matmul(ref_s.to(torch.bfloat16).float(), b2.float())
    if integers:
        assert torch.equal(s, ref_s) and torch.equal(c, ref_c)
    else:
        # f32 sums of 128 terms in another order; C: S may round to the
        # neighbouring bf16 (at most 2^-7 relative) where the two S differ
        torch.testing.assert_close(s, ref_s, rtol=1e-5, atol=1e-4)
        mag = torch.matmul(ref_s.abs(), b2.float().abs())
        assert float(((c - ref_c).abs() - 2.0 ** -7 * mag).max()) <= 1e-4


@pytest.mark.cuda
def test_flash_attention_function_on_card(cuda):
    """The autograd Function's gradients on the card against autograd
    through the plain forward (bf16 inputs): within 2% in norm per input
    (P and dS rounded to bf16 in the kernels, O to bf16 before delta)."""
    q, k, v = (_rnd(cuda, 2, 192, 8, 128).requires_grad_(), _rnd(cuda, 2, 192, 2, 128).requires_grad_(),
               _rnd(cuda, 2, 192, 2, 128).requires_grad_())
    g = _rnd(cuda, 2, 192, 8, 128)
    n = [f.launches for f in (tfa.flash_attention_fwd, tfa.flash_attention_dkdv,
                              tfa.flash_attention_dq)]
    got = torch.autograd.grad(tfa.flash_attention(q, k, v), (q, k, v), g)
    assert [f.launches for f in (tfa.flash_attention_fwd, tfa.flash_attention_dkdv,
                                 tfa.flash_attention_dq)] == [x + 1 for x in n]
    want = torch.autograd.grad(tfa.flash_attention_plain(q, k, v)[0], (q, k, v), g)
    for a, w in zip(got, want):
        assert float((a.float() - w.float()).norm() / w.float().norm()) < 2e-2


@pytest.mark.cuda
def test_train_step_on_card_goes_through_the_kernels(cuda):
    """A small bf16 Llama with head_dim 128 trains 3 steps on one packed
    batch: finite, falling loss; K1 twice per layer per step (forward and
    the remat recompute), K2 and K3 once."""
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from neuronx_distributed_tpu_torch.trainer import (
        OptimizerConfig,
        build_train_step,
        create_train_state,
        make_optimizer,
    )

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    model = LlamaForCausalLM(cfg, trainable=True)
    opt = make_optimizer(OptimizerConfig(learning_rate=1e-3))
    state = create_train_state(model, opt, seed=0)
    step = build_train_step(model, opt)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 1000, size=(2, 257))
    seg = np.zeros((2, 256), np.int32)
    seg[:, 100:] = 1
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:], "segment_ids": seg,
             "loss_mask": np.ones((2, 256), np.float32)}
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_dkdv, tfa.flash_attention_dq)
    before = [f.launches for f in counters]
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert [f.launches - n for f, n in zip(counters, before)] == [12, 6, 6]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
