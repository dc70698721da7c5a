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
gathered view bit for bit (the same tiles in the same order), and K5q
(int8 pages) K4 on the dequantized gathered view; DQ equals its plain
version bit for bit (one rounding of the same f32 product). Backward (K2, K3), the same
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


def _k1_segments(kind, b, s):
    """K1's segment cases on (B, S): none; left padding (row 1 from 30% of
    S on, padding = -1); or packed documents (K2/K3's packing)."""
    if kind is None:
        return None
    seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    if kind == "padding":
        seg[1, :s * 3 // 10] = -1
    else:
        seg[:, s * 7 // 20:] = 1
        seg[1, s * 3 // 4:] = 2
    return seg


def _k1_check(q, k, v, causal, seg, kv_seg=None):
    """K1 on the card against its plain version, and once more for the
    same bits; returns (out, lse)."""
    n = tfa.flash_attention_fwd.launches
    got, lse = tfa.flash_attention_fwd(q, k, v, causal, seg, kv_seg)
    assert tfa.flash_attention_fwd.launches == n + 1
    want, wlse = tfa.flash_attention_plain(q, k, v, causal, seg, kv_seg)
    pv = tfa.flash_attention_plain(q, k, v.abs(), causal, seg, kv_seg)[0]
    _assert_out_close(got, want, pv, 2.0 ** -8)
    torch.testing.assert_close(lse, wlse, atol=5e-4, rtol=1e-4)
    again, again_lse = tfa.flash_attention_fwd(q, k, v, causal, seg, kv_seg)
    assert torch.equal(got, again) and torch.equal(lse, again_lse)
    return got, lse


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("segments", [None, "padding", "packed"])
@pytest.mark.parametrize("h,hkv", [(32, 8), (8, 8), (4, 1)])
@pytest.mark.parametrize("s", [1, 8, 33, 200, 1000])
def test_flash_attention_kernel_matches_plain(cuda, s, h, hkv, segments, causal):
    """K1 against its plain version across its 128-row query and 128-key
    tiles (S below one tile, ragged, several tiles): GQA groups 4, 1 and
    4 with one kv-head, no segments, left padding and packed documents,
    causal or not; two runs give the same bits."""
    b = 2
    q, k, v = _rnd(cuda, b, s, h, 128), _rnd(cuda, b, s, hkv, 128), _rnd(cuda, b, s, hkv, 128)
    _k1_check(q, k, v, causal, _k1_segments(segments, b, s))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,segments", [(33, None), (200, "padding"), (1000, "packed")])
def test_flash_attention_kernel_reads_strided_operands(cuda, s, segments, causal):
    """q a view of (B, S, H + 2, D), k and v views of one (B, S, 2 Hkv + 1,
    D) tensor: row strides that are not H * D, read in place by TMA."""
    b, h, hkv = 2, 8, 2
    q = _rnd(cuda, b, s, h + 2, 128)[:, :, 1:h + 1]
    kv = _rnd(cuda, b, s, 2 * hkv + 1, 128)
    k, v = kv[:, :, :hkv], kv[:, :, hkv + 1:]
    _k1_check(q, k, v, causal, _k1_segments(segments, b, s))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,sk", [(130, 300), (300, 130), (8, 200), (1000, 33)])
def test_flash_attention_kernel_cross_length(cuda, s, sk, causal):
    """Sk != S (causal is top-left aligned, as in the TPU kernel)."""
    q, k, v = _rnd(cuda, 1, s, 4, 128), _rnd(cuda, 1, sk, 1, 128), _rnd(cuda, 1, sk, 1, 128)
    _k1_check(q, k, v, causal, None)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_fully_masked_rows(cuda, causal):
    """Rows with no live key give O = 0 and LSE ~ -1e30: single rows (query
    ids no key has) and a whole 128-row query tile whose segment range meets
    no key tile's, so its block visits no tile at all."""
    b, s, h, hkv = 2, 300, 8, 2
    q, k, v = _rnd(cuda, b, s, h, 128), _rnd(cuda, b, s, hkv, 128), _rnd(cuda, b, s, hkv, 128)
    seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    kv_seg = seg.clone()
    seg[0, 5] = seg[1, 290] = 7
    seg[1, 128:256] = 9
    kv_seg[1, 128:] = 3
    got, lse = _k1_check(q, k, v, causal, seg, kv_seg)
    for bi, rows in ((0, [5]), (1, [290, *range(128, 256)])):
        assert float(got[bi, rows].abs().max()) == 0.0
        assert float(lse[bi, :, rows].max()) <= -1e29


@pytest.mark.cuda
def test_flash_attention_kernel_does_not_spill(cuda):
    """``ptxas -v`` for csrc/flash_attention.cu: K1 keeps everything in
    registers (no spill, nothing local at run time) and ptxas left its
    `wgmma` products asynchronous (no C7514/C7515 serialization warning)."""
    from neuronx_distributed_tpu_torch.kernels import _build

    report = _build.resource_report("flash_attention")
    lines = report.splitlines()
    assert sum("Compiling entry function" in line for line in lines) == 1, report
    spills = [line for line in lines if "spill" in line]
    assert spills and all("0 bytes spill stores, 0 bytes spill loads" in line for line in spills), report
    assert "C7514" not in report and "C7515" not in report, report
    vals = (ctypes.c_int * 4)()
    lib = _build.load("flash_attention")
    _build.check(lib.nxd_flash_attention_fwd_resources(vals), "flash_attention")
    assert vals[2] == 0 and vals[3] >= 1, list(vals)


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


def _paged_case(gen, s, ps, h=8, hkv=2, b=3, L=384, bound=341, d=128):
    """q, pools, a numpy-seeded scrambled block table (unmapped pages -> the
    null page, filled with large garbage), positions and kv_valid with left
    padding and gaps that stops at each slot's mapped columns."""
    n_log = L // ps
    n_pages = b * n_log + 1
    q = _rnd(gen, b, s, h, d)
    kp, vp = _rnd(gen, n_pages, ps, hkv, d), _rnd(gen, n_pages, ps, hkv, d)
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


def _suffix_case(gen, s, h, hkv, b=2, L=2048, prefix=1500, d=128):
    """A suffix prefill's decode call: q of ``s`` tokens at columns
    [prefix, prefix + s) behind a live prefix; slot 1 left-padded over its
    first 300 columns, a gap of dead columns in both prefixes, and the last
    3 suffix tokens a pad tail (invalid columns, rows still computed)."""
    q = _rnd(gen, b, s, h, d)
    kc, vc = _rnd(gen, b, L, hkv, d), _rnd(gen, b, L, hkv, d)
    pos = torch.arange(prefix, prefix + s, dtype=torch.int32, device="cuda")
    valid = torch.zeros(b, L, dtype=torch.bool, device="cuda")
    valid[:, :prefix + s - 3] = True
    valid[1, :300] = False
    valid[:, 700:760] = False
    return q, kc, vc, pos, valid


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,hkv,L,prefix,ps", [
    (16, 8, 2, 2048, 1500, 16),   # R = 64: one 64-row tile
    (64, 8, 2, 2048, 1500, 16),   # R = 256
    (256, 8, 2, 2048, 1500, 16),  # R = 1024: 16 row tiles; the suffix crosses 128-column tiles
    (300, 8, 2, 2048, 1500, 16),  # R = 1200: 19 row tiles, the last of 12 tokens
    (40, 16, 2, 2048, 1500, 16),  # group 8: 8 tokens a tile
    (50, 6, 2, 2048, 1500, 16),   # group 3: 21 tokens a tile, 63 rows
    (40, 2, 2, 2048, 1500, 16),   # group 1: 64 tokens a tile
    (64, 8, 2, 2000, 1900, 16),   # L not a multiple of 64: the last tile runs past the cache
    (64, 8, 2, 2048, 1500, 8),    # K5: eight pages a 64-column tile
    (64, 8, 2, 2048, 1500, 128),  # K5: half a page a tile
])
def test_flash_decode_kernels_take_many_rows(cuda, s, h, hkv, L, prefix, ps):
    """K4 and K5 above 32 rows per kv-head (group 4 at R = 64 to 1200; group
    8, 3 and 1; a cache whose last 64-column tile runs past L; K5 at page
    sizes 8, 16 and 128): the multi-row path against the plain versions,
    with a live prefix, left padding, a gap and a pad tail; two runs bitwise
    equal; K5 through a scrambled table bitwise equal to K4 on the gathered
    view; one counted launch a call."""
    q, kc, vc, pos, valid = _suffix_case(cuda, s, h, hkv, L=L, prefix=prefix)
    n4, n5 = tfd.flash_decode_fwd.launches, tfd.paged_flash_decode_fwd.launches
    got, lse = tfd.flash_decode_fwd(q, kc, vc, pos, valid)
    again, again_lse = tfd.flash_decode_fwd(q, kc, vc, pos, valid)
    assert tfd.flash_decode_fwd.launches == n4 + 2
    assert torch.equal(got, again) and torch.equal(lse, again_lse)
    want, wlse = tfd.flash_decode_plain(q, kc, vc, pos, valid)
    pv = tfd.flash_decode_plain(q, kc, vc.abs(), pos, valid)[0]
    _assert_out_close(got, want, pv, 2.0 ** -12)
    torch.testing.assert_close(lse, wlse, atol=5e-4, rtol=1e-4)
    kp, vp, bt = _paged_view(cuda, kc, vc, valid, ps)
    paged, paged_lse = tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    assert tfd.paged_flash_decode_fwd.launches == n5 + 1
    row, row_lse = tfd.flash_decode_fwd(q, tfd.paged_gather_leaf(kp, bt, ps),
                                        tfd.paged_gather_leaf(vp, bt, ps), pos, valid)
    assert torch.equal(paged, row) and torch.equal(paged_lse, row_lse)
    pwant, pwlse = tfd.paged_flash_decode_plain(q, kp, vp, bt, pos, valid, ps)
    ppv = tfd.paged_flash_decode_plain(q, kp, vp.abs(), bt, pos, valid, ps)[0]
    _assert_out_close(paged, pwant, ppv, 2.0 ** -12)
    torch.testing.assert_close(paged_lse, pwlse, atol=5e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_decode_kernels_do_not_spill(cuda):
    """``ptxas -v`` for csrc/flash_decode.cu: no decode kernel or merge
    spills to local memory."""
    from neuronx_distributed_tpu_torch.kernels import _build

    report = _build.resource_report("flash_decode")
    entries = [line for line in report.splitlines() if "Compiling entry function" in line]
    # K4, K5, K5q and K5q with the write at R <= 4, 8, 16, 32, the merges of
    # K4, K5 and K5q, and the multi-row kernels of K4 and K5
    # (flash_decode_kernel_rows, paged_flash_decode_kernel_rows)
    assert len(entries) == 21, report
    spills = [line for line in report.splitlines() if "spill" in line]
    assert len(spills) >= len(entries), report
    assert all("0 bytes spill stores, 0 bytes spill loads" in line for line in spills), report


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    n1 = tfa.flash_attention_fwd.launches
    q32 = torch.randn(1, 16, 4, 128, device="cuda")
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q32, q32[:, :, :2], q32[:, :, :2])
    q64 = _rnd(cuda, 1, 16, 4, 64)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q64, q64[:, :, :2], q64[:, :, :2])
    q = _rnd(cuda, 1, 16, 4, 128)
    kv = _rnd(cuda, 1, 16, 2, 128)
    with pytest.raises(ValueError):  # a head dim that is not unit-stride
        tfa.flash_attention_fwd(q.transpose(1, 3).contiguous().transpose(1, 3), kv, kv)
    with pytest.raises(ValueError):  # a row stride that is not a 16-byte multiple (TMA)
        tfa.flash_attention_fwd(_rnd(cuda, 1, 16, 4, 129)[..., :128], kv, kv)
    with pytest.raises(ValueError):  # a base that is not 16-byte aligned (TMA)
        tfa.flash_attention_fwd(_rnd(cuda, 1, 16, 4, 129)[..., 1:], kv, kv)
    with pytest.raises(ValueError):  # q heads not a multiple of kv heads
        tfa.flash_attention_fwd(_rnd(cuda, 1, 16, 5, 128), kv, kv)
    with pytest.raises(ValueError):  # kv segment ids without the query side
        tfa.flash_attention_fwd(q, kv, kv, True, None, torch.zeros(1, 16, dtype=torch.int32,
                                                                    device="cuda"))
    assert tfa.flash_attention_fwd.launches == n1  # nothing refused was counted
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
    with pytest.raises(ValueError):  # a group of 64 q-heads: more than the kernels take
        tfd.paged_flash_decode_fwd(_rnd(cuda, 3, 1, 128, 128), kp, vp, bt, pos, valid, 16)
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
    # the decode steps are graph replays: the wrapper ran for the capture's
    # warm-up, and each replay launches what the capture recorded
    prog = engine.decode_program
    assert tfd.flash_decode_fwd.launches - n4 == cfg.num_layers
    assert (prog.replays * prog.launches_per_replay["flash_decode"]
            == engine.metrics.executed_steps * cfg.num_layers)


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
        # every executed step is a replay of the graph captured (with the
        # patch in force, for the witness) at the first chunk; the wrappers
        # ran only for the capture's warm-up
        prog = engine.decode_program
        replayed = {name: prog.replays * n for name, n in prog.launches_per_replay.items()}
        warmup = (tfd.paged_flash_decode_fwd.launches - n5, tfd.flash_decode_fwd.launches - n4)
        if attention == "fused":
            assert (replayed.get("paged_flash_decode", 0), replayed.get("flash_decode", 0)) == (executed, 0)
            assert warmup == (cfg.num_layers, 0)
        else:
            assert (replayed.get("paged_flash_decode", 0), replayed.get("flash_decode", 0)) == (0, executed)
            assert warmup == (0, cfg.num_layers)
        assert all(len(r.tokens) == 12 and all(0 <= t < 1000 for t in r.tokens) for r in reqs)
        engine.cache.check()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_engine_decodes_through_one_captured_graph(cuda, monkeypatch, paged):
    """The engine's decode step is one CUDA graph, captured at the first
    chunk and replayed for every executed step, across an eager
    preemption; one replay launches one decode kernel per layer; the token
    streams equal the same engine's with the eager step patched in."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 1000, size=n) for n in (120, 40, 160)]
    news = (360, 40, 120)
    kw = dict(kv_page_size=16) if paged else {}
    wrapper = tfd.paged_flash_decode_fwd if paged else tfd.flash_decode_fwd
    name = "paged_flash_decode" if paged else "flash_decode"
    streams = []
    for eager in (False, True):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(DecodeProgram, "__call__", lambda self: self.step())
            engine = ServingEngine(model, num_slots=2, decode_chunk_size=8, admission="eager",
                                   **kw)
            reqs = [engine.submit(p, GenerationConfig(n, temperature=0.0), seed=i)
                    for i, (p, n) in enumerate(zip(prompts, news))]
            n0 = wrapper.launches
            engine.run()
        snap = engine.metrics.snapshot()
        assert snap["preemptions"] > 0
        assert [len(r.tokens) for r in reqs] == list(news)
        prog = engine.decode_program
        # resumes hit the prefix cache: each suffix prefill launches the
        # decode kernel once a layer, eagerly, outside the graph
        suffix = snap["prefill_suffix_count"] * cfg.num_layers
        if eager:
            assert engine.decode_compilations == 0 and prog.replays == 0
            assert wrapper.launches - n0 == snap["executed_steps"] * cfg.num_layers + suffix
        else:
            assert engine.decode_compilations == 1 == snap["decode_captures"]
            assert prog.replays == snap["executed_steps"] == snap["graph_replays"]
            assert prog.launches_per_replay == {name: cfg.num_layers}
            # the capture's warm-up, and the suffix prefills
            assert wrapper.launches - n0 == cfg.num_layers + suffix
            assert snap["capture_s"] > 0
        if paged:
            engine.cache.check()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_engine_prefix_hits_on_card_run_the_decode_kernels(cuda, monkeypatch, paged):
    """Shared-prompt traffic on the card (group 4, head_dim 128): one miss
    (K1) seeds the store, every hit prefills its tail through K4 (row) or
    K5 (paged) with R = 4 x chunk rows, 32 and above 32 (chunks 8, 64 and
    256), never through K1 or a plain version; a hit admitted between
    chunks leaves the decode program at one capture, and the streams equal
    the same engine's with the eager step patched in."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    cfg = LlamaConfig(vocab_size=1000, hidden_size=1024, intermediate_size=1024, num_layers=2,
                      num_heads=8, num_kv_heads=2, max_seq_len=1024)
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 1000, size=200)
    prompts = [np.concatenate([shared, rng.integers(1, 1000, size=n)]) for n in (20, 5, 60, 150)]
    kw = dict(kv_page_size=16) if paged else {}
    wrapper = tfd.paged_flash_decode_fwd if paged else tfd.flash_decode_fwd
    kernel = "_paged_kernel_call" if paged else "_kernel_call"
    for plain in ("flash_decode_plain", "paged_flash_decode_plain", "flash_attention_plain"):
        mod = tfa if plain == "flash_attention_plain" else tfd
        monkeypatch.setattr(mod, plain, lambda *a, **k: pytest.fail("a plain version ran"))
    streams = []
    for eager in (False, True):
        rows = []
        real = getattr(tfd, kernel)

        def recording(q, *a, **k):
            rows.append(q.shape[1] * q.shape[2] // a[0].shape[2])  # R = s x group
            return real(q, *a, **k)

        with monkeypatch.context() as m:
            m.setattr(tfd, kernel, recording)
            if eager:
                m.setattr(DecodeProgram, "__call__", lambda self: self.step())
            engine = ServingEngine(model, num_slots=3, decode_chunk_size=4, **kw)
            n1, nd = tfa.flash_attention_fwd.launches, wrapper.launches
            first = engine.submit(prompts[0], GenerationConfig(24, temperature=0.0), seed=0)
            engine.step()  # the miss: K1, then the first chunk (captured)
            reqs = [first] + [engine.submit(p, GenerationConfig(12, temperature=0.0), seed=i)
                              for i, p in enumerate(prompts[1:], 1)]
            engine.run()  # three hits between chunks
        snap = engine.metrics.snapshot()
        assert (snap["prefix_hits"], snap["prefix_misses"]) == (3, 1)
        assert snap["prefix_validation_failures"] == 0
        assert tfa.flash_attention_fwd.launches - n1 == cfg.num_layers  # the miss alone
        # s = 1 decode steps have R = 4; a paged match floors to 12 pages
        hits_r = sorted(set(r for r in rows if r != 4))
        assert hits_r == ([64, 512, 1024] if paged else [32, 256, 1024]), rows
        assert engine.decode_compilations == (0 if eager else 1)
        # the suffix prefills, and every step (eager) or the capture's warm-up
        decode = snap["executed_steps"] if eager else 1
        assert wrapper.launches - nd == (3 + decode) * cfg.num_layers
        if paged:
            assert engine.cache.alloc.copy_bytes == 0 and snap["prefix_pages_shared"] > 0
            engine.cache.check()
        assert all(len(r.tokens) == r.config.max_new_tokens for r in reqs)
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.cuda
def test_prewarm_captures_on_an_idle_engine(cuda):
    """``prewarm`` captures before any request (no trace: the streams equal
    an engine that captures at its first chunk), and a second engine of
    the same model captures its own graph."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 1000, size=n) for n in (9, 70, 33)]
    streams = []
    for prewarm in (True, False):
        engine = ServingEngine(model, num_slots=3, decode_chunk_size=4, kv_page_size=16)
        if prewarm:
            assert engine.prewarm() > 0 and engine.decode_compilations == 1
            assert engine.cache.cursor == 0 and int(engine.cache.cache.cursor) == 0
            assert engine.prewarm() == 0.0  # captured once
        reqs = [engine.submit(p, GenerationConfig(10, temperature=0.0), seed=i)
                for i, p in enumerate(prompts)]
        engine.run()
        assert engine.decode_compilations == 1
        engine.cache.check()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_spec_engine_rounds_through_one_captured_graph(cuda, monkeypatch, paged):
    """A speculative engine (an early-exit draft of the target's first
    layer, gamma 4) decodes through one CUDA graph of its draft-verify
    round, captured at the first chunk and replayed for every executed
    round across an eager preemption: one replay launches the draft's 1 x 4
    and the target's 2 decode kernels (K4, or K5 on the paged engine, and
    never the other); its streams equal the same engine's with the eager
    round patched in. (Not the spec-off engine's: the verify forward's
    GEMMs have another M than the plain step's, and cuBLAS may round them
    otherwise; the CPU tests hold that identity.)"""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        early_exit_draft,
        init_params,
    )
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    target, draft = early_exit_draft(init_params(LlamaForCausalLM(cfg), seed=0), 1, 0.3)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 1000, size=n) for n in (120, 40, 160)]
    gcfgs = [GenerationConfig(300, temperature=0.0), GenerationConfig(40, temperature=0.8,
                                                                      top_k=20),
             GenerationConfig(100, temperature=0.0)]
    kw = dict(kv_page_size=16) if paged else {}
    wrapper = tfd.paged_flash_decode_fwd if paged else tfd.flash_decode_fwd
    other = tfd.flash_decode_fwd if paged else tfd.paged_flash_decode_fwd
    name = "paged_flash_decode" if paged else "flash_decode"
    streams = []
    for eager in (False, True):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(DecodeProgram, "__call__", lambda self: self.step())
            engine = ServingEngine(target, num_slots=2, decode_chunk_size=8, admission="eager",
                                   prefix_cache=None, draft_model=draft, gamma=4, **kw)
            reqs = [engine.submit(p, g, seed=i) for i, (p, g) in enumerate(zip(prompts, gcfgs))]
            n0, o0, mr0 = wrapper.launches, other.launches, wrapper.multi_row_launches
            engine.run()
        snap = engine.metrics.snapshot()
        assert snap["preemptions"] > 0 and all(r.state.name == "DONE" for r in reqs)
        assert [len(r.tokens) for r in reqs] == [g.max_new_tokens for g in gcfgs]
        assert other.launches == o0 and wrapper.multi_row_launches == mr0
        prog = engine.decode_program
        if eager:
            assert engine.decode_compilations == 0 and prog.replays == 0
            assert wrapper.launches - n0 == snap["executed_steps"] * (4 + 2)
        else:
            assert engine.decode_compilations == 1 == snap["decode_captures"]
            assert prog.replays == snap["executed_steps"] == snap["graph_replays"]
            assert prog.launches_per_replay == {name: 1 * 4 + 2}
            assert wrapper.launches - n0 == 4 + 2  # the capture's warm-up
            assert snap["spec_rounds"] > 0 and 0.0 < snap["spec_accept_rate"] < 1.0
        if paged:
            engine.cache.check()
            engine.draft_cache.check()
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


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
def test_tree_decode_attention_on_card(cuda, b):
    """The Medusa verify's masked attention (torch ops: bf16 products with
    f32 sums, P as bf16 hi + lo) at the round's shapes (8 nodes, group 4,
    head_dim 128) against float64 on the same values, at K4's limits."""
    from neuronx_distributed_tpu_torch.modules.attention import tree_decode_attention

    s, L = 8, 2048
    q, k, v = _rnd(cuda, b, s, 32, 128), _rnd(cuda, b, L, 8, 128), _rnd(cuda, b, L, 8, 128)
    mask = torch.rand(s, L, generator=cuda, device="cuda") < 0.7
    valid = torch.rand(b, L, generator=cuda, device="cuda") < 0.9
    got = tree_decode_attention(q, k, v, mask, valid)
    ok = (mask[None] & valid[:, None])[:, None, None]
    scores = torch.einsum("bshgd,blhd->bhgsl", q.double().reshape(b, s, 8, 4, 128),
                          k.double()) / 128 ** 0.5
    p = torch.softmax(scores.masked_fill(~ok, -1e300), dim=-1)
    want = torch.einsum("bhgsl,blhd->bshgd", p, v.double()).reshape(b, s, 32, 128)
    pv = torch.einsum("bhgsl,blhd->bshgd", p, v.double().abs()).reshape(b, s, 32, 128)
    _assert_out_close(got, want, pv, 2.0 ** -12)


@pytest.mark.cuda
def test_medusa_round_is_one_captured_graph(cuda, monkeypatch):
    """Medusa tree decoding on the card at a small width (head_dim 128,
    4 heads trained a few steps on the base's own greedy text, so rounds
    accept chains): the round is captured once and replayed every round,
    one replay launches K4 once a layer (the tree verify is masked torch
    ops) and the prefill K1 once a layer; tokens and accepted lengths
    equal the eager round's bit for bit."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig, generate
    from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram
    from neuronx_distributed_tpu_torch.inference.medusa import MedusaStats, medusa_generate
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params
    from neuronx_distributed_tpu_torch.models.medusa import (
        MedusaForCausalLM,
        init_medusa_heads,
        medusa_head_loss,
    )
    from neuronx_distributed_tpu_torch.trainer.trainer import AdamW

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    base = init_params(LlamaForCausalLM(cfg), seed=0)
    model = init_medusa_heads(MedusaForCausalLM(cfg, 4, base=base, trainable=True), seed=1)
    ids = np.random.default_rng(2).integers(1, 1000, size=(2, 40))
    seq = torch.cat([torch.as_tensor(ids, device="cuda"),
                     generate(base, ids, GenerationConfig(80, temperature=0.0))], dim=1)
    heads = model.head_parameters()
    opt = AdamW(1e-3, weight_decay=0.0)
    state = opt.init(heads)
    for _ in range(20):
        loss = medusa_head_loss(model, seq, torch.roll(seq, -1, dims=1))
        opt.update(heads, torch.autograd.grad(loss, heads), state)
    runs = []
    for eager in (False, True):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(DecodeProgram, "__call__", lambda self: self.step())
            stats = MedusaStats()
            n1, n4 = tfa.flash_attention_fwd.launches, tfd.flash_decode_fwd.launches
            toks, acc = medusa_generate(model, ids, 64, stats=stats)
        prog, rounds = stats.program, len(stats.emitted)
        assert tfa.flash_attention_fwd.launches - n1 == cfg.num_layers
        if eager:
            assert prog.captures == prog.replays == 0
            assert tfd.flash_decode_fwd.launches - n4 == rounds * cfg.num_layers
        else:
            assert prog.captures == 1 and prog.replays == rounds
            assert prog.launches_per_replay == {"flash_decode": cfg.num_layers}
            assert tfd.flash_decode_fwd.launches - n4 == cfg.num_layers  # the warm-up
        assert toks.shape == (2, 64) and 0 <= int(toks.min()) and int(toks.max()) < 1000
        runs.append((toks.cpu(), stats.accept_lens, acc))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1:] == runs[1][1:]
    assert max(max(a) for a in runs[0][1]) >= 1, runs[0][1]


def _qpaged_case(gen, s, ps):
    """``_paged_case`` with its pools quantized to int8 pages and bf16
    scales a (page, kv-head) (``quantize_page_block``): the null page's
    codes and scales are garbage too."""
    q, kp, vp, bt, pos, valid = _paged_case(gen, s, ps)
    kq, ks = tfd.quantize_page_block(kp)
    vq, vs = tfd.quantize_page_block(vp)
    return q, kq, vq, ks, vs, bt, pos, valid


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("s", [1, 2, 8])
def test_qpaged_kernel_equals_k4_on_the_dequantized_view(cuda, s, ps):
    """K5q (int8 pages, bf16 scales) through a scrambled table: within K5's
    limits of its plain version (a dropped 128-column tile is not), equal
    bit for bit to K4 on the dequantized gathered view, blind to the null
    page, the same bits twice; one launch counted."""
    q, kq, vq, ks, vs, bt, pos, valid = _qpaged_case(cuda, s, ps)
    n, n5 = tfd.qpaged_flash_decode_fwd.launches, tfd.paged_flash_decode_fwd.launches
    got, lse = tfd.paged_flash_decode_fwd(q, kq, vq, bt, pos, valid, ps, ks, vs)
    assert tfd.qpaged_flash_decode_fwd.launches == n + 1
    assert tfd.paged_flash_decode_fwd.launches == n5  # K5's counter is K5's alone
    want, wlse = tfd.paged_flash_decode_plain_q(q, kq, vq, ks, vs, bt, pos, valid, ps)
    pv = tfd.paged_flash_decode_plain_q(q, kq, vq.abs(), ks, vs, bt, pos, valid, ps)[0]
    _assert_out_close(got, want, pv, 2.0 ** -12)
    torch.testing.assert_close(lse, wlse, atol=5e-4, rtol=1e-4)
    cut = valid.clone()
    bound = int(pos.max()) + 1
    cut[:, (bound - 1) // 128 * 128:bound] = False
    fault = tfd.paged_flash_decode_plain_q(q, kq, vq, ks, vs, bt, pos, cut, ps)[0]
    with pytest.raises(AssertionError):
        _assert_out_close(fault, want, pv, 2.0 ** -12)
    kg = tfd.paged_gather_leaf_dequant(kq, ks, bt, ps)
    vg = tfd.paged_gather_leaf_dequant(vq, vs, bt, ps)
    row, row_lse = tfd.flash_decode_fwd(q, kg, vg, pos, valid)
    assert torch.equal(got, row) and torch.equal(lse, row_lse)
    kq[0].random_(-127, 128, generator=cuda)
    ks[0].normal_(generator=cuda)
    vs[0].fill_(-1e4)
    again, again_lse = tfd.paged_flash_decode_fwd(q, kq, vq, bt, pos, valid, ps, ks, vs)
    assert torch.equal(got, again) and torch.equal(lse, again_lse)


@pytest.mark.cuda
def test_qpaged_wrapper_refuses_what_k5q_does_not_take(cuda):
    q, kq, vq, ks, vs, bt, pos, valid = _qpaged_case(cuda, 1, 16)
    n = tfd.qpaged_flash_decode_fwd.launches
    with pytest.raises(ValueError):  # f32 scales
        tfd.paged_flash_decode_fwd(q, kq, vq, bt, pos, valid, 16, ks.float(), vs.float())
    with pytest.raises(TypeError):  # bf16 pools with scales
        tfd.paged_flash_decode_fwd(q, kq.bfloat16(), vq.bfloat16(), bt, pos, valid, 16, ks, vs)
    with pytest.raises(ValueError):  # 64 rows a kv-head: no multi-row K5q
        tfd.paged_flash_decode_fwd(_rnd(cuda, 3, 16, 8, 128), kq, vq, bt,
                                   torch.arange(300, 316, dtype=torch.int32, device="cuda"),
                                   valid, 16, ks, vs)
    assert tfd.qpaged_flash_decode_fwd.launches == n


@pytest.mark.cuda
def test_qpaged_kernel_over_more_items_than_blocks_and_a_dead_slot(cuda):
    """K5q at 64 slots (L = 8192, bound 3109: 13 ranges x 64 slots x 8
    kv-heads, more blocks than the card holds at once) with slot 5 holding
    no live column: equal bit for bit to K4 on the dequantized gathered
    view (slot 5's rows O = 0, LSE -1e30); captured in a CUDA graph and
    replayed three times in a row, the same bits each time."""
    b, h, hkv, ps, L, bound = 64, 32, 8, 16, 8192, 3109
    n_log, used = L // ps, -(-bound // ps)
    n_pages = b * used + 1
    rng = np.random.default_rng(64)
    table = np.zeros((b, n_log), np.int32)
    table[:, :used] = rng.permutation(np.arange(1, n_pages)).reshape(b, used)
    kq, ks = tfd.quantize_page_block(_rnd(cuda, n_pages, ps, hkv, 128))
    vq, vs = tfd.quantize_page_block(_rnd(cuda, n_pages, ps, hkv, 128))
    bt = torch.from_numpy(table).cuda()
    q = _rnd(cuda, b, 1, h, 128)
    pos = torch.tensor([bound - 1], dtype=torch.int32, device="cuda")
    valid = torch.rand(b, L, generator=cuda, device="cuda") > 0.1
    valid[:, bound:] = False
    valid[5] = False
    run = lambda: tfd.paged_flash_decode_fwd(q, kq, vq, bt, pos, valid, ps, ks, vs)  # noqa: E731
    n = tfd.qpaged_flash_decode_fwd.launches
    got, lse = run()
    assert tfd.qpaged_flash_decode_fwd.launches == n + 1
    row, row_lse = tfd.flash_decode_fwd(q, tfd.paged_gather_leaf_dequant(kq, ks, bt, ps),
                                        tfd.paged_gather_leaf_dequant(vq, vs, bt, ps), pos, valid)
    assert torch.equal(got, row) and torch.equal(lse, row_lse)
    assert not got[5].any() and bool((lse[5] == -1e30).all())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out, g_lse = run()
    for _ in range(3):
        g_out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_out, got) and torch.equal(g_lse, lse)


def _qw_case(gen, s, col, b=4, hkv=8, n_log=32, ps=16):
    """An int8 pool (bf16 scales) behind a scrambled table whose row 3 maps
    only its first 20 logical pages, the slots' view at column ``col`` with
    ``s`` columns addressed, and new rows k, v: row 0's 50x (its page's
    absmax rises); the pool rows under row 1's columns 50x before they are
    quantized (its page's absmax falls)."""
    from neuronx_distributed_tpu_torch.modules.attention import PagedKVCache

    n_pages = b * n_log + 1
    cache = PagedKVCache.allocate(1, b, n_log * ps, hkv, 128, torch.bfloat16, "cuda", n_pages,
                                  ps, kv_quant="int8")
    table = np.random.default_rng(s + col).permutation(np.arange(1, n_pages)).reshape(b, n_log)
    table = table.astype(np.int32)
    table[3, 20:] = 0
    for pool, scale in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
        x = torch.randn(n_pages, ps, hkv, 128, generator=gen, device="cuda")
        for c in range(col, col + s):
            x[table[1, c // ps], c % ps] *= 50.0
        q, sc = tfd.quantize_page_block(x.to(torch.bfloat16))
        pool[0].copy_(q)
        scale[0].copy_(sc)
    cache.upload_table(table)
    view = cache.view(slice(None), col)
    view._address(view._cols[:s])
    k, v = _rnd(gen, b, s, hkv, 128), _rnd(gen, b, s, hkv, 128)
    k[0].mul_(50.0)
    v[0].mul_(50.0)
    return cache, view, table, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("s,col", [(1, 37), (300, 45), (17, 495)])
def test_window_requantize_kernel_equals_plain(cuda, s, col):
    """QW writes an int8 pool's window (a decode step mid-page, a 300-token
    prefill window from mid-page, a window past the table's end) equal bit
    for bit to its plain version on every page but the null page, K and V
    in one launch; row 0's page scale rises and row 1's falls."""
    from neuronx_distributed_tpu_torch.kernels import kv_quant as tkq

    cache, view, table, k, v = _qw_case(cuda, s, col)
    pages, w0 = view._win
    want = [t[0].clone() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)]
    before = [t.clone() for t in want]
    tkq.window_requantize_plain(*want, pages, w0, k, v)
    n = tkq.window_requantize_fwd.launches
    view.decode_write(0, k, v)
    assert tkq.window_requantize_fwd.launches == n + 1
    for got, w in zip((cache.k[0], cache.v[0], cache.k_scale[0], cache.v_scale[0]), want):
        assert torch.equal(got[1:], w[1:])
    ks, ks0 = cache.k_scale[0].float(), before[2].float()
    p0, p1 = int(table[0, col // 16]), int(table[1, col // 16])
    assert bool((ks[p0] > 2 * ks0[p0]).all()) and bool((ks[p1] < 0.5 * ks0[p1]).all())
    with pytest.raises(TypeError):  # f32 rows
        tkq.window_requantize_fwd(cache.k[0], cache.v[0], cache.k_scale[0], cache.v_scale[0],
                                  pages, w0, k.float(), v.float())
    assert tkq.window_requantize_fwd.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("s,col", [(1, 37), (4, 253), (4, 318)])
def test_qpaged_write_attend_kernel_equals_qw_then_k5q(cuda, s, col):
    """K5q with the write (a decode step mid-page; a verify window across a
    page and a 256-column range; row 3's window past its mapped pages, into
    the null page) equals QW then K5q: pools and scales bit for bit on
    every page but the null page, out and lse bit for bit; one launch
    counted, in its own count and K5q's, none in QW's; f32 rows refused."""
    from neuronx_distributed_tpu_torch.kernels import kv_quant as tkq

    cache, view, table, k, v = _qw_case(cuda, s, col)
    b, L = cache.valid.shape
    leaves = (cache.k[0], cache.v[0], cache.k_scale[0], cache.v_scale[0])
    mapped = torch.from_numpy(np.repeat(table, 16, axis=1) != 0).cuda()
    valid = (torch.rand(b, L, generator=cuda, device="cuda") > 0.1) & mapped
    valid[:, col + s:] = False
    pos = torch.arange(col, col + s, dtype=torch.int32, device="cuda")
    q = _rnd(cuda, b, s, 32, 128)
    base = [t.clone() for t in leaves]
    view.decode_write(0, k, v)
    want_out, want_lse = tfd.qpaged_flash_decode_fwd(q, *leaves, cache.block_table, pos, valid, 16)
    want = [t.clone() for t in leaves]
    for t, x in zip(leaves, base):
        t.copy_(x)
    n, nq, nw = (tfd.qpaged_write_attend_fwd.launches, tfd.qpaged_flash_decode_fwd.launches,
                 tkq.window_requantize_fwd.launches)
    out, lse = tfd.qpaged_write_attend_fwd(q, k, v, *leaves, cache.block_table, pos, valid,
                                           view._c0, 16)
    torch.cuda.synchronize()
    assert (tfd.qpaged_write_attend_fwd.launches - n, tfd.qpaged_flash_decode_fwd.launches - nq,
            tkq.window_requantize_fwd.launches - nw) == (1, 1, 0)
    for got, w in zip(leaves, want):
        assert torch.equal(got[1:], w[1:])
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    with pytest.raises(TypeError):  # f32 rows
        tfd.qpaged_write_attend_fwd(q, k.float(), v.float(), *leaves, cache.block_table, pos,
                                    valid, view._c0, 16)
    assert tfd.qpaged_write_attend_fwd.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("per_tensor", [False, True])
def test_dequantize_kernel_equals_plain(cuda, fp8, per_tensor):
    """DQ turns int8 / fp8 e4m3 codes and f32 scales into the bf16 weight
    bit for bit as ``(q.float() * scale).to(bf16)``; one launch counted."""
    from neuronx_distributed_tpu_torch.kernels import dequantize as tdq

    w = torch.randn(1000, 4096, generator=cuda, device="cuda") * 0.05
    qdt = torch.float8_e4m3fn if fp8 else torch.int8
    bound = 448.0 if fp8 else 127.0
    scale = (w.abs().amax() if per_tensor else w.abs().amax(1)) / bound
    scaled = (w / (scale if per_tensor else scale[:, None])).clamp(-bound, bound)
    q = scaled.to(qdt) if fp8 else scaled.round().to(qdt)
    n = tdq.dequantize_fwd.launches
    got = tdq.dequantize_fwd(q, scale, torch.bfloat16)
    assert tdq.dequantize_fwd.launches == n + 1
    assert torch.equal(got, tdq.dequantize_plain(q, scale if per_tensor else scale[:, None],
                                                 torch.bfloat16))
    with pytest.raises(TypeError):
        tdq.dequantize_fwd(q, scale, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"])
def test_quantized_engine_decodes_through_one_captured_graph(cuda, monkeypatch, kv):
    """A small bf16 Llama (head_dim 128) behind a quantized engine: int8
    weights on the row engine, int8 weights and an int8 pool (K5q with the
    write) on the paged one. One capture, replays = executed steps, one
    replay launches the decode kernel once a layer (on the int8 pool K5q
    with the write, counted in K5q's launches too, and no QW) and DQ once a
    linear; the streams equal
    the same engine's with the eager step patched in, and every request
    finishes (an eager preemption on the way)."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 1000, size=n) for n in (120, 40, 160)]
    news = (360, 40, 120)
    kw = dict(kv_page_size=16) if kv else {}
    name = "qpaged_flash_decode" if kv else "flash_decode"
    streams = []
    for eager in (False, True):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(DecodeProgram, "__call__", lambda self: self.step())
            engine = ServingEngine(model, num_slots=2, decode_chunk_size=8, admission="eager",
                                   quantize=QuantConfig(weights="int8", kv=kv), **kw)
            reqs = [engine.submit(p, GenerationConfig(n, temperature=0.0), seed=i)
                    for i, (p, n) in enumerate(zip(prompts, news))]
            engine.run()
        snap = engine.metrics.snapshot()
        assert snap["preemptions"] > 0
        assert [len(r.tokens) for r in reqs] == list(news)
        prog = engine.decode_program
        if not eager:
            assert engine.decode_compilations == 1 and prog.replays == snap["executed_steps"]
            want = {name: cfg.num_layers, "dequantize": 7 * cfg.num_layers + 1}
            if kv:
                want["qpaged_write_attend"] = cfg.num_layers
            assert prog.launches_per_replay == want
        if kv:
            engine.cache.check()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


def _pf_pools(gen, dtype, layers=4, pages=40, ps=16, hkv=8, d=128, scales=False):
    """A pool (layers, pages, ps, hkv, d) of ``dtype`` (K and V) and, for an
    int8 pool, bf16 scales (layers, pages, 1, hkv, 1)."""
    shape = (layers, pages, ps, hkv, d)
    if dtype == torch.int8:
        leaves = [torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                dtype=torch.int8) for _ in range(2)]
    else:
        leaves = [torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(2)]
    if scales:
        s = [torch.rand(layers, pages, 1, hkv, 1, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2)]
        leaves = [leaves[0], s[0], leaves[1], s[1]]
    return leaves


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,scales,hkv", [(torch.bfloat16, False, 8), (torch.float32, False, 8),
                                             (torch.int8, True, 8), (torch.int8, True, 3)],
                         ids=["bf16", "f32", "int8", "int8_hkv3"])
def test_page_fingerprint_kernel_equals_plain(cuda, dtype, scales, hkv):
    """PF over 12 layers (the sorted-key order: layers_10 before layers_2)
    at scrambled page ids with repeats equals its plain version bit for bit
    (scale pages of 3 heads take the kernel's scalar path); one launch
    counted; flipping one bit of one page moves that page's value alone."""
    from neuronx_distributed_tpu_torch.kernels import page_fingerprint as tpf
    from neuronx_distributed_tpu_torch.utils.fingerprint import jax_layer_order

    leaves = _pf_pools(cuda, dtype, layers=12, hkv=hkv, scales=scales)
    ids = torch.tensor([31, 2, 17, 17, 39, 0, 5, 2, 22], device="cuda")
    order = jax_layer_order(12)
    n = tpf.pool_pages_fingerprint_fwd.launches
    got = tpf.pool_pages_fingerprint_fwd(leaves, ids, order)
    assert tpf.pool_pages_fingerprint_fwd.launches == n + 1
    want = tpf.pool_pages_fingerprint_plain(leaves, ids, order)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert torch.equal(got, tpf.pool_pages_fingerprint_fwd(leaves, ids, order))
    leaves[-1].view(torch.uint8)[10, 17].reshape(-1)[1] ^= 4
    moved = tpf.pool_pages_fingerprint_fwd(leaves, ids, order) != got
    assert moved.tolist() == [i in (2, 3) for i in range(len(ids))]


@pytest.mark.cuda
def test_page_fingerprint_wrapper_refuses_what_pf_does_not_take(cuda):
    """The wrapper raises (no plain fallback, no launch counted) on a
    non-contiguous leaf, int32 ids, CPU ids beside CUDA leaves, 8-byte
    elements and an order that is not a permutation."""
    from neuronx_distributed_tpu_torch.kernels import page_fingerprint as tpf

    leaves = _pf_pools(cuda, torch.bfloat16, layers=2, pages=4)
    ids = torch.tensor([1, 2], device="cuda")
    n = tpf.pool_pages_fingerprint_fwd.launches
    for bad in ([leaves[0].transpose(3, 4), leaves[1]], [leaves[0].double(), leaves[1]]):
        with pytest.raises(ValueError):
            tpf.pool_pages_fingerprint_fwd(bad, ids, (0, 1))
    with pytest.raises(ValueError):
        tpf.pool_pages_fingerprint_fwd(leaves, ids.int(), (0, 1))
    with pytest.raises(ValueError):
        tpf.pool_pages_fingerprint_fwd(leaves, ids, (0, 0))
    with pytest.raises(ValueError):
        tpf._kernel_call(leaves, ids.cpu(), (0, 1))
    assert tpf.pool_pages_fingerprint_fwd.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_engine_faults_on_card_keep_one_captured_graph(cuda, paged):
    """A small bf16 Llama (head_dim 128) on the card under a fault schedule:
    a dispatch failure before the chunk, one after its steps ran, a
    poisoned readback and (paged) a flipped pool bit at a prefix hit. One
    capture throughout, every buffer the graph reads at its address, the
    counters equal to the schedule, every request done; paged: PF once an
    insert and once a hit, ``check()`` clean."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.kernels import page_fingerprint as tpf
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params
    from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.faults import FaultInjector

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    rng = np.random.default_rng(2)
    shared = rng.integers(1, 1000, size=64)
    prompts = [np.concatenate([shared, rng.integers(1, 1000, size=n)]) for n in (5, 30, 12)]
    inj = (FaultInjector().fail_dispatch(at=1).poison_readback(at=3, slot=0, token=-5)
           .flip_bits("kv_pool", at=0))
    kw = dict(kv_page_size=16) if paged else {}
    engine = ServingEngine(model, num_slots=2, decode_chunk_size=4, fault_injector=inj,
                           sleep_fn=lambda s: None, prefix_cache=PrefixCache(min_match=16), **kw)
    c = engine.cache.cache
    ptrs = [t.data_ptr() for t in (c.k, c.v, c.valid, c.cursor, *engine._state.values())]
    pf = tpf.pool_pages_fingerprint_fwd.launches
    reqs = [engine.submit(p, GenerationConfig(24, temperature=0.0), seed=i)
            for i, p in enumerate(prompts)]
    engine.step()
    engine.step()  # the injected failure before the chunk
    real = engine._chunk

    class StepsThenFail:
        def __getattr__(self, name):
            return getattr(real, name)

        def __call__(self):
            real()
            raise RuntimeError("fault after the steps ran")

    engine._chunk = StepsThenFail()
    engine.step()
    engine._chunk = real
    while engine.has_work:
        engine.step()
        if paged:
            engine.cache.check()
    snap = engine.metrics.snapshot()
    assert all(r.state.value == "done" and len(r.tokens) == 24 for r in reqs)
    assert engine.decode_compilations == 1
    assert ptrs == [t.data_ptr() for t in (c.k, c.v, c.valid, c.cursor, *engine._state.values())]
    assert (snap["dispatch_retries"], snap["recoveries"], snap["quarantines"]) == (2, 2, 1)
    assert inj.counters["poisoned_readbacks"] == 1
    if paged:
        assert inj.counters["bit_flips"] == (1 if snap["prefix_validation_failures"] else 0)
        hits = snap["prefix_hits"] + snap["prefix_validation_failures"]
        inserts = tpf.pool_pages_fingerprint_fwd.launches - pf - hits
        assert hits >= 1 and inserts >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_slo_engine_on_card_preempts_on_one_captured_graph(cuda, monkeypatch, paged):
    """The SLO policy on the card (a small bf16 Llama, head_dim 128): a
    pressured chat arrival behind two docs requests makes the policy vacate
    one docs slot mid-generation; the decode step stays one capture on its
    buffers, the victim resumes (K1 re-prefills it) and every greedy token
    lies within phase 3's limit (5e-2 of the logit scale) of its row's
    maximum logit in a teacher-forced pass; the eager step's streams equal
    the graph's bit for bit; host reads = chunks + first tokens."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params
    from neuronx_distributed_tpu_torch.observability.slo import SLOSpec
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.sched import FeedbackConfig, SloPolicy

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    rng = np.random.default_rng(3)
    prompts = {n: rng.integers(1, 1000, size=k) for n, k in
               (("chat_a", 20), ("docs_a", 90), ("docs_b", 70), ("chat_b", 30))}
    news = {"chat_a": 8, "docs_a": 48, "docs_b": 48, "chat_b": 8}
    kw = dict(kv_page_size=16) if paged else {}
    wrapper = tfd.paged_flash_decode_fwd if paged else tfd.flash_decode_fwd
    streams = []
    for eager in (False, True):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(DecodeProgram, "__call__", lambda self: self.step())
            engine = ServingEngine(
                model, num_slots=2, decode_chunk_size=4, prefix_cache=None, **kw,
                scheduling=SloPolicy(feedback=FeedbackConfig(min_decided=1, cooldown_s=0.0,
                                                             min_victim_remaining=1)),
                slo={"chat": SLOSpec(ttft_p99_s=1e-9), "docs": SLOSpec(ttft_p99_s=1e6)})
            reqs = {}

            def sub(name, tenant, prio):
                reqs[name] = engine.submit(prompts[name], GenerationConfig(news[name],
                                                                           temperature=0.0),
                                           seed=len(reqs), tenant=tenant, priority=prio)

            sub("chat_a", "chat", "interactive")
            while not reqs["chat_a"].finished:
                engine.step()
            sub("docs_a", "docs", "batch")
            sub("docs_b", "docs", "batch")
            engine.step()
            sub("chat_b", "chat", "interactive")
            k1, k5 = tfa.flash_attention_fwd.launches, wrapper.launches
            while engine.has_work:
                engine.step()
                if paged:
                    engine.cache.check()
        snap = engine.metrics.snapshot()
        assert snap["preemptions"] >= 1 and engine.policy.preemptions_requested >= 1
        victims = [n for n, r in reqs.items() if r.preemptions]
        assert victims and all(n.startswith("docs") for n in victims)
        assert all(len(r.tokens) == news[n] for n, r in reqs.items())
        assert tfa.flash_attention_fwd.launches - k1 >= 2 * cfg.num_layers  # chat_b + a resume
        if not eager:
            assert engine.decode_compilations == 1 == snap["decode_captures"]
            assert engine.decode_program.launches_per_replay == {
                "paged_flash_decode" if paged else "flash_decode": cfg.num_layers}
            assert wrapper.launches == k5  # every decode step a graph replay
        assert engine.host_reads == snap["chunks"] + len(reqs)
        streams.append({n: list(r.tokens) for n, r in reqs.items()})
    assert streams[0] == streams[1]
    with torch.no_grad():
        for name, toks in streams[0].items():
            ids = torch.tensor(np.concatenate([prompts[name], toks[:-1]])[None], device="cuda")
            logits = model.lm_head(model.model(ids, mode="train")[:, len(prompts[name]) - 1:])
            logits = logits.float()[0]
            emitted = torch.tensor(toks, device="cuda")[:, None]
            gap = logits.max(-1).values - logits.gather(-1, emitted)[:, 0]
            assert float((gap / (5e-2 * logits.abs().max())).max()) <= 1.0, name


def _tier_pool(gen, n_pages, int8, layers=2, hkv=8, ps=16, max_seq_len=8192):
    """A page manager over a pool on the card filled with random K/V (int8
    codes with bf16 scales, or bf16), every page but the null page live
    content; the manager owns no slot yet."""
    from neuronx_distributed_tpu_torch.modules.attention import PagedKVCache
    from neuronx_distributed_tpu_torch.serving.paging import PagedCacheManager

    mgr = PagedCacheManager(1, max_seq_len, ps, num_pages=n_pages)
    mgr.cache = PagedKVCache.allocate(layers, 1, max_seq_len, hkv, 128, torch.bfloat16, "cuda",
                                      n_pages, ps, "int8" if int8 else None)
    c = mgr.cache
    if int8:
        for t in (c.k, c.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device="cuda"))
        for t in (c.k_scale, c.v_scale):
            t.copy_(torch.rand(t.shape, generator=gen, device="cuda") + 0.01)
    else:
        c.k.copy_(_rnd(gen, *c.k.shape))
        c.v.copy_(_rnd(gen, *c.v.shape))
    return mgr


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_tier_spill_then_prefetch_round_trips_pages_bitwise(cuda, int8):
    """A scrambled set of pinned pool pages spilled to a pinned host store
    (CRC-checked) and prefetched into other pages: every leaf, codes and
    scales on an int8 pool, bit for bit, and PF over the new pages equals
    PF over the old."""
    from neuronx_distributed_tpu_torch.serving.tiering import HostPageStore
    from neuronx_distributed_tpu_torch.utils.fingerprint import pool_leaves, pool_pages_fingerprint

    mgr = _tier_pool(cuda, 64, int8)
    ids = [int(p) for p in np.random.default_rng(8).permutation(np.arange(1, 64))[:20]]
    mgr.alloc._free = [p for p in mgr.alloc._free if p not in ids]
    for pid in ids:
        mgr.alloc._refs[pid] = 1
        mgr._pins[pid] = 1
    want = [t[:, ids].clone() for t in pool_leaves(mgr.cache)]
    fp = pool_pages_fingerprint(mgr.cache, ids)
    store = HostPageStore(32, layout=mgr.page_layout(), pin_memory=True)
    assert store.arena.is_pinned()
    items, nbytes = mgr.spill_pages(ids)
    hids = store.put(ids, items)
    assert nbytes == store.nbytes == len(ids) * mgr.page_nbytes and store.verify(hids)
    mgr.unpin_pages(ids)
    for t in pool_leaves(mgr.cache):  # what a freed page may hold next
        t[:, ids] = 0
    rows, _ = store.fetch(hids)
    new, done = mgr.prefetch_pages(rows, len(ids))
    store.drop(hids, after=done)
    mgr.sync_tier(new)
    assert done is not None and not set(new) & {0}
    for t, w in zip(pool_leaves(mgr.cache), want):
        assert torch.equal(t[:, new], w)
    assert torch.equal(pool_pages_fingerprint(mgr.cache, new), fp)
    mgr.check()
    store.check()


@pytest.mark.cuda
def test_tier_prefetch_then_k5_without_host_sync(cuda):
    """K5 through freshly prefetched pages right after the prefetch, with no
    host sync between (the main stream waits for the copy's event on the
    device, as the engine's mapping does), equals the same call after
    ``torch.cuda.synchronize()``, bit for bit; a long prefetch (512 pages)
    over pages holding other bytes makes a missing wait show."""
    from neuronx_distributed_tpu_torch.serving.tiering import HostPageStore

    n = 512
    mgr = _tier_pool(cuda, n + 1, False)
    ids = list(range(1, n + 1))
    mgr.alloc._free = []
    for pid in ids:
        mgr.alloc._refs[pid] = 1
        mgr._pins[pid] = 1
    store = HostPageStore(n, layout=mgr.page_layout(), pin_memory=True)
    hids = store.put(ids, mgr.spill_pages(ids)[0])
    mgr.unpin_pages(ids)
    c = mgr.cache
    c.k.mul_(-3.0)  # the pages' next content differs from the stored one
    c.v.mul_(7.0)
    q = _rnd(cuda, 1, 1, 32, 128)
    pos = torch.tensor([n * 16 - 1], dtype=torch.int32, device="cuda")
    valid = torch.ones(1, n * 16, dtype=torch.bool, device="cuda")
    rows, _ = store.fetch(hids)
    new, done = mgr.prefetch_pages(rows, n)
    table = torch.tensor([new], dtype=torch.int32, device="cuda")
    mgr.sync_tier(new)  # a device-side wait, no host sync
    early = tfd.paged_flash_decode_fwd(q, c.k[1], c.v[1], table, pos, valid, 16)
    torch.cuda.synchronize()
    late = tfd.paged_flash_decode_fwd(q, c.k[1], c.v[1], table, pos, valid, 16)
    assert torch.equal(early[0], late[0]) and torch.equal(early[1], late[1])
    store.drop(hids, after=done)


@pytest.mark.cuda
def test_tier_arena_rows_not_reused_while_a_prefetch_copies_them(cuda):
    """A prefetch's arena rows are fenced by its copy's event: a ``put``
    issued while the copy is still in flight (held back on the tier stream
    here) waits for it instead of overwriting the rows, so the prefetched
    pages hold the first pages' bytes, never the second's."""
    from neuronx_distributed_tpu_torch.serving.tiering import HostPageStore
    from neuronx_distributed_tpu_torch.utils.fingerprint import pool_leaves

    mgr = _tier_pool(cuda, 64, False)
    first, second = list(range(1, 9)), list(range(9, 17))
    mgr.alloc._free = [p for p in mgr.alloc._free if p > 16]
    for pid in first + second:
        mgr.alloc._refs[pid] = 1
        mgr._pins[pid] = 1
    want = [t[:, first].clone() for t in pool_leaves(mgr.cache)]
    store = HostPageStore(8, layout=mgr.page_layout(), pin_memory=True)
    hids = store.put(first, mgr.spill_pages(first)[0])
    mgr.unpin_pages(first)
    mgr._tier_stream = torch.cuda.Stream()
    with torch.cuda.stream(mgr._tier_stream):
        torch.cuda._sleep(200_000_000)  # hold the copy back ~0.1 s
    rows, _ = store.fetch(hids)
    new, done = mgr.prefetch_pages(rows, len(first))
    store.drop(hids, after=done)
    assert not done.query() and len(store._fenced) == 1
    store.put(second, mgr.spill_pages(second)[0])  # needs the fenced rows
    assert done.query() and not store._fenced
    mgr.sync_tier(new)
    for t, w in zip(pool_leaves(mgr.cache), want):
        assert torch.equal(t[:, new], w)
    store.check()


@pytest.mark.cuda
def test_tiered_engine_pins_its_arena_once_and_never_in_a_capture(cuda, monkeypatch):
    """A small bf16 Llama's paged engine with a host tier on the card: the
    pinned arena is allocated at construction and never again (no pinned
    allocation while the engine serves, none during the capture), one
    capture, spills and host-tier prefetches on JAX's tiered workload
    (four prefixes of two pages, waves 0,1,2,3,0,1, a pool of 8 usable
    pages), and streams equal a control whose pool holds the whole working
    set, bit for bit; both tiers ``check()`` clean after every step."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params
    from neuronx_distributed_tpu_torch.serving.cache_manager import PrefixCache
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    model = init_params(LlamaForCausalLM(cfg), seed=0)
    rng = np.random.default_rng(4)
    prefixes = [rng.integers(1, 1000, size=33) for _ in range(4)]
    prompts = [np.concatenate([prefixes[w], rng.integers(1, 1000, size=4)])
               for w in (0, 1, 2, 3, 0, 1)]
    pinned = []
    real_empty = torch.empty

    def empty(*a, **kw):
        if kw.get("pin_memory"):
            pinned.append(torch.cuda.is_current_stream_capturing())
        return real_empty(*a, **kw)

    def serve(**kw):
        engine = ServingEngine(model, num_slots=2, decode_chunk_size=4, kv_page_size=16,
                               admission="eager", prefix_cache=PrefixCache(min_match=16), **kw)
        arena = engine.tier.arena.data_ptr() if engine.tier is not None else None
        monkeypatch.setattr(torch, "empty", empty)
        monkeypatch.setattr(torch.Tensor, "pin_memory",
                            lambda self, *a: pytest.fail("pin_memory on the serving path"))
        toks = []
        for i, p in enumerate(prompts):
            r = engine.submit(p, GenerationConfig(8, temperature=0.0), seed=i)
            while engine.has_work:
                engine.step()
                engine.cache.check()
                if engine.tier is not None:
                    engine.tier.check()
            toks.append(list(r.tokens))
        monkeypatch.undo()
        if arena is not None:
            assert engine.tier.arena.data_ptr() == arena
        assert engine.decode_compilations == 1
        return engine, toks

    tiered, toks = serve(kv_num_pages=9, kv_host_pages=16)
    control, want = serve(kv_num_pages=65)
    assert pinned == []
    snap = tiered.metrics.snapshot()
    assert snap["kv_pages_spilled"] >= 4 and snap["kv_pages_prefetched"] >= 4
    assert snap["prefix_hit_tier"].get("host", 0) == snap["prefix_hits"] >= 2
    assert control.metrics.snapshot()["prefix_hit_tier"] == {"device": snap["prefix_hits"]}
    assert toks == want
    assert tiered.cache.alloc.copy_bytes == 0


def _small_llama(seed=0):
    """A small bf16 Llama (head_dim 128) on the card."""
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_params

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    return init_params(LlamaForCausalLM(cfg), seed=seed)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_weight_swap_on_card_keeps_addresses_and_the_capture(cuda, paged):
    """``engine.params = W1`` between two waves on the card: every
    parameter at its address, one capture, the store empty and (paged) no
    page referenced; the replayed step reads the new weights: the second
    wave's streams differ from the first's and equal a fresh engine's on a
    model holding W1."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    model, w1 = _small_llama(0), _small_llama(1).state_dict()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 1000, size=n) for n in (70, 20, 45)]
    kw = dict(kv_page_size=16) if paged else {}

    def wave(engine):
        reqs = [engine.submit(p, GenerationConfig(16, temperature=0.0), seed=i)
                for i, p in enumerate(prompts)]
        engine.run()
        return [r.tokens for r in reqs]

    engine = ServingEngine(model, num_slots=2, decode_chunk_size=4, **kw)
    first = wave(engine)
    ptrs = {k: t.data_ptr() for k, t in engine.params.items()}
    engine.params = w1
    assert {k: t.data_ptr() for k, t in engine.params.items()} == ptrs
    assert len(engine.prefix.entries) == 0 and engine.decode_compilations == 1
    if paged:
        assert engine.cache.alloc.referenced_pages == 0
        engine.cache.check()
    second = wave(engine)
    assert engine.decode_compilations == 1 and second != first
    assert second == wave(ServingEngine(model, num_slots=2, decode_chunk_size=4, **kw))


@pytest.mark.cuda
def test_quantized_swap_on_card_equals_quantize_state_dict(cuda):
    """A float swap on an int8 engine on the card: the codes and scales in
    the engine's own tensors equal ``quantize_state_dict`` of the same
    weights bit for bit; the float source model keeps every bit."""
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    from neuronx_distributed_tpu_torch.quantization.utils import quantize_state_dict
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    model, w1 = _small_llama(0), _small_llama(1).state_dict()
    source = {k: v.clone() for k, v in model.state_dict().items()}
    engine = ServingEngine(model, num_slots=2, quantize=QuantConfig(weights="int8"))
    ptrs = {k: t.data_ptr() for k, t in engine.params.items()}
    engine.params = w1
    want = quantize_state_dict(w1, engine._weight_qcfg)
    got = engine.params
    assert {k: t.data_ptr() for k, t in got.items()} == ptrs
    assert sorted(got) == sorted(want)
    assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(v, source[k]) for k, v in model.state_dict().items())


@pytest.mark.cuda
def test_poisoned_draft_on_card_restores_its_bits(cuda):
    """``poison_draft`` on a captured speculative round (the target as its
    own draft through ``draft_params=``): acceptance collapses against the
    clean engine's, every request finishes, and the draft's bits equal its
    clean copy afterwards, one capture (the streams of two speculative
    engines are no bitwise gate on the card: their verify windows differ)."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.faults import FaultInjector

    model = _small_llama(0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 1000, size=n) for n in (40, 90)]
    runs = []
    for poison in (True, False):
        inj = FaultInjector().poison_draft(at=0, times=None) if poison else None
        engine = ServingEngine(model, num_slots=2, decode_chunk_size=4, prefix_cache=None,
                               draft_model=model, draft_params=model.state_dict(), gamma=3,
                               fault_injector=inj)
        clean = {k: v.clone() for k, v in engine.draft_params.items()}
        reqs = [engine.submit(p, GenerationConfig(24, temperature=0.0), seed=i)
                for i, p in enumerate(prompts)]
        engine.run()
        assert engine.decode_compilations == 1
        assert all(len(r.tokens) == 24 for r in reqs)
        assert all(torch.equal(v, clean[k]) for k, v in engine.draft_params.items())
        runs.append(([r.tokens for r in reqs], engine.metrics.snapshot()["spec_accept_rate"]))
        if poison:
            assert inj.counters["poisoned_drafts"] > 0
    assert runs[0][1] < 0.5 < runs[1][1]


@pytest.mark.cuda
def test_restored_engine_on_card_continues_the_snapshot(cuda):
    """Two steps, ``fence``, the snapshot through JSON, a restore on a fresh
    engine over the same module: every stream starts with its pre-kill
    tokens and finishes with its token count in the vocabulary; one capture
    an engine (the re-prefill runs K1 over tokens the first engine decoded
    through K4, so the rest is no bitwise gate)."""
    import json

    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
    from neuronx_distributed_tpu_torch.serving.traffic import VirtualClock

    model = _small_llama(0)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 1000, size=n) for n in (30, 60, 15)]
    cfg = GenerationConfig(20, temperature=0.0)
    a = ServingEngine(model, num_slots=2, decode_chunk_size=4, prefix_cache=None,
                      time_fn=VirtualClock())
    reqs = [a.submit(p, cfg, seed=i) for i, p in enumerate(prompts)]
    a.step()
    a.step()
    mid = [list(r.tokens) for r in reqs]
    a.fence("kill")
    snap = json.loads(json.dumps(a.snapshot_serving_state()))
    b = ServingEngine(model, num_slots=2, decode_chunk_size=4, prefix_cache=None,
                      time_fn=VirtualClock(start=1000.0))
    assert b.restore_serving_state(snap)["restored"] == 3
    b.run()
    assert a.decode_compilations == 1 and b.decode_compilations == 1
    for i, r in enumerate(reqs):
        got = b.scheduler.requests[r.rid]
        assert got.tokens[:len(mid[i])] == mid[i] and len(got.tokens) == 20
        assert all(0 <= t < 1000 for t in got.tokens)


@pytest.mark.cuda
def test_handoff_on_card_keeps_one_capture_and_the_table_address(cuda):
    """A disaggregated server on the card: the worker's prefills (K1) stage
    pages in the decode engine's pool, every handoff writes the slot's
    block table, validity and cursor in place, so the decode engine keeps
    ONE capture over the same block-table and validity addresses; no KV
    byte moves (``copy_bytes`` 0) and every page is free at the end."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.serving.disagg import DisaggregatedServer
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    model = _small_llama(0)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 1000, size=n) for n in (70, 20, 45, 110)]
    engine = ServingEngine(model, num_slots=2, decode_chunk_size=4, prefix_cache=None,
                           kv_page_size=16)
    engine.prewarm()
    c = engine.cache.cache
    ptrs = (c.block_table.data_ptr(), c.valid.data_ptr(), c.cursor.data_ptr(), c.k.data_ptr())
    server = DisaggregatedServer(engine, n_workers=1)
    reqs = [server.submit(p, GenerationConfig(12, temperature=0.0), seed=i)
            for i, p in enumerate(prompts)]
    server.run()
    assert all(r.state.value == "done" and len(r.tokens) == 12 for r in reqs)
    assert server.stats["handoffs"] == 4 and engine.decode_compilations == 1
    assert (c.block_table.data_ptr(), c.valid.data_ptr(), c.cursor.data_ptr(),
            c.k.data_ptr()) == ptrs
    assert engine.cache.alloc.copy_bytes == 0 and engine.cache.alloc.referenced_pages == 0
    engine.cache.check()


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"])
def test_staged_pages_on_card_equal_a_coupled_prefill(cuda, kv):
    """On the card (K1 prefills; QW writes an int8 pool), the pages a worker
    stages hold the bytes a coupled prefill of the same prompt writes into
    its slot, bit for bit, codes and scales included, and the handoff
    samples the coupled admission's first token."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    from neuronx_distributed_tpu_torch.serving.disagg import DisaggregatedServer
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    model = _small_llama(0)
    kw = dict(quantize=QuantConfig(kv="int8")) if kv else {}
    gcfg = GenerationConfig(4, temperature=0.0)
    rng = np.random.default_rng(9)
    for n in (37, 130, 300):
        prompt = rng.integers(1, 1000, size=n)
        coupled = ServingEngine(model, num_slots=1, prefix_cache=None, kv_page_size=16, **kw)
        creq = coupled.submit(prompt, gcfg, seed=1)
        coupled._admit(0.0)
        cids = coupled.cache.slot_pages(0)
        engine = ServingEngine(model, num_slots=1, prefix_cache=None, kv_page_size=16, **kw)
        server = DisaggregatedServer(engine, n_workers=1)
        req = server.submit(prompt, gcfg, seed=1)
        staged, logits = server.workers[0].prefill(req, engine.max_seq_len)
        sids = list(staged.page_ids)
        assert len(sids) == len(cids)
        for name in ("k", "v", "k_scale", "v_scale") if kv else ("k", "v"):
            a = getattr(coupled.cache.cache, name)[:, cids]
            b = getattr(engine.cache.cache, name)[:, sids]
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), (n, name)
        assert engine.admit_staged(req, staged, logits, now=0.0)
        assert req.tokens == creq.tokens


@pytest.mark.cuda
def test_rehomed_request_continues_its_stream_on_the_survivor(cuda):
    """A router of two row replicas on the card; replica 0 halts
    mid-decode: its requests re-home with their tokens, the survivor's
    first token of each continues the stream (its pre-halt tokens exactly,
    then the count), ``tokens_lost == 0``, one capture a replica."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
    from neuronx_distributed_tpu_torch.serving.router import ReplicaRouter

    model = _small_llama(0)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, 1000, size=n) for n in (30, 60, 15, 44)]
    router = ReplicaRouter.build(model, 2, num_slots=2, decode_chunk_size=4, prefix_cache=None,
                                 sleep_fn=lambda s: None)
    reqs = [router.submit(p, GenerationConfig(20, temperature=0.0), seed=i)
            for i, p in enumerate(prompts)]
    router.step()
    router.step()
    mid = {r.rid: list(r.tokens) for r in reqs}
    assert any(mid[r.rid] for r in reqs if r.rid < 4)
    router.replicas[0]._faults = FaultInjector().fail_dispatch(at=0, times=None)
    router.run()
    assert router.replicas[0].health().value == "halted"
    assert router.stats["rehomed_requests"] > 0
    for r in reqs:
        got = router.requests[r.rid]
        assert got.state.value == "done" and len(got.tokens) == 20
        assert got.tokens[:len(mid[r.rid])] == mid[r.rid]
    assert router.replicas[1].decode_compilations == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [("bfloat16",), ("int8", "float32"), ("float8_e4m3fn", "int64"),
                                    ("bfloat16", "int8", "float32", "bool")])
def test_tree_fingerprint_kernel_equals_plain(cuda, dtypes):
    """TF (``csrc/tree_fingerprint.cu``) = its plain version bit for bit
    over leaves of 8-, 16-, 32- and 64-bit elements, ragged sizes, a leaf of
    several 1 MiB items, an empty leaf and a view at an odd offset (the
    scalar path); a flipped bit and a swap of two elements each move it;
    one launch a call; a rebound leaf rebuilds the tables."""
    from neuronx_distributed_tpu_torch.integrity.chaos import flip_leaf_bit
    from neuronx_distributed_tpu_torch.kernels import tree_fingerprint as ttf

    leaves = []
    for i, name in enumerate(dtypes):
        n = (3 << 20) // 2 + 7 if i == 0 else 1000 + 13 * i
        x = torch.randn(n, generator=cuda, device="cuda") * 40
        leaves.append(x.to(getattr(torch, name)) if name != "int64"
                      else torch.randint(-2 ** 62, 2 ** 62, (n,), device="cuda"))
    leaves.append(torch.empty(0, device="cuda"))
    base = torch.randn(4097, generator=cuda, device="cuda").to(torch.bfloat16)
    leaves.append(base[1:])  # 2-byte offset: not 16-byte aligned
    prog = ttf.TreeFingerprint(leaves)
    before = ttf.tree_fingerprint_fwd.launches
    got = int(prog())
    torch.cuda.synchronize()
    assert ttf.tree_fingerprint_fwd.launches == before + 1
    assert got == int(ttf.tree_fingerprint_plain(leaves))
    assert int(prog()) == got
    flip_leaf_bit(leaves[0], byte_index=12345)
    flipped = int(prog())
    assert flipped != got and flipped == int(ttf.tree_fingerprint_plain(leaves))
    flip_leaf_bit(leaves[0], byte_index=12345)
    assert int(prog()) == got
    x = leaves[-1]
    x[[3, 4]] = x[[4, 3]].clone()
    if not torch.equal(x[3], x[4]):
        assert int(prog()) != got
    prog.leaves[1] = prog.leaves[1].clone()  # rebound: a new address
    assert int(prog()) == int(ttf.tree_fingerprint_plain(prog.leaves))


@pytest.mark.cuda
def test_integrity_vote_convicts_a_flipped_replica(cuda):
    """Three own-weight row replicas on the card under the vote; replica 0
    flips a weight bit at its step 1: the next vote convicts it (TF's
    values), fences it and re-homes its work, every request DONE with its
    count; the survivors' fingerprints stay equal."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.serving.faults import FaultInjector
    from neuronx_distributed_tpu_torch.serving.router import ReplicaRouter, WatchdogConfig
    from neuronx_distributed_tpu_torch.serving.traffic import VirtualClock

    clock = VirtualClock()
    router = ReplicaRouter.build(_small_llama(0), 3, num_slots=2, decode_chunk_size=4,
                                 prefix_cache=None, time_fn=clock,
                                 watchdog=WatchdogConfig(integrity_interval_s=0.5))
    router.replicas[0]._faults = FaultInjector().flip_bits("params", at=1)
    rng = np.random.default_rng(12)
    reqs = [router.submit(rng.integers(1, 1000, size=n), GenerationConfig(12, temperature=0.0),
                          seed=i) for i, n in enumerate((20, 33, 9, 41, 17, 25))]
    router.step()
    clock.advance(0.6)
    router.step()
    assert router.stats["integrity_fences"] == 0
    clock.advance(0.6)
    router.step()
    assert router.stats["integrity_fences"] == 1 and router.probe_states()["replica0"] == "dead"
    router.run()
    assert all(router.requests[r.rid].state.value == "done"
               and len(router.requests[r.rid].tokens) == 12 for r in reqs)
    fps = {router.replicas[i].integrity_fingerprint() for i in (1, 2)}
    assert len(fps) == 1 and router.replicas[0].integrity_fingerprint() not in fps


def _packed_source(n_batches=64):
    """A cursor-carrying source of packed 2 x 256 batches (two documents a
    row) for the training loop on the card."""

    class Source:
        def __init__(self):
            self.i = 0

        def state(self):
            return {"batch": self.i}

        def restore(self, st):
            self.i = int(st["batch"])

        def __iter__(self):
            while True:
                rng = np.random.default_rng([7, self.i])
                self.i += 1
                ids = rng.integers(1, 1000, size=(2, 257))
                seg = np.zeros((2, 256), np.int32)
                seg[:, 100:] = 1
                yield {"input_ids": ids[:, :-1], "labels": ids[:, 1:], "segment_ids": seg,
                       "loss_mask": np.ones((2, 256), np.float32)}

    return Source()


def _canary_trainer(inj=None):
    from neuronx_distributed_tpu_torch.integrity import SentinelConfig
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from neuronx_distributed_tpu_torch.trainer import Trainer

    cfg = LlamaConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=512)
    return Trainer(model=LlamaForCausalLM(cfg, trainable=True), fault_injector=inj,
                   integrity=SentinelConfig(check_every=2))


@pytest.mark.cuda
def test_canary_check_on_card_judges_a_clean_step_clean(cuda):
    """The canary runs a check step twice on the card and compares TF over
    the state: a clean run's steps (K1, K2, K3, cuBLAS, the optimizer) are
    bitwise reproducible, so every check is clean, and the state equals a
    sentinel-off run's bit for bit; TF launches twice a check."""
    from neuronx_distributed_tpu_torch.kernels import tree_fingerprint as ttf
    from neuronx_distributed_tpu_torch.trainer import Trainer

    tr = _canary_trainer()
    n = ttf.tree_fingerprint_fwd.launches
    tr.fit(_packed_source(), 0, max_steps=6)
    s = tr._sentinel
    assert s.counters == {"integrity_checks": 3, "sdc_detected": 0, "sdc_unlocalized": 0,
                          "sdc_rollbacks": 0}
    assert ttf.tree_fingerprint_fwd.launches - n == 6 and tr.host_reads == 6
    got = [t.clone() for t in tr._state_leaves()]  # the next fit re-initialises the model
    ref = Trainer(model=tr.model)
    ref.fit(_packed_source(), 0, max_steps=6)
    assert all(torch.equal(a, b) for a, b in zip(got, ref._state_leaves()))


@pytest.mark.cuda
def test_canary_on_card_convicts_a_flip_and_rolls_back(cuda):
    """A flipped parameter bit at check step 3: the two runs' TF values
    differ, the run rolls back to step 2 and retrains to the clean final
    state bit for bit."""
    from neuronx_distributed_tpu_torch.trainer import Trainer
    from neuronx_distributed_tpu_torch.trainer.faults import FaultInjector

    tr = _canary_trainer(FaultInjector().flip_bits("params", at=3))
    tr.fit(_packed_source(), 0, max_steps=6)
    s = tr._sentinel
    assert s.counters["sdc_detected"] == 1 and s.counters["sdc_rollbacks"] == 1
    assert tr.step == 6 and tr.fault_injector.counters["bit_flips"] == 1
    got = [t.clone() for t in tr._state_leaves()]
    ref = Trainer(model=tr.model)
    ref.fit(_packed_source(), 0, max_steps=6)
    assert all(torch.equal(a, b) for a, b in zip(got, ref._state_leaves()))


def _mx_case(gen, case, t, e=8, h=1024, i=2048):
    """Routes and stacks for MX/MXq at a reduced width (the card check of
    chip_smoke.py phase 2 runs Mixtral-8x7B's): "random" (two distinct
    experts a token), "skewed" (every pair on expert 3) or "untouched"
    (expert 5 never chosen)."""
    if case == "skewed":
        top_e = torch.full((t, 2), 3, dtype=torch.int64, device="cuda")
    else:
        top_e = torch.rand(t, e - (case == "untouched"), generator=gen,
                           device="cuda").argsort(-1)[:, :2]
        if case == "untouched":
            top_e = top_e + (top_e >= 5).long()
    w = torch.rand(t, 2, generator=gen, device="cuda") + 0.1
    x = _rnd(gen, t, h)
    stacks = [(torch.randn(e, i, h, generator=gen, device="cuda") / h ** 0.5).to(torch.bfloat16),
              (torch.randn(e, i, h, generator=gen, device="cuda") / h ** 0.5).to(torch.bfloat16),
              (torch.randn(e, h, i, generator=gen, device="cuda") / i ** 0.5).to(torch.bfloat16)]
    return x, top_e, w / w.sum(-1, keepdim=True), stacks


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("case,t", [("random", 8), ("random", 1), ("skewed", 8),
                                    ("untouched", 8), ("random", 16), ("random", 128),
                                    ("skewed", 128)])
def test_moe_experts_kernel_equals_plain(cuda, kind, case, t):
    """MX/MXq against their plain version: |out - ref| <= 2^-7 |ref| +
    2^-9 sum_j |w_j| (|down| . |act|) + 1e-5 (the same bf16 rounding
    points; f32 sums of up to I terms in another order, 2 I 2^-24 <=
    2^-9 of the magnitude); a dropped pair must fail it; two runs
    bitwise equal; one launch counted a call."""
    from neuronx_distributed_tpu_torch.kernels import moe_experts as tmx
    from neuronx_distributed_tpu_torch.quantization.config import QuantConfig
    from neuronx_distributed_tpu_torch.quantization.utils import quantize_weight

    x, top_e, top_w, stacks = _mx_case(cuda, case, t)
    if kind == "bf16":
        args, fn = stacks, tmx.moe_experts
    else:
        qs = [quantize_weight(w, QuantConfig(weights=kind).weight_qconfig()) for w in stacks]
        args, fn = [q for q, _ in qs] + [s for _, s in qs], tmx.moe_experts_quantized
    n0 = fn.launches
    got = fn(x, top_e, top_w, *args)
    assert fn.launches == n0 + 1
    assert torch.equal(fn(x, top_e, top_w, *args), got)
    scales = args[3:] if kind != "bf16" else (None, None, None)
    old = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        ref = tmx.moe_experts_plain(x, top_e, top_w, *args[:3], *scales)
        g = tmx.gathered(args[0], scales[0], top_e, torch.bfloat16)
        u = tmx.gathered(args[1], scales[1], top_e, torch.bfloat16)
        act = (torch.nn.functional.silu(torch.einsum("th,tkih->tki", x, g))
               * torch.einsum("th,tkih->tki", x, u))
        d = tmx.gathered(args[2], scales[2], top_e, torch.bfloat16)
        y = torch.einsum("tki,tkhi->tkh", act, d)
        mag = torch.einsum("tki,tkhi->tkh", act.float().abs(), d.float().abs())
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = old
    wb = top_w.to(torch.bfloat16).float()
    limit = 2.0 ** -7 * ref.float().abs() + 2.0 ** -9 * torch.einsum("tk,tkh->th", wb, mag) + 1e-5
    assert float(((got.float() - ref.float()).abs() / limit).max()) <= 1.0
    dropped = ref.float() - wb[:, :1] * y[:, 0].float()
    assert float(((dropped - ref.float()).abs() / limit).max()) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_moe_experts_dequantize_is_exact(cuda, kind):
    """MXq's dequantize, held code by code on ``dequant_probe``'s inputs
    (x one-hot, so every sum is a single term): act = 128 bf16(f32(q)
    scale) over every code of up under a spread of scales, then each
    pair's down output over every code of down, both equal to the plain
    version's bit for bit."""
    from neuronx_distributed_tpu_torch.kernels import moe_experts as tmx

    h = i = 512
    pr = tmx.dequant_probe(kind, h, i)
    x, top_e, top_w = pr["x"], pr["top_e"], pr["top_w"]
    t, k = top_e.shape

    def stages(up):
        ws = (pr["gate"], up, pr["down"])
        _, act, y = tmx._kernel_call(x, top_e, top_w, *(w for w, _ in ws), *(s for _, s in ws))
        G, U, D = (tmx.gathered(w, s, top_e, torch.bfloat16) for w, s in ws)
        a = torch.nn.functional.silu(torch.einsum("th,tkih->tki", x, G)) * torch.einsum(
            "th,tkih->tki", x, U)
        return act, y, a.reshape(t * k, i), torch.einsum("tki,tkhi->tkh", a, D).reshape(t * k, h)

    act, _, act_ref, _ = stages(pr["up"])
    assert torch.isfinite(act_ref.float()).all() and torch.equal(act, act_ref)
    act, y, act_ref, y_ref = stages(pr["up1"])
    assert torch.equal(act, act_ref) and int((act_ref != 0).sum()) == t * k
    assert torch.equal(y, y_ref)


@pytest.mark.cuda
def test_moe_experts_split_is_deterministic(cuda):
    """A call whose down product is cut into column shares (the plan's
    split > 1) gives the same bits over ten runs and three graph replays."""
    from neuronx_distributed_tpu_torch.kernels import moe_experts as tmx

    x, top_e, top_w, stacks = _mx_case(cuda, "random", 8)
    assert tmx.plan(8, 2, 8, 1024, 2048).split > 1
    first = tmx.moe_experts(x, top_e, top_w, *stacks)
    for _ in range(9):
        assert torch.equal(tmx.moe_experts(x, top_e, top_w, *stacks), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tmx.moe_experts(x, top_e, top_w, *stacks)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tmx.moe_experts(x, top_e, top_w, *stacks)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)


@pytest.mark.cuda
@pytest.mark.parametrize("slots,paged", [(8, False), (16, True)])
def test_mixtral_engine_on_card_captured_equals_eager(cuda, monkeypatch, slots, paged):
    """A 2-layer Mixtral on the card: the decode step is one CUDA graph
    (MX a layer at 8 slots; the blockwise route's sort and grouped products
    at 16), its streams equal the same engine's with the eager step
    patched in, every request DONE."""
    from neuronx_distributed_tpu_torch.inference.generate import GenerationConfig
    from neuronx_distributed_tpu_torch.inference.graphs import DecodeProgram
    from neuronx_distributed_tpu_torch.kernels import moe_experts as tmx
    from neuronx_distributed_tpu_torch.models.mixtral import (
        MixtralConfig, MixtralForCausalLM, init_params)
    from neuronx_distributed_tpu_torch.serving.engine import ServingEngine

    cfg = MixtralConfig(vocab_size=1000, hidden_size=512, intermediate_size=1024, num_layers=2,
                        num_heads=4, num_kv_heads=2, max_seq_len=512)
    model = init_params(MixtralForCausalLM(cfg), seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 1000, size=n) for n in (120, 40, 160, 9)]
    kw = dict(kv_page_size=16) if paged else {}
    streams = []
    for eager in (False, True):
        with monkeypatch.context() as m:
            if eager:
                m.setattr(DecodeProgram, "__call__", lambda self: self.step())
            engine = ServingEngine(model, num_slots=slots, decode_chunk_size=8, **kw)
            reqs = [engine.submit(p, GenerationConfig(24, temperature=0.0), seed=i)
                    for i, p in enumerate(prompts)]
            n0 = tmx.moe_experts.launches
            engine.run()
        assert [len(r.tokens) for r in reqs] == [24] * len(prompts)
        snap = engine.metrics.snapshot()
        if not eager:
            assert engine.decode_compilations == 1
            assert engine.decode_program.launches_per_replay.get("moe_experts", 0) == (
                cfg.num_layers if slots <= 8 else 0)
        elif slots <= 8:
            assert tmx.moe_experts.launches - n0 == snap["executed_steps"] * cfg.num_layers
        if paged:
            engine.cache.check()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


def _mixtral_train_model(**over):
    """A small trainable Mixtral on the card (head_dim 128 for K1-K3, bf16
    compute, fp32 masters), jitter and shuffle on, the blockwise route."""
    from neuronx_distributed_tpu_torch.models.mixtral import (
        MixtralForCausalLM,
        init_params,
        tiny_mixtral,
    )

    cfg = tiny_mixtral(**{**dict(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                                 num_heads=4, num_kv_heads=2, num_experts=8, max_seq_len=1024,
                                 dtype=torch.bfloat16, remat=True, router_jitter_eps=0.01,
                                 token_shuffle=True, expert_strategy="blockwise"), **over})
    return init_params(MixtralForCausalLM(cfg, trainable=True), seed=0)


@pytest.mark.cuda
def test_mixtral_train_blockwise_backward_equals_per_expert_matmuls(cuda):
    """The blockwise route's backward on the card at Mixtral-8x7B's widths
    (H 4096, I 14336, 8 experts top-2; 512 tokens): ``torch._grouped_mm``'s
    input and weight gradients against a per-expert ``torch.matmul`` loop on
    the same bf16 stacks, relative norm error 1e-2 per leaf (bf16 products
    with f32 sums on both sides, the intermediate rounded to bf16 on both)."""
    from neuronx_distributed_tpu_torch.modules.moe.expert_mlps import blockwise

    e, h, i, t, k = 8, 4096, 14336, 512, 2
    ws = [_rnd(cuda, e, i, h) * 0.02, _rnd(cuda, e, i, h) * 0.02, _rnd(cuda, e, h, i) * 0.01]
    x = _rnd(cuda, t, h)
    top_e = torch.stack([torch.randperm(e, generator=cuda, device="cuda")[:k] for _ in range(t)])
    top_w = torch.rand(t, k, generator=cuda, device="cuda")
    dout = _rnd(cuda, t, h)

    def loop(x, gate, up, down):
        out = torch.zeros(t, h, device="cuda", dtype=torch.float32)
        for j in range(k):
            for ex in range(e):
                rows = (top_e[:, j] == ex).nonzero()[:, 0]
                a = x[rows]
                y = (torch.nn.functional.silu(a @ gate[ex].t()) * (a @ up[ex].t())) @ down[ex].t()
                out = out.index_add(0, rows, y.float() * top_w[rows, j:j + 1])
        return out.to(torch.bfloat16)

    grads = []
    for fn in (lambda *a: blockwise(a[0], top_e, top_w, *a[1:], e), loop):
        leaves = [x.clone().requires_grad_(True)] + [w.clone().requires_grad_(True) for w in ws]
        (fn(*leaves).float() * dout.float()).sum().backward()
        grads.append([p.grad.float() for p in leaves])
    for name, a, b in zip(("x", "gate", "up", "down"), *grads):
        rel = float((a - b).norm() / b.norm())
        assert rel <= 1e-2, f"{name}: relative error {rel:.3g}"


@pytest.mark.cuda
def test_mixtral_train_step_is_deterministic(cuda):
    """A Mixtral train step on the card (K1 forward and remat recompute,
    K2/K3, the grouped products' backward, jitter and shuffle from the
    step's generator) re-run from a copy of the state gives the same bits:
    the canary's and the exact resume's premise. K1 launches twice a layer,
    K2 and K3 once."""
    from neuronx_distributed_tpu_torch.trainer import (
        OptimizerConfig,
        build_train_step,
        create_train_state,
        make_optimizer,
    )

    model = _mixtral_train_model()
    opt = make_optimizer(OptimizerConfig(learning_rate=1e-3))
    state = create_train_state(model, opt, seed=0)

    def loss_fn(batch, generator):
        return model.loss(batch["input_ids"], batch["labels"], deterministic=False,
                          generator=generator)

    step = build_train_step(model, opt, loss_fn=loss_fn, seed=3)
    ids = torch.randint(1, 1024, (2, 513), generator=cuda, device="cuda")
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    step(state, batch)
    leaves = lambda: [p.detach() for p in model.parameters()] + state.opt_state["mu"] + \
        state.opt_state["nu"]  # noqa: E731
    saved = [t.clone() for t in leaves()]
    n = {f: f.launches for f in (tfa.flash_attention_fwd, tfa.flash_attention_dkdv,
                                 tfa.flash_attention_dq)}
    _, m1 = step(state, batch)
    first = [t.clone() for t in leaves()]
    counts = {f.__name__: f.launches - c for f, c in n.items()}
    with torch.no_grad():
        for dst, src in zip(leaves(), saved):
            dst.copy_(src)
    state.opt_state["count"].sub_(1)
    state.step -= 1
    _, m2 = step(state, batch)
    assert torch.equal(m1["loss"], m2["loss"]) and torch.isfinite(m1["loss"])
    assert all(torch.equal(a, b) for a, b in zip(first, leaves()))
    assert counts == {"flash_attention_fwd": 4, "flash_attention_dkdv": 2,
                      "flash_attention_dq": 2}


@pytest.mark.cuda
def test_mixtral_train_selective_route_raises_under_autograd(cuda):
    """The selective route launches MX, which has no backward: on a CUDA
    input that needs a gradient it raises rather than leave the experts'
    gradients empty; without autograd it serves a trainable model's fp32
    masters cast to bf16 (MX launches once)."""
    from neuronx_distributed_tpu_torch.kernels import moe_experts as tmx
    from neuronx_distributed_tpu_torch.modules.moe.expert_mlps import ExpertMLPs

    m = ExpertMLPs(8, 512, 1024, strategy="selective", dtype=torch.bfloat16, device="cuda",
                   trainable=True)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.02)
    x = _rnd(cuda, 4, 512)
    top_e = torch.tensor([[0, 1], [2, 3], [4, 5], [6, 7]], device="cuda")
    top_w = torch.full((4, 2), 0.5, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        m(x, top_e, top_w)
    n = tmx.moe_experts.launches
    with torch.no_grad():
        out = m(x, top_e, top_w)
    assert tmx.moe_experts.launches - n == 1 and out.dtype == torch.bfloat16
    m.strategy = "blockwise"
    with torch.no_grad():
        ref = m(x, top_e, top_w)
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= 1e-2, rel


# --- head_dim 96 (GPT-NeoX-20B): the builds of K1, K4 and K5 with
# -DNXD_HEAD_DIM=96, against the same plain versions and limits


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [None, "padding"])
@pytest.mark.parametrize("h,hkv", [(8, 8), (32, 8)])
@pytest.mark.parametrize("s", [1, 33, 200, 1000])
def test_flash_attention_head_dim_96_matches_plain(cuda, s, h, hkv, segments):
    """K1's head_dim-96 build against its plain version (causal; no
    segments and left padding; multi-head and GQA); its launches count in
    ``d96`` alone; q read in place from a fused (B, S, 3, H, 96) tensor."""
    b = 2
    qkv = _rnd(cuda, b, s, 3, h, 96)
    q = qkv[:, :, 0]
    k, v = _rnd(cuda, b, s, hkv, 96), _rnd(cuda, b, s, hkv, 96)
    n128, n96 = tfa.flash_attention_fwd.launches, tfa.flash_attention_fwd.d96.launches
    seg = _k1_segments(segments, b, s)
    got, lse = tfa.flash_attention_fwd(q, k, v, True, seg, seg)
    assert tfa.flash_attention_fwd.launches == n128
    assert tfa.flash_attention_fwd.d96.launches == n96 + 1
    want, wlse = tfa.flash_attention_plain(q, k, v, True, seg, seg)
    pv = tfa.flash_attention_plain(q, k, v.abs(), True, seg, seg)[0]
    _assert_out_close(got, want, pv, 2.0 ** -8)
    torch.testing.assert_close(lse, wlse, atol=5e-4, rtol=1e-4)
    again, again_lse = tfa.flash_attention_fwd(q, k, v, True, seg, seg)
    assert torch.equal(got, again) and torch.equal(lse, again_lse)


def _decode_96_check(q, kc, vc, pos, valid, ps=16):
    """K4 and K5 (through a scrambled table) at head_dim 96 against their
    plain versions; K5 bitwise equal to K4 on the gathered view; the
    launches counted in ``d96`` alone."""
    n4, n5 = tfd.flash_decode_fwd.d96.launches, tfd.paged_flash_decode_fwd.d96.launches
    l4, l5 = tfd.flash_decode_fwd.launches, tfd.paged_flash_decode_fwd.launches
    got, lse = tfd.flash_decode_fwd(q, kc, vc, pos, valid)
    want, wlse = tfd.flash_decode_plain(q, kc, vc, pos, valid)
    pv = tfd.flash_decode_plain(q, kc, vc.abs(), pos, valid)[0]
    _assert_out_close(got, want, pv, 2.0 ** -12)
    torch.testing.assert_close(lse, wlse, atol=5e-4, rtol=1e-4)
    kp, vp, bt = _paged_view(torch.Generator(device="cuda").manual_seed(1), kc, vc, valid, ps)
    paged, paged_lse = tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, ps)
    row, row_lse = tfd.flash_decode_fwd(q, tfd.paged_gather_leaf(kp, bt, ps),
                                        tfd.paged_gather_leaf(vp, bt, ps), pos, valid)
    assert torch.equal(paged, row) and torch.equal(paged_lse, row_lse)
    assert (tfd.flash_decode_fwd.d96.launches, tfd.paged_flash_decode_fwd.d96.launches) == (
        n4 + 2, n5 + 1)
    assert (tfd.flash_decode_fwd.launches, tfd.paged_flash_decode_fwd.launches) == (l4, l5)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,hkv", [(1, 8, 8), (1, 32, 8), (16, 8, 8), (4, 32, 8)])
def test_flash_decode_head_dim_96_split_path(cuda, s, h, hkv):
    """The split path (R <= 32) of K4 and K5 at head_dim 96: the decode
    step, GPT-NeoX's verify window (group 1, s = 16) and a GQA window."""
    q, kc, vc, pos, valid = _suffix_case(cuda, s, h, hkv, L=1024, prefix=700, d=96)
    got = _decode_96_check(q, kc, vc, pos, valid)
    assert got.shape == (2, s, h, 96)


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,hkv,ps", [(64, 4, 4, 16), (256, 4, 4, 16), (40, 8, 2, 8),
                                         (100, 4, 4, 128)])
def test_flash_decode_head_dim_96_multi_row(cuda, s, h, hkv, ps):
    """The multi-row path (R > 32) of K4 and K5 at head_dim 96: group 1 (64
    tokens a row tile, GPT-NeoX's) up to R = 256, group 4, and page sizes
    16, 8 and 128."""
    q, kc, vc, pos, valid = _suffix_case(cuda, s, h, hkv, d=96)
    _decode_96_check(q, kc, vc, pos, valid, ps)


@pytest.mark.cuda
def test_head_dim_96_builds_do_not_spill_and_refuse_the_rest(cuda):
    """``ptxas -v`` for the head_dim-96 builds: no kernel spills; K5q takes
    head_dim 128 alone; a head dim with no build raises before a launch."""
    from neuronx_distributed_tpu_torch.kernels import _build

    for name in ("flash_attention_d96", "flash_decode_d96"):
        report = _build.resource_report(name)
        spills = [line for line in report.splitlines() if "spill" in line]
        assert spills and all("0 bytes spill stores, 0 bytes spill loads" in line
                              for line in spills), report
    q, kp, vp, bt, pos, valid = _paged_case(cuda, 1, 16, d=96)
    kq = torch.zeros(kp.shape, dtype=torch.int8, device="cuda")
    sc = torch.ones(kp.shape[0], 1, kp.shape[2], 1, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        tfd.qpaged_flash_decode_fwd(q, kq, kq, sc, sc, bt, pos, valid, 16)
    with pytest.raises(ValueError):  # head_dim 80: no build
        x = _rnd(cuda, 1, 16, 4, 80)
        tfa.flash_attention_fwd(x, x, x)
