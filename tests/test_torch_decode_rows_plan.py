"""The multi-row decode path's plan and arithmetic (CPU).

Above 32 rows per kv-head (a prefix hit's suffix prefill) K4 and K5
(``csrc/flash_decode.cu`` ``decode_rows``) run one block per 64-row tile of
whole tokens of every head of a group, visit the 64-column tiles that hold
a live column below the tile's largest position + 1, mask only the tiles
that hold a dead column or cut the tile's smallest position, and run the
blocks latest tokens first. ``flash_decode_rows_plan`` states that plan with
the kernel's own predicate. Here it is held to ``flash_decode_plain``'s
mask: every live (row, column) pair lies in a visited tile, and every
visited tile the kernel does not mask is live for each row of its tile;
the grid and the block order do not change with ``kv_valid`` or the
layout. Booleans and integers: exact.

The kernel keeps P at f32 accuracy in ``wgmma`` products by splitting it
into two bf16 halves (P = P_hi + P_lo), each a register-A operand of its
own product into one accumulator. ``_emulated`` repeats that arithmetic in
torch (the plan's tiles, online softmax in exp2, P split, f32 sums of
exact bf16 products), and is held to the on-card limit (elementwise |Δ| <=
2^-7 |ref| + 2^-12 P|V| + 1e-5, LSE 5e-4), which a bf16 P does not meet,
and to the JAX package's Pallas decode kernel in interpret mode."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.kernels import flash_decode as jfd
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd

torch.set_num_threads(1)

TN = tfd.ROWS_TILE_COLS
LOG2E = 1.4426950408889634


def _case(kind, s, group, L, b=2, seed=0):
    """q_pos (s,) int32 and kv_valid (B, L) bool: a live prefix then s
    suffix tokens, with slot 1 left-padded; ``gaps``: random dead columns;
    ``pad_tail``: the last 5 suffix columns invalid (rows still computed);
    ``scattered``: positions not contiguous and not sorted."""
    rng = np.random.default_rng(seed)
    start = L - s - int(rng.integers(0, 40))
    pos = np.arange(start, start + s, dtype=np.int32)
    valid = np.zeros((b, L), bool)
    valid[:, :start + s] = True
    valid[1, :int(rng.integers(1, start))] = False
    if kind == "gaps":
        valid &= rng.random((b, L)) > 0.3
    elif kind == "pad_tail":
        valid[:, start + s - 5:] = False
    elif kind == "scattered":
        pos = np.sort(rng.choice(np.arange(start // 2, start + s), size=s, replace=False))
        pos = pos.astype(np.int32)[rng.permutation(s)]
        valid[:, :int(pos.max()) + 1] |= rng.random((b, int(pos.max()) + 1)) > 0.5
    return torch.from_numpy(pos), torch.from_numpy(valid)


def _live(pos, valid):
    """(B, s, L): token t of slot b sees column c (``flash_decode_plain``'s mask)."""
    cols = torch.arange(valid.shape[1])
    return valid[:, None, :] & (cols[None, None, :] <= pos.long()[None, :, None])


def _tile_flags(plan, s, L):
    """The plan's (B, n_rt, n_ct) flags as (B, s, L) flags of each token's row tile."""
    t = plan["tokens"]
    out = []
    for key in ("visited", "masked"):
        f = plan[key].repeat_interleave(t, 1)[:, :s].repeat_interleave(TN, 2)[:, :, :L]
        out.append(f)
    return out


CASES = [  # (kind, s, group, L)
    ("left_padding", 16, 4, 512),
    ("gaps", 64, 4, 512),
    ("pad_tail", 256, 4, 2048),
    ("scattered", 48, 4, 1024),
    ("gaps", 50, 3, 700),
    ("pad_tail", 40, 8, 640),
    ("scattered", 33, 8, 300),
    ("left_padding", 100, 3, 1000),
]


@pytest.mark.parametrize("kind,s,group,L", CASES)
def test_every_live_pair_lies_in_a_visited_tile(kind, s, group, L):
    pos, valid = _case(kind, s, group, L)
    plan = tfd.flash_decode_rows_plan(pos, valid, L, group, b=2)
    visited, _ = _tile_flags(plan, s, L)
    live = _live(pos, valid)
    assert live.any()
    assert not (live & ~visited).any()


@pytest.mark.parametrize("kind,s,group,L", CASES)
def test_every_unmasked_visited_tile_is_wholly_live(kind, s, group, L):
    pos, valid = _case(kind, s, group, L)
    plan = tfd.flash_decode_rows_plan(pos, valid, L, group, b=2)
    visited, masked = _tile_flags(plan, s, L)
    live = _live(pos, valid)
    assert not (visited & ~masked & ~live).any()
    # a column tile past L, ragged: masked wherever it is visited
    if L % TN:
        assert bool(plan["masked"][..., -1].all())


@pytest.mark.parametrize("group", [3, 4, 8])
def test_suffix_prefill_masks_only_edge_tiles(group):
    """Phase 5c's shape (a 1600-column live prefix after left padding, a
    256-token suffix with a pad tail): a tile is masked only at the left
    padding's edge, at a row tile's own diagonal or at the pad tail; the
    tiles before the context are never visited."""
    L, c0, s = 2300, 150, 256
    pos = torch.arange(c0 + 1600, c0 + 1600 + s, dtype=torch.int32)
    valid = torch.zeros(1, L, dtype=torch.bool)
    valid[0, c0:c0 + 1600 + s - 3] = True
    plan = tfd.flash_decode_rows_plan(pos, valid, L, group)
    visited, masked = plan["visited"][0], plan["visited"][0] & plan["masked"][0]
    assert not visited[:, :c0 // TN].any()
    per_tile = masked.sum(1)
    assert int(per_tile.max()) <= 4, per_tile
    assert int(masked.sum()) < int(visited.sum()) // 10


@pytest.mark.parametrize("kind,s,group,L", CASES)
def test_grid_and_order_depend_on_shapes_only(kind, s, group, L):
    """The block order is every (row tile, kv-head, slot) once, the latest
    tokens first, and the same under any kv_valid and any q_pos of the same
    length. The plan takes no layout: K5 makes it from the same logical
    q_pos and kv_valid as K4 (the on-card tests hold K5 through a scrambled
    table bitwise equal to K4 on the gathered view)."""
    pos, valid = _case(kind, s, group, L, b=3)
    plan = tfd.flash_decode_rows_plan(pos, valid, L, group, b=3, hkv=2)
    order = plan["order"]
    n_rt = -(-s // plan["tokens"])
    assert plan["tokens"] == tfd.ROWS_TILE // group
    assert order.shape == (n_rt * 2 * 3, 3)
    assert len({tuple(r) for r in order.tolist()}) == n_rt * 2 * 3
    assert bool((order[1:, 0] <= order[:-1, 0]).all()) and int(order[0, 0]) == n_rt - 1
    for other_valid in (None, torch.zeros_like(valid), ~valid):
        for other_pos in (pos, torch.flip(pos, [0]) - 7):
            other = tfd.flash_decode_rows_plan(other_pos, other_valid, L, group, b=3, hkv=2)
            assert torch.equal(other["order"], order) and other["tokens"] == plan["tokens"]


def _emulated(q, k, v, q_pos, valid, p_bits="hi_lo"):
    """The multi-row kernel's arithmetic in torch: per (slot, row tile,
    kv-head) the plan's visited 64-column tiles in order, S = Q K^T from the
    inputs' values in f32, the mask on every tile (a no-op on the tiles the
    kernel leaves unmasked, by the test above), online softmax in exp2
    (scale x log2 e folded in, a row with no live column so far keeping m =
    -1e30 and the reference 0), l from the unrounded P, and P V from P split
    into bf16 hi + lo (``p_bits="bf16"``: P rounded to bf16 once, as K1
    does). Returns (out in q.dtype, lse f32 (B, Hkv, R))."""
    b, s, h, d = q.shape
    L, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    plan = tfd.flash_decode_rows_plan(q_pos, valid, L, g, b=b, hkv=hkv)
    t_rows = plan["tokens"]
    sl2 = LOG2E / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    vmask = torch.ones(b, L, dtype=torch.bool) if valid is None else valid.bool()
    out = torch.zeros(b, s, h, d)
    lse = torch.full((b, hkv, g, s), tfd.NEG_INF)
    cols = torch.arange(L)
    for bb in range(b):
        for rt in range(plan["visited"].shape[1]):
            t = torch.arange(rt * t_rows, min(s, rt * t_rows + t_rows))
            pos = q_pos.long()[t].repeat(g)  # local row g * T + j
            for hk in range(hkv):
                qr = qf[bb, t, hk * g:(hk + 1) * g].transpose(0, 1).reshape(-1, d)
                m = torch.full((len(pos),), tfd.NEG_INF)
                l = torch.zeros(len(pos))
                o = torch.zeros(len(pos), d)
                for j in torch.nonzero(plan["visited"][bb, rt]).flatten().tolist():
                    c = cols[j * TN:(j + 1) * TN]
                    sc = qr @ kf[bb, c, hk].T
                    ok = vmask[bb, c][None, :] & (c[None, :] <= pos[:, None])
                    sc = torch.where(ok, sc, -math.inf)
                    mn = torch.maximum(m, sc.amax(1) * sl2)
                    ref = torch.where(mn > tfd.NEG_INF / 2, mn, 0.0)
                    alpha = torch.exp2(m - ref)
                    m = mn
                    p = torch.exp2(sc * sl2 - ref[:, None])
                    l = l * alpha + p.sum(1)
                    hi = p.to(torch.bfloat16).float()
                    pv = hi @ vf[bb, c, hk]
                    if p_bits == "hi_lo":
                        pv = pv + (p - hi).to(torch.bfloat16).float() @ vf[bb, c, hk]
                    o = o * alpha[:, None] + pv
                res = torch.where(l[:, None] > 0, o / l.clamp_min(1e-30)[:, None], 0.0)
                out[bb, t, hk * g:(hk + 1) * g] = res.reshape(g, len(t), d).transpose(0, 1)
                lse[bb, hk][:, t] = torch.where(
                    l > 0, m * math.log(2.0) + torch.log(l.clamp_min(1e-30)), tfd.NEG_INF
                ).reshape(g, len(t))
    return out.to(q.dtype), lse.reshape(b, hkv, g * s)


def _limit_ratio(got, want, pv, c=2.0 ** -12):
    want = want.float()
    limit = 2.0 ** -7 * want.abs() + c * pv.float() + 1e-5
    return float(((got.float() - want).abs() / limit).max())


def _bf16_case(seed, s, h, hkv, L, q_scale):
    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn(1, s, h, 128, generator=gen) * q_scale).to(torch.bfloat16)
    k = torch.randn(1, L, hkv, 128, generator=gen).to(torch.bfloat16)
    v = torch.randn(1, L, hkv, 128, generator=gen).to(torch.bfloat16)
    pos = torch.arange(L - s - 20, L - 20, dtype=torch.int32)
    valid = torch.zeros(1, L, dtype=torch.bool)
    valid[0, 30:L - 23] = True  # left padding, a live prefix, a pad tail of 3
    return q, k, v, pos, valid


@pytest.mark.parametrize("q_scale", [1.0, 3.0])
@pytest.mark.parametrize("s,h,hkv", [(48, 8, 2), (30, 6, 2)])
def test_hi_lo_pv_meets_the_f32_limit_where_bf16_p_does_not(s, h, hkv, q_scale):
    """bf16 inputs as on the card: with P = P_hi + P_lo the output stays
    within the K4/K5 limit (c = 2^-12) and LSE within 5e-4 of the plain
    version; with P rounded to bf16 once (c = 2^-8 is K1's limit) the same
    inputs read above the 2^-12 limit."""
    q, k, v, pos, valid = _bf16_case(s + h, s, h, hkv, 512, q_scale)
    want, wlse = tfd.flash_decode_plain(q, k, v, pos, valid)
    pv = tfd.flash_decode_plain(q, k, v.abs(), pos, valid)[0]
    got, lse = _emulated(q, k, v, pos, valid)
    assert _limit_ratio(got, want, pv) <= 1.0
    torch.testing.assert_close(lse, wlse, atol=5e-4, rtol=1e-4)
    rounded, _ = _emulated(q, k, v, pos, valid, p_bits="bf16")
    assert _limit_ratio(rounded, want, pv) > 1.0


def test_emulated_kernel_matches_pallas_decode():
    """f32 inputs (the JAX test's widths: D = 16), R = 64 and 96 rows a
    kv-head with gaps, left padding and a row that sees nothing: the
    emulated multi-row arithmetic against the Pallas decode kernel in
    interpret mode, out and LSE, at the port's decode tolerance (2e-5; the
    hi/lo split is exact to ~2^-17 of P)."""
    for s, h, hkv, L, q0 in ((16, 8, 2, 64, 30), (24, 8, 2, 96, 2)):
        rng = np.random.default_rng(L + s)
        b, d = 3, 16
        q = rng.normal(size=(b, s, h, d)).astype(np.float32)
        kc = rng.normal(size=(b, L, hkv, d)).astype(np.float32)
        vc = rng.normal(size=(b, L, hkv, d)).astype(np.float32)
        pos = np.arange(q0, q0 + s, dtype=np.int32)
        valid = rng.random((b, L)) > 0.3
        valid[1, :5] = False
        valid[2, :q0 + 3] = False  # the first rows of slot 2 see no live column
        want = jfd.flash_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                          jnp.asarray(pos), jnp.asarray(valid), interpret=True)
        g = h // hkv
        qt = jnp.swapaxes(jnp.asarray(q), 1, 2).reshape(b, hkv, g * s, d)
        _, want_lse = jfd._flash_decode_call(
            qt, jnp.swapaxes(jnp.asarray(kc), 1, 2), jnp.swapaxes(jnp.asarray(vc), 1, 2),
            jnp.tile(jnp.asarray(pos), (g,)), jnp.asarray(valid), 0, True, 512,
        )
        got, lse = _emulated(*(torch.from_numpy(x) for x in (q, kc, vc, pos, valid)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
        want_lse = np.asarray(want_lse)[..., 0]
        live = want_lse > tfd.NEG_INF / 2
        np.testing.assert_allclose(lse.numpy()[live], want_lse[live], atol=2e-5, rtol=1e-6)
        assert np.all(lse.numpy()[~live] == tfd.NEG_INF)
