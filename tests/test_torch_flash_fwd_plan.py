"""K1's tile plan (CPU).

On the card K1 (``csrc/flash_attention.cu``) runs one block per 128-row
query tile, visits 128-key tiles at or below the causal diagonal whose
segment-id ranges can meet the query tile's, and evaluates the mask only on
tiles that cut the diagonal, the ragged key edge or a segment boundary.
``flash_fwd_tile_plan`` states that plan with the kernel's own predicate.
Here it is held to the plain mask (``_live``): no live (query, key) pair
falls outside a visited tile, and every tile the kernel does not mask is
live for each valid row and key. The per-tile ranges it reads are held to
the JAX package's ``_seg_block_ranges`` on the same numpy segment ids.
Everything is exact (booleans and integers)."""

import importlib

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)

# the JAX `kernels` package re-exports functions under this module name
jfa = importlib.import_module("neuronx_distributed_tpu.kernels.flash_attention")

TQ, TK = tfa.FWD_Q_TILE, tfa.FWD_K_TILE


def _segments(kind, b, s, seed=0):
    """(B, S) int32 numpy ids: None; left padding (-1) of a different
    length in each row; or documents of 50..400 tokens packed end to end."""
    if kind is None:
        return None
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        if kind == "padding":
            seg[i, :int(rng.integers(0, s))] = -1
        else:
            pos, doc = 0, 0
            while pos < s:
                n = int(rng.integers(50, 401))
                seg[i, pos:pos + n] = doc
                pos, doc = pos + n, doc + 1
    return seg


def _plan_and_live(s, sk, causal, kind, b=2, seed=0):
    q_seg = _segments(kind, b, s, seed)
    k_seg = q_seg if sk == s else _segments(kind, b, sk, seed + 1)
    qs = ks = None
    ranges = {}
    if q_seg is not None:
        qs, ks = torch.from_numpy(q_seg), torch.from_numpy(k_seg)
        ranges = dict(q_ranges=tfa._seg_tile_ranges(qs, TQ), k_ranges=tfa._seg_tile_ranges(ks, TK))
    plan = tfa.flash_fwd_tile_plan(s, sk, causal, h=1, b=b, **ranges)
    live = tfa._live(torch.empty(b, s, 1, 1), torch.empty(b, sk, 1, 1), causal, qs, ks)[:, 0, 0]
    return plan, live


def _per_element(tiles, s, sk):
    """(B, nQ, nK) tile flags as (B, S, Sk) element flags."""
    return tiles.repeat_interleave(TQ, 1)[:, :s].repeat_interleave(TK, 2)[:, :, :sk]


CASES = [  # (S, Sk, causal, segments)
    (1, 1, True, None),
    (8, 8, True, "padding"),
    (33, 33, False, None),
    (200, 200, True, "packed"),
    (512, 512, True, None),
    (1000, 1000, True, "padding"),
    (1000, 1000, False, "packed"),
    (1300, 1300, True, "packed"),
    (130, 300, True, None),
    (300, 130, True, None),
    (300, 700, False, "packed"),
    (4096, 4096, True, "packed"),
]


@pytest.mark.parametrize("s,sk,causal,kind", CASES)
def test_every_live_pair_lies_in_a_visited_tile(s, sk, causal, kind):
    plan, live = _plan_and_live(s, sk, causal, kind)
    assert not (live & ~_per_element(plan["visited"], s, sk)).any()


@pytest.mark.parametrize("s,sk,causal,kind", CASES)
def test_every_unmasked_visited_tile_is_fully_live(s, sk, causal, kind):
    plan, live = _plan_and_live(s, sk, causal, kind)
    unmasked = plan["visited"] & ~plan["masked"]
    assert not (_per_element(unmasked, s, sk) & ~live).any()
    # and the masked flag is not set where nothing needs it: causal without
    # segments masks exactly the diagonal tiles and the ragged key edge
    if kind is None and causal:
        nq, nk = plan["visited"].shape[1:]
        i, j = torch.arange(nq)[:, None], torch.arange(nk)[None, :]
        want = (j * TK + TK - 1 > i * TQ) | ((j + 1) * TK > sk)
        assert torch.equal(plan["masked"][0], want & plan["visited"][0])


@pytest.mark.parametrize("s,h,b", [(1, 1, 1), (1000, 8, 2), (4096, 32, 1), (4096, 32, 2)])
def test_blocks_run_heaviest_first(s, h, b):
    """Causal: each block's count of visited tiles never rises along the
    launch order, and the order covers every (query tile, head, batch) once."""
    plan = tfa.flash_fwd_tile_plan(s, s, True, h=h, b=b)
    order = plan["order"]
    nq = -(-s // TQ)
    assert order.shape == (nq * h * b, 3)
    assert len({tuple(r) for r in order.tolist()}) == nq * h * b
    work = plan["visited"].sum(-1)[order[:, 2], order[:, 0]]
    assert bool((work[1:] <= work[:-1]).all())
    assert int(work[0]) == nq and int(work[-1]) == 1


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [2048, 4096])
def test_packed_segments_skip_tiles(s, causal):
    """Documents of 50..400 tokens: most tile pairs lie in no common
    document and are never visited, and a tile pair inside one document is
    not masked unless it cuts the diagonal."""
    plan, live = _plan_and_live(s, s, causal, "packed")
    bare = tfa.flash_fwd_tile_plan(s, s, causal, b=2)
    n, n_bare = int(plan["visited"].sum()), int(bare["visited"].sum())
    assert n < n_bare / 2, (n, n_bare)
    # the skipped pairs hold no live pair: the skip is exact
    assert not (live & ~_per_element(plan["visited"], s, s)).any()


def test_one_document_skips_nothing_and_masks_only_the_diagonal():
    seg = torch.zeros(1, 1024, dtype=torch.int32)
    r = tfa._seg_tile_ranges(seg, TQ)
    plan = tfa.flash_fwd_tile_plan(1024, 1024, True, q_ranges=r, k_ranges=r)
    bare = tfa.flash_fwd_tile_plan(1024, 1024, True)
    assert torch.equal(plan["visited"], bare["visited"])
    assert torch.equal(plan["masked"], bare["masked"])
    assert int(plan["masked"].sum()) == 8  # the diagonal tiles only


@pytest.mark.parametrize("kind", ["padding", "packed"])
@pytest.mark.parametrize("s", [128, 1024, 4096, 1000, 33])
def test_seg_tile_ranges_equal_jax_seg_block_ranges(s, kind):
    """The ranges K1 (and K2/K3) read equal the JAX package's on the same
    numpy ids; a ragged S equals JAX on the ids padded with their last id
    (JAX takes whole blocks only)."""
    seg = _segments(kind, 3, s, seed=s)
    n = -(-s // TQ)
    padded = np.concatenate([seg, np.repeat(seg[:, -1:], n * TQ - s, axis=1)], axis=1)
    jmin, jmax = jfa._seg_block_ranges(padded, TQ)
    tmin, tmax = tfa._seg_tile_ranges(torch.from_numpy(seg), TQ)
    assert np.array_equal(np.asarray(jmin), tmin.numpy())
    assert np.array_equal(np.asarray(jmax), tmax.numpy())
    assert tmin.dtype == tmax.dtype == torch.int32
