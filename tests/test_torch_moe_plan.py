"""The routed expert kernel's launch plan (``kernels/moe_experts.py plan``)
against a plain restatement of its rule: pairs a pass and down's column
split, from the shapes alone, within what the kernel's entry point takes."""

import math

import pytest

from neuronx_distributed_tpu_torch.kernels import moe_experts as tmx

H, I = 4096, 14336  # Mixtral-8x7B's hidden and intermediate widths


def _plan_ref(t, k, e, h, i):
    pairs = t * k
    np_ = 8 if pairs <= 8 else 16
    touched = min(e, pairs)
    tiles = math.ceil(h / 64)
    shares = [s for s in (1, 2, 4, 8) if s <= max(1, i // 1024)]
    # the least share count giving 4 waves of 2 blocks on each of 132 SMs, else the most
    split = next((s for s in shares if touched * tiles * s >= 4 * 2 * 132), shares[-1])
    return dict(np=np_, split=split)


@pytest.mark.parametrize("e", [4, 8])
@pytest.mark.parametrize("t", [1, 8, 16, 128])
def test_plan_equals_its_rule(t, e):
    got = tmx.plan(t, 2, e, H, I)
    assert got._asdict() == _plan_ref(t, 2, e, H, I)
    assert got == tmx.plan(t, 2, e, H, I)  # shapes alone


@pytest.mark.parametrize("t,k,e,h,i", [(8, 2, 8, 1024, 2048), (3, 2, 4, 64, 64),
                                       (128, 1, 2, 512, 512), (5, 3, 16, 2048, 8192)])
def test_plan_equals_its_rule_at_other_widths(t, k, e, h, i):
    assert tmx.plan(t, k, e, h, i)._asdict() == _plan_ref(t, k, e, h, i)


@pytest.mark.parametrize("t", [1, 8, 16, 128])
def test_plan_fits_the_kernel(t):
    """Every pair of a decode step (T <= 8, top-2) fits one pass even when
    all route to one expert, and wider calls take passes of 16; the split
    leaves each share at least 1024 columns and stays within what the entry
    point takes (at most 8, at most I / 128)."""
    p = tmx.plan(t, 2, 8, H, I)
    assert p.np in (8, 16) and p.np >= min(2 * t, 16)
    assert p.split == 1 or I // p.split >= 1024
    assert 1 <= p.split <= min(8, max(1, I // 128))
    if t <= 8:
        assert p.np >= 2 * t
