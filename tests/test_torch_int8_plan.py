"""The int8-weight linear kernel's plan (`kernels/int8_linear.py::_plan`):
which token tile and how many work units, with K split in whole stages,
the card runs at every shape serving gives it. A plain function of the
shape, so it is read here, on the CPU; the card tests check that the card
runs the plan it names (tests/test_torch_kernels_cuda.py)."""

import pytest

pytest.importorskip("torch")

from ecamp_tpu_torch.kernels import int8_linear as i8  # noqa: E402

SMS = 132  # the H100 SXM's streaming multiprocessors
PROJECTIONS = ((2304, 768), (768, 768), (3072, 768), (768, 3072))  # ViT-B
# M = 197 tokens an image (the classifier), 196 for the patch projection
# (768 outputs over 3 x 16 x 16), at buckets 1, 8 and 64; and chip_smoke's
# ragged shape
SERVED = ([(197 * b, n, k) for b in (1, 8, 64) for n, k in PROJECTIONS]
          + [(196 * b, 768, 768) for b in (1, 8, 64)] + [(37, 200, 64)])


def _stages(k):
    return -(-k // i8.BK)


@pytest.mark.parametrize("m,n,k", SERVED)
def test_plan_is_valid_at_every_served_shape(m, n, k):
    plan = i8._plan(m, n, k, SMS)
    assert plan.bt in i8.TILE_T
    assert plan.tiles == -(-m // plan.bt) * -(-n // i8.BN)
    assert 0 <= plan.whole <= plan.tiles <= plan.units
    assert plan.units - plan.whole <= (plan.tiles - plan.whole) * _stages(k)
    assert plan.grid == min(plan.units, SMS)
    # every tile's K is cut into whole 64-deep stages that cover it once;
    # the whole tiles are one unit each, the tail's units spread evenly
    ranges = i8.split_stages(plan, k)
    assert len(ranges) == plan.tiles
    assert sum(len(r) for r in ranges) == plan.units
    for splits in ranges:
        assert splits[0][0] == 0 and splits[-1][1] == _stages(k)
        assert all(a < b for a, b in splits)
        assert all(b == c for (_, b), (c, _) in zip(splits, splits[1:]))
    assert all(len(r) == 1 for r in ranges[:plan.whole])
    tail = [len(r) for r in ranges[plan.whole:]]
    if plan.units > plan.tiles:
        assert max(tail) == plan.splits and min(tail) >= plan.splits - 1
        assert m - plan.row0(n) <= i8.MAX_SPLIT_ROWS
    else:
        assert plan.splits == 1 and set(tail) <= {1}


@pytest.mark.parametrize("n,k", PROJECTIONS)
@pytest.mark.parametrize("m", [197, 196])
def test_plan_split_fills_the_card_at_one_image(m, n, k):
    """At one image the tiles are fewer than the 132 SMs. A split of K
    fills whole waves of units; the shapes whose tiles are fewest (proj
    and fc2: 12 tiles) or deepest (fc2: 48 stages a tile) are split. fc1's
    48 tiles of 12 stages stay whole: split into a wave they measured
    slower on the card (PERF.md, PR 16)."""
    plan = i8._plan(m, n, k, SMS)
    assert plan.tiles < SMS
    if plan.units > plan.tiles:
        assert plan.whole == 0 and plan.units % SMS == 0
        assert plan.grid == SMS
    if n == 768:
        assert plan.units == SMS


@pytest.mark.parametrize("n,k", PROJECTIONS)
def test_plan_keeps_whole_waves_whole_at_bucket_64(n, k):
    """At bucket 64 (M = 12,608) the tiles fill many waves: those are one
    unit a tile; only the tiles of a last, part-filled wave may be split,
    into one wave of units, when that is modelled faster."""
    plan = i8._plan(197 * 64, n, k, SMS)
    assert plan.grid == SMS
    assert plan.whole == plan.tiles // SMS * SMS or plan.whole == plan.tiles
    assert plan.units in (plan.tiles, plan.whole + SMS)
    assert i8._modelled_us(plan, 197 * 64, n, k, SMS) <= i8._modelled_us(
        i8.Plan(plan.bt, plan.tiles, plan.tiles, plan.tiles, SMS),
        197 * 64, n, k, SMS)


def test_plan_is_cached_and_follows_the_card():
    assert i8._plan(197, 768, 3072, SMS) is i8._plan(197, 768, 3072, SMS)
    small = i8._plan(197, 768, 3072, 16)
    assert small.grid <= 16
