"""The roofline's arithmetic on a hand-worked case."""

import pytest

from harness import roofline

BASE = dict(pairs_in_reach=1_000_000, num_points=3_000, binned=False, union_edges=2,
            scale_edges=2, weighted=False, max_angle=0.01, num_bins=2, num_patches=4)


def test_cumulative_unbinned():
    # 16 + 3 * 2 = 22 operations per pair in reach
    assert roofline.count_operations(BASE) == 22e6
    # 3,000 points x 20 B + 2 bins x 16 patch pairs x 2 edges x 4 B
    assert roofline.count_bytes(BASE) == 60_000 + 256
    assert roofline.least_seconds([BASE]) == pytest.approx(max(22e6 / 67e12, 60_256 / 3.35e12))


def test_binned_weighted_takes_the_cheaper_formulation():
    work = dict(BASE, binned=True, weighted=True, union_edges=35, scale_edges=4)
    # direct: 3 * 4 + 12 + 1 = 25 < cumulative 3 * 35 = 105; +16 chord, +1 bin
    assert roofline.count_operations(work) == 1e6 * (16 + 1 + 25)
    assert roofline.count_bytes(work) == 60_000 + 2 * 16 * 4 * 4
    wide = dict(work, max_angle=1.3)
    assert roofline.count_operations(wide) == 1e6 * (16 + 1 + 3 * 4 + 18 + 1)
    few = dict(work, union_edges=5)
    assert roofline.count_operations(few) == 1e6 * (16 + 1 + 15)


def test_sum_over_counts():
    assert roofline.least_seconds([BASE, BASE]) == pytest.approx(
        2 * roofline.least_seconds([BASE]))
