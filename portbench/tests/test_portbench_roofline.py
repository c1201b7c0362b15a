"""K1's and K2's operations and bytes, worked out from shapes."""

import pytest

from portbench import roofline

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_k1_bytes_at_3125_groups():
    l, g, k, s = 2, 3125, 8192, 32
    docs, query, out = l * 4 * g * k, l * k * 4 * s, 4 * l * g * s
    assert docs == 204_800_000
    assert query == 2_097_152
    assert out == 800_000
    tables = 4 * (l * 4 * 4 * s + l * 8)
    assert roofline.k1_bytes(l, g, k, s) == docs + query + out + tables


def test_k1_ops_and_bound_are_bytes_bound():
    l, g, k, s = 2, 3125, 8192, 32
    ops = roofline.k1_ops(l, g, k, s)
    assert ops == 2 * 2 * 12500 * 8192 * 128
    t = roofline.bound_s(roofline.k1_bytes(l, g, k, s), ops, H100)
    assert t == pytest.approx(roofline.k1_bytes(l, g, k, s) / 3.35e12)
    assert t == pytest.approx(62.0e-6, rel=0.01)
    assert ops / H100.int8_ops_per_s < t


def test_k1_at_2048_groups_matches_the_earlier_bound():
    # PERF.md's K1 bound at 2048 groups: 0.0408 ms.
    t = roofline.bound_s(roofline.k1_bytes(2, 2048, 8192, 32),
                         roofline.k1_ops(2, 2048, 8192, 32), H100)
    assert t * 1e3 == pytest.approx(0.0408, abs=0.0005)


@pytest.mark.parametrize("rows,l,n", [(16384 * 2, 2, 4096), (12, 12, 16384), (24, 12, 16384),
                                      (2, 2, 4096)])
def test_k2_bytes(rows, l, n):
    assert roofline.k2_bytes(rows, l, n) == 8 * rows * n + l * (16 * n + 4)


def test_k2_at_16384_rows_matches_the_earlier_bound():
    # PERF.md's K2 bound at 16,384 rows x 4096 (2 limbs): 0.1603 ms.
    t = roofline.bound_s(roofline.k2_bytes(16384, 2, 4096), 0, H100)
    assert t * 1e3 == pytest.approx(0.1603, abs=0.0005)


def test_unknown_card_has_no_peaks():
    assert roofline.peaks("cpu") is None
