"""The roofline arithmetic against hand counts."""

from __future__ import annotations

import pytest

from portbench import roofline


def test_k1_hand_count():
    # m = 10 SNPs, n = 8 samples, N = 6 columns: 2*10*8*6 operations;
    # bytes: 10*2 packed + 10*4 means + 8*6*4 U + 10*6*4 R
    assert roofline.k1(10, 8, 6) == (960.0, 20 + 40 + 192 + 240)


def test_k2_hand_count():
    # m = 10, n = 8, G = 4, T = 2, p = 1: (1 + 2 + 1) grams of 2*n*G per SNP
    ops, nbytes = roofline.k2(10, 8, 4, 2, 1)
    assert ops == 2 * 4 * 10 * 4 * 8
    # R 10*8, W 4*8, YX 3*8, SH 2*7*4, lattice 2*10*4 floats
    assert nbytes == 4 * (80 + 32 + 24 + 56 + 80)


def test_grams_hand_count():
    ops, nbytes = roofline.lm_grams(10, 8, 1)
    assert ops == 2 * 8 * 10 * 3
    assert nbytes == 10 * 2 + 10 * 4 + 2 * 10 * 8


def test_bound_takes_the_larger_and_share_is_a_percentage():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(989e12, 6.7e12) == pytest.approx(2.0)
    assert roofline.share_pct(989e12, 0, 4.0) == pytest.approx(25.0)
    assert roofline.share_pct(1.0, 1.0, 0.0) is None


def test_counts_do_not_depend_on_precision_or_padding():
    # the bench shape: K1 1.14e12 operations, ~1.15 ms at the peak
    ops, nbytes = roofline.k1(287_104, 1_410, 1_410)
    assert ops == 2 * 287_104 * 1_410 * 1_410
    assert roofline.bound_s(ops, nbytes) == pytest.approx(ops / 989e12)
    assert 1.1e-3 < roofline.bound_s(ops, nbytes) < 1.2e-3
    ops2, _ = roofline.k2(287_104, 1_410, 256, 1, 1)
    assert roofline.bound_s(ops2, 0) == pytest.approx(2 * 3 * 287_104 * 256 * 1_410 / 989e12)
    # the sparse cell's grams are bound by the packed panel's bytes
    ops3, nbytes3 = roofline.lm_grams(1_000_000, 10_000, 1)
    assert roofline.bound_s(ops3, nbytes3) == pytest.approx(nbytes3 / 3.35e12)
    assert nbytes3 > 2.5e9
