"""K1/K2 bound arithmetic: the port's chip_smoke.py numbers at its shapes,
and the share read from shapes and a trace's kernel times."""

import pytest

from hgtbench import roofline


def test_bounds_at_the_port_shapes():
    # chip_smoke.py / PERF.md: K1 at B=152, M=192, N=256 0.009 ms and at
    # B=8,192 0.481 ms, K2 at B=8,192, M=N=160 0.069 ms, all by operations
    assert roofline.bound_s("sw_align", 152, 192, 256) * 1e3 == pytest.approx(
        0.00893, abs=1e-5)
    assert roofline.bound_s("sw_align", 8192, 192, 256) * 1e3 == pytest.approx(
        0.4814, abs=1e-4)
    assert roofline.bound_s("sw_score", 8192, 160, 160) * 1e3 == pytest.approx(
        0.06896, abs=1e-5)


def test_bytes_bound_wins_for_a_thin_launch():
    # K2 on one query row of a few columns: its 5.5 ops a cell take less
    # time than the bytes
    B, M, N = 1, 1, 8
    assert roofline.bound_s("sw_score", B, M, N) == pytest.approx(
        (B * (M + N) + 4 * B) / roofline.HBM_BYTES_PER_S)


def test_share_pct_reads_its_kernel_names_only():
    shapes = {(152, 192, 256): 2}
    by_name = {"void sw_align_kernel<32, 8, false, false, false>(...)": 2e-4,
               "void sw_score_kernel<8, 20, false, false, false>(...)": 1.0}
    share = roofline.share_pct("sw_align", shapes, by_name)
    assert share == pytest.approx(100 * 2 * 8.932966e-6 / 2e-4, rel=1e-4)
    assert roofline.share_pct("sw_align", {}, by_name) is None
    assert roofline.share_pct("sw_score", shapes, {}) is None
