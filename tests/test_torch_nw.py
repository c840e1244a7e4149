"""Port parity of ops/nw.py: the semi-global score and the longest
ungapped block of nw_max_ungapped against the JAX package's jitted version
and its per-pair numpy oracle. Comparisons are exact (integers)."""

import numpy as np
import pytest
import torch

from localhgt_tpu.ops import nw as jax_nw
from localhgt_tpu_torch.ops import nw


def _both(q, r, **kw):
    s, m = nw.nw_max_ungapped(torch.from_numpy(q), torch.from_numpy(r), **kw)
    return s.numpy(), m.numpy()


@pytest.mark.parametrize("alpha", [2, 4])
def test_nw_matches_jax_and_oracle_random(alpha):
    rng = np.random.default_rng(7 + alpha)
    B, M, N = 16, 48, 52
    q = rng.integers(0, alpha, (B, M)).astype(np.uint8)
    r = rng.integers(0, alpha, (B, N)).astype(np.uint8)
    r[::3, 10:34] = q[::3, 4:28]  # planted shared blocks
    q[rng.random(q.shape) < 0.02] = 4
    got = _both(q, r)
    want = jax_nw.nw_max_ungapped(q, r)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, w in zip(got, jax_nw.nw_max_ungapped_np(q[:6], r[:6])):
        np.testing.assert_array_equal(g[:6], w)


def test_nw_identical_and_gap_split():
    rng = np.random.default_rng(1)
    q = rng.integers(0, 4, (2, 40)).astype(np.uint8)
    s, m = _both(q, q)
    assert np.all(m == 40) and np.all(s == 80)  # match=2 each
    # identical halves separated by an insertion in ref -> run = half
    q = np.tile(np.array([0, 1, 2, 3], np.uint8), 10)[None]
    r = np.concatenate([q[0, :20], np.zeros(6, np.uint8), q[0, 20:]])[None]
    got = _both(q, r)
    assert int(got[1][0]) == 20
    for g, w in zip(got, jax_nw.nw_max_ungapped(q, r)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_nw_flank_shape_and_gap_costs():
    """The 2 x 100 bp flanks of the microhomology analysis, and non-default
    scoring."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, (24, 200)).astype(np.uint8)
    r = rng.integers(0, 4, (24, 200)).astype(np.uint8)
    r[::2, 150:] = q[::2, :50]
    kw = dict(match=1, mismatch=-2, gap_open=-3, gap_ext=-1)
    for case in ({}, kw):
        got = _both(q, r, **case)
        for g, w in zip(got, jax_nw.nw_max_ungapped(q, r, **case)):
            np.testing.assert_array_equal(g, np.asarray(w))
