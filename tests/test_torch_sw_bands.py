"""Port parity above 4,096 reference columns, where kernels K1 (sw_align)
and K2 (sw_score) sweep bands on the card: their plain versions against
the JAX package's O(MN) numpy oracle, lax.scan formulation and Pallas
kernels in interpret mode, none of which has a width limit. Comparisons
are exact. (The band schedule itself, written out in numpy, is held to
Pallas in tests/test_torch_sw.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localhgt_tpu.ops import pallas_sw
from localhgt_tpu.ops import sw as jax_sw
from localhgt_tpu_torch.ops import cuda_sw

WIDTHS = [cuda_sw.WIDE_MAX_N + 1, 5000]


def _tie_heavy_wide(seed, B, M, N):
    """2-letter alphabet, each query planted with a 1-5 bp insertion
    across the first band's edge (column 4,096) or past it."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2, (B, M)).astype(np.uint8)
    r = rng.integers(0, 2, (B, N)).astype(np.uint8)
    for b in range(B):
        ins = int(rng.integers(1, 6))
        cut = int(rng.integers(4, M - 4))
        seg = np.concatenate([q[b, :cut],
                              rng.integers(0, 2, ins).astype(np.uint8),
                              q[b, cut:]])
        # the segment's last base at column 4,096 or past it
        off = int(rng.integers(cuda_sw.WIDE_MAX_N + 1 - len(seg),
                               N - len(seg) + 1))
        r[b, off:off + len(seg)] = seg
    r[1, :] = 4  # unalignable: zero-score row
    return q, r


@pytest.mark.parametrize("N, M", [(WIDTHS[0], 2), (WIDTHS[1], 1)])
def test_sw_align_plain_matches_oracle_past_the_block(N, M):
    """The O(MN) oracle takes seconds a query row at this width, so it
    sees one short query whose first base no earlier column holds: at
    N = 4,097 two rows whose diagonal crosses from column 4,095 to 4,096,
    at 5,000 one base at column 4,096."""
    rng = np.random.default_rng(N)
    r = rng.integers(0, 4, (1, N)).astype(np.uint8)
    lead = cuda_sw.WIDE_MAX_N + 1 - M  # the query's first column
    r[0, :lead] = rng.integers(1, 4, lead)  # no base 0 before it
    r[0, lead] = 0
    q = r[:, lead:lead + M].copy()
    got = cuda_sw.sw_align(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    assert tuple(got[0]) == jax_sw.sw_align_np(q[0], r[0])
    assert got[0, 0] == M and got[0, 4] >= cuda_sw.WIDE_MAX_N


@pytest.mark.parametrize("N", WIDTHS)
def test_sw_align_plain_matches_pallas_and_lax_scan_past_the_block(N):
    """Every field against Pallas in interpret mode; score and ends
    against lax.scan, which breaks E ties the other way (ROADMAP F1)."""
    B, M = 8, 64
    q, r = _tie_heavy_wide(N, B, M, N)
    got = cuda_sw.sw_align(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    # every alignment but the unalignable row ends in the second band
    assert got[1, 0] == 0
    assert (np.delete(got[:, 4], 1) >= cuda_sw.WIDE_MAX_N).all()
    want = np.asarray(pallas_sw.sw_align_pallas(
        jnp.asarray(q), jnp.asarray(r), tile=B, interpret=True))
    np.testing.assert_array_equal(got, want)
    scan = jax_sw.sw_align(jnp.asarray(q), jnp.asarray(r))
    for i, f in enumerate(jax_sw._FIELDS):
        if f in ("score", "qend", "rend"):
            np.testing.assert_array_equal(got[:, i], np.asarray(scan[f]),
                                          err_msg=f)


@pytest.mark.parametrize("N", WIDTHS)
def test_sw_score_plain_matches_lax_scan_and_pallas_past_the_block(N):
    B, M = 8, 64
    q, r = _tie_heavy_wide(N + 1, B, M, N)
    got = cuda_sw.sw_score(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_sw.sw_score(jnp.asarray(q), jnp.asarray(r))))
    np.testing.assert_array_equal(got, np.asarray(pallas_sw.sw_score_pallas(
        jnp.asarray(q), jnp.asarray(r), tile=B, interpret=True)))
