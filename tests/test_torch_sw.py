"""Port parity: the plain versions of kernels K1 (sw_align) and K2
(sw_score) against the Pallas kernels in interpret mode, the lax.scan
formulation and the O(MN) numpy oracle. Comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localhgt_tpu.ops import pallas_sw
from localhgt_tpu.ops import sw as jax_sw
from localhgt_tpu_torch.ops import cuda_sw
from localhgt_tpu_torch.ops import sw as port_sw


def _planted(seed, B, M, N):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, M)).astype(np.uint8)
    r = rng.integers(0, 4, (B, N)).astype(np.uint8)
    for b in range(0, B, 5):
        r[b, 30:30 + M] = q[b][: min(M, N - 30)]
    for b in range(0, B, 11):
        r[b, 4:20] = q[b][8:24]
        r[b, N - 20:N - 4] = q[b][8:24]
    q[2, 5:25] = 4
    r[7, :] = 4  # unalignable: zero-score row
    return q, r


def _tie_heavy(seed, B, M, N):
    """2-letter alphabet with planted 1-5 bp insertions: the inputs on which
    the lax.scan and Pallas start coordinates differ (ROADMAP F1)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2, (B, M)).astype(np.uint8)
    r = rng.integers(0, 2, (B, N)).astype(np.uint8)
    for b in range(B):
        ins = int(rng.integers(1, 6))
        cut = int(rng.integers(4, M - 4))
        seg = np.concatenate([q[b, :cut],
                              rng.integers(0, 2, ins).astype(np.uint8),
                              q[b, cut:]])
        off = int(rng.integers(0, max(1, N - len(seg))))
        r[b, off:off + len(seg)] = seg[: N - off]
    return q, r


def _pallas_align(q, r, **kw):
    return np.asarray(pallas_sw.sw_align_pallas(
        jnp.asarray(q), jnp.asarray(r), tile=q.shape[0], interpret=True,
        **kw))


def _plain_align(q, r, **kw):
    return cuda_sw.sw_align(torch.from_numpy(q), torch.from_numpy(r),
                            **kw).numpy()


@pytest.mark.parametrize("case", ["planted", "tie_heavy"])
def test_sw_align_plain_matches_pallas_and_oracle(case):
    B, M, N = 128, 32, 64
    q, r = (_planted(1, B, M, N) if case == "planted"
            else _tie_heavy(11, B, M, N))
    got = _plain_align(q, r)
    np.testing.assert_array_equal(got, _pallas_align(q, r))
    for b in range(0, B, 9):
        assert tuple(got[b]) == jax_sw.sw_align_np(q[b], r[b]), b


@pytest.mark.parametrize("case", ["planted", "tie_heavy"])
def test_sw_align_plain_matches_lax_scan_on_score_and_ends(case):
    """lax.scan breaks E ties the other way (ROADMAP F1), so only the
    score and the end coordinates are held to it."""
    B, M, N = 128, 32, 64
    q, r = (_planted(2, B, M, N) if case == "planted"
            else _tie_heavy(12, B, M, N))
    got = _plain_align(q, r)
    want = jax_sw.sw_align(jnp.asarray(q), jnp.asarray(r))
    for i, f in enumerate(jax_sw._FIELDS):
        if f in ("score", "qend", "rend"):
            np.testing.assert_array_equal(got[:, i], np.asarray(want[f]),
                                          err_msg=f)


@pytest.mark.parametrize("case", ["planted", "tie_heavy"])
def test_sw_score_plain_matches_pallas_and_lax_scan(case):
    B, M, N = 128, 32, 64
    q, r = (_planted(3, B, M, N) if case == "planted"
            else _tie_heavy(13, B, M, N))
    got = cuda_sw.sw_score(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    want_pallas = np.asarray(pallas_sw.sw_score_pallas(
        jnp.asarray(q), jnp.asarray(r), tile=B, interpret=True))
    want_scan = np.asarray(jax_sw.sw_score(jnp.asarray(q), jnp.asarray(r)))
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_scan)


def test_sw_align_plain_gap_costs():
    """Non-default match/mismatch/open/ext, as tests/test_pallas_sw.py:68."""
    rng = np.random.default_rng(2)
    B, M, N = 64, 32, 64
    q = rng.integers(0, 4, (B, M)).astype(np.uint8)
    r = rng.integers(0, 4, (B, N)).astype(np.uint8)
    for b in range(B):
        seg = rng.integers(0, 4, 40).astype(np.uint8)
        r[b, 10:50] = seg
        q[b, :30] = np.concatenate([seg[:12], seg[18:36]])
    kw = dict(match=2, mismatch=-3, gap_open=-5, gap_ext=-2)
    got = _plain_align(q, r, **kw)
    np.testing.assert_array_equal(got, _pallas_align(q, r, **kw))
    for b in range(0, B, 13):
        assert tuple(got[b]) == jax_sw.sw_align_np(q[b], r[b], **kw), b


def test_tiled_entry_points_match_reference():
    q, r = _planted(4, 96, 24, 56)
    got = port_sw.sw_align_tiled(q, r, "cpu", tile=40)
    want = _pallas_align(q, r)
    for i, f in enumerate(port_sw.FIELDS):
        np.testing.assert_array_equal(got[f], want[:, i], err_msg=f)
    sc = port_sw.sw_score_tiled(q, r, "cpu", tile=40)
    np.testing.assert_array_equal(
        sc, np.asarray(jax_sw.sw_score(jnp.asarray(q), jnp.asarray(r))))
    np.testing.assert_array_equal(port_sw.sw_score(q[:2], r[:2], "cpu"),
                                  sc[:2])


@pytest.mark.parametrize("shape", [(4, 2, cuda_sw.MAX_N + 1),
                                   (4, 1 << 19, cuda_sw.MAX_N)])
def test_wrappers_reject_windows_above_the_kernels_limits(shape):
    """Above MAX_N reference columns, or where i*(N+1)+j overflows int32,
    both wrappers raise on every device (the plain version is not a
    fallback)."""
    B, M, N = shape
    q = torch.zeros((B, M), dtype=torch.uint8)
    r = torch.zeros((B, N), dtype=torch.uint8)
    for fn in (cuda_sw.sw_align, cuda_sw.sw_score):
        with pytest.raises(ValueError, match="widest|int32"):
            fn(q, r)


def test_sw_plain_at_a_wide_reference():
    """N > 512 (the kernels' wide variant on the card): the plain version
    against the Pallas kernel in interpret mode."""
    q, r = _tie_heavy(14, 8, 40, 600)
    np.testing.assert_array_equal(_plain_align(q, r), _pallas_align(q, r))


def test_wrappers_reject_other_devices_and_types():
    q = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        cuda_sw.sw_align(q, q)
    with pytest.raises(TypeError):
        cuda_sw.sw_score(torch.zeros((2, 8), dtype=torch.int32),
                         torch.zeros((2, 8), dtype=torch.int32))
