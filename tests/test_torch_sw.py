"""Port parity: the plain versions of kernels K1 (sw_align) and K2
(sw_score) against the Pallas kernels in interpret mode, the lax.scan
formulation and the O(MN) numpy oracle; and the Gotoh form and the
wavefront schedule of the CUDA kernel K2, written out in numpy, against
both. Comparisons are exact."""

import hypothesis
import hypothesis.strategies as st
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


NEG = cuda_sw.NEG
SCORE_PARAMS = {"score_defaults": (1, -2, -3, -1),
                "align_defaults": (1, -4, -6, -1),
                "free_gap_open": (2, -3, 0, -2)}


def _sub(qi, rj, match, mismatch):
    return np.where((qi == rj) & (qi < 4) & (rj < 4), match, mismatch)


def _gotoh_np(q, r, match, mismatch, gap_open, gap_ext):
    """K2 cell by cell in the form the CUDA kernel computes it (header of
    csrc/sw.cu), over the batch: no i*ext or j*ext term anywhere."""
    B, M = q.shape
    N = r.shape[1]
    H = np.zeros((B, N + 1), np.int64)          # H[:, j + 1] is column j
    F = np.full((B, N), NEG + gap_open, np.int64)
    best = np.zeros(B, np.int64)
    for i in range(M):
        diag = H[:, 0].copy()                   # H[i-1][j-1], 0 left of j=0
        E = np.full(B, NEG + gap_open, np.int64)
        for j in range(N):
            h1 = np.maximum(np.maximum(
                diag + _sub(q[:, i], r[:, j], match, mismatch), F[:, j]), 0)
            h = np.maximum(h1, E)
            E = np.maximum(E + gap_ext, h1 + gap_open + gap_ext)
            F[:, j] = np.maximum(F[:, j] + gap_ext, h + gap_open + gap_ext)
            diag = H[:, j + 1].copy()
            H[:, j + 1] = h
            best = np.maximum(best, h)
    return best.astype(np.int32)


def _wavefront_np(q, r, G, NPL, match, mismatch, gap_open, gap_ext):
    """One alignment on the kernel's schedule: G lanes of NPL columns, lane
    l on query row t - l at step t, taking from lane l - 1 what it left one
    step earlier; E inside a lane as the running maximum of H1 - c*ext."""
    M, N = len(q), len(r)
    assert G * NPL >= N
    rc = np.full(G * NPL, 255)
    rc[:N] = np.where(r < 4, r, 255)
    qc = np.where(q < 4, q, 254)
    H = np.zeros((G, NPL), np.int64)
    F = np.full((G, NPL), NEG + gap_open, np.int64)
    hlast, eout, hprev = (np.zeros(G, np.int64) for _ in range(3))
    best = 0
    for t in range(M + G - 1):
        hleft = np.concatenate([[0], hlast[:-1]])   # the two shuffles
        e_in = np.concatenate([[NEG], eout[:-1]])
        for l in range(G):
            i = t - l
            if 0 <= i < M:
                hd, e = hprev[l], e_in[l]
                for c in range(NPL):
                    sub = match if rc[l * NPL + c] == qc[i] else mismatch
                    h1 = max(hd + sub, F[l, c], 0)
                    hd = H[l, c]
                    h = max(e + gap_open + c * gap_ext, h1)
                    e = max(h1 - c * gap_ext, e)
                    F[l, c] = max(F[l, c] + gap_ext,
                                  h + gap_open + gap_ext)
                    H[l, c] = h
                best = max(best, int(H[l].max()))   # columns past N too
                hlast[l], eout[l] = H[l, NPL - 1], e + NPL * gap_ext
        hprev = hleft
    return best


@pytest.mark.parametrize("params", list(SCORE_PARAMS))
@pytest.mark.parametrize("shape", [(32, 32), (96, 96), (160, 160),
                                   (40, 100)])
def test_sw_score_gotoh_form_matches_plain_and_pallas(shape, params):
    """The recurrence the CUDA kernel K2 runs equals the plain version and
    the Pallas kernel, on planted and on tie-heavy inputs."""
    M, N = shape
    B = 16
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_ext"),
                  SCORE_PARAMS[params]))
    for q, r in (_planted(M + N, B, M, N), _tie_heavy(M + N + 1, B, M, N)):
        got = _gotoh_np(q, r, **kw)
        plain = cuda_sw.sw_score_plain(torch.from_numpy(q),
                                       torch.from_numpy(r), **kw).numpy()
        pallas = np.asarray(pallas_sw.sw_score_pallas(
            jnp.asarray(q), jnp.asarray(r), tile=B, interpret=True, **kw))
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("mapping", [(8, 4, 32), (16, 6, 96), (16, 8, 100),
                                     (32, 5, 160), (16, 10, 160)])
def test_sw_score_wavefront_schedule_matches_plain(mapping):
    """(lanes a group, columns a lane, N): the anti-diagonal schedule of
    the CUDA kernel, columns past N left in the maximum as the kernel
    leaves them for parameters that decay."""
    G, NPL, N = mapping
    M = 24
    q, r = _tie_heavy(G + NPL, 6, M, N)
    q[1, 3:9] = 4
    r[2, 10:14] = 4
    for params in SCORE_PARAMS.values():
        want = cuda_sw.sw_score_plain(torch.from_numpy(q),
                                      torch.from_numpy(r), *params).numpy()
        got = [_wavefront_np(q[b], r[b], G, NPL, *params)
               for b in range(len(q))]
        np.testing.assert_array_equal(got, want)


@hypothesis.settings(max_examples=30, deadline=None)
@hypothesis.given(
    B=st.integers(1, 4), M=st.integers(1, 12), N=st.integers(1, 20),
    match=st.integers(0, 4), mismatch=st.integers(-5, 0),
    gap_open=st.integers(-7, 0), gap_ext=st.integers(-3, 0),
    alpha=st.sampled_from([2, 5]), seed=st.integers(0, 1 << 16))
def test_sw_score_gotoh_form_matches_plain_on_small_inputs(
        B, M, N, match, mismatch, gap_open, gap_ext, alpha, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, alpha, (B, M)).astype(np.uint8)
    r = rng.integers(0, alpha, (B, N)).astype(np.uint8)
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_ext=gap_ext)
    plain = cuda_sw.sw_score_plain(torch.from_numpy(q), torch.from_numpy(r),
                                   **kw).numpy()
    np.testing.assert_array_equal(_gotoh_np(q, r, **kw), plain)
    got = [_wavefront_np(q[b], r[b], 8, 3, **kw) for b in range(B)]
    np.testing.assert_array_equal(got, plain)
