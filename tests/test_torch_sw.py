"""Port parity: the plain versions of kernels K1 (sw_align) and K2
(sw_score) against the Pallas kernels in interpret mode, the lax.scan
formulation and the O(MN) numpy oracle; and the Gotoh form and the
wavefront schedules of the CUDA kernels K1 and K2 (narrow groups, K1's
wide stripes with a lag and a ring, and its sweep of bands joined by an
edge buffer), written out in numpy, against them.
Comparisons are exact."""

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
    score and the end coordinates of the plain version and of K1's Gotoh
    form are held to it."""
    B, M, N = 128, 32, 64
    q, r = (_planted(2, B, M, N) if case == "planted"
            else _tie_heavy(12, B, M, N))
    got = _plain_align(q, r)
    gotoh = _gotoh_align_np(q, r, *SCORE_PARAMS["align_defaults"])
    want = jax_sw.sw_align(jnp.asarray(q), jnp.asarray(r))
    for i, f in enumerate(jax_sw._FIELDS):
        if f in ("score", "qend", "rend"):
            for x in (got, gotoh):
                np.testing.assert_array_equal(x[:, i], np.asarray(want[f]),
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


@pytest.mark.parametrize("shape", [(4, 1 << 12, 1 << 19),
                                   (4, 1 << 19, cuda_sw.WIDE_MAX_N)])
def test_wrappers_reject_windows_above_the_kernels_limits(shape):
    """Where i*(N+1)+j overflows int32 (the origin register, the one limit
    of the kernels' width: wider references sweep bands), both wrappers
    raise on every device (the plain version is not a fallback)."""
    B, M, N = shape
    q = torch.zeros((B, M), dtype=torch.uint8)
    r = torch.zeros((B, N), dtype=torch.uint8)
    for fn in (cuda_sw.sw_align, cuda_sw.sw_score):
        with pytest.raises(ValueError, match="int32"):
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


# K1: the scores of SCORE_PARAMS and a set whose scores do not fit a byte
# of the kernel's table; and parameters that do not decay, for which the
# kernel masks the columns past N out of the best (its guarded variant)
ALIGN_PARAMS = {**SCORE_PARAMS, "past_a_byte": (200, -300, -500, -30)}
GUARDED_PARAMS = {"mismatch_gains": (2, 1, 1, 1), "open_gains": (3, -1, 2, -1)}


def _align_fields(bH, bPos, bO, N):
    """score, qstart, qend, rstart, rend from the best cell's H, packed
    index i*(N+1)+j and origin; all 0 where the score is not positive."""
    np1 = N + 1
    out = np.stack([bH, bO // np1, bPos // np1, bO % np1, bPos % np1], 1)
    out[bH <= 0] = 0
    return out.astype(np.int32)


def _gotoh_align_np(q, r, match, mismatch, gap_open, gap_ext):
    """K1 cell by cell in the Gotoh form with origins (header of
    csrc/sw.cu), over the batch: each maximum takes its winner with the
    operands in the kernel's order."""
    B, M = q.shape
    N = r.shape[1]
    np1, goe = N + 1, gap_open + gap_ext
    H = np.zeros((B, N + 1), np.int64)          # H[:, j + 1] is column j
    O = np.zeros((B, N + 1), np.int64)
    F = np.full((B, N), NEG + gap_open, np.int64)
    FO = np.zeros((B, N), np.int64)
    bH, bPos, bO = (np.zeros(B, np.int64) for _ in range(3))
    for i in range(M):
        hd, od = H[:, 0].copy(), O[:, 0].copy()  # 0 left of column 0
        E = np.full(B, NEG + gap_open, np.int64)
        EO = np.zeros(B, np.int64)
        for j in range(N):
            start = i * np1 + j
            h0 = np.maximum(hd + _sub(q[:, i], r[:, j], match, mismatch), 0)
            d_o = np.where(hd > 0, od, start)
            f = F[:, j] > h0                     # the diagonal wins a tie
            h1 = np.where(f, F[:, j], h0)
            o1 = np.where(f, FO[:, j], d_o)
            e = E > h1                           # H1 wins a tie
            h = np.where(e, E, h1)
            o = np.where(e, EO, o1)
            op = h1 + goe >= E + gap_ext         # the opened gap wins a tie
            E = np.where(op, h1 + goe, E + gap_ext)
            EO = np.where(op, o1, EO)
            ex = F[:, j] + gap_ext >= h + goe    # the extended gap wins a tie
            F[:, j] = np.where(ex, F[:, j] + gap_ext, h + goe)
            FO[:, j] = np.where(ex, FO[:, j], o)
            hd, od = H[:, j + 1].copy(), O[:, j + 1].copy()
            H[:, j + 1], O[:, j + 1] = h, o
            b = h > bH                           # the earliest cell
            bH = np.where(b, h, bH)
            bPos = np.where(b, start, bPos)
            bO = np.where(b, o, bO)
    return _align_fields(bH, bPos, bO, N)


class _Lanes:
    """The registers of K1's lanes over a batch: H, O, F and F's origin of
    every column (the columns of lane l are [l*NPL, (l+1)*NPL)), each
    lane's best cell, and what each lane left for the lane to its right
    (last H and O, outgoing E and its origin)."""

    def __init__(self, q, r, lanes, NPL, params, guard, col0=0):
        B, self.N = r.shape
        self.M = q.shape[1]
        self.NPL, self.params = NPL, params
        self.guard = guard
        self.col0 = col0  # the first column of lane 0 (a band's)
        W = lanes * NPL
        # codes past N and query codes above 3 never match (kPadR, kPadQ)
        self.rc = np.full((B, W), 255, np.int64)
        width = min(W, self.N - col0)
        self.rc[:, :width] = np.where(r[:, col0:col0 + width] < 4,
                                      r[:, col0:col0 + width], 255)
        self.qc = np.where(q < 4, q, 254).astype(np.int64)
        z = lambda n: np.zeros((B, n), np.int64)
        self.H, self.O, self.FO = z(W), z(W), z(W)
        self.F = np.full((B, W), NEG + params[2], np.int64)
        self.bH, self.bPos, self.bO = z(lanes), z(lanes), z(lanes)
        self.left = [z(lanes) for _ in range(4)]  # last H, O; E out, origin
        self.prev = [z(lanes), z(lanes)]          # H, O of the row above

    def row(self, l, i, hd, od, e, eo):
        """Lane l on query row i (align_row in csrc/sw.cu)."""
        match, mismatch, gap_open, gap_ext = self.params
        goe = gap_open + gap_ext
        H, O, F, FO = self.H, self.O, self.F, self.FO
        base = i * (self.N + 1) + self.col0 + l * self.NPL
        for c in range(self.NPL):
            j = l * self.NPL + c
            start = base + c
            sub = np.where(self.rc[:, j] == self.qc[:, i], match, mismatch)
            h0 = np.maximum(hd + sub, 0)
            d_o = np.where(hd > 0, od, start)
            p = h0 >= F[:, j]
            h1, o1 = np.where(p, h0, F[:, j]), np.where(p, d_o, FO[:, j])
            hd, od = H[:, j].copy(), O[:, j].copy()
            p = h1 >= e
            h, o = np.where(p, h1, e), np.where(p, o1, eo)
            p = h1 + goe >= e + gap_ext
            e, eo = np.where(p, h1 + goe, e + gap_ext), np.where(p, o1, eo)
            p = F[:, j] + gap_ext >= h + goe
            F[:, j] = np.where(p, F[:, j] + gap_ext, h + goe)
            FO[:, j] = np.where(p, FO[:, j], o)
            H[:, j], O[:, j] = h, o
            if self.guard and self.col0 + j >= self.N:
                continue
            p = self.bH[:, l] >= h
            self.bH[:, l] = np.where(p, self.bH[:, l], h)
            self.bPos[:, l] = np.where(p, self.bPos[:, l], start)
            self.bO[:, l] = np.where(p, self.bO[:, l], o)
        j = (l + 1) * self.NPL - 1
        for x, v in zip(self.left, (H[:, j], O[:, j], e, eo)):
            x[:, l] = v

    def step(self, t, lanes, edge=None):
        """Step t of the G lanes `lanes` (a slice): lane l on row
        t - (l - lanes.start). The shuffles take what the lane to the left
        left one step earlier; the group's first lane takes 0 and E's
        start, or `edge(i)` (the ring) where it is given."""
        G = lanes.stop - lanes.start
        fill = (0, 0, NEG + self.params[2], 0)
        got = [np.concatenate([np.full((len(x), 1), f), x[:, lanes][:, :-1]],
                              1) for x, f in zip(self.left, fill)]
        if edge is not None and t < self.M:
            for x, v in zip(got, edge(t)):
                x[:, 0] = v
        for lg in range(G):
            i = t - lg
            if 0 <= i < self.M:
                l = lanes.start + lg
                self.row(l, i, self.prev[0][:, l], self.prev[1][:, l],
                         got[2][:, lg], got[3][:, lg])
        self.prev[0][:, lanes], self.prev[1][:, lanes] = got[0], got[1]

    def best(self):
        """Over the lanes: max H, then the smallest packed index."""
        return _best_of(self.bH, self.bPos, self.bO, self.N)


def _best_of(bH, bPos, bO, N):
    """The fields of the best cell among the columns of [B, n] bests: max
    H, then the smallest packed index."""
    top = bH == bH.max(1, keepdims=True)
    k = np.where(top, bPos, np.iinfo(np.int64).max).argmin(1)
    rows = np.arange(len(k))
    return _align_fields(bH[rows, k], bPos[rows, k], bO[rows, k], N)


def _wavefront_align_np(q, r, G, NPL, params, guard=False):
    """K1's narrow schedule over the batch: G lanes of NPL columns, lane l
    on query row t - l at step t (four shuffles a step, no scan)."""
    assert G * NPL >= r.shape[1]
    lanes = _Lanes(q, r, G, NPL, params, guard)
    for t in range(q.shape[1] + G - 1):
        lanes.step(t, slice(0, G))
    return lanes.best()


def _stripes_align_np(q, r, NPL, lag, ring, params, guard=False):
    """K1's wide schedule: stripe w is 32 lanes of NPL columns running the
    same wavefront `lag` steps behind stripe w-1. The edge of every row
    (last H and O, outgoing E and origin of the left stripe's last lane)
    goes through a ring of `ring` rows; a slot is overwritten only after
    the right stripe read it, and read only when it holds its row."""
    S = -(-r.shape[1] // (32 * NPL))
    lanes = _Lanes(q, r, 32 * S, NPL, params, guard)
    _run_stripes(lanes, S, lag, ring)
    return lanes.best()


def _run_stripes(lanes, S, lag, ring, edge_in=None, edge_out=None):
    """The S stripes of `lanes`, stripe w `lag` steps behind stripe w-1,
    the edge between two through a ring of `ring` rows. edge_in(i): row
    i's left edge of the first stripe (0 and E's start where it is None);
    edge_out(i, edge): the last stripe's outgoing edge of row i."""
    M = lanes.M
    held = np.full((S, ring), -1)     # the row each slot holds
    read = np.full((S, ring), -1)     # the row last read from it
    slots = np.zeros((S, ring, 4, lanes.H.shape[0]), np.int64)

    def edge(w):
        def take(i):
            assert held[w - 1, i % ring] == i, ("not yet written", w, i)
            read[w - 1, i % ring] = i
            return slots[w - 1, i % ring]
        return take if w else edge_in

    T = M + 31
    for tau in range(T + (S - 1) * lag):
        for w in range(S):
            t = tau - w * lag
            if not 0 <= t < T:
                continue
            lanes.step(t, slice(32 * w, 32 * w + 32), edge(w))
            i = t - 31                # the stripe's last lane wrote row i
            if not 0 <= i < M:
                continue
            out = [x[:, 32 * w + 31] for x in lanes.left]
            if w + 1 < S:
                k = i % ring
                assert held[w, k] < 0 or read[w, k] == held[w, k], (w, i)
                held[w, k] = i
                slots[w, k] = out
            elif edge_out is not None:
                edge_out(i, out)


def _bands_align_np(q, r, NPL, S, lag, ring, params, guard=False):
    """K1's sweep of a reference wider than its block: bands of S stripes
    (32 lanes of NPL columns each), one after another. The last stripe of
    a band writes its outgoing edge of every row into ONE buffer of M rows,
    which the first stripe of the next band reads in place of column 0's
    boundary: a row is overwritten only after that stripe read it, and read
    only after the band before wrote it. A last band narrower than S
    stripes runs only the stripes it has. Each lane's best of a band joins
    the bests of the bands before, lexicographically."""
    B, M = q.shape
    N = r.shape[1]
    width = 32 * NPL * S
    buf = np.zeros((M, 4, B), np.int64)
    written = np.full(M, -1)   # the band that wrote each row last
    read = np.full(M, -1)      # the band that read it last
    bests = []
    for band, col0 in enumerate(range(0, N, width)):
        stripes = min(S, -(-(N - col0) // (32 * NPL)))
        lanes = _Lanes(q, r, 32 * stripes, NPL, params, guard, col0=col0)

        def edge_in(i, band=band):
            assert written[i] == band - 1, ("edge not yet written", band, i)
            read[i] = band
            return buf[i]

        def edge_out(i, edge, band=band):
            assert band == 0 or read[i] == band, ("edge not yet read", band, i)
            buf[i] = edge
            written[i] = band

        _run_stripes(lanes, stripes, lag, ring,
                     edge_in if band else None,
                     edge_out if col0 + width < N else None)
        bests.append((lanes.bH, lanes.bPos, lanes.bO))
    return _best_of(*(np.concatenate(x, 1) for x in zip(*bests)), N)


def _with_code4(q, r):
    q, r = q.copy(), r.copy()
    q[1, 3:9] = 4
    r[2, 10:14] = 4
    r[3, :] = 4
    return q, r


@pytest.mark.parametrize("params", list(ALIGN_PARAMS))
def test_sw_align_gotoh_form_matches_plain_pallas_and_oracle(params):
    """K1's recurrence with origins and its narrow schedule equal the
    plain version, the Pallas kernel and the O(MN) oracle on planted and
    tie-heavy inputs with code-4 rows and columns (start coordinates
    included)."""
    B, M, N = 12, 32, 60
    prm = ALIGN_PARAMS[params]
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_ext"), prm))
    for q, r in (_planted(M + N, B, M, N), _tie_heavy(M + N + 1, B, M, N)):
        q, r = _with_code4(q, r)
        want = _plain_align(q, r, **kw)
        np.testing.assert_array_equal(_gotoh_align_np(q, r, **kw), want)
        np.testing.assert_array_equal(_wavefront_align_np(q, r, 8, 8, prm),
                                      want)
        np.testing.assert_array_equal(_pallas_align(q, r, **kw), want)
        for b in range(0, B, 3):
            assert tuple(want[b]) == jax_sw.sw_align_np(q[b], r[b], **kw), b


@pytest.mark.parametrize("mapping", [(8, 4, 32), (8, 12, 90), (16, 12, 192),
                                     (16, 16, 250), (32, 12, 380)])
def test_sw_align_wavefront_schedule_matches_plain(mapping):
    """(lanes a group, columns a lane, N): K1's narrow schedule, columns
    past N in the best for parameters that decay and masked for the
    others (the guarded kernel), equals the plain version."""
    G, NPL, N = mapping
    q, r = _with_code4(*_tie_heavy(G + NPL, 5, 20, N))
    for name, prm in {**ALIGN_PARAMS, **GUARDED_PARAMS}.items():
        want = cuda_sw.sw_align_plain(torch.from_numpy(q),
                                      torch.from_numpy(r), *prm).numpy()
        got = _wavefront_align_np(q, r, G, NPL, prm,
                                  guard=name in GUARDED_PARAMS)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("stripes", [(2, 150, 32, 8), (2, 129, 45, 16),
                                     (8, 600, 64, 256)])
def test_sw_align_wide_stripes_match_plain(stripes):
    """(columns a lane, N, lag, ring rows): K1's wide schedule, a stripe
    of 32 lanes a warp running behind the stripe to its left and taking
    its edge through a ring that wraps (more query rows than ring rows
    where the ring is short), equals the plain version."""
    NPL, N, lag, ring = stripes
    M = 40 if N < 512 else 20
    q, r = _with_code4(*_tie_heavy(N + lag, 4, M, N))
    for name, prm in {**ALIGN_PARAMS, **GUARDED_PARAMS}.items():
        want = cuda_sw.sw_align_plain(torch.from_numpy(q),
                                      torch.from_numpy(r), *prm).numpy()
        got = _stripes_align_np(q, r, NPL, lag, ring, prm,
                                guard=name in GUARDED_PARAMS)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("bands", [(1, 3, 32, 8), (1, 3, 40, 64),
                                   (2, 2, 33, 16)])
def test_sw_align_bands_match_pallas(bands):
    """(columns a lane, stripes a band, lag, ring rows): K1's sweep of a
    reference wider than its block, with a band of 96 or 128 columns so
    that N = 200 crosses three bands (the last of 8 columns, one stripe) or
    two, equals the Pallas kernel in interpret mode on tie-heavy inputs,
    start coordinates included, and K2's Pallas score; the guarded
    parameters equal the plain version."""
    NPL, S, lag, ring = bands
    B, M, N = 6, 40, 200
    q, r = _with_code4(*_tie_heavy(N + S + lag, B, M, N))
    for name, prm in {**ALIGN_PARAMS, **GUARDED_PARAMS}.items():
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_ext"), prm))
        got = _bands_align_np(q, r, NPL, S, lag, ring, prm,
                              guard=name in GUARDED_PARAMS)
        if name in GUARDED_PARAMS:
            want = _plain_align(q, r, **kw)
        else:
            want = _pallas_align(q, r, **kw)
            score = np.asarray(pallas_sw.sw_score_pallas(
                jnp.asarray(q), jnp.asarray(r), tile=B, interpret=True,
                **kw))
            np.testing.assert_array_equal(got[:, 0], score, err_msg=name)
        np.testing.assert_array_equal(got, want, err_msg=name)


@hypothesis.settings(max_examples=30, deadline=None)
@hypothesis.given(
    B=st.integers(1, 4), M=st.integers(1, 12), N=st.integers(1, 20),
    match=st.integers(0, 4), mismatch=st.integers(-5, 0),
    gap_open=st.integers(-7, 0), gap_ext=st.integers(-3, 0),
    alpha=st.sampled_from([2, 5]), seed=st.integers(0, 1 << 16))
def test_sw_align_gotoh_form_matches_plain_on_small_inputs(
        B, M, N, match, mismatch, gap_open, gap_ext, alpha, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, alpha, (B, M)).astype(np.uint8)
    r = rng.integers(0, alpha, (B, N)).astype(np.uint8)
    prm = (match, mismatch, gap_open, gap_ext)
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_ext"), prm))
    plain = _plain_align(q, r, **kw)
    np.testing.assert_array_equal(_gotoh_align_np(q, r, **kw), plain)
    np.testing.assert_array_equal(_wavefront_align_np(q, r, 4, 5, prm),
                                  plain)
    for b in range(B):
        assert tuple(plain[b]) == jax_sw.sw_align_np(q[b], r[b], **kw), b
