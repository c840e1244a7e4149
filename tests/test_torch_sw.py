"""Port parity: the plain versions of kernels K1 (sw_align) and K2
(sw_score) against the Pallas kernels in interpret mode, the lax.scan
formulation and the O(MN) numpy oracle; and the Gotoh form and the
wavefront schedules of the CUDA kernels K1 and K2 (narrow groups, K1's
wide stripes with a lag and a ring, and both kernels' bands running
together in a cluster, joined by rings between blocks and past the
cluster's reach by a wrap buffer), written out in numpy, against them;
and the tie rule at free vertical gaps, where the oracle and Pallas part.
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
    of the kernels' width: wider references run in bands), both wrappers
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
        self.fill = (0, 0, NEG + params[2], 0)

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
        left one step earlier; the group's first lane takes `fill` (0 and
        E's start), or `edge(i)` (the ring) where it is given. The first
        len(prev) values a lane leaves are the next row's diagonal."""
        G = lanes.stop - lanes.start
        got = [np.concatenate([np.full((len(x), 1), f), x[:, lanes][:, :-1]],
                              1) for x, f in zip(self.left, self.fill)]
        if edge is not None and t < self.M:
            for x, v in zip(got, edge(t)):
                x[:, 0] = v
        n = len(self.prev)
        for lg in range(G):
            i = t - lg
            if 0 <= i < self.M:
                l = lanes.start + lg
                self.row(l, i, *(p[:, l] for p in self.prev),
                         *(x[:, lg] for x in got[n:]))
        for p, x in zip(self.prev, got):
            p[:, lanes] = x

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


def _run_stripes(lanes, S, lag, ring):
    """The S stripes of `lanes`, stripe w `lag` steps behind stripe w-1,
    the edge between two through a ring of `ring` rows."""
    M = lanes.M
    held = np.full((S, ring), -1)     # the row each slot holds
    read = np.full((S, ring), -1)     # the row last read from it
    slots = np.zeros((S, ring, 4, lanes.H.shape[0]), np.int64)

    def edge(w):
        def take(i):
            assert held[w - 1, i % ring] == i, ("not yet written", w, i)
            read[w - 1, i % ring] = i
            return slots[w - 1, i % ring]
        return take if w else None

    T = M + 31
    for tau in range(T + (S - 1) * lag):
        for w in range(S):
            t = tau - w * lag
            if not 0 <= t < T:
                continue
            lanes.step(t, slice(32 * w, 32 * w + 32), edge(w))
            i = t - 31                # the stripe's last lane wrote row i
            if not 0 <= i < M or w + 1 == S:
                continue
            k = i % ring
            assert held[w, k] < 0 or read[w, k] == held[w, k], (w, i)
            held[w, k] = i
            slots[w, k] = [x[:, 32 * w + 31] for x in lanes.left]


class _ScoreLanes(_Lanes):
    """K2's lanes over a batch: H and F of every column, each lane's best
    H, and what each lane left for the lane to its right (last H, outgoing
    E)."""

    def __init__(self, q, r, lanes, NPL, params, guard, col0=0):
        super().__init__(q, r, lanes, NPL, params, guard, col0)
        B = r.shape[0]
        self.best_h = np.zeros((B, lanes), np.int64)
        self.left = [np.zeros((B, lanes), np.int64) for _ in range(2)]
        self.prev = [np.zeros((B, lanes), np.int64)]  # H of the row above
        self.fill = (0, NEG + params[2])

    def row(self, l, i, hd, e):
        """Lane l on query row i (score_row in csrc/sw.cu)."""
        match, mismatch, gap_open, gap_ext = self.params
        goe = gap_open + gap_ext
        H, F = self.H, self.F
        for c in range(self.NPL):
            j = l * self.NPL + c
            sub = np.where(self.rc[:, j] == self.qc[:, i], match, mismatch)
            h1 = np.maximum(np.maximum(hd + sub, F[:, j]), 0)
            hd = H[:, j].copy()
            h = np.maximum(h1, e)
            e = np.maximum(e + gap_ext, h1 + goe)
            F[:, j] = np.maximum(F[:, j] + gap_ext, h + goe)
            H[:, j] = h
            if not (self.guard and self.col0 + j >= self.N):
                self.best_h[:, l] = np.maximum(self.best_h[:, l], h)
        j = (l + 1) * self.NPL - 1
        self.left[0][:, l], self.left[1][:, l] = H[:, j], e


def _cluster_bands(N, NPL, S):
    """(warps a block, columns a band, bands): ceil(N / (S stripes)) bands,
    balanced, each rounded up to whole stripes of 32 * NPL columns
    (band_shape in csrc/sw.cu, where S stripes make 4,096 columns)."""
    stripe = 32 * NPL
    nb = -(-N // (S * stripe))
    warps = -(-(-(-N // nb)) // stripe)
    return warps, warps * stripe, -(-N // (warps * stripe))


def _run_cluster(make, M, N, NPL, S, lag, ring, cluster, lagb, band_ring):
    """The band kernels' schedule: one block a band, min(bands, cluster)
    blocks, block r running the bands r, r + cluster, ... one after
    another (round k its k-th). Within a band stripe w runs `lag` steps
    behind stripe w-1, its left edge through a ring of `ring` rows; a band
    starts `lagb` steps after the last stripe of the band to its left, and
    not before its block's band before has finished. The edge between two
    bands goes through a ring of `band_ring` rows in the right block's
    memory, the rows of every round one stream (round k's row i is k*M +
    i); from the cluster's last block to its first (past `cluster` bands)
    through one buffer of M rows. A slot is read only when it holds its
    row and overwritten only after it was read. make(col0, stripes): the
    lanes of a band. Returns [(block, lanes) of every band]."""
    warps, W, nbands = _cluster_bands(N, NPL, S)
    cs = min(nbands, cluster)
    T = M + 31
    stripes = [min(warps, -(-(N - g * W) // (32 * NPL)))
               for g in range(nbands)]
    lanes = [make(g * W, stripes[g]) for g in range(nbands)]
    start = []
    for g in range(nbands):
        s = 0 if g == 0 else start[g - 1] + (stripes[g - 1] - 1) * lag + lagb
        if g >= cs:  # the block's band before is done
            s = max(s, start[g - cs] + (stripes[g - cs] - 1) * lag + T)
        start.append(s)
    nv = len(lanes[0].left)
    B = lanes[0].H.shape[0]
    # the rings between stripes of a band, between blocks, and the wrap:
    # the row (stream position) each slot holds, and the last one read
    held = [np.full((warps, ring), -1) for _ in range(nbands)]
    read = [np.full((warps, ring), -1) for _ in range(nbands)]
    slots = [np.zeros((warps, ring, nv, B), np.int64) for _ in range(nbands)]
    bheld = np.full((cs, band_ring), -1)
    bread = np.full((cs, band_ring), -1)
    bslots = np.zeros((cs, band_ring, nv, B), np.int64)
    wrap = np.zeros((M, nv, B), np.int64)
    wwritten = np.full(M, -1)  # the band that wrote each row last
    wread = np.full(M, -1)     # the band that read it last

    def edge_in(g, w):
        if w > 0:
            def take(i):
                assert held[g][w - 1, i % ring] == i, ("stripe", g, w, i)
                read[g][w - 1, i % ring] = i
                return slots[g][w - 1, i % ring]
            return take
        if g == 0:
            return None
        r, k = g % cs, g // cs
        if r > 0:
            def take(i):
                pos = k * M + i
                assert bheld[r, pos % band_ring] == pos, ("band", g, i)
                bread[r, pos % band_ring] = pos
                return bslots[r, pos % band_ring]
            return take

        def take(i):
            assert wwritten[i] == g - 1, ("wrap not yet written", g, i)
            wread[i] = g
            return wrap[i]
        return take

    def edge_out(g, w, i, out):
        if w + 1 < stripes[g]:
            k = i % ring
            assert held[g][w, k] < 0 or read[g][w, k] == held[g][w, k]
            held[g][w, k], slots[g][w, k] = i, out
        elif g + 1 < nbands:
            r, k = g % cs, g // cs
            if r + 1 < cs:
                pos = k * M + i
                slot = pos % band_ring
                assert (bheld[r + 1, slot] < 0
                        or bread[r + 1, slot] == bheld[r + 1, slot]), (
                    "band ring full", g, i)
                bheld[r + 1, slot], bslots[r + 1, slot] = pos, out
            else:
                assert wwritten[i] < 0 or wread[i] == wwritten[i] + 1, (
                    "wrap not yet read", g, i)
                wrap[i], wwritten[i] = out, g

    end = max(start[g] + (stripes[g] - 1) * lag + T for g in range(nbands))
    for tau in range(end):
        # right to left: a row written at step tau is read at tau + 1 on
        for g in reversed(range(nbands)):
            for w in reversed(range(stripes[g])):
                t = tau - start[g] - w * lag
                if not 0 <= t < T:
                    continue
                lanes[g].step(t, slice(32 * w, 32 * w + 32), edge_in(g, w))
                i = t - 31  # the stripe's last lane wrote row i
                if 0 <= i < M:
                    edge_out(g, w, i,
                             [x[:, 32 * w + 31] for x in lanes[g].left])
    return [(g % cs, lanes[g]) for g in range(nbands)]


def _fold_align(a, b):
    """The better of two (H, packed index, origin) bests, lane by lane:
    max H, then the smallest index (take_better in csrc/sw.cu)."""
    take = (b[0] > a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
    return tuple(np.where(take, y, x) for x, y in zip(a, b))


def _cluster_align_np(q, r, NPL, S, lag, ring, cluster, lagb, band_ring,
                      params, guard=False):
    """K1 on the band kernels' schedule (_run_cluster). A lane keeps its
    best of its block's bands (folded round by round), the block folds its
    lanes, and block 0 folds the blocks in band order."""
    B, M = q.shape
    N = r.shape[1]
    bands = _run_cluster(
        lambda col0, n: _Lanes(q, r, 32 * n, NPL, params, guard, col0),
        M, N, NPL, S, lag, ring, cluster, lagb, band_ring)
    warps = _cluster_bands(N, NPL, S)[0]
    zero = tuple(np.zeros((B, 32 * warps), np.int64) for _ in range(3))
    per_block = {}
    for blk, lanes in bands:
        n = lanes.bH.shape[1]
        mine = tuple(np.pad(x, ((0, 0), (0, 32 * warps - n)))
                     for x in (lanes.bH, lanes.bPos, lanes.bO))
        per_block[blk] = _fold_align(per_block.get(blk, zero), mine)
    best = tuple(np.zeros(B, np.int64) for _ in range(3))
    for blk in sorted(per_block):
        bH, bPos, bO = per_block[blk]
        for lane in range(bH.shape[1]):
            best = _fold_align(best, (bH[:, lane], bPos[:, lane],
                                      bO[:, lane]))
    return _align_fields(*best, N)


def _cluster_score_np(q, r, NPL, S, lag, ring, cluster, lagb, band_ring,
                      params, guard=False):
    """K2 on the band kernels' schedule: the maximum of every lane's best
    over every band."""
    bands = _run_cluster(
        lambda col0, n: _ScoreLanes(q, r, 32 * n, NPL, params, guard, col0),
        q.shape[1], r.shape[1], NPL, S, lag, ring, cluster, lagb, band_ring)
    return np.max([lanes.best_h.max(1) for _, lanes in bands],
                  0).astype(np.int32)


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


# (columns a lane, stripes of the widest band, lag between stripes, their
# ring's rows, cluster size, lag between bands, the band ring's rows); N =
# 200 makes bands of 96 (the last of 8 columns, one stripe) or 128
# columns, M = 40 rows wrap every band ring; a cluster of 2 takes bands
# round-robin and wraps the edge from its last block to its first
CLUSTER_CASES = {"three_bands": (1, 3, 32, 8, 8, 32, 16),
                 "long_lags": (1, 3, 40, 64, 8, 40, 64),
                 "two_bands": (2, 2, 33, 16, 8, 33, 8),
                 "round_robin": (1, 2, 32, 8, 2, 36, 8),
                 "seven_bands_two_blocks": (1, 1, 32, 8, 2, 32, 4)}


@pytest.mark.parametrize("case", list(CLUSTER_CASES))
def test_sw_align_bands_match_pallas(case):
    """K1's band kernels on their schedule (one block a band, the bands of
    an alignment in a cluster, running together; balanced bands; rings
    between stripes and between blocks that wrap; past the cluster's reach
    bands round-robin and the wrap edge) equal the Pallas kernel in
    interpret mode on tie-heavy inputs, start coordinates included; the
    guarded parameters equal the plain version."""
    shape = CLUSTER_CASES[case]
    B, M, N = 6, 40, 200
    q, r = _with_code4(*_tie_heavy(N + sum(shape), B, M, N))
    for name, prm in {**ALIGN_PARAMS, **GUARDED_PARAMS}.items():
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_ext"), prm))
        got = _cluster_align_np(q, r, *shape, prm,
                                guard=name in GUARDED_PARAMS)
        want = (_plain_align(q, r, **kw) if name in GUARDED_PARAMS
                else _pallas_align(q, r, **kw))
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("case", list(CLUSTER_CASES))
def test_sw_score_bands_match_pallas(case):
    """K2's band kernels on the same schedule equal the Pallas score
    kernel in interpret mode on tie-heavy inputs; the guarded parameters
    equal the plain version."""
    shape = CLUSTER_CASES[case]
    B, M, N = 6, 40, 200
    q, r = _with_code4(*_tie_heavy(N + sum(shape) + 1, B, M, N))
    for name, prm in {**ALIGN_PARAMS, **GUARDED_PARAMS}.items():
        kw = dict(zip(("match", "mismatch", "gap_open", "gap_ext"), prm))
        got = _cluster_score_np(q, r, *shape, prm,
                                guard=name in GUARDED_PARAMS)
        if name in GUARDED_PARAMS:
            want = cuda_sw.sw_score_plain(torch.from_numpy(q),
                                          torch.from_numpy(r), **kw).numpy()
        else:
            want = np.asarray(pallas_sw.sw_score_pallas(
                jnp.asarray(q), jnp.asarray(r), tile=B, interpret=True,
                **kw))
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_balanced_bands_match_the_kernels_band_shape():
    """The balanced bands of csrc/sw.cu's band_shape at K1's stripes of
    512 columns (8 to a block of 4,096): N = 4,097 is two bands of 2,560
    and 1,537 columns, not 4,096 + 1; 6,000 two of 3,072; 8,192 two of
    4,096; 33,000 and 36,865 are nine and ten bands of 4,096, past a
    cluster's 8."""
    assert _cluster_bands(4097, 16, 8) == (5, 2560, 2)
    assert _cluster_bands(6000, 16, 8) == (6, 3072, 2)
    assert _cluster_bands(8192, 16, 8) == (8, 4096, 2)
    assert _cluster_bands(33000, 16, 8) == (8, 4096, 9)
    assert _cluster_bands(36865, 16, 8) == (8, 4096, 10)


def test_sw_align_free_gap_ties_follow_pallas_not_the_oracle():
    """At gap extend 0 a vertical gap costs the same whatever its length,
    so gaps opened in different rows of a column tie. The O(MN) oracle
    takes the nearest row among them (its first candidate is g = 1);
    Pallas keeps the earliest (Mf keeps the older value), and so do
    lax.scan and the port (ROADMAP F1). The draw that showed it: B=1, M=7,
    N=3, match 1, mismatch 0, open 0, ext 0, alphabet 5, seed 60656; q[2]
    and q[3] both match r[1], q[5] matches r[2], a free gap between."""
    rng = np.random.default_rng(60656)
    q = rng.integers(0, 5, (1, 7)).astype(np.uint8)
    r = rng.integers(0, 5, (1, 3)).astype(np.uint8)
    kw = dict(match=1, mismatch=0, gap_open=0, gap_ext=0)
    want = [[2, 2, 5, 1, 2]]  # score, qstart, qend, rstart, rend
    np.testing.assert_array_equal(_plain_align(q, r, **kw), want)
    np.testing.assert_array_equal(_pallas_align(q, r, **kw), want)
    np.testing.assert_array_equal(
        _gotoh_align_np(q, r, **kw), want)
    lax = jax_sw.sw_align(jnp.asarray(q), jnp.asarray(r), **kw)
    assert [int(lax[k][0]) for k in ("score", "qstart", "qend", "rstart",
                                     "rend")] == want[0]
    # the oracle: the same score and ends, the gap opened one row later
    assert jax_sw.sw_align_np(q[0], r[0], **kw) == (2, 3, 5, 1, 2)


@hypothesis.settings(max_examples=30, deadline=None)
@hypothesis.given(
    B=st.integers(1, 4), M=st.integers(1, 12), N=st.integers(1, 20),
    match=st.integers(0, 4), mismatch=st.integers(-5, 0),
    gap_open=st.integers(-7, 0), gap_ext=st.integers(-3, 0),
    alpha=st.sampled_from([2, 5]), seed=st.integers(0, 1 << 16))
def test_sw_align_gotoh_form_matches_plain_on_small_inputs(
        B, M, N, match, mismatch, gap_open, gap_ext, alpha, seed):
    """The Gotoh form and the narrow schedule equal the plain version;
    score, qend and rend equal the O(MN) oracle in every draw, and the
    starts too where gap extend is below 0. At gap extend 0 the oracle
    breaks ties among vertical gaps the other way (see the test above), so
    there the starts are held to Pallas in interpret mode."""
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
        oracle = jax_sw.sw_align_np(q[b], r[b], **kw)
        if gap_ext < 0:
            assert tuple(plain[b]) == oracle, b
        else:
            assert tuple(plain[b, [0, 2, 4]]) == oracle[0::2], b
    if gap_ext == 0:
        np.testing.assert_array_equal(_pallas_align(q, r, **kw), plain)
