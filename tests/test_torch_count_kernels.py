"""The count step's kernels K4 and K5 (csrc/kmer.cu), modelled on the CPU.

K4 builds each k-mer window from two ballot words a bit stream and one
funnel shift; its count epilogue, a warp a unit of up to 128 window starts
of one read, ballots each 32-code word of the unit once and writes the
flat 32-bit keys that the count step sorts. K5 takes the sorted rows of
every table in one launch, a thread a key: the thread of a run's head
reads to the run's end (at most cap + 32 keys) and adds min(run, cap)
with one 32-bit atomic add whose carry it takes back, or with compare
and swap where a neighbouring run shares the word. Both are written out
in numpy here and held with the port's plain count route against the JAX
package's count step on seeded batches: duplicate-heavy reads (runs
longer than the cap), reads shorter than k, all-N reads, reads that are
not accepted, the `kw` crop and, at k=32, the all-ones k-mer that must
stay uncounted; the end of a K5 head's read also under hypothesis. The
kernels themselves run on the card in tests/test_torch_cuda.py.
"""

import hypothesis
import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localhgt_tpu.ops import count as jax_count
from localhgt_tpu.ops import encode as jax_encode
from localhgt_tpu_torch.ops import count, cuda_kmer, encode
from localhgt_tpu_torch.utils import metrics
from test_torch_count_scan_peaks import (ALL_ONES, ALL_ONES_CODER,
                                         ALL_ONES_SEED, _all_ones_kmer)

U32 = np.uint64(0xFFFFFFFF)
REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint64)
LANE = np.arange(32, dtype=np.uint64)
# the kernel's bit streams: p0 = A|T, p1 = A|C, p2 = A|G, valid
STREAMS = (lambda c: (c == 0) | (c == 3), lambda c: c < 2,
           lambda c: (c == 0) | (c == 2), lambda c: c < 4)


def _brev(x):
    """__brev of 32-bit values held in uint64."""
    out = np.zeros_like(x)
    for i in range(4):
        out |= REV8[(x >> np.uint64(8 * i)) & np.uint64(255)] << np.uint64(
            8 * (3 - i))
    return out


def _ballot(pred):
    """__ballot_sync over the last axis (32 lanes): lane l is bit l."""
    return (pred.astype(np.uint64) << LANE).sum(axis=-1)


def _k4_model(codes, masks, k):
    """K4 as the kernel computes it: a warp a 32-start tile of a row, the
    codes at j0 + lane and j0 + 32 + lane (a non-base past L), one ballot
    a stream and half, `__brev`, a funnel shift by the lane. Returns
    (hashes uint64 [C, R, L], valid bool [R, L])."""
    R, L = codes.shape
    T = -(-L // 32)
    pad = np.full((R, 32 * T + 32), 4, np.uint8)
    pad[:, :L] = codes
    ca = pad[:, : 32 * T].reshape(R, T, 32)
    cb = pad[:, 32 : 32 * T + 32].reshape(R, T, 32)
    sh = np.uint64(32 - k)
    win = []
    for pred in STREAMS:
        hi = _brev(_ballot(pred(ca)))[..., None]
        lo = _brev(_ballot(pred(cb)))[..., None]
        x = ((hi << LANE) | (lo >> (np.uint64(32) - LANE))) & U32
        win.append(x >> sh)
    w0, w1, w2, wv = win
    kmask = np.uint64((1 << k) - 1)
    r0 = _brev(w0) >> sh
    r1 = _brev(~w1 & kmask) >> sh
    r2 = _brev(~w2 & kmask) >> sh
    hs = []
    for m0, m1, m2 in np.asarray(masks, np.uint64):
        fwd = (w0 & m0) | (w1 & m1) | (w2 & m2)
        rev = (r0 & m0) | (r1 & m1) | (r2 & m2)
        hs.append(np.minimum(fwd, rev).reshape(R, 32 * T)[:, :L])
    return np.stack(hs), (wv == kmask).reshape(R, 32 * T)[:, :L]


UNIT_TILES = 4  # count epilogue: 32-start tiles a warp takes at a time
K5_SCAN = 32    # K5: keys a head reads past the cap at most


def _k4_count_model(codes, lengths, accept, masks, k, kw):
    """K4's count epilogue as its warps compute it: a warp a unit of
    UNIT_TILES tiles of 32 window starts of one read; the unit's
    UNIT_TILES + 1 words of 32 codes (a non-base at or past
    min(L, W + k - 1), which no window below W reads), one ballot a stream
    and word, tile t's windows the funnel shift of words t and t + 1.
    Returns keys uint32 [C, B * W], 0xFFFFFFFF wherever a window is not
    valid, starts past lengths - k or is in a read that is not accepted."""
    R, L = codes.shape
    W = kw if 0 < kw < L else L
    units = -(-W // (32 * UNIT_TILES))
    limit = min(L, W + k - 1)
    pad = np.full((R, units * 32 * UNIT_TILES + 32), 4, np.uint8)
    pad[:, :limit] = codes[:, :limit]
    lane_pos = (32 * UNIT_TILES * np.arange(units)[:, None, None]
                + 32 * np.arange(UNIT_TILES + 1)[None, :, None]
                + np.arange(32)[None, None, :])  # [unit, word, lane]
    words = pad[:, lane_pos]                      # [R, unit, word, lane]
    sh = np.uint64(32 - k)
    kmask = np.uint64((1 << k) - 1)
    win = []
    for pred in STREAMS:  # 4 x (UNIT_TILES + 1) ballots a unit
        bits = _brev(_ballot(pred(words)))        # [R, unit, word]
        hi = bits[:, :, :UNIT_TILES, None]
        lo = bits[:, :, 1:, None]
        x = ((hi << LANE) | (lo >> (np.uint64(32) - LANE))) & U32
        win.append((x >> sh).reshape(R, -1)[:, :W])
    w0, w1, w2, wv = win
    r0 = _brev(w0) >> sh
    r1 = _brev(~w1 & kmask) >> sh
    r2 = _brev(~w2 & kmask) >> sh
    j = np.arange(W)
    live = (wv == kmask) & (j[None] <= lengths[:, None] - k) & accept[:, None]
    keys = []
    for m0, m1, m2 in np.asarray(masks, np.uint64):
        fwd = (w0 & m0) | (w1 & m1) | (w2 & m2)
        rev = (r0 & m0) | (r1 & m1) | (r2 & m2)
        keys.append(np.where(live, np.minimum(fwd, rev), ALL_ONES))
    return np.stack(keys).reshape(len(keys), -1).astype(np.uint32)


def _k5_model(s, cap):
    """K5 on sorted key rows s [C, N] (one launch) as its threads run it,
    a thread a key: the thread of a run's head (its key differs from the
    one before it and is not the sentinel) reads on while the key
    repeats, to the run's end or cap + K5_SCAN keys, whichever comes
    first, and then the key after what it read (0xFFFFFFFF past N). It
    adds min(run length, cap). Its word is shared when the key before its
    run or the key after what it read lies in the same 4 table bytes and
    is not the sentinel: the latter is its own key when the run goes on.
    Returns per row (hashes, adds, shared) in the order of the heads; a
    hash occurs at most once a row."""
    s = np.atleast_2d(np.asarray(s, np.uint32))
    out = []
    for row in s:
        N = len(row)
        starts = np.flatnonzero(np.r_[True, row[1:] != row[:-1]])
        ends = np.r_[starts[1:], N]
        keep = (row[starts] != ALL_ONES) & (cap > 0)
        j, end = starts[keep], ends[keep]
        h = row[j].astype(np.int64)
        e = np.minimum(end, np.minimum(N, j + cap + K5_SCAN))  # read to
        before = np.where(j > 0, row[np.maximum(j - 1, 0)], ALL_ONES)
        after = np.where(e < N, row[np.minimum(e, N - 1)], ALL_ONES)

        def near(x):
            x = x.astype(np.int64)
            return (x != ALL_ONES) & ((x >> 2) == (h >> 2))

        out.append((h, np.minimum(e - j, cap).astype(np.int64),
                    near(before) | near(after)))
    return out


def _k5_apply(table, h, d, shared):
    """K5's table updates in issue order on an int8 table (in place): a
    head whose word is not shared adds d << 8p to its 32-bit word (mod
    2^32, as the atomic does) and takes back a carry out of byte p from
    the old word it got; a shared word's head adds to its byte alone (the
    compare-and-swap). Every word that two heads update must be shared."""
    words = table.view(np.uint32)
    for key, a, sh in zip(h.tolist(), d.tolist(), shared.tolist()):
        w, p = key >> 2, key & 3
        if sh:
            table[key] = np.int8((int(table[key]) + a + 128) % 256 - 128)
            continue
        old = int(words[w])
        new = (old + (a << (8 * p))) % (1 << 32)
        if p < 3 and ((old >> (8 * p)) & 0xFF) + a > 0xFF:
            new = (new - (1 << (8 * p + 8))) % (1 << 32)
        words[w] = new
    _assert_shared_words(h, shared)


def _assert_shared_words(h, shared):
    """Every head of a word that two heads update takes the shared path."""
    word_of = np.asarray(h) >> 2
    ids, n = np.unique(word_of, return_counts=True)
    assert np.asarray(shared)[np.isin(word_of, ids[n > 1])].all()


def _runs(s, cap):
    """Every run of one sorted row other than the sentinel's:
    {hash: min(run length, cap)}."""
    s = np.asarray(s, np.uint32)
    start = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    run = np.diff(np.r_[start, len(s)])
    keep = (s[start] != ALL_ONES) & (cap > 0)
    return dict(zip(s[start][keep].tolist(),
                    np.minimum(run, cap)[keep].tolist()))


def _sorted(keys, signed: bool):
    """Each key row sorted as unsigned or as signed 32-bit (the int32 bit
    pattern): only the grouping into runs may differ in order."""
    if signed:
        return np.sort(keys.view(np.int32), axis=1).view(np.uint32)
    return np.sort(keys, axis=1)


@pytest.mark.parametrize("k", [1, 5, 15, 18, 24, 31, 32])
def test_k4_formulation_is_the_plain_version_at_every_position(k):
    """The ballot and funnel-shift windows give canonical_hashes_plain's
    hashes and valid bits everywhere, j > L - k included, and the count
    epilogue gives count_keys_plain's keys in place."""
    rng = np.random.default_rng(100 + k)
    masks, _ = encode.hasher_for(k, 3, seed=k)
    # the plain version takes L >= k; the window at j = L - k is the last
    for B, L in ((5, 97), (3, 32), (4, k), (2, k + 1), (2, 200)):
        codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.05] = 4
        codes[0, : L // 2] = rng.integers(5, 255, L // 2)  # other non-bases
        got_h, got_v = _k4_model(codes, masks, k)
        want_h, want_v = encode.canonical_hashes_plain(
            torch.from_numpy(codes), masks, k)
        np.testing.assert_array_equal(got_v, want_v.numpy())
        np.testing.assert_array_equal(got_h.astype(np.int64),
                                      want_h.numpy())
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        accept = rng.random(B) < 0.7
        for kw in (0, 64, L, L + 5):
            want = count.count_keys_plain(
                torch.from_numpy(codes), torch.from_numpy(lengths),
                torch.from_numpy(accept), masks, k, kw)
            assert want.dtype == cuda_kmer.KEY_DTYPE
            np.testing.assert_array_equal(
                _k4_count_model(codes, lengths, accept, masks, k, kw),
                want.numpy().view(np.uint32))


def _batches(rng, k, masks):
    """Three [40, 96] read batches with every case of the module
    docstring; at k=32 each holds the all-ones k-mer of ALL_ONES_CODER
    nine times (more than any cap)."""
    out = []
    for _ in range(3):
        B, L = 40, 96
        codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.01] = 4
        codes[5:16] = codes[4]             # 12 copies: runs past every cap
        codes[16, :50] = codes[17, 10:60]  # k-mers shared at other starts
        codes[20] = 4                      # an all-N read
        lengths = rng.integers(k, L + 1, B).astype(np.int32)
        lengths[4:16] = L
        lengths[21] = k - 1                # shorter than k
        lengths[22] = int(rng.integers(0, k))
        accept = rng.random(B) < 0.85
        accept[4:16] = True
        accept[23:25] = False
        if k == 32:
            kmer = _all_ones_kmer(masks[ALL_ONES_CODER])
            for b, z in ((30, 0), (30, 50), (31, 10), (32, 64), (33, 30),
                         (34, 30), (35, 5), (36, 60), (37, 33)):
                codes[b, z : z + 32] = kmer
            lengths[30:38] = L
            accept[30:38] = True
        out.append((codes, lengths, accept))
    return out


# (clip, kw) of the three batches: deferred clips, the crop, a clip
STEPS = ((False, 0), (False, 64), (True, 0))


@pytest.mark.parametrize("cap", [1, 3, 7])
@pytest.mark.parametrize("k", [18, 24, 32])
def test_count_step_kernel_models_give_the_jax_tables(k, cap):
    """The plain route's keys are K4's count epilogue; K5's model over
    them, sorted as unsigned or as signed, adds what the JAX count step
    adds; the port's count step on the CPU gives the same tables. At k=32
    the JAX tables (2^29 packed words each) are too large for a test: the
    JAX step's own sort and rank-capped contributions
    (`capped_batch_delta_multi`, whose per-hash sums its scatter adds)
    stand for them, over every hash."""
    rng = np.random.default_rng(1000 * k + cap)
    masks, _ = jax_encode.hasher_for(
        k, 3, seed=ALL_ONES_SEED if k == 32 else 1)
    batches = _batches(rng, k, masks)
    dense = k < 32
    if dense:
        model = [np.zeros(1 << k, np.int8) for _ in range(3)]
        jt = tuple(jax_count.make_table(k) for _ in range(3))
        pt = [count.make_table(k, "cpu") for _ in range(3)]
    else:
        model = [{} for _ in range(3)]
        want = [{} for _ in range(3)]
    for (codes, lengths, accept), (clip, kw) in zip(batches, STEPS):
        keys = count.count_keys(
            torch.from_numpy(codes), torch.from_numpy(lengths),
            torch.from_numpy(accept), masks, k, kw).numpy().view(np.uint32)
        np.testing.assert_array_equal(
            keys, _k4_count_model(codes, lengths, accept, masks, k, kw))
        # K5's threads over the three rows in one launch
        runs = [_k5_model(_sorted(keys, signed), cap)
                for signed in (False, True)]
        for i in range(3):
            got = dict(zip(*map(np.ndarray.tolist, runs[0][i][:2])))
            assert got == dict(zip(*map(np.ndarray.tolist, runs[1][i][:2])))
            assert got == _runs(_sorted(keys, False)[i], cap)
            assert max(got.values()) == cap    # some run reached the cap
            if dense:
                _k5_apply(model[i], *runs[1][i])
                if clip:
                    np.minimum(model[i], cap, out=model[i])
            else:
                for h, d in got.items():
                    model[i][h] = model[i].get(h, 0) + d
        if dense:
            jt = jax_count.count_reads_step(
                jt, jnp.asarray(codes), jnp.asarray(lengths),
                jnp.asarray(accept), jnp.asarray(masks), k, cap, clip=clip,
                kw=kw)
            count.count_reads_step(
                pt, torch.from_numpy(codes), torch.from_numpy(lengths),
                torch.from_numpy(accept), masks, k, cap, clip=clip, kw=kw)
            continue
        jh, jv = jax_encode.canonical_hashes(np, codes, masks, k)
        L = kw if kw else codes.shape[1]
        live = (jv[:, :L] & (np.arange(L)[None] <= lengths[:, None] - k)
                & accept[:, None])
        s, contrib = jax_count.capped_batch_delta_multi(
            jnp.asarray(jh[:, :, :L]), jnp.asarray(live), cap)
        s, contrib = np.asarray(s), np.asarray(contrib)
        for i in range(3):
            sel = (s[i] != ALL_ONES) & (contrib[i] != 0)
            for h, d in zip(s[i][sel].tolist(), contrib[i][sel].tolist()):
                want[i][h] = want[i].get(h, 0) + d
            if clip:
                for tab in (model[i], want[i]):
                    tab.update((h, min(c, cap)) for h, c in tab.items())
    if dense:
        for m, j, p in zip(model, jt, pt):
            assert int(m.max()) == cap
            np.testing.assert_array_equal(np.asarray(j), m)
            np.testing.assert_array_equal(p.numpy(), m)
        return
    assert model == want
    h, v = _k4_model(batches[0][0], masks, k)
    assert int(((h[ALL_ONES_CODER] == ALL_ONES) & v).sum()) == 9
    assert ALL_ONES not in model[ALL_ONES_CODER]


@pytest.mark.parametrize("cap", [0, 1, 3, 7, 127])
def test_run_capped_update_plain_adds_the_k5_model(cap):
    """The CPU route of K5 (rank-capped contributions, scatter-add) adds
    min(run length, cap) at every run's hash of a sorted row, sentinels
    and all, onto a table that already holds counts."""
    k = 12
    rng = np.random.default_rng(cap)
    keys = np.concatenate([
        rng.integers(0, 1 << k, 3000), np.full(200, 77),
        np.full(9, ALL_ONES), np.repeat(rng.integers(0, 1 << k, 50), 6),
    ]).astype(np.uint32)
    s = np.sort(keys.view(np.int32)).view(np.uint32)  # as the card sorts
    table = rng.integers(0, 4, 1 << k).astype(np.int8)
    want = table.copy()
    [(h, d, shared)] = _k5_model(s, cap)
    assert dict(zip(h.tolist(), d.tolist())) == _runs(s, cap)
    _k5_apply(want, h, d, shared)
    got = torch.from_numpy(table.copy())
    count.run_capped_update([got], torch.from_numpy(s.view(np.int32))[None],
                            cap)
    np.testing.assert_array_equal(got.numpy(), want)
    # many runs whatever the cap (cap 0 adds at none of them)
    assert ALL_ONES not in h.tolist() and len(_runs(s, 1)) > 2000


def _k5_rows(rng, N, lengths, k=12, sentinel=True):
    """Sorted rows [C, N] (int32, as the card sorts them), row c made of
    runs of lengths[c] in that order (ascending keys, the first run the
    sentinel -1 if `sentinel`), cut or its last run stretched to N."""
    rows = []
    for ln in lengths:
        keys = np.sort(rng.choice(1 << k, len(ln), replace=False))
        if sentinel:
            keys[0] = -1
        row = np.repeat(keys, ln)[:N]
        rows.append(np.pad(row, (0, N - len(row)), mode="edge"))
    return np.stack(rows).astype(np.int32)


def _hold_k5(s, cap, k=12, seed=0):
    """K5's model over the rows of s [C, N] (int32) against the
    plain version in one call and against the rows' runs, on tables of
    every byte value (a negative byte plus a run carries out of its byte
    in a word add); returns the model's updates."""
    runs = _k5_model(s.view(np.uint32), cap)
    rng = np.random.default_rng(seed)
    base = rng.integers(-128, 128, (len(s), 1 << k)).astype(np.int8)
    got = [torch.from_numpy(b.copy()) for b in base]
    count.run_capped_update(got, torch.from_numpy(s), cap)
    for b, g, row, (h, d, shared) in zip(base, got, s, runs):
        assert dict(zip(h.tolist(), d.tolist())) == _runs(
            row.view(np.uint32), cap)
        want = b.copy()
        _k5_apply(want, h, d, shared)
        np.testing.assert_array_equal(g.numpy(), want)
    return runs


# run lengths of K5's edge rows: runs that end where a head's read stops
# (cap + K5_SCAN keys, at caps 1, 2, 3 and 127) or one key before or
# after it, a run of one key, and runs past every read (300 keys)
EDGE_RUNS = (33, 1, 34, 5, 300, 3, 35, 36, 2, 4, 158, 159, 1, 1, 160, 9)


@pytest.mark.parametrize("N", [1, 3, 33, 34, 35, 127, 128, 159, 1001])
def test_k5_at_the_end_of_a_heads_read(N):
    """Runs that end at, just before or just past the last key a head
    reads, and a row that ends there, three rows in one call, caps from 0
    to 127. Row 0 holds EDGE_RUNS in order; rows 1 and 2 the same lengths
    plus 1 and 2, shuffled."""
    rng = np.random.default_rng(N)
    lengths = [list(EDGE_RUNS)]
    for i in (1, 2):
        ln = [x + i for x in EDGE_RUNS]
        rng.shuffle(ln)
        lengths.append(ln)
    s = _k5_rows(rng, N, lengths)
    for cap in (0, 1, 2, 3, 7, 127):
        _hold_k5(s, cap, seed=cap)


@pytest.mark.parametrize("kind", ["one_key", "sentinels", "distinct"])
def test_k5_degenerate_rows(kind):
    """A row of one key (one run, capped, longer than any head's read), a
    row of sentinels only (no head), and a row of distinct keys (every key
    a head)."""
    rng = np.random.default_rng(len(kind))
    for N in (1, 127, 128, 129, 1000):
        if kind == "one_key":
            s = np.full((2, N), 77, np.int32)
        elif kind == "sentinels":
            s = np.full((2, N), -1, np.int32)
        else:
            s = np.stack([np.sort(rng.choice(1 << 12, N, replace=False))
                          for _ in range(2)]).astype(np.int32)
        for cap in (1, 3, 127):
            n_heads = [len(r[0]) for r in _hold_k5(s, cap)]
            assert n_heads == {"one_key": [1, 1], "sentinels": [0, 0],
                               "distinct": [N, N]}[kind]


def test_k5_shared_words():
    """Keys from a narrow range put several heads in one 32-bit word of
    the table, next to words with one head, with runs longer than the cap
    and than a head's read: the shared words take the byte-wise path and
    the others the word add whose carry is taken back, on tables of every
    byte value."""
    rng = np.random.default_rng(4)
    for N in (5, 128, 129, 700):
        lengths = [rng.integers(1, 9, 60).tolist(),
                   rng.integers(1, 300, 60).tolist()]
        rows = []
        for ln in lengths:
            keys = np.sort(rng.choice(90, len(ln), replace=False))
            row = np.repeat(keys, ln)[:N]
            rows.append(np.pad(row, (0, N - len(row)), mode="edge"))
        s = np.stack(rows).astype(np.int32)
        for cap in (1, 3, 127):
            runs = _hold_k5(s, cap, k=8, seed=N + cap)
            if N == 700:
                flags = np.concatenate([r[2] for r in runs])
                assert flags.any() and not flags.all()


def test_k5_shared_words_at_the_top_of_the_key_range():
    """At k=32 the sentinel shares its word with keys 0xFFFFFFFC to
    0xFFFFFFFE, which sort just before it as int32: a head there is
    shared only with another counted head, never through the sentinel;
    and the key after the sentinel (0) starts a word of its own."""
    rng = np.random.default_rng(7)
    for _ in range(30):
        keys = np.sort(rng.choice(np.arange(-9, 4), rng.integers(2, 12),
                                  replace=False))
        row = np.repeat(keys, rng.integers(1, 200, len(keys))).astype(
            np.int32)
        [(h, d, shared)] = _k5_model(row.view(np.uint32), 3)
        assert dict(zip(h.tolist(), d.tolist())) == _runs(
            row.view(np.uint32), 3)
        _assert_shared_words(h, shared)
        single = {x for x in h.tolist() if sum(
            (y >> 2) == (x >> 2) for y in h.tolist()) == 1}
        # a lone head in its word is shared only when its run goes on
        # past what its thread read
        for x, sh in zip(h.tolist(), shared.tolist()):
            if x in single and sh:
                assert (row.view(np.uint32) == x).sum() > 3 + K5_SCAN


@hypothesis.settings(max_examples=200, deadline=None)
@hypothesis.given(word=st.integers(0, (1 << 32) - 1), p=st.integers(0, 3),
                  a=st.integers(1, 127))
def test_k5_word_add_with_its_carry_taken_back_is_a_byte_add(word, p, a):
    """The atomic add of a << 8p to a word, less 1 << 8(p + 1) when byte p
    overflowed (what undo_carry subtracts), changes byte p alone, to its
    sum mod 256."""
    table = np.frombuffer(np.uint32(word).tobytes(), np.int8).copy()
    want = table.copy()
    want[p] = np.int8((int(want[p]) + a + 128) % 256 - 128)
    _k5_apply(table, np.array([p]), np.array([a]), np.array([False]))
    np.testing.assert_array_equal(table, want)


@hypothesis.settings(max_examples=60, deadline=None)
@hypothesis.given(
    lengths=st.lists(st.integers(1, 300), min_size=1, max_size=40),
    cap=st.integers(0, 130), cut=st.integers(0, 7), sentinel=st.booleans())
def test_k5_hypothesis(lengths, cap, cut, sentinel):
    """Random run lengths against the end of a K5 head's read, in two rows
    of one call: the model's adds are the rows' capped runs and the plain
    version's table."""
    cap = min(cap, 127)
    rng = np.random.default_rng(len(lengths) * 131 + cap)
    N = max(1, sum(lengths) - cut)
    _hold_k5(_k5_rows(rng, N, [lengths, lengths[::-1]], sentinel=sentinel),
             cap)


def test_k4_count_warp_schedule_at_every_k_and_crop():
    """The count epilogue's warp model against count_keys_plain at every
    k of 1..32 and the crops the count step takes (0, and 64-multiples up
    to the batch width, which bkp pads to 192 or more), on a width that
    is no multiple of a unit and one that is."""
    rng = np.random.default_rng(5)
    for L in (150, 192, 256):
        codes = rng.integers(0, 4, (6, L)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.03] = 4
        codes[1] = codes[0]
        lengths = rng.integers(0, L + 1, 6).astype(np.int32)
        lengths[0] = L
        accept = np.array([True, True, False, True, True, True])
        tc, tl, ta = map(torch.from_numpy, (codes, lengths, accept))
        for k in range(1, 33):
            masks, _ = encode.hasher_for(k, 2, seed=k)
            for kw in (0, 64, 128, 192, 256):
                want = count.count_keys_plain(tc, tl, ta, masks, k, kw)
                np.testing.assert_array_equal(
                    _k4_count_model(codes, lengths, accept, masks, k, kw),
                    want.numpy().view(np.uint32))


@pytest.mark.parametrize("wrapper", ["canonical_hashes", "count_keys",
                                     "run_capped_update"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """A kernel wrapper launches on CUDA tensors only: the CPU route is
    the dispatchers' (encode.canonical_hashes, count.count_keys,
    count.run_capped_update), and no launch is counted."""
    codes = torch.zeros((2, 40), dtype=torch.uint8)
    masks, _ = encode.hasher_for(18, 3, seed=1)
    fn = getattr(cuda_kmer, wrapper)
    n0 = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "run_capped_update":
            fn([torch.zeros(16, dtype=torch.int8)],
               torch.zeros((1, 4), dtype=cuda_kmer.KEY_DTYPE), 3)
        elif wrapper == "count_keys":
            fn(codes, torch.zeros(2, dtype=torch.int32),
               torch.ones(2, dtype=torch.bool), masks, 18)
        else:
            fn(codes, masks, 18)
    assert fn.launches == n0


def test_dispatchers_refuse_other_devices():
    codes = torch.zeros((2, 40), dtype=torch.uint8, device="meta")
    masks, _ = encode.hasher_for(18, 3, seed=1)
    with pytest.raises(ValueError, match="unsupported device"):
        encode.canonical_hashes(codes, masks, 18)
    with pytest.raises(ValueError, match="unsupported device"):
        count.count_keys(codes, torch.zeros(2, dtype=torch.int32,
                                            device="meta"),
                         torch.ones(2, dtype=torch.bool, device="meta"),
                         masks, 18)
    with pytest.raises(ValueError, match="unsupported device"):
        count.run_capped_update(
            [torch.zeros(16, dtype=torch.int8, device="meta")],
            torch.zeros((1, 4), dtype=cuda_kmer.KEY_DTYPE, device="meta"), 3)


def test_current_stage_is_the_innermost_open_stage():
    """K4's launches are counted by the stage open at the launch."""
    assert metrics.current_stage() == ""
    with metrics.stage("outer"):
        assert metrics.current_stage() == "outer"
        with metrics.stage("inner"):
            assert metrics.current_stage() == "inner"
        assert metrics.current_stage() == "outer"
    with pytest.raises(RuntimeError):
        with metrics.stage("failing"):
            raise RuntimeError("a stage that raises still closes")
    assert metrics.current_stage() == ""
    metrics.reset()
