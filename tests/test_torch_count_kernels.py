"""The count step's kernels K4 and K5 (csrc/kmer.cu), modelled on the CPU.

K4 builds each k-mer window from two ballot words a bit stream and one
funnel shift, and its count epilogue writes the flat 32-bit keys that the
count step sorts; K5 adds min(run length, cap) at the first key of every
run of the sorted row. Both are written out in numpy here, step for step,
and held with the port's plain count route against the JAX package's
count step on seeded batches: duplicate-heavy reads (runs longer than the
cap), reads shorter than k, all-N reads, reads that are not accepted, the
`kw` crop and, at k=32, the all-ones k-mer that must stay uncounted.
The kernels themselves run on the card in tests/test_torch_cuda.py.
"""

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


def _k4_count_model(codes, lengths, accept, masks, k, kw):
    """K4's count epilogue: keys uint32 [C, B * W], 0xFFFFFFFF wherever a
    window is not valid, starts past lengths - k or is in a read that is
    not accepted."""
    h, v = _k4_model(codes, masks, k)
    W = kw if 0 < kw < codes.shape[1] else codes.shape[1]
    j = np.arange(W)
    live = v[:, :W] & (j[None] <= lengths[:, None] - k) & accept[:, None]
    keys = np.where(live[None], h[:, :, :W], ALL_ONES)
    return keys.reshape(len(h), -1).astype(np.uint32)


def _k5_model(s, cap):
    """K5 on one sorted key row: (hashes, min(run length, cap)) at the
    first key of every run other than the sentinel."""
    s = np.asarray(s, np.uint32)
    start = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    run = np.diff(np.r_[start, len(s)])
    keep = s[start] != ALL_ONES
    return s[start][keep].astype(np.int64), np.minimum(run, cap)[keep]


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
        for i in range(3):
            runs = [_k5_model(_sorted(keys, signed)[i], cap)
                    for signed in (False, True)]
            got = dict(zip(*map(np.ndarray.tolist, runs[0])))
            assert got == dict(zip(*map(np.ndarray.tolist, runs[1])))
            assert max(got.values()) == cap    # some run reached the cap
            if dense:
                h, d = runs[0]
                model[i][h] += d.astype(np.int8)
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
    h, d = _k5_model(s, cap)
    want[h] += d.astype(np.int8)
    got = torch.from_numpy(table.copy())
    count.run_capped_update(got, torch.from_numpy(s.view(np.int32)), cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ALL_ONES not in h.tolist() and len(h) > 2000


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
            fn(torch.zeros(16, dtype=torch.int8),
               torch.zeros(4, dtype=cuda_kmer.KEY_DTYPE), 3)
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
            torch.zeros(16, dtype=torch.int8, device="meta"),
            torch.zeros(4, dtype=cuda_kmer.KEY_DTYPE, device="meta"), 3)


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
