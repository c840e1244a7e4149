"""Kernels K1 to K6 on the card against their plain torch versions.

These tests need an NVIDIA GPU with nvcc: they carry the `cuda` marker and
skip without a card. Run them on one with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(`--noconftest`: tests/conftest.py imports jax, which a machine that only
runs the port need not have.)
"""

import numpy as np
import pytest
import torch

from localhgt_tpu_torch import tune_seed
from localhgt_tpu_torch.ops import count, cuda_kmer, cuda_seed, cuda_sw
from localhgt_tpu_torch.ops import cuda_vote, encode
from localhgt_tpu_torch.pipeline import align

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _reads(rng, B, M, N, alpha=4):
    q = rng.integers(0, alpha, (B, M)).astype(np.uint8)
    r = rng.integers(0, alpha, (B, N)).astype(np.uint8)
    for b in range(0, B, 2):
        off = int(rng.integers(0, max(1, N - M)))
        r[b, off:off + M] = q[b]
        r[b, off + M // 2] = (r[b, off + M // 2] + 1) % alpha
    q[rng.random(q.shape) < 0.01] = 4
    return q, r


@pytest.mark.parametrize("shape", [(512, 192, 256), (300, 40, 100),
                                   (64, 150, 512)])
@pytest.mark.parametrize("alpha", [2, 4])
def test_sw_kernels_match_plain(dev, shape, alpha):
    q, r = _reads(np.random.default_rng(sum(shape) + alpha), *shape, alpha)
    qd, rd = torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)
    n0 = cuda_sw.sw_align.launches
    got = cuda_sw.sw_align(qd, rd)
    assert cuda_sw.sw_align.launches == n0 + 1
    torch.testing.assert_close(got, cuda_sw.sw_align_plain(qd, rd),
                               rtol=0, atol=0)
    torch.testing.assert_close(cuda_sw.sw_score(qd, rd),
                               cuda_sw.sw_score_plain(qd, rd), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(64, 150, 513), (48, 1000, 1000),
                                   (32, 300, 1024), (8, 256, 4096)])
@pytest.mark.parametrize("alpha", [2, 4])
def test_sw_kernels_match_plain_wide_reference(dev, shape, alpha):
    """N > 512 runs the one-block-per-alignment variant of csrc/sw.cu."""
    q, r = _reads(np.random.default_rng(sum(shape) + alpha), *shape, alpha)
    qd, rd = torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)
    n0 = cuda_sw.sw_align.wide_launches, cuda_sw.sw_score.wide_launches
    torch.testing.assert_close(cuda_sw.sw_align(qd, rd),
                               cuda_sw.sw_align_plain(qd, rd), rtol=0, atol=0)
    torch.testing.assert_close(cuda_sw.sw_score(qd, rd),
                               cuda_sw.sw_score_plain(qd, rd), rtol=0, atol=0)
    assert (cuda_sw.sw_align.wide_launches,
            cuda_sw.sw_score.wide_launches) == (n0[0] + 1, n0[1] + 1)


SCORE_SHAPES = {
    # every window width accbkp makes from 150-bp reads: each fits its
    # (lanes a group, columns a lane) pair exactly
    "n32": (777, 32, 32), "n64": (515, 64, 64), "n96": (300, 96, 96),
    "n128": (259, 128, 128), "n160": (1030, 160, 160),
    # N that is no multiple of the group's width: columns past N
    "n100": (300, 40, 100), "n161": (129, 150, 161), "n300": (40, 90, 300),
    "n511": (65, 100, 511), "n512": (33, 64, 512),
    # the wide mapping and its stripe boundaries (256 columns a warp)
    "n513": (33, 150, 513), "n768": (9, 300, 768), "n769": (9, 300, 769),
    "n1000": (48, 1000, 1000), "n1025": (5, 200, 1025),
    "n4096": (8, 256, 4096),
    # wider than the block: a block a band in a cluster, balanced bands
    # (the last one column short of its stripes at 4,097), with more query
    # rows than the rings hold, one alignment, and past the cluster's 8
    # bands (round-robin, the wrap edge)
    "n4097": (5, 200, 4097), "n8192": (3, 300, 8192),
    "n8193": (3, 100, 8193), "long_m_bands": (2, 700, 5000),
    "n4097_one_alignment": (1, 200, 4097),
    "past_the_cluster": (2, 120, 33000),
    # three rounds of 8 blocks, the wrap buffer and the rings reused from
    # round to round, more query rows than the ring between two blocks
    # holds
    "three_rounds_long_m": (2, 600, 70000),
    # more query rows than the ring between two stripes holds: it wraps,
    # and the left stripe waits for the right one
    "long_m_wide": (6, 1500, 600),
    # more query rows than a staged chunk, and a query shorter than a group
    "long_m_narrow": (70, 700, 96), "short_m": (50, 3, 160),
    # B that is no multiple of the alignments a block holds, down to one
    "ragged_b_g8": (13, 50, 32), "ragged_b_g16": (7, 60, 160),
    "ragged_b_g32": (3, 60, 320), "one_alignment": (1, 20, 160),
}
# defaults of accbkp and of align, a free gap open, and parameters that do
# not decay (the guarded kernels: columns past N are masked)
SCORE_PARAMS = [(1, -2, -3, -1), (1, -4, -6, -1), (2, -3, 0, -2),
                (2, 1, 1, 1), (3, -1, 2, -1)]


@pytest.mark.parametrize("case", list(SCORE_SHAPES))
@pytest.mark.parametrize("alpha", [2, 4])
def test_sw_score_kernel_matches_plain(dev, case, alpha):
    B, M, N = SCORE_SHAPES[case]
    rng = np.random.default_rng(sum((B, M, N)) + alpha)
    if M <= N:
        q, r = _reads(rng, B, M, N, alpha)
    else:  # the query is longer than the window: plant the window in it
        r, q = _reads(rng, B, N, M, alpha)
    r[rng.random(r.shape) < 0.01] = 4
    qd, rd = torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)
    for params in SCORE_PARAMS:
        n0 = (cuda_sw.sw_score.launches, cuda_sw.sw_score.wide_launches,
              cuda_sw.sw_score.band_launches)
        n_shape = cuda_sw.sw_score.shapes[(B, M, N)]
        got = cuda_sw.sw_score(qd, rd, *params)
        assert cuda_sw.sw_score.launches == n0[0] + 1
        assert cuda_sw.sw_score.wide_launches == n0[1] + int(
            N > cuda_sw.NARROW_MAX_N)
        assert cuda_sw.sw_score.band_launches == n0[2] + int(
            N > cuda_sw.WIDE_MAX_N)
        assert cuda_sw.sw_score.shapes[(B, M, N)] == n_shape + 1
        torch.testing.assert_close(
            got, cuda_sw.sw_score_plain(qd, rd, *params), rtol=0, atol=0)


def test_sw_score_kernel_on_unalignable_and_identical_rows(dev):
    """All-N rows score 0; a read equal to its window scores M * match."""
    q = torch.randint(0, 4, (40, 160), dtype=torch.uint8, device=dev)
    r = q.clone()
    q[::2] = 4
    got = cuda_sw.sw_score(q, r)
    assert got[::2].abs().sum().item() == 0
    assert (got[1::2] == 160).all()


def test_sw_kernels_raise_above_the_widest_reference(dev):
    """The widest reference is the one whose cells overflow K1's int32
    origin register: both wrappers raise there and launch nothing."""
    q = torch.zeros((2, 1 << 12), dtype=torch.uint8, device=dev)
    r = torch.zeros((2, 1 << 19), dtype=torch.uint8, device=dev)
    n0 = cuda_sw.sw_align.launches, cuda_sw.sw_score.launches
    with pytest.raises(ValueError, match="int32"):
        cuda_sw.sw_align(q, r)
    with pytest.raises(ValueError, match="int32"):
        cuda_sw.sw_score(q, r)
    assert (cuda_sw.sw_align.launches, cuda_sw.sw_score.launches) == n0


# K1's (lanes a group, columns a lane) pairs for N <= 512, as
# LHT_ALIGN_PAIRS in csrc/sw.cu lists them
ALIGN_PAIRS = [(32, 2), (32, 4), (32, 6), (32, 8), (32, 12), (32, 16)]
ALIGN_SHAPES = {
    # every pair's widest window and the width just above it, with few
    # alignments and with many
    **{f"n{g * npl}": (37, 60, g * npl) for g, npl in ALIGN_PAIRS},
    **{f"n{g * npl + 1}": (37, 60, g * npl + 1)
       for g, npl in ALIGN_PAIRS[:-1]},
    **{f"n{g * npl}_many": (2100, 30, g * npl) for g, npl in ALIGN_PAIRS},
    **{f"n{g * npl + 1}_many": (2100, 30, g * npl + 1)
       for g, npl in ALIGN_PAIRS[:-1]},
    "n1": (20, 30, 1), "n31": (20, 30, 31), "n511": (9, 100, 511),
    # align's windows: 150-bp reads padded to 192 rows, 32 columns either
    # side, at a batch of the main path and at the one-launch tile
    "align_window": (152, 192, 256), "align_window_many": (2048, 192, 256),
    # the wide mapping and its stripe boundaries (512 columns a warp; K2's
    # 256)
    "n513": (9, 150, 513), "n767": (5, 200, 767), "n768": (5, 200, 768),
    "n769": (5, 200, 769), "n1000": (12, 1000, 1000),
    "n1024": (4, 300, 1024), "n1025": (4, 300, 1025),
    "n4096": (3, 256, 4096),
    # wider than the block: a block a band in a cluster, balanced bands of
    # up to 8 stripes (N = 4,097: 2,560 + 1,537 columns), with more query
    # rows than the rings hold, one alignment, and past the cluster's 8
    # bands (round-robin, the wrap edge)
    "n4097": (5, 200, 4097), "n8192": (3, 300, 8192),
    "n8193": (3, 100, 8193), "long_m_bands": (2, 700, 5000),
    "n4097_one_alignment": (1, 200, 4097),
    "past_the_cluster": (2, 120, 33000),
    # three rounds of 8 blocks, the wrap buffer and the rings reused from
    # round to round, more query rows than the ring between two blocks
    # holds
    "three_rounds_long_m": (2, 600, 70000),
    # more query rows than the ring between two stripes holds: it wraps,
    # and the left stripe waits for the right one
    "long_m_wide": (6, 1500, 600),
    # one query row; more query rows than a staged chunk
    "m1": (9, 1, 200), "m1_wide": (4, 1, 700), "long_m_narrow": (20, 700, 96),
    # B that is no multiple of the alignments a block holds, down to one
    "ragged_b_many": (2061, 20, 32), "ragged_b_n192": (2055, 20, 192),
    "ragged_b_few": (3, 60, 384), "one_alignment": (1, 20, 160),
}
# SCORE_PARAMS and a set whose scores do not fit a byte of the table
ALIGN_PARAMS = SCORE_PARAMS + [(200, -300, -500, -30)]


@pytest.mark.parametrize("case", list(ALIGN_SHAPES))
@pytest.mark.parametrize("alpha", [2, 4])
def test_sw_align_kernel_matches_plain(dev, case, alpha):
    """K1 against its plain version, origins included: the 2-letter
    alphabet is tie-heavy, the parameters that do not decay or do not fit
    a byte take the guarded kernels, and a row of code 4 scores 0 where
    scores decay."""
    B, M, N = ALIGN_SHAPES[case]
    rng = np.random.default_rng(sum((B, M, N)) + alpha)
    if M <= N:
        q, r = _reads(rng, B, M, N, alpha)
    else:  # the query is longer than the window: plant the window in it
        r, q = _reads(rng, B, N, M, alpha)
    r[rng.random(r.shape) < 0.01] = 4
    q[B // 2] = 4  # a row that scores 0
    qd, rd = torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)
    for params in ALIGN_PARAMS:
        n0 = (cuda_sw.sw_align.launches, cuda_sw.sw_align.wide_launches,
              cuda_sw.sw_align.band_launches)
        n_shape = cuda_sw.sw_align.shapes[(B, M, N)]
        got = cuda_sw.sw_align(qd, rd, *params)
        assert cuda_sw.sw_align.launches == n0[0] + 1
        assert cuda_sw.sw_align.wide_launches == n0[1] + int(
            N > cuda_sw.NARROW_MAX_N)
        assert cuda_sw.sw_align.band_launches == n0[2] + int(
            N > cuda_sw.WIDE_MAX_N)
        assert cuda_sw.sw_align.shapes[(B, M, N)] == n_shape + 1
        want = cuda_sw.sw_align_plain(qd, rd, *params)
        _, mismatch, go, ge = params
        if mismatch <= 0 and ge <= 0 and go + ge <= 0:  # scores decay
            assert int(want[B // 2].abs().sum()) == 0
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sw_align_kernel_on_unalignable_and_identical_rows(dev):
    """All-N rows give five zeros; a read equal to its window aligns end
    to end: (M, 0, M - 1, 0, M - 1)."""
    for M in (160, 700):
        q = torch.randint(0, 4, (24, M), dtype=torch.uint8, device=dev)
        r = q.clone()
        q[::2] = 4
        got = cuda_sw.sw_align(q, r)
        assert got[::2].abs().sum().item() == 0
        want = torch.tensor([M, 0, M - 1, 0, M - 1], dtype=torch.int32,
                            device=dev)
        assert (got[1::2] == want).all()


@pytest.mark.parametrize("seed", [1, 2])
def test_vote_kernel_matches_plain(dev, seed):
    G = cuda_vote.KERNEL_SLOTS
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    C, B, P = 3, 4096, 64
    peak_contig = torch.randint(1, 30, (501,), generator=gen, device=dev,
                                dtype=torch.int32)
    pk = torch.randint(1, 501, (C, B, P), generator=gen, device=dev,
                       dtype=torch.int32)
    pk = torch.where(torch.rand((C, B, P), generator=gen, device=dev) < 0.4,
                     pk, 0)
    genome = torch.where(pk > 0, peak_contig[pk.long()], 0)
    got = cuda_vote.vote_state(genome, pk, n_slots=G)
    want = cuda_vote.vote_state_plain(genome, pk, n_slots=G)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _vote_inputs(dev, shape, density, n_genomes, seed, zero_genome=0.0):
    """(genome, pk) int32 [C, B, P] from a seeded numpy draw: candidates
    set with probability `density`; `zero_genome` of them carry a peak id
    but genome 0, which matches nothing."""
    rng = np.random.default_rng(seed)
    pk = rng.integers(1, 2000, shape).astype(np.int32)
    pk[rng.random(shape) >= density] = 0
    genome = ((pk * 7919) % n_genomes + 1).astype(np.int32)
    genome[(pk == 0) | (rng.random(shape) < zero_genome)] = 0
    return torch.from_numpy(genome).to(dev), torch.from_numpy(pk).to(dev)


VOTE_CASES = {
    # a ragged last block and a ragged last warp
    "ragged_B": ((3, 1000 + 77, 256), 0.5, 40, 0.0),
    "one_pair": ((3, 1, 128), 0.5, 40, 0.0),
    # P that is a multiple of 4 but not of the tile depth
    "P_not_tile_multiple": ((3, 300, 140), 0.5, 40, 0.0),
    # P that is no multiple of 4: the 4-byte copy path
    "P_odd": ((3, 333, 203), 0.5, 40, 0.0),
    "P_shorter_than_tile": ((3, 130, 3), 0.9, 5, 0.0),
    "all_zero": ((3, 500, 128), 0.0, 40, 0.0),
    "all_dense": ((3, 500, 128), 1.0, 40, 0.0),
    # more than 8 genomes a pair: the register overflows and evicts
    "eviction_heavy": ((3, 700, 256), 0.9, 300, 0.0),
    "few_genomes_high_counts": ((3, 700, 256), 0.9, 3, 0.0),
    "genome_zero_candidates": ((3, 400, 128), 0.6, 12, 0.3),
    "one_hash": ((1, 400, 128), 0.5, 20, 0.0),
    "nine_hashes": ((9, 200, 64), 0.4, 20, 0.0),
}


@pytest.mark.parametrize("case", list(VOTE_CASES))
def test_vote_kernel_matches_plain_on_edge_shapes(dev, case):
    shape, density, n_genomes, zero_genome = VOTE_CASES[case]
    genome, pk = _vote_inputs(dev, shape, density, n_genomes,
                              sum(shape) + n_genomes, zero_genome)
    n0 = cuda_vote.vote_state.launches
    got = cuda_vote.vote_state(genome, pk)
    assert cuda_vote.vote_state.launches == n0 + 1
    want = cuda_vote.vote_state_plain(genome, pk)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if case == "eviction_heavy":  # far more genomes met than slots
        assert int(genome[:, 0].unique().numel()) > 5 * cuda_vote.KERNEL_SLOTS


def test_vote_kernel_reads_a_misaligned_view(dev):
    """A [C, B, P] view whose storage offset is not 16-byte aligned takes
    the 4-byte copy path and gives the same answer."""
    genome, pk = _vote_inputs(dev, (3, 200, 129), 0.5, 30, 5)
    g1, p1 = genome[:, :, 1:].contiguous(), pk[:, :, 1:].contiguous()
    flat_g = torch.zeros(g1.numel() + 1, dtype=torch.int32, device=dev)
    flat_p = torch.zeros_like(flat_g)
    flat_g[1:] = g1.reshape(-1)
    flat_p[1:] = p1.reshape(-1)
    g2, p2 = flat_g[1:].view(g1.shape), flat_p[1:].view(p1.shape)
    assert g2.data_ptr() % 16 != 0 and g2.is_contiguous()
    for a, b in zip(cuda_vote.vote_state(g2, p2),
                    cuda_vote.vote_state_plain(g1, p1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_vote_kernel_raises_above_nine_hashes(dev):
    z = torch.zeros((cuda_vote.KERNEL_MAX_HASHES + 1, 4, 8),
                    dtype=torch.int32, device=dev)
    n0 = cuda_vote.vote_state.launches
    with pytest.raises(ValueError, match="hash functions"):
        cuda_vote.vote_state(z, z)
    assert cuda_vote.vote_state.launches == n0


# K4's callers: (rows, L) of codes a call hashes. Count: a 65,536-read
# batch padded to 192; scan: 8 reference chunks of 2^20 (`big`'s contigs
# of 1 Mbp); peak set: one chunk of 2^22 + k; vote: a 32,768-pair mate
# batch; and a ragged width
KMER_SHAPES = {"count": (65_536, 192), "scan": (8, 1 << 20),
               "peakset": (1, (1 << 22) + 32), "vote": (32_768, 192),
               "ragged": (77, 150)}


def _codes(rng, shape, n_frac=0.01):
    codes = rng.integers(0, 4, shape).astype(np.uint8)
    codes[rng.random(shape) < n_frac] = 4
    codes[0, : shape[1] // 3] = rng.integers(4, 256, shape[1] // 3)
    return codes


@pytest.mark.parametrize("k", [15, 18, 24, 31, 32])
@pytest.mark.parametrize("caller", list(KMER_SHAPES))
def test_kmer_hashes_kernel_is_bit_equal_to_plain(dev, caller, k):
    """K4 gives canonical_hashes_plain's hashes and valid bits at every
    position, past L - k included."""
    rng = np.random.default_rng(k + len(caller))
    masks, _ = encode.hasher_for(k, 3, seed=k)
    codes = torch.from_numpy(_codes(rng, KMER_SHAPES[caller])).to(dev)
    n0 = cuda_kmer.canonical_hashes.launches
    got_h, got_v = encode.canonical_hashes(codes, masks, k)
    assert cuda_kmer.canonical_hashes.launches == n0 + 1
    want_h, want_v = encode.canonical_hashes_plain(codes, masks, k)
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_h, want_h)


def test_kmer_hashes_kernel_takes_any_leading_shape(dev):
    rng = np.random.default_rng(3)
    masks, _ = encode.hasher_for(32, 5, seed=2)
    codes = torch.from_numpy(_codes(rng, (6, 70))).to(dev).view(2, 3, 70)
    got_h, got_v = encode.canonical_hashes(codes, masks, 32)
    want_h, want_v = encode.canonical_hashes_plain(codes, masks, 32)
    assert got_h.shape == (5, 2, 3, 70)
    assert torch.equal(got_v, want_v) and torch.equal(got_h, want_h)


def _read_batch(rng, B, L, k):
    codes = _codes(rng, (B, L))
    codes[1 : B // 8] = codes[0]          # runs longer than any cap
    codes[B // 8] = 4                     # an all-N read
    lengths = rng.integers(k - 3, L + 1, B).astype(np.int32)
    accept = rng.random(B) < 0.9
    return (torch.from_numpy(codes), torch.from_numpy(lengths),
            torch.from_numpy(accept))


@pytest.mark.parametrize("k,kw", [(32, 128), (32, 0), (18, 64), (24, 100)])
def test_count_keys_kernel_matches_plain_and_sorted_contrib(dev, k, kw):
    """K4's count epilogue equals count_keys_plain in place and
    sorted_contrib's keys as a multiset per row."""
    rng = np.random.default_rng(k + kw)
    masks, _ = encode.hasher_for(k, 3, seed=1)
    codes, lengths, accept = (x.to(dev) for x in _read_batch(
        rng, 65_536, 192, k))
    n0 = cuda_kmer.count_keys.launches
    got = count.count_keys(codes, lengths, accept, masks, k, kw)
    assert cuda_kmer.count_keys.launches == n0 + 1
    assert got.dtype == cuda_kmer.KEY_DTYPE
    assert torch.equal(got, count.count_keys_plain(
        codes, lengths, accept, masks, k, kw))
    s, _ = count.sorted_contrib(codes, lengths, accept, masks, k, 3, kw)
    unsigned = got.to(torch.int64) & count.SENTINEL
    assert torch.equal(torch.sort(unsigned, dim=1).values, s)


@pytest.mark.parametrize("k", range(15, 33))
@pytest.mark.parametrize("kw", [0, 64, 128])
def test_count_keys_kernel_at_every_k_and_crop(dev, k, kw):
    """K4's count epilogue (a warp a unit of up to 128 starts of a read,
    persistent blocks) equals count_keys_plain at every k the count step
    takes at k >= 15 and its crops, on a width a unit does not divide."""
    rng = np.random.default_rng(100 * k + kw)
    masks, _ = encode.hasher_for(k, 3, seed=k)
    for B, L in ((4_099, 192), (517, 150)):
        codes, lengths, accept = (x.to(dev) for x in _read_batch(
            rng, B, L, k))
        n0 = cuda_kmer.count_keys.launches
        got = count.count_keys(codes, lengths, accept, masks, k, kw)
        assert cuda_kmer.count_keys.launches == n0 + 1
        assert torch.equal(got, count.count_keys_plain(
            codes, lengths, accept, masks, k, kw))


def _k5_check(dev, s, cap, k=24, seed=0):
    """K5 over the rows of s [C, N] (int32, sorted) in one launch against
    run_capped_update_plain, onto tables of every byte value (a negative
    byte plus a run overflows it: the kernel's word add must not carry)."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.integers(-128, 128, (s.shape[0], 1 << k))
                            .astype(np.int8)).to(dev)
    got = [t.clone() for t in base]
    want = [t.clone() for t in base]
    n0 = cuda_kmer.run_capped_update.launches
    count.run_capped_update(got, s, cap)
    assert cuda_kmer.run_capped_update.launches == n0 + 1
    count.run_capped_update_plain(want, s, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got, base


@pytest.mark.parametrize("cap", [0, 1, 3, 7, 127])
def test_run_capped_update_kernel_matches_plain(dev, cap):
    """K5's tables, one launch for the three rows of a count batch, equal
    scatter_delta of rank_capped_contrib, onto tables that already hold
    counts."""
    k = 24
    rng = np.random.default_rng(cap)
    masks, _ = encode.hasher_for(k, 3, seed=1)
    codes, lengths, accept = (x.to(dev) for x in _read_batch(
        rng, 16_384, 192, k))
    s = torch.sort(count.count_keys(codes, lengths, accept, masks, k, 128),
                   dim=1).values
    got, base = _k5_check(dev, s, cap, k, seed=cap)
    for i in range(3):
        s64 = s[i].to(torch.int64) & count.SENTINEL
        want = base[i].clone()
        count.scatter_delta(want, s64,
                            count.rank_capped_contrib(s64[None], cap)[0])
        assert torch.equal(got[i], want)
        assert cap == 0 or not torch.equal(got[i], base[i])


def _straddling_row(n, rng, k=24):
    """A sorted key row of n keys in runs of 1 to 14, with no run start
    at a multiple of 128: every 128-key boundary lies inside a run."""
    q = np.arange(n)
    starts = ((q % 7 == 3) | (q % 11 == 5)) & (q % 128 != 0)
    starts[0] = True
    keys = np.sort(rng.choice(1 << k, int(starts.sum()), replace=False))
    return keys[np.cumsum(starts) - 1].astype(np.int32)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1_000, 65_536 + 5])
@pytest.mark.parametrize("cap", [1, 3, 9, 127])
def test_run_capped_update_kernel_on_edge_rows(dev, n, cap):
    """K5 on a row of short runs over every 128-key boundary, a row of
    all one key, a row of all sentinels and a row of long runs (up to 300
    keys, past the cap + 32 keys a head reads; the sentinel's among them),
    in one launch; n not a multiple of 4, so rows after the first start
    off a 16-byte boundary."""
    rng = np.random.default_rng(n + cap)
    lengths = rng.integers(1, 301, n)
    keys = np.sort(rng.choice(1 << 24, n, replace=False)).astype(np.int32)
    keys[0] = -1
    rows = np.stack([
        _straddling_row(n, rng),
        np.full(n, 77, np.int32),
        np.full(n, -1, np.int32),
        np.repeat(keys, lengths)[:n],
    ])
    got, base = _k5_check(dev, torch.from_numpy(rows).to(dev), cap,
                          seed=n)
    assert int((got[1] != base[1]).sum()) == 1
    assert int(got[1][77] - base[1][77]) == min(n, cap)
    assert torch.equal(got[2], base[2])


@pytest.mark.parametrize("cap", [1, 3, 127])
def test_run_capped_update_kernel_on_shared_words(dev, cap):
    """Keys from narrow ranges put several heads in one 32-bit table word
    (the compare-and-swap path) beside words of one head (the atomic add
    with its carry taken back), with runs past the cap and past what a
    head reads, in four rows of one launch."""
    rng = np.random.default_rng(cap)
    rows = []
    for span, longest in ((300, 4), (600, 9), (1 << 20, 300), (400, 150)):
        keys = np.sort(rng.choice(span, 250, replace=False))
        rows.append(np.repeat(keys, rng.integers(1, longest + 1, 250)))
    n = min(len(r) for r in rows)
    s = torch.from_numpy(np.stack([r[:n] for r in rows]).astype(np.int32))
    _k5_check(dev, s.to(dev), cap, k=22, seed=cap)


def test_run_capped_update_kernel_at_the_top_of_a_k32_table(dev):
    """At k=32 the sentinel's word holds keys 0xFFFFFFFC to 0xFFFFFFFE,
    which sort just before it as int32; the table's first and last 64
    bytes hold every byte value."""
    rng = np.random.default_rng(32)
    keys = np.sort(rng.choice(np.arange(-9, 6), 12, replace=False))
    row = np.repeat(keys, rng.integers(1, 200, 12)).astype(np.int32)
    s = torch.from_numpy(row[None]).to(dev)
    top = (1 << 32) - 64
    for cap in (1, 3, 127):
        ends = rng.integers(-128, 128, (2, 64)).astype(np.int8)
        got = count.make_table(32, dev)
        got[:64] = torch.from_numpy(ends[0]).to(dev)
        got[top:] = torch.from_numpy(ends[1]).to(dev)
        want = ends.copy()
        vals, runs = np.unique(row.view(np.uint32), return_counts=True)
        for v, r in zip(vals.tolist(), runs.tolist()):
            if v != 0xFFFFFFFF:
                part, i = (0, v) if v < 64 else (1, v - top)
                want[part, i] = np.int8(
                    (int(want[part, i]) + min(r, cap) + 128) % 256 - 128)
        n0 = cuda_kmer.run_capped_update.launches
        count.run_capped_update([got], s, cap)
        assert cuda_kmer.run_capped_update.launches == n0 + 1
        assert np.array_equal(got[:64].cpu().numpy(), want[0])
        assert np.array_equal(got[top:].cpu().numpy(), want[1])
        assert int(torch.count_nonzero(got[64:top])) == 0
        del got


def test_count_step_on_the_card_never_waits_for_the_host(dev):
    """A count step raises nothing under sync debug mode "error": K4's
    count epilogue, the sort and one K5 launch for the three tables, with
    and without the clip; its tables equal the plain route's."""
    k, cap = 24, 3
    rng = np.random.default_rng(8)
    masks, _ = encode.hasher_for(k, 3, seed=1)
    batch = _read_batch(rng, 8_192, 192, k)
    on_card = [count.make_table(k, dev) for _ in range(3)]
    plain = [count.make_table(k, dev) for _ in range(3)]
    codes, lengths, accept = (x.to(dev) for x in batch)
    count.count_reads_step(on_card, codes, lengths, accept, masks, k, cap,
                           clip=False, kw=128)  # builds and loads kmer.cu
    n0 = cuda_kmer.run_capped_update.launches
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for clip in (False, True):
            count.count_reads_step(on_card, codes, lengths, accept, masks,
                                   k, cap, clip=clip, kw=128)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_kmer.run_capped_update.launches == n0 + 2  # one a batch
    for clip in (False, False, True):
        s = torch.sort(count.count_keys_plain(
            codes, lengths, accept, masks, k, 128), dim=1).values
        count.run_capped_update_plain(plain, s, cap)
        if clip:
            count.clip_tables(plain, cap)
    for g, w in zip(on_card, plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", list(tune_seed.SHAPES))
def test_seed_prefilter_kernel_matches_plain_at_chip_smoke_shapes(dev, kind):
    """K6 at bkp's batch and direct mode's (chip_smoke.py's rows), one
    launch each, its edge rows as tune_seed.edge_rows builds them (in
    direct mode's dense bitmap rows 7 and 8 may hit elsewhere)."""
    codes, lengths, bitmap = tune_seed.inputs(kind, dev)
    n0 = cuda_seed.seed_prefilter.launches
    got = align.seed_prefilter_device(codes, lengths, bitmap)
    assert cuda_seed.seed_prefilter.launches == n0 + 1
    want = align.seed_prefilter_plain(codes, lengths, bitmap)
    assert torch.equal(got, want)
    edge = got[:12].tolist()
    assert [edge[i] for i in (0, 1, 9, 10)] == [False] * 4
    assert [edge[i] for i in (2, 3, 4, 5, 6, 11)] == [True] * 6
    if kind == "bkp":
        assert edge[7:9] == [False, False]
    assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("L", [15, 16, 17, 31, 32, 33, 47, 48, 63, 64, 65,
                               150, 191, 192, 193, 300])
def test_seed_prefilter_kernel_on_edge_widths(dev, L):
    """Every width about a tile's edge, lengths 0 to past L, N codes and
    planted windows of bit-31 and last-word prefixes on both strands."""
    rng = np.random.default_rng(L)
    B = 777
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    lengths = rng.integers(0, L + 8, B).astype(np.int32)
    pre = [*tune_seed.EDGE_PREFIXES]
    for b in np.flatnonzero(rng.random(B) < 0.3):
        if L >= 16:
            at = int(rng.integers(0, L - 15))
            codes[b, at:at + 16] = tune_seed.prefix_bases(
                pre[b % 3], bool(b % 2))
    bitmap = tune_seed.bitmap_of(pre, dev)
    c, ln = torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev)
    got = cuda_seed.seed_prefilter(c, ln, bitmap)
    assert torch.equal(got, align.seed_prefilter_plain(c, ln, bitmap))
    # a view of a wider batch: the wrapper reads it contiguous
    wide = torch.full((B, L + 5), 4, dtype=torch.uint8, device=dev)
    wide[:, :L] = c
    assert torch.equal(cuda_seed.seed_prefilter(wide[:, :L], ln, bitmap), got)


def test_seed_prefilter_kernel_on_empty_and_full_bitmaps(dev):
    codes, lengths, _ = tune_seed.inputs("bkp", dev, shape=(1000, 192),
                                         ref_bp=5_000)
    empty = torch.zeros(cuda_seed.BITMAP_WORDS, dtype=torch.int32,
                        device=dev)
    assert not cuda_seed.seed_prefilter(codes, lengths, empty).any()
    full = torch.full_like(empty, -1)
    got = cuda_seed.seed_prefilter(codes, lengths, full)
    assert torch.equal(got, align.seed_prefilter_plain(codes, lengths, full))
    assert got[2:7].all() and not got[:2].any()
    none = codes[:0]
    assert cuda_seed.seed_prefilter(none, lengths[:0], empty).shape == (0,)


def test_seed_prefilter_kernel_raises_on_what_it_does_not_take(dev):
    codes, lengths, bitmap = tune_seed.inputs("bkp", dev, shape=(64, 192),
                                              ref_bp=5_000)
    with pytest.raises(TypeError, match="int32 lengths"):
        cuda_seed.seed_prefilter(codes, lengths.long(), bitmap)
    with pytest.raises(TypeError, match="uint8 codes"):
        cuda_seed.seed_prefilter(codes.int(), lengths, bitmap)
    with pytest.raises(TypeError, match="bitmap"):
        cuda_seed.seed_prefilter(codes, lengths, bitmap[:-1])
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_seed.seed_prefilter(codes, lengths.cpu(), bitmap)


def test_seed_prefilter_on_the_card_never_waits_for_the_host(dev):
    """align.seed_prefilter_device raises nothing under sync debug mode
    "error": K6 is one launch with no host sync."""
    codes, lengths, bitmap = tune_seed.inputs("bkp", dev, shape=(4096, 192),
                                              ref_bp=20_000)
    align.seed_prefilter_device(codes, lengths, bitmap)  # builds seed.cu
    torch.cuda.synchronize(dev)
    n0 = cuda_seed.seed_prefilter.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = align.seed_prefilter_device(codes, lengths, bitmap)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_seed.seed_prefilter.launches == n0 + 1
    assert torch.equal(got, align.seed_prefilter_plain(codes, lengths,
                                                       bitmap))


def _card_mesh(n_shards=4):
    """n_shards entries over every visible card in turn: one card holds
    them all, four cards hold one each."""
    from localhgt_tpu_torch.parallel.mesh import make_flat_mesh

    cards = torch.cuda.device_count()
    return make_flat_mesh([f"cuda:{i % cards}" for i in range(n_shards)])


def test_sw_align_sharded_on_the_card(dev):
    """Data-parallel K1: every shard launches the kernel on its own card
    and the rows come back in order."""
    from localhgt_tpu_torch.ops import sw

    q, r = _reads(np.random.default_rng(17), 3001, 150, 214)
    want = sw.sw_align_tiled(q, r, dev)
    mesh = _card_mesh()
    n0 = cuda_sw.sw_align.launches
    got = sw.sw_align_sharded(mesh, q, r, tile=512)
    assert cuda_sw.sw_align.launches == n0 + 4 * 2   # 750 rows a shard
    for f in sw.FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_bkp_over_a_mesh_on_the_card(dev, tmp_path):
    """`bkp` at k=18 over four shards, on as many cards as there are:
    every file equals the single-device run's, and K3 launches once per
    shard and vote batch (no plain version on a CUDA tensor)."""
    from localhgt_tpu_torch.config import Config, KmerConfig
    from localhgt_tpu_torch.pipeline.bkp import detect_breakpoint
    from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample

    out = str(tmp_path)
    ref, fq1, fq2, _ = simulate_sample(out, "sx", SimParams(
        n_genomes=6, genome_len=30_000, hgt_num=3, depth=8, snp_rate=0.01,
        seed=21))
    cfg = Config().replace(kmer=KmerConfig(k=18))
    detect_breakpoint(ref, fq1, fq2, "one", out, dev, cfg=cfg)
    mesh = _card_mesh()
    n0 = cuda_vote.vote_state.launches
    detect_breakpoint(ref, fq1, fq2, "mesh", out, dev, cfg=cfg, mesh=mesh)
    assert cuda_vote.vote_state.launches == n0 + mesh.n  # one vote batch
    for suffix in ("acc.csv", "interval.txt", "interval.txt.bed"):
        with open(f"{out}/one.{suffix}", "rb") as f, \
                open(f"{out}/mesh.{suffix}", "rb") as g:
            want = f.read()
            assert want.count(b"\n") > 1 and g.read() == want, suffix


def test_count_kmers_samples_the_device_step_on_the_card(dev, tmp_path,
                                                         monkeypatch):
    """On the card count_kmers records one dispatch sample a batch and no
    synced device step (`count_step_device_s`: it synchronized the card
    inside the timed path), its `count.*` spans record seconds as on the
    CPU, and its tables equal the CPU run's."""
    want, nb, cpu_series, cpu_counters = count_series(
        tmp_path / "cpu", monkeypatch, "cpu")
    got, nb_card, series, counters = count_series(
        tmp_path / "card", monkeypatch, dev)
    assert nb_card == nb > 17
    assert set(series) == set(cpu_series) == {"count_batch_dispatch_s"}
    assert len(series["count_batch_dispatch_s"]) == nb
    spans = {f"count.{p}_s" for p in ("parse", "pad", "upload", "step")}
    assert spans <= set(counters) and spans <= set(cpu_counters)
    assert all(counters[s] > 0 for s in spans)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


def count_series(tmp_path, monkeypatch, device):
    """count_kmers at 64 reads a batch on a small fixture; returns (its
    tables, the number of batches, the registry's series and counters).
    Also run on the CPU by tests/test_torch_count_scan_peaks.py."""
    from localhgt_tpu_torch.config import Config, KmerConfig
    from localhgt_tpu_torch.ops import encode
    from localhgt_tpu_torch.pipeline import extract
    from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample
    from localhgt_tpu_torch.utils import metrics

    pa = SimParams(n_genomes=2, genome_len=20_000, hgt_num=1, depth=5,
                   seed=3)
    _, fq1, fq2, _ = simulate_sample(str(tmp_path), "c", pa)
    with open(fq1) as f:
        n_reads = sum(1 for _ in f) // 4
    monkeypatch.setattr(extract, "COUNT_BATCH_READS", 64)
    masks, _ = encode.hasher_for(14, 3, seed=1)
    metrics.reset()
    tables, _, _, _ = extract.count_kmers(
        fq1, fq2, masks, Config().replace(kmer=KmerConfig(k=14)), device)
    nb = 2 * -(-n_reads // 64)
    assert metrics.counters()["count_batches"] == nb
    series = {k: list(v) for k, v in metrics._SERIES.items()}
    counters = metrics.counters()
    metrics.reset()
    return tables, nb, series, counters
