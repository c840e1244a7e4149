"""Kernels K1, K2 and K3 on the card against their plain torch versions.

These tests need an NVIDIA GPU with nvcc: they carry the `cuda` marker and
skip without a card. Run them on one with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(`--noconftest`: tests/conftest.py imports jax, which a machine that only
runs the port need not have.)
"""

import numpy as np
import pytest
import torch

from localhgt_tpu_torch.ops import cuda_sw, cuda_vote

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


def test_sw_kernels_raise_above_the_widest_reference(dev):
    q = torch.zeros((2, 16), dtype=torch.uint8, device=dev)
    r = torch.zeros((2, cuda_sw.MAX_N + 1), dtype=torch.uint8, device=dev)
    n0 = cuda_sw.sw_align.launches
    with pytest.raises(ValueError, match="widest"):
        cuda_sw.sw_align(q, r)
    with pytest.raises(ValueError, match="widest"):
        cuda_sw.sw_score(q, r)
    assert cuda_sw.sw_align.launches == n0


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
