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
