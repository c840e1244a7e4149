"""Port parity: the plain version of kernel K3 (vote_state) against the
Pallas kernel in interpret mode and the lax.scan _vote_core, and the
port's split_vote_batch against the JAX one on a small direct map.
Comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localhgt_tpu.ops import encode as jax_encode
from localhgt_tpu.ops import pallas_vote
from localhgt_tpu.pipeline import peaks as jax_peaks
from localhgt_tpu_torch.ops import cuda_vote
from localhgt_tpu_torch.pipeline import peaks


def _random_candidates(seed, C, B, P, n_peaks, n_genomes, density):
    rng = np.random.default_rng(seed)
    pk = (rng.integers(1, n_peaks + 1, (C, B, P))
          * (rng.random((C, B, P)) < density)).astype(np.int32)
    peak_contig = rng.integers(1, n_genomes + 1, n_peaks + 1).astype(np.int32)
    peak_contig[0] = 0
    return pk, peak_contig


def _eviction_cases():
    """The register-overflow orderings of tests/test_vote.py:190 and :217."""
    out = []
    for genomes, G, mbn in (
        ([100 + i for i in range(10)] + [1] * 8 + [2] * 8, 8, 6),
        ([2, 2, 2, 1, 21, 22, 23, 1, 24, 1, 25, 1], 4, 3),
    ):
        P = len(genomes)
        pk = np.arange(1, P + 1, dtype=np.int32).reshape(1, 1, P)
        peak_contig = np.zeros(P + 1, np.int32)
        peak_contig[1:] = genomes
        out.append((pk, peak_contig, G, mbn))
    return out


CASES = ([_random_candidates(9, 3, 6, 40, 12, 4, 0.3) + (8, 2),
          _random_candidates(10, 3, 64, 48, 200, 20, 0.5) + (8, 3),
          _random_candidates(11, 2, 32, 24, 50, 12, 0.7) + (4, 2)]
         + _eviction_cases())


@pytest.mark.parametrize("case", range(len(CASES)))
def test_vote_state_plain_matches_pallas_and_lax_scan(case):
    pk, peak_contig, G, mbn = CASES[case]
    genome = peak_contig[pk]
    C, B, P = pk.shape
    got = cuda_vote.vote_state(torch.from_numpy(genome), torch.from_numpy(pk),
                               n_slots=G)
    want = pallas_vote.vote_state(jnp.asarray(genome), jnp.asarray(pk),
                                  n_slots=G, interpret=True)
    for g, w, name in zip(got, want, ("slots_g", "slots_c", "slots_p",
                                      "hits")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)

    # the whole vote core (K3 + tail) against the lax.scan path
    accept = np.ones(B, bool)
    accept[::5] = False
    half = P // 2
    want_pf = jax_peaks._vote_core(
        jnp.zeros(len(peak_contig), jnp.int32), jnp.asarray(pk[:, :, :half]),
        jnp.asarray(pk[:, :, half:]), jnp.asarray(peak_contig),
        jnp.asarray(accept), min_base_num=mbn, n_slots=G)
    got_pf = torch.zeros(len(peak_contig), dtype=torch.int32)
    peaks.vote_core(got_pf, torch.from_numpy(pk[:, :, :half]),
                    torch.from_numpy(pk[:, :, half:]),
                    torch.from_numpy(peak_contig), torch.from_numpy(accept),
                    min_base_num=mbn, n_slots=G)
    np.testing.assert_array_equal(got_pf.numpy(), np.asarray(want_pf))


@pytest.mark.parametrize("kw", [0, 64])
def test_split_vote_batch_matches_jax(kw):
    """Reads drawn from a few random genomes, half of them chimeric, voted
    against a direct map holding peak k-mers of every genome."""
    k = 12
    rng = np.random.default_rng(21 + kw)
    n_gen, glen, B, L = 5, 600, 96, 100
    genomes = rng.integers(0, 4, (n_gen, glen)).astype(np.uint8)
    masks, _ = jax_encode.hasher_for(k, 3, seed=1)
    dm = np.zeros(1 << k, np.int32)
    peak_contig = [0]
    for g in range(n_gen):
        for s in (100, 300):  # two peaks per genome, 80-bp windows
            pid = len(peak_contig)
            peak_contig.append(g + 1)
            h, v = jax_encode.canonical_hashes(
                np, genomes[g][None, s:s + 80], masks, k)
            hv = h[:, 0][:, v[0]].reshape(-1).astype(np.int64)
            dm[hv] = np.maximum(dm[hv], pid)
    peak_contig = np.asarray(peak_contig, np.int32)

    def reads():
        out = np.full((B, L), 4, np.uint8)
        for b in range(B):
            g1, g2 = rng.integers(0, n_gen, 2)
            s1, s2 = rng.integers(80, 340, 2)
            cut = int(rng.integers(30, 70)) if b % 2 else L
            out[b, :cut] = genomes[g1, s1:s1 + cut]
            out[b, cut:] = genomes[g2, s2:s2 + L - cut]
        return out

    c1, c2 = reads(), reads()
    l1 = rng.integers(60, L + 1, B).astype(np.int32)
    l2 = np.full(B, L, np.int32)
    accept = rng.random(B) < 0.9
    want = jax_peaks.split_vote_batch(
        jnp.zeros(len(peak_contig), jnp.int32), jnp.asarray(c1),
        jnp.asarray(l1), jnp.asarray(c2), jnp.asarray(l2),
        jnp.asarray(accept), jnp.asarray(masks), jnp.asarray(dm),
        jnp.zeros(1, jnp.int32), jnp.asarray(peak_contig), k=k,
        min_base_num=3, use_map=True, kw=kw)
    got = torch.zeros(len(peak_contig), dtype=torch.int32)
    t = torch.from_numpy
    peaks.split_vote_batch(got, t(c1), t(l1), t(c2), t(l2), t(accept), masks,
                           t(dm), t(peak_contig), k=k, min_base_num=3, kw=kw)
    want = np.asarray(want)
    assert want[1:].sum() > 0  # the fixture must exercise real votes
    np.testing.assert_array_equal(got.numpy(), want)


def test_vote_state_rejects_bad_inputs():
    z = torch.zeros((1, 2, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_vote.vote_state(z.long(), z.long())
    with pytest.raises(ValueError):
        cuda_vote.vote_state(z, z[:, :1])
    with pytest.raises(ValueError):
        cuda_vote.vote_state(z.to("meta"), z.to("meta"))
