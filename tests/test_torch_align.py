"""Port parity of the seed-and-extend aligner on the `world` fixture of
tests/test_align.py: placement, strand, split reads across contigs,
garbage unmapped, mapq on repeats, and the native seed lookup.

Each case asserts what the JAX test asserts on the port's align_batch
(prefilter passed in, as `bkp` passes it), and holds the port's table to
the JAX align_batch's on the same reads field by field. Starts follow
ROADMAP F1: the JAX package's CPU path runs the lax.scan K1, which breaks
start-coordinate ties the other way, so against it every field but the
starts (pos, qstart, pos2, qstart2) must be equal; against the JAX
align_batch with its Pallas K1 (interpret mode, the production tie rule)
every field must be equal."""

import functools

import numpy as np
import pytest
import torch

from localhgt_tpu.config import AlignConfig as JaxAlignConfig
from localhgt_tpu.io import fasta as jax_fasta
from localhgt_tpu.ops import pallas_sw as jax_pallas_sw
from localhgt_tpu.ops import sw as jax_sw
from localhgt_tpu.pipeline import align as jax_align
from localhgt_tpu_torch.config import AlignConfig
from localhgt_tpu_torch.io import fasta, native
from localhgt_tpu_torch.ops.coder import COMPLEMENT
from localhgt_tpu_torch.pipeline import align

STARTS = ("pos", "qstart", "pos2", "qstart2")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _contigs(mod, names, codes):
    lengths = np.array([len(c) for c in codes])
    return mod.Contigs(
        names=names, lengths=lengths,
        offsets=np.concatenate([[0], np.cumsum(lengths)[:-1]]),
        codes=np.concatenate(codes).astype(np.uint8)).finalize()


def _world(names, codes, intervals):
    """(port contigs, port subref, port index, JAX subref, JAX index)."""
    c = _contigs(fasta, names, codes)
    jc = _contigs(jax_fasta, names, codes)
    sub = align.build_subref(c, intervals)
    jsub = jax_align.build_subref(jc, intervals)
    return (c, sub, align.SeedIndex.build(sub, 19), jsub,
            jax_align.SeedIndex.build(jsub, 19))


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 10000).astype(np.uint8)
    return _world(["c1_1", "c2_1"], [codes[:5000], codes[5000:]],
                  [(1, 1, 5000), (2, 1, 5000)])


def _batch(reads):
    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
    return codes, np.array([len(r) for r in reads], np.int32)


def _aln(w, reads):
    """The port's table for `reads`, held to the JAX align_batch's."""
    _, sub, index, jsub, jindex = w
    codes, lengths = _batch(reads)
    ids = np.arange(len(reads))
    pf = align.seed_prefilter_device(
        torch.from_numpy(codes), torch.from_numpy(lengths),
        align.prefix_bitmap(index, "cpu")).numpy()
    got = align.align_batch(sub, index, codes, lengths, ids, 0,
                            AlignConfig(), "cpu", pf)
    jcfg = JaxAlignConfig()
    scan = jax_align.align_batch(jsub, jindex, codes, lengths, ids, 0, jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sw, "_use_pallas", lambda: True)
        mp.setattr(jax_pallas_sw, "sw_align_pallas", functools.partial(
            jax_pallas_sw.sw_align_pallas, interpret=True))
        pallas = jax_align.align_batch(jsub, jindex, codes, lengths, ids, 0,
                                       jcfg)
    for f in got.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got, f), getattr(pallas, f),
                                      err_msg=f)
        if f not in STARTS:
            np.testing.assert_array_equal(getattr(got, f), getattr(scan, f),
                                          err_msg=f)
    return got


def test_exact_placement_and_strand(world):
    contigs = world[0]
    c1 = contigs.contig_codes(1)
    r_fwd = c1[1000:1150].copy()
    r_rev = COMPLEMENT[c1[2000:2150]][::-1].copy()
    t = _aln(world, [r_fwd, r_rev])
    assert t.contig[0] == 1 and abs(t.pos[0] - 1000) <= 1
    assert t.strand[0] == 0 and t.mapq[0] >= 20
    assert t.contig[1] == 1 and abs(t.pos[1] - 2000) <= 1
    assert t.strand[1] == 1
    assert t.contig2[0] == -1  # no split


def test_split_read_across_contigs(world):
    contigs = world[0]
    c1 = contigs.contig_codes(1)
    c2 = contigs.contig_codes(2)
    chimera = np.concatenate([c1[3000:3070], c2[1200:1280]])
    t = _aln(world, [chimera])
    got = {int(t.contig[0]), int(t.contig2[0])}
    assert got == {1, 2}, (t.contig, t.contig2, t.pos, t.pos2)
    # the two parts cover disjoint read halves
    assert t.score[0] >= 60 and t.score2[0] >= 60


def test_split_read_reverse_second_half(world):
    """Junction into a reverse-complemented segment (the reversed-HGT
    case)."""
    contigs = world[0]
    c1 = contigs.contig_codes(1)
    c2 = contigs.contig_codes(2)
    part2 = COMPLEMENT[c2[600:680]][::-1]
    chimera = np.concatenate([c1[4000:4070], part2])
    t = _aln(world, [chimera])
    assert {int(t.contig[0]), int(t.contig2[0])} == {1, 2}
    assert {int(t.strand[0]), int(t.strand2[0])} == {0, 1}


def test_unmapped_garbage(world):
    rng = np.random.default_rng(9)
    junk = rng.integers(0, 4, 150).astype(np.uint8)
    t = _aln(world, [junk])
    assert t.contig[0] == -1 or t.mapq[0] == 0


def test_mapq_drops_for_repeats(world):
    c1 = world[0].contig_codes(1).copy()
    # duplicate a region so the read maps to two places
    dup = _world(["d1_1"], [np.concatenate([c1[:2000], c1[:2000]])],
                 [(1, 1, 4000)])
    t = _aln(dup, [c1[500:650].copy()])
    assert t.mapq[0] < 20


def test_native_seed_hits_match_jax_and_numpy():
    """The port's C++ seed_hits (io/csrc) reproduces the numpy seeding
    path exactly (same hits per strand in the same order), as the JAX
    package's does, and equals the JAX package's hits."""
    from localhgt_tpu.io import native as jax_native

    rng = np.random.default_rng(11)
    ref_codes = rng.integers(0, 4, 5000).astype(np.uint8)
    _, subref, index, _, _ = _world(["c1"], [ref_codes], [(1, 1, 5000)])

    B, L = 32, 128
    codes = np.full((B, L), 4, np.uint8)
    lengths = rng.integers(60, L, B).astype(np.int32)
    for i in range(B):
        ln = lengths[i]
        src = int(rng.integers(0, 5000 - ln))
        seg = ref_codes[src: src + ln].copy()
        if i % 3 == 0:  # reverse-complement some reads
            seg = np.array([3 - c for c in seg[::-1]], np.uint8)
        codes[i, :ln] = seg
    codes[5, 30] = 4  # an N breaks seeds spanning it

    hr, ho, hp, hs = native.seed_hits(
        codes, lengths, index.sorted_hash, index.sorted_pos, 19, 5, 32)
    want = jax_native.seed_hits(
        codes, lengths, index.sorted_hash, index.sorted_pos, 19, 5, 32)
    for a, b in zip((hr, ho, hp, hs), want):
        np.testing.assert_array_equal(a, b)

    rc = align._revcomp_batch(codes, lengths)
    for strand, arr in ((0, codes), (1, rc)):
        stride_idx = np.arange(0, L - 19 + 1, 5)
        h, valid = align._pack_seeds_at(arr, 19, stride_idx)
        # the numpy path hashes padded tails too; keep in-read seeds
        valid = valid & (stride_idx[None, :] + 19 <= lengths[:, None])
        flat = valid.reshape(-1)
        qh = h.reshape(-1)[flat]
        qread = np.broadcast_to(np.arange(B)[:, None], h.shape).reshape(-1)[
            flat]
        qoff = np.broadcast_to(stride_idx[None, :], h.shape).reshape(-1)[
            flat]
        hit_q, hit_pos = index.lookup(qh, max_occ=32)
        m = hs == strand
        np.testing.assert_array_equal(hr[m], qread[hit_q])
        np.testing.assert_array_equal(ho[m], qoff[hit_q])
        np.testing.assert_array_equal(hp[m], hit_pos)
