"""Coordinates past 2^31 in the port: the four cases of
tests/test_int64_coords.py on localhgt_tpu_torch.pipeline.{align, accbkp,
rawbkp}, each also held equal to the JAX package's result on the same
input.

A >= 1 Gbp reference puts flat sub-reference offsets, contig start
coordinates and alignment positions past 2^31; every structure of the port
that carries them must stay int64 end to end:

  * SubRef.lift of flat positions > 2^31 onto contigs starting > 2^31;
  * seed-candidate grouping with diagonals > 2^31;
  * raw-junction calling (insert estimate, orientation clustering) on
    alignments positioned > 2^31;
  * AlnIndex interval fetches at those loci.
"""

import dataclasses

import numpy as np

from localhgt_tpu import config as jax_config
from localhgt_tpu.pipeline import accbkp as jax_accbkp
from localhgt_tpu.pipeline import align as jax_align
from localhgt_tpu.pipeline import rawbkp as jax_rawbkp
from localhgt_tpu_torch.config import BkpConfig
from localhgt_tpu_torch.pipeline import accbkp, align, rawbkp

BIG = np.int64(3_000_000_000)  # > 2^31
POS1 = np.int64(2) ** 31 + 50_000  # both junction sides beyond 2^31
POS2 = np.int64(3_100_000_000)


def _subref_big(mod):
    return mod.SubRef(
        codes=np.zeros(64, np.uint8),
        seg_contig=np.array([1, 2], np.int32),
        seg_start=np.array([0, BIG], np.int64),
        seg_off=np.array([0, np.int64(2) ** 31 + 1000], np.int64),
        seg_len=np.array([2**31 + 1000, 5_000_000], np.int64),
    )


def test_subref_lift_past_2_31():
    flat = np.array([500, 2**31 + 1500], np.int64)
    contig, orig, seg = _subref_big(align).lift(flat)
    assert contig.tolist() == [1, 2]
    assert orig.dtype == np.int64
    assert int(orig[0]) == 500
    assert int(orig[1]) == int(BIG) + 500  # contig start beyond 2^31 kept
    assert seg.tolist() == [0, 1]
    for got, want in zip((contig, orig, seg),
                         _subref_big(jax_align).lift(flat)):
        np.testing.assert_array_equal(got, want)


def test_candidate_grouping_keeps_int64_diagonals():
    # two seed hits on the same far diagonal, one on a near one
    args = (np.array([0, 0, 0], np.int64),
            np.array([2**31 + 7_777, 2**31 + 7_779, 100], np.int64),
            np.array([10, 40, 10], np.int64))
    kw = dict(n_queries=1, gap=16, max_candidates=4, min_votes=1)
    d, votes, qmin, qmax, ok = align._group_candidates(*args, **kw)
    assert d.dtype == np.int64
    assert sorted(d[0][ok[0]].tolist()) == [100, 2**31 + 7_777]
    far = d[0].tolist().index(2**31 + 7_777)
    assert votes[0][far] == 2
    for got, want in zip((d, votes, qmin, qmax, ok),
                         jax_align._group_candidates(*args, **kw)):
        np.testing.assert_array_equal(got, want)


def _aln_pair_at(mod, pos1, pos2, n=40, rlen=150, insert=350):
    """Positionally-paired AlnTables of `mod`: proper pairs on contig 1
    for the insert estimate, plus cross-contig pairs at (pos1, pos2)."""
    total = 2 * n

    def mk(contig, pos, strand, mate):
        return mod.AlnTable(
            read_id=np.arange(total, dtype=np.int64),
            mate=np.full(total, mate, np.int8),
            contig=np.asarray(contig, np.int32),
            pos=np.asarray(pos, np.int64),
            rend=np.asarray(pos, np.int64) + rlen - 1,
            strand=np.asarray(strand, np.int8),
            qstart=np.zeros(total, np.int32),
            qend=np.full(total, rlen - 1, np.int32),
            score=np.full(total, rlen, np.int32),
            mapq=np.full(total, 60, np.int16),
            rlen=np.full(total, rlen, np.int32),
            contig2=np.full(total, -1, np.int32),
            pos2=np.zeros(total, np.int64),
            rend2=np.zeros(total, np.int64),
            strand2=np.zeros(total, np.int8),
            qstart2=np.zeros(total, np.int32),
            qend2=np.zeros(total, np.int32),
            score2=np.zeros(total, np.int32),
            has_alt=np.zeros(total, bool),
        )

    # first n rows: proper pairs on contig 1 near pos1 (insert estimate);
    # last n rows: discordant cross-contig pairs at (pos1 on 1, pos2 on 2)
    c1 = np.concatenate([np.full(n, 1), np.full(n, 1)])
    p1 = np.concatenate([np.arange(n, dtype=np.int64) * 10 + pos1,
                         np.arange(n, dtype=np.int64) % 8 + pos1])
    c2 = np.concatenate([np.full(n, 1), np.full(n, 2)])
    p2 = np.concatenate([
        np.arange(n, dtype=np.int64) * 10 + pos1 + insert - rlen,
        np.arange(n, dtype=np.int64) % 8 + pos2])
    return (mk(c1, p1, np.zeros(total, np.int8), 0),
            mk(c2, p2, np.ones(total, np.int8), 1))


def test_raw_junctions_past_2_31():
    a1, a2 = _aln_pair_at(align, POS1, POS2)
    cfg = BkpConfig()
    ins = rawbkp.estimate_insert(a1, a2, cfg)
    assert ins.rlen == 150
    raw = rawbkp.call_raw_bkps(a1, a2, ins, cfg)
    assert raw, "cross-contig cluster must produce a junction"
    assert any(
        c1 == 1 and c2 == 2 and abs(int(q1) - int(POS1)) < 500
        and abs(int(q2) - int(POS2)) < 500
        for r in raw for (c1, q1, c2, q2) in ((r.c1, r.pos1, r.c2, r.pos2),
                                              (r.c2, r.pos2, r.c1, r.pos1))
    ), [(r.c1, r.pos1, r.c2, r.pos2) for r in raw]
    j1, j2 = _aln_pair_at(jax_align, POS1, POS2)
    jcfg = jax_config.BkpConfig()
    jins = jax_rawbkp.estimate_insert(j1, j2, jcfg)
    assert dataclasses.astuple(ins) == dataclasses.astuple(jins)
    assert ([dataclasses.astuple(r) for r in raw]
            == [dataclasses.astuple(r)
                for r in jax_rawbkp.call_raw_bkps(j1, j2, jins, jcfg)])


def test_aln_index_fetch_past_2_31():
    a1, a2 = _aln_pair_at(align, POS1, POS2)
    idx = accbkp.AlnIndex(a1, a2)
    rows = idx.fetch(2, int(POS2) - 1000, int(POS2) + 1000)
    assert len(rows), "fetch at a >2^31 locus must find the alignments"
    assert idx.d["pos"].dtype == np.int64
    assert all(int(p) > 2**31 for p in idx.d["pos"][rows])
    want = jax_accbkp.AlnIndex(*_aln_pair_at(jax_align, POS1, POS2)).fetch(
        2, int(POS2) - 1000, int(POS2) + 1000)
    np.testing.assert_array_equal(rows, want)
