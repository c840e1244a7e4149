"""Port parity of io/qc.py (`--refine_fq 1`): the overlap scan equals the
JAX jitted scan and its numpy oracle exactly, the refined FASTQs are
byte-identical to the JAX package's, R1/R2 stay paired across blob
boundaries, and `bkp --refine_fq 1` writes the JAX package's acc.csv."""

import os

import numpy as np
import pytest
import torch

from localhgt_tpu.io import qc as jax_qc
from localhgt_tpu.ops.coder import _ASCII_TO_CODE
from localhgt_tpu_torch.io import qc

BASES = "ACGT"
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions are many small torch ops: one intra-op thread
    keeps them from spinning against the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rc(s):
    return "".join(COMP[c] for c in reversed(s))


def _rand_seq(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def _codes(seqs, width):
    c = np.full((len(seqs), width), 4, np.uint8)
    ln = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        a = _ASCII_TO_CODE[np.frombuffer(s.encode(), np.uint8)]
        c[i, : len(a)] = a
        ln[i] = len(a)
    return c, ln


def _port_insert(c1, l1, c2, l2):
    return qc._overlap_insert(*(torch.from_numpy(a)
                                for a in (c1, l1, c2, l2))).numpy()


def _assert_all_equal(seqs1, seqs2, width):
    c1, l1 = _codes(seqs1, width)
    c2, l2 = _codes(seqs2, width)
    got = _port_insert(c1, l1, c2, l2)
    np.testing.assert_array_equal(got, np.asarray(jax_qc._overlap_insert(
        c1, l1, c2, l2, max_len=width)))
    np.testing.assert_array_equal(got, jax_qc._overlap_insert_np(
        c1, l1, c2, l2))
    return got


def _qc_cases():
    """The cases of tests/test_qc.py: short insert, long insert,
    unrelated reads."""
    rng = np.random.default_rng(0)
    insert = _rand_seq(rng, 80)
    short = ((insert + _rand_seq(rng, 40))[:120],
             (_rc(insert) + _rand_seq(rng, 40))[:120])
    rng = np.random.default_rng(1)
    insert = _rand_seq(rng, 200)
    long_ = (insert[:120], _rc(insert)[:120])
    rng = np.random.default_rng(2)
    unrelated = (_rand_seq(rng, 120), _rand_seq(rng, 120))
    return [short, long_, unrelated], [80, 200, 0]


def test_overlap_insert_matches_jax_on_qc_cases():
    pairs, want = _qc_cases()
    got = _assert_all_equal([p[0] for p in pairs], [p[1] for p in pairs], 128)
    assert list(got) == want


def _random_pairs(seed, n):
    """Planted short inserts with adapter tails, long inserts with
    substitutions, unrelated reads, N runs and low-complexity repeats whose
    overlap ties across several offsets."""
    rng = np.random.default_rng(seed)
    s1, s2 = [], []
    for i in range(n):
        kind = i % 5
        if kind == 0:
            ins = _rand_seq(rng, int(rng.integers(35, 150)))
            a = (ins + _rand_seq(rng, 80))[:150]
            b = (_rc(ins) + _rand_seq(rng, 80))[:150]
        elif kind == 1:
            ins = list(_rand_seq(rng, int(rng.integers(150, 280))))
            for k in rng.integers(0, len(ins), 4):
                ins[k] = BASES[(BASES.index(ins[k]) + 1) % 4]
            ins = "".join(ins)
            a, b = ins[:150], _rc(ins)[:150]
        elif kind == 2:
            a = _rand_seq(rng, int(rng.integers(20, 151)))
            b = _rand_seq(rng, int(rng.integers(20, 151)))
        elif kind == 3:
            unit = _rand_seq(rng, int(rng.integers(1, 4)))
            a = (unit * 150)[: int(rng.integers(60, 151))]
            b = (_rc(unit) * 150)[: int(rng.integers(60, 151))]
        else:
            ins = _rand_seq(rng, 100)
            a = ins[:40] + "N" * 8 + ins[48:] + _rand_seq(rng, 30)
            b = _rc(ins) + _rand_seq(rng, 30)
        s1.append(a)
        s2.append(b)
    return s1, s2


def test_overlap_insert_matches_jax_on_random_batch():
    s1, s2 = _random_pairs(3, 200)
    got = _assert_all_equal(s1, s2, 160)
    assert ((got > 0) & (got < 150)).sum() >= 40  # short inserts found


def _write_pairs(path1, path2, s1, s2, seed):
    rng = np.random.default_rng(seed)
    with open(path1, "w") as f1, open(path2, "w") as f2:
        for i, (a, b) in enumerate(zip(s1, s2)):
            q1 = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, len(a)))
            q2 = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, len(b)))
            if i % 13 == 0:  # low quality
                q1 = "#" * len(a)
            f1.write(f"@r{i} extra/1\n{a}\n+\n{q1}\n")
            f2.write(f"@r{i}/2\n{b}\n+r{i}\n{q2}\n")


@pytest.mark.parametrize("batch", [7, 1 << 15])
def test_refined_files_byte_equal_to_jax(tmp_path, batch):
    s1, s2 = _random_pairs(4, 150)
    fq1, fq2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    _write_pairs(fq1, fq2, s1, s2, 5)
    want = jax_qc.refine_fastq(fq1, fq2, str(tmp_path / "j1.fq"),
                               str(tmp_path / "j2.fq"))
    got = qc.refine_fastq(fq1, fq2, str(tmp_path / "t1.fq"),
                          str(tmp_path / "t2.fq"), "cpu", batch=batch)
    # the JAX package's counts; the port counts its overlap scans besides
    assert {k: vars(got)[k] for k in vars(want)} == vars(want)
    assert 0 < got.pairs_out < got.pairs_in and got.adapter_trimmed > 0
    for m in "12":
        assert ((tmp_path / f"t{m}.fq").read_bytes()
                == (tmp_path / f"j{m}.fq").read_bytes())


def test_refine_fastq_end_to_end(tmp_path):
    """tests/test_qc.py's three pairs: trimmed, kept, dropped."""
    rng = np.random.default_rng(4)
    ins0 = _rand_seq(rng, 80)
    ins1 = _rand_seq(rng, 400)
    pairs = [((ins0 + _rand_seq(rng, 40))[:110],
              (_rc(ins0) + _rand_seq(rng, 40))[:110]),
             (ins1[:100], _rc(ins1)[:100]),
             (_rand_seq(rng, 100), _rand_seq(rng, 100))]
    fq1, fq2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i, (a, b) in enumerate(pairs):
            q = "#" if i == 2 else "I"
            f1.write(f"@p{i}/1\n{a}\n+\n{q * len(a)}\n")
            f2.write(f"@p{i}/2\n{b}\n+\n{q * len(b)}\n")
    o1, o2 = tmp_path / "o1.fq", tmp_path / "o2.fq"
    st = qc.refine_fastq(str(fq1), str(fq2), str(o1), str(o2), "cpu")
    assert st.pairs_in == 3 and st.pairs_out == 2
    assert st.adapter_trimmed == 2  # both mates of pair 0
    lines = o1.read_text().splitlines()
    assert lines[0] == "@p0/1"
    assert len(lines[1]) == 80 and len(lines[3]) == 80
    assert lines[4] == "@p1/1" and len(lines[5]) == 100


def test_passes_matches_jax_per_record(tmp_path):
    rng = np.random.default_rng(6)
    recs = []
    for i in range(120):
        n = int(rng.integers(5, 60))
        seq = "".join("ACGTNn"[k] for k in rng.integers(0, 6 if i % 3 else 4,
                                                        n))
        qual = "".join(chr(33 + int(x)) for x in rng.integers(0, 41, n))
        recs.append((seq, qual[: n if i % 7 else max(0, n - 3)]))
    path = tmp_path / "r.fq"
    path.write_text("".join(f"@r{i}\n{s}\n+\n{q}\n"
                            for i, (s, q) in enumerate(recs)))
    (rec,) = list(qc._records(str(path)))
    for cut in (None, 20):
        seq_len = rec.line_len(1)
        qual_len = rec.line_len(3)
        if cut is not None:
            seq_len = np.minimum(seq_len, cut)
            qual_len = np.minimum(qual_len, cut)
        got = qc._passes(rec.line_bytes(1, int(seq_len.max())),
                         rec.line_bytes(3, int(qual_len.max())),
                         seq_len, qual_len)
        want = [jax_qc._passes(s[:cut].encode(), q[:cut].encode())
                for s, q in recs]
        np.testing.assert_array_equal(got, want)


def test_read_batches_stay_paired_across_blob_boundaries(tmp_path,
                                                         monkeypatch):
    """tests/test_qc.py's case: R1 records much longer than R2 records, and
    blobs so small that boundaries split the files at different record
    counts."""
    n = 50
    fq1, fq2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i in range(n):
            f1.write(f"@read{i}/1\n{'A' * 90}\n+\n{'I' * 90}\n")
            f2.write(f"@read{i}/2\n{'C' * 30}\n+\n{'I' * 30}\n")
    monkeypatch.setattr(qc, "BLOB_BYTES", 256)
    batches = list(qc._read_batches(str(fq1), str(fq2), batch=7))
    assert [len(b1) for b1, _ in batches] == [7] * 7 + [1]
    got = []
    for b1, b2 in batches:
        for rec, mate in ((b1, 1), (b2, 2)):
            names = [bytes(rec.buf[s:e]) for s, e in
                     zip(rec.start[:, 0], rec.end[:, 0])]
            got.append((mate, names))
    names1 = [x for mate, ns in got if mate == 1 for x in ns]
    names2 = [x for mate, ns in got if mate == 2 for x in ns]
    assert names1 == [f"@read{i}/1".encode() for i in range(n)]
    assert names2 == [f"@read{i}/2".encode() for i in range(n)]


def _plant_adapter_pairs(fq1, fq2, frac, seed):
    """Rewrite `frac` of the pairs to a short insert (60-120 bp of the
    pair's own read 1) followed by an adapter; returns the insert length
    of each rewritten pair."""
    rng = np.random.default_rng(seed)
    with open(fq1) as f:
        r1 = f.read().splitlines()
    with open(fq2) as f:
        r2 = f.read().splitlines()
    adapter = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC" * 5
    planted = {}
    for i in range(0, len(r1) // 4):
        if rng.random() >= frac:
            continue
        seq = r1[4 * i + 1]
        n = int(rng.integers(60, 121))
        ins = seq[:n]
        r1[4 * i + 1] = (ins + adapter)[: len(seq)]
        r2[4 * i + 1] = (_rc(ins) + adapter)[: len(r2[4 * i + 1])]
        planted[i] = n
    for path, lines in ((fq1, r1), (fq2, r2)):
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return planted


def test_bkp_refine_fq_matches_jax(tmp_path):
    from localhgt_tpu.config import Config, KmerConfig
    from localhgt_tpu.pipeline.bkp import detect_breakpoint as jax_bkp
    from localhgt_tpu.sim.simulate import SimParams, simulate_sample
    from localhgt_tpu_torch import cli

    pa = SimParams(n_genomes=4, genome_len=20_000, hgt_num=2, depth=6,
                   seed=8)
    ref, fq1, fq2, _ = simulate_sample(str(tmp_path), "q1", pa)
    planted = _plant_adapter_pairs(fq1, fq2, 0.02, 9)
    assert planted
    cfg = Config().replace(kmer=KmerConfig(k=18))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    want = jax_bkp(ref, fq1, fq2, "q1", str(jdir), cfg=cfg, refine_fq=True,
                   mesh=None)
    assert cli.main(["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2,
                     "-s", "q1", "-o", str(tdir), "-k", "18",
                     "--refine_fq", "1", "--device", "cpu"]) == 0
    for m in "12":
        assert ((tdir / f"q1_refined_{m}.fq").read_bytes()
                == (jdir / f"q1_refined_{m}.fq").read_bytes())
    # every planted pair is cut to its insert
    with open(tdir / "q1_refined_1.fq") as f:
        out = f.read().splitlines()
    lens = {ln[1:].split("/")[0]: len(out[k + 1])
            for k, ln in enumerate(out) if k % 4 == 0}
    with open(fq1) as f:
        names = f.read().splitlines()[::4]
    for i, ins in planted.items():
        assert lens[names[i][1:].split("/")[0]] == ins
    got = (tdir / "q1.acc.csv").read_bytes()
    assert got.count(b"\n") > 2  # the fixture calls breakpoints
    assert got == open(want, "rb").read()
