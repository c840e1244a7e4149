"""QC on raw reads (`refine_fq` in a configuration): the generator's
planting, the plain reference's QC against the JAX package's, and a run
of the harness on the CPU at a tiny size in which QC's two faults (no
adapter trimmed, no pair filtered) each turn `correct` false."""

import numpy as np
import pytest
import torch

from hgtbench import check, cohort, registry, run, sim

CONFIG = {"n_genomes": 12, "genome_len": 20_000}  # two chunks of contigs
PLAIN = {"depth": 5, "hgt_num": 2, "pool": 1}
RAW = {**PLAIN, "adapter_frac": 0.05, "adapter_insert": "60-140",
       "lowq_frac": 0.02}


def _records(path):
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return [lines[i:i + 4] for i in range(0, len(lines) - 1, 4)]


def _made(tmp_path, traffic, seed):
    s = cohort.make(str(tmp_path / f"{seed}-{len(traffic)}"), CONFIG,
                    traffic, seed).pool[0]
    return s, _records(s.fq1), _records(s.fq2)


def _planted(plain, raw):
    """({pair: insert} of the short-insert pairs, [pairs of low quality])
    from the records of one seed made without and with the planting."""
    lo, hi = (int(x) for x in RAW["adapter_insert"].split("-"))
    short, low = {}, []
    for i, (p1, p2, r1, r2) in enumerate(zip(*plain, *raw)):
        assert (p1[0], p2[0], p1[2], p2[2]) == (r1[0], r2[0], r1[2], r2[2])
        if r1[1] != p1[1]:
            L = len(p1[1])
            n = [n for n in range(lo, hi + 1) if r1[1][:n] == p1[1][:n]
                 and r1[1][n:n + 33] == sim.ADAPTER_R1.tobytes()[: L - n]]
            assert len(n) == 1, i
            short[i] = n[0]
            assert r2[1][: n[0]] == sim.revcomp(
                r1[1][: n[0]].decode()).encode()
            assert (r1[3], r2[3]) == (p1[3], p2[3])
        elif r2[3] != p2[3]:
            low.append(i)
            assert r2[3][len(r2[3]) // 2:] == b"#" * (len(r2[3]) -
                                                     len(r2[3]) // 2)
            assert (r1, r2[:3]) == (p1, p2[:3])
        else:
            assert (r1, r2) == (p1, p2)
    return short, low


def _chunks(records):
    """The chunk of each pair: contigs in their order in the file, a
    chunk every cohort.CHUNK_CONTIGS of them."""
    order = {}
    out = []
    for rec in records:
        contig = rec[0][1:].decode().rsplit("-", 2)[0]
        order.setdefault(contig, len(order))
        out.append(order[contig] // cohort.CHUNK_CONTIGS)
    return np.array(out)


@pytest.mark.parametrize("seed", [11, 2**31 + 13])
def test_planting_rewrites_a_fixed_share_of_every_chunk(tmp_path, seed):
    s0, *plain = _made(tmp_path, PLAIN, seed)
    s1, *raw = _made(tmp_path, RAW, seed)
    assert s1.n_pairs == s0.n_pairs == len(raw[0]) == len(raw[1])
    short, low = _planted(plain, raw)
    chunk = _chunks(raw[0])
    assert chunk.max() == 1
    for c in range(2):
        n = int((chunk == c).sum())
        assert sum(chunk[i] == c for i in short) == round(
            RAW["adapter_frac"] * n)
        assert sum(chunk[i] == c for i in low) == round(RAW["lowq_frac"] * n)


def test_two_seeds_plant_as_many_pairs_as_their_chunks_hold(tmp_path):
    got = []
    for seed in (5, 2**31 + 3):
        s, r1, r2 = _made(tmp_path, RAW, seed)
        short, low = _planted(_made(tmp_path, PLAIN, seed)[1:], (r1, r2))
        chunk = _chunks(r1)
        sizes = np.bincount(chunk)
        got.append((len(short), len(low), sizes))
    (a1, l1, n1), (a2, l2, n2) = got
    # each chunk plants round(frac x its pairs); the chunks' pairs differ
    # between seeds only within the indels' play
    for frac, x, y in ((RAW["adapter_frac"], a1, a2),
                       (RAW["lowq_frac"], l1, l2)):
        assert abs(x - y) <= frac * np.abs(n1 - n2).sum() + len(n1)


def test_the_port_trims_every_planted_pair_to_its_insert(tmp_path):
    from localhgt_tpu_torch.io import qc

    seed = 2**31 + 21
    raw = _made(tmp_path, RAW, seed)
    short, low = _planted(_made(tmp_path, PLAIN, seed)[1:], raw[1:])
    out = [str(tmp_path / f"refined_{m}.fq") for m in (1, 2)]
    st = qc.refine_fastq(raw[0].fq1, raw[0].fq2, *out, torch.device("cpu"))
    kept = [{r[0]: r for r in _records(p)} for p in out]
    for i, n in short.items():
        for m in (0, 1):
            rec = kept[m][raw[1 + m][i][0]]
            assert len(rec[1]) == len(rec[3]) == n
    for i in low:
        assert raw[1][i][0] not in kept[0]
    assert st.adapter_trimmed == 2 * len(short)
    assert st.pairs_out == st.pairs_in - len(low)


def test_plain_qc_writes_the_jax_packages_refined_files(tmp_path):
    from localhgt_tpu.io import qc as jax_qc

    from hgtbench.plainref.io import qc

    s = _made(tmp_path, RAW, 2**31 + 23)[0]
    mine = [str(tmp_path / f"plain_{m}.fq") for m in (1, 2)]
    theirs = [str(tmp_path / f"jax_{m}.fq") for m in (1, 2)]
    st = qc.refine_fastq(s.fq1, s.fq2, *mine, torch.device("cpu"))
    jst = jax_qc.refine_fastq(s.fq1, s.fq2, *theirs)
    assert vars(st) == vars(jst)
    assert st.adapter_trimmed > 0 and st.pairs_out < st.pairs_in
    for a, b in zip(mine, theirs):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()


def test_refined_records_counts_records_that_differ():
    a = b"@r1\nACGT\n+\nIIII\n@r2\nAC\n+\nII\n"
    b = b"@r1\nACGT\n+\nIIII\n@r2\nACG\n+\nIII\n@r3\nA\n+\nI\n"
    assert check.refined_records((a, a), (a, a)) == 0
    assert check.refined_records((a, a), (b, a)) == 2
    assert check.refined_records((a[:-1], b""), (a, a)) == 1 + 2


@pytest.fixture
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _correct(spec, d):
    cell = registry.Cell(spec, "tiny.qc", d)
    workdir = d / "run"
    workdir.mkdir()
    res, nums = run.run_cell(cell, 2**31 + 5, 0.1, False,
                             torch.device("cpu"), str(workdir))
    return run.finish(res, nums)


def test_sound_program_with_qc_is_correct(tiny_bench, _few_threads):
    res = _correct(*tiny_bench)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {
        "intervals", "bed", "subref_bp", "alignments", "raw_junctions",
        "acc_lines", "qc_counts", "refined_records", "checked_runs"}
    assert res["checks"]["qc_counts"]["limit"] == 0
    assert res["checks"]["refined_records"]["limit"] == 0


def test_qc_that_trims_no_adapter(tiny_bench, _few_threads, monkeypatch):
    from localhgt_tpu_torch.io import qc
    monkeypatch.setattr(qc, "_overlap_insert", lambda c1, l1, c2, l2:
                        torch.zeros(len(l1), dtype=torch.int32))
    res = _correct(*tiny_bench)
    assert not res["correct"]
    assert res["checks"]["refined_records"]["value"] > 0
    assert res["checks"]["qc_counts"]["value"] > 0


def test_qc_filter_that_keeps_every_pair(tiny_bench, _few_threads,
                                         monkeypatch):
    from localhgt_tpu_torch.io import qc
    monkeypatch.setattr(qc, "_passes", lambda seq, qual, seq_len, qual_len:
                        np.ones(len(seq_len), bool))
    res = _correct(*tiny_bench)
    assert not res["correct"]
    assert res["checks"]["refined_records"]["value"] > 0
    assert res["checks"]["qc_counts"]["value"] > 0
