"""Port parity of the analyses: microhomology and mechanism (device
alignments by ops/nw.py), the logistic-regression classifier and LODO
(torch Adam), and every `analyze` analysis through the port's CLI, held
against the JAX package on tests/test_analysis.py's fixtures.

Tolerances: integer outputs and JSON text are exact; the trained weights
are within atol 1e-4 of optax's (float32, summed in another order), and
the AUCs computed from them are equal."""

import dataclasses

import numpy as np
import pytest
from test_analysis import _cohort_samples, toy_cohort  # noqa: F401

from localhgt_tpu import cli as jax_cli
from localhgt_tpu.analysis import classifier as jax_classifier
from localhgt_tpu.analysis import cohort as jax_cohort
from localhgt_tpu.analysis import mechanism as jax_mechanism
from localhgt_tpu.analysis import microhomology as jax_mh
from localhgt_tpu.analysis import records
from localhgt_tpu.utils import formats
from localhgt_tpu_torch import cli
from localhgt_tpu_torch.analysis import classifier, cohort, mechanism
from localhgt_tpu_torch.analysis import microhomology as mh

# ---------- microhomology ----------


def test_bkp_and_random_homology_match_jax(toy_cohort):  # noqa: F811
    contigs, sdir, _ = toy_cohort
    bkps = [b for s in records.load_cohort(sdir) for b in s.bkps]
    got = mh.bkp_homology(bkps, contigs, "cpu")
    np.testing.assert_array_equal(got, jax_mh.bkp_homology(bkps, contigs))
    assert got.min() >= 30
    np.testing.assert_array_equal(
        mh.random_homology(contigs, 40, "cpu", seed=5, batch=16),
        jax_mh.random_homology(contigs, 40, seed=5))


def test_compare_vs_random_matches_jax(toy_cohort):  # noqa: F811
    contigs, sdir, _ = toy_cohort
    bkps = [b for s in records.load_cohort(sdir) for b in s.bkps]
    got = mh.compare_vs_random(bkps, contigs, "cpu", n_random=48)
    assert got == jax_mh.compare_vs_random(bkps, contigs, n_random=48)
    assert got["hgt_mean"] >= 25 > got["random_mean"]


def test_host_helpers_match_jax(toy_cohort):  # noqa: F811
    contigs, _, _ = toy_cohort
    for args in (("gA_1", 401, "+"), ("gA_1", 401, "-"), ("gB_1", 50, "+"),
                 ("gB_1", 9990, "-"), ("missing_1", 500, "+")):
        got = mh.flank_codes(contigs, *args)
        want = jax_mh.flank_codes(contigs, *args)
        assert (got is None and want is None) or np.array_equal(got, want)
    rng = np.random.default_rng(0)
    for _ in range(20):
        s1 = rng.integers(0, 4, 60).astype(np.uint8)
        s2 = rng.integers(0, 4, 60).astype(np.uint8)
        k = int(rng.integers(0, 50))
        s2[k:k + 5] = s1[k + 3:k + 8] if k + 8 <= 60 else s2[k:k + 5]
        assert mh.find_mh(s1, s2) == jax_mh.find_mh(s1, s2)
    lens = [-1, 3, 3, 7, 0, -1, 12]
    assert mh.average_homology(lens) == jax_mh.average_homology(lens)
    assert mh.length_freq(lens) == jax_mh.length_freq(lens)


# ---------- mechanism ----------


def _events():
    return [("s1", "gA_1", 471, "gB_1", 701, 950, "False"),
            ("s2", "gA_1", 2000, "gB_1", 950, 701, "True"),
            ("s3", "gB_1", 300, "gA_1", 5000, 5800, "False"),
            ("s4", "gB_1", 300, "gA_1", 20, 9990, "1")]


def test_classify_events_matches_jax(toy_cohort):  # noqa: F811
    contigs, _, _ = toy_cohort
    tei = {"gB_1": [(690, 710)], "gA_1": [(1990, 2010)]}
    tandem = {"gA_1": [(4990, 5010)]}
    for kw in ({}, {"tei": tei, "tandem": tandem},
               {"ins_lens": [0, 3, 12, 0]}):
        got = mechanism.classify_events(
            [mechanism.EventRow(*e) for e in _events()], contigs, "cpu", **kw)
        want = jax_mechanism.classify_events(
            [jax_mechanism.EventRow(*e) for e in _events()], contigs, **kw)
        for g, w in zip(got, want, strict=True):
            assert dataclasses.astuple(g.pop("event")) == \
                dataclasses.astuple(w.pop("event"))
            assert g == w
    for bt in ("ins", "del"):
        for ins_n in (0, 3, 12):
            for homo in (0, 1, 5, 150):
                for flags in ((False, False), (True, False), (False, True)):
                    assert (mechanism.classify(bt, *flags, ins_n, homo)
                            == jax_mechanism.classify(bt, *flags, ins_n,
                                                      homo))


def test_mechanism_frequency_matches_jax(toy_cohort):  # noqa: F811
    """The relative frequency of each deletion mechanism, on classified
    events (with the annotations that give TEI and VNTR calls) and on no
    event at all."""
    contigs, _, _ = toy_cohort
    events = [mechanism.EventRow(*e) for e in _events()]
    classified = mechanism.classify_events(
        events * 3, contigs, "cpu", tei={"gB_1": [(690, 710)]},
        tandem={"gA_1": [(4990, 5010)]}, ins_lens=[0, 3, 12, 0] * 3)
    got = mechanism.mechanism_frequency(classified)
    assert len(got) > 1
    assert got == jax_mechanism.mechanism_frequency(classified)
    assert mechanism.mechanism_frequency([]) == \
        jax_mechanism.mechanism_frequency([]) == {}


def test_event_and_bed_readers_match_jax(tmp_path):
    ev = tmp_path / "events.csv"
    ev.write_text("sample,receptor,insert_locus,donor,delete_start,"
                  "delete_end,reverse_flag\n"
                  + "".join(",".join(map(str, e)) + "\n" for e in _events()))
    got = [dataclasses.astuple(e) for e in mechanism.read_events(str(ev))]
    assert got == [dataclasses.astuple(e)
                   for e in jax_mechanism.read_events(str(ev))]
    bed = tmp_path / "tei.bed"
    bed.write_text("gA_1 10 20\ngA_1 30 40 x\ngB_1 5 9\nshort 1\n")
    assert (mechanism.read_interval_bed(str(bed))
            == jax_mechanism.read_interval_bed(str(bed)))


# ---------- classifier and LODO ----------


def _marker_samples():
    """tests/test_analysis.py::test_marker_selection_and_training's
    samples."""
    rng = np.random.default_rng(0)
    samples = []
    for i in range(30):
        gi = i % 2
        s = records.SampleBkps(f"x{i}")
        s.disease = "CRC" if gi == 0 else "control"
        pos = 100 if gi == 0 else 900
        npos = int(rng.integers(0, 50))
        s.bkps.append(records.BkpRecord(
            "gA_1", pos, "right", "+", "gB_1", pos + npos % 20, "left", "+",
            "False", 0.9, 1, 1, 5, 1,
        ))
        samples.append(s)
    return samples


def test_train_logreg_matches_optax():
    rng = np.random.default_rng(1)
    for n, d in ((40, 5), (120, 20)):
        X = (rng.random((n, d)) < 0.4).astype(np.float32)
        y = (X[:, 0] + 0.8 * rng.random(n) > 0.9).astype(np.int32)
        score, p = classifier.train_logreg(X, y, "cpu")
        jscore, jp = jax_classifier.train_logreg_tpu(X, y)
        np.testing.assert_allclose(p["w"], jp["w"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(p["b"], jp["b"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(score(X), jscore(X), rtol=0, atol=1e-4)


def test_train_and_eval_matches_jax():
    samples = _marker_samples()
    got = classifier.train_and_eval(samples, "CRC", "control", "cpu")
    want = jax_classifier.train_and_eval(samples, "CRC", "control")
    assert got == want
    assert got["auc"] > 0.9


def test_lodo_matches_jax():
    samples = _cohort_samples()
    got = cohort.lodo(samples, "CRC", "control", "cpu", marker_num=5)
    want = jax_cohort.lodo(samples, "CRC", "control", marker_num=5)
    assert got == want
    assert got["weighted_mean"] > 0.9
    with pytest.raises(ValueError):
        cohort.lodo([s for s in samples if s.cohort == "cohortA"], "CRC",
                    "control", "cpu")


# ---------- every `analyze` analysis through the CLI ----------


def _write_acc(path, rows):
    with open(path, "w") as f:
        print("# the number of reads in the sample is: 100000; "
              "Insert size is 300.", file=f)
        print(",".join(formats.HEADER), file=f)
        for r in rows:
            print(",".join(str(x) for x in r), file=f)


@pytest.fixture(scope="module")
def cli_inputs(toy_cohort, tmp_path_factory):  # noqa: F811
    """A 40-sample, two-cohort folder of acc.csv files with one
    group-specific junction each (a few samples carry the other group's)
    beside 12 random ones between 16 genomes, its phenotype CSV, and the
    side files of kegg, timeline, mechanism, transfer_gene and
    phenotype_table."""
    _, toy_dir, ref = toy_cohort
    td = tmp_path_factory.mktemp("cli_inputs")
    sdir = td / "signal"
    sdir.mkdir()
    rng = np.random.default_rng(11)
    pheno = ["sample,cohort,disease,full"]
    for i in range(40):
        crc = i % 2 == 0
        if i % 9 == 0:
            crc = not crc  # carries the other group's junction
        pos = 150 if crc else 850
        rows = [["gA_1", pos + int(rng.integers(0, 40)), "right", "+",
                 "gB_1", pos + 800, "left", "+", "False", "", "", "0.9",
                 4, 5, 6, 7]]
        for e in rng.choice(64, 12, replace=False):  # network edges
            rows.append([f"gN{e // 8}_1", 500, "right", "+", f"gM{e % 8}_1",
                         900, "left", "-", "True", "", "", "0.9", 4, 5, 6,
                         7])
        _write_acc(sdir / f"s{i}.acc.csv", rows)
        group = "CRC" if i % 2 == 0 else "control"
        pheno.append(f"s{i},{'cA' if i < 20 else 'cB'},{group},"
                     f"{'CRC' if group == 'CRC' else 'healthy'}")
    (td / "pheno.csv").write_text("\n".join(pheno) + "\n")
    (td / "individuals.csv").write_text(
        "sample,individual\n" + "".join(f"s{i},I{i % 5}\n"
                                        for i in range(40)))
    (td / "events.csv").write_text(
        "sample,receptor,insert_locus,donor,delete_start,delete_end,"
        "reverse_flag\n"
        + "".join(",".join(map(str, e)) + "\n" for e in _events()))
    (td / "tei.bed").write_text("gB_1 690 710\n")
    (td / "tandem.bed").write_text("gA_1 4990 5010\n")
    (td / "genes.gff").write_text(
        "gB_1\tsrc\tCDS\t720\t900\t.\t+\t0\tID=g1;product=IS3 transposase\n"
        "gA_1\tsrc\tCDS\t5100\t5600\t.\t+\t0\t"
        "ID=g2;product=tetracycline resistance protein\n")
    ko_pathway = {f"K{i:05d}": "map00010" for i in range(10)}
    ko_pathway.update({f"K1{i:04d}": "map99999,ko99999" for i in range(50)})
    (td / "ko_pathway.tsv").write_text(
        "".join(f"{k}\t{v}\n" for k, v in ko_pathway.items()))
    (td / "kos.txt").write_text(
        "".join(f"K{i:05d}\n" for i in range(10)) + "K10000\n")
    (td / "bg.txt").write_text("".join(f"{k}\n" for k in ko_pathway))
    (td / "meta.csv").write_text(
        "sample,cohort,disease,full_disease,run,age,gender,bmi\n"
        "p1,co1,CRC,CRC,SRR001,61,male,24.2\n"
        "p2,co1,control,healthy,SRR002,55,female,22.9\n")
    return {"toy": toy_dir, "ref": ref, "dir": str(sdir), "td": td}


def _analyze_args(what, d):
    td = d["td"]
    pheno = ["--pheno", str(td / "pheno.csv")]
    return {
        "stats": ["-b", d["toy"], "-r", d["ref"]],
        "microhomology": ["-b", d["toy"], "-r", d["ref"], "--n-random", "24"],
        "mechanism": ["-r", d["ref"], "-e", str(td / "events.csv"),
                      "--tei", str(td / "tei.bed"),
                      "--tandem", str(td / "tandem.bed")],
        "network": ["-b", d["dir"], *pheno, "--level", "phylum"],
        "classifier": ["-b", d["dir"], *pheno, "--markers", "5"],
        "lodo": ["-b", d["dir"], *pheno, "--markers", "5"],
        "kegg": ["--kos", str(td / "kos.txt"),
                 "--background-kos", str(td / "bg.txt"),
                 "--ko-pathway", str(td / "ko_pathway.tsv")],
        "timeline": ["-b", d["dir"],
                     "--individuals", str(td / "individuals.csv")],
        "transfer_gene": ["-e", str(td / "events.csv"),
                          "--gff", str(td / "genes.gff")],
        "association": ["-b", d["dir"], *pheno],
        "phenotype_table": ["--meta-csv", str(td / "meta.csv")],
    }[what]


WHATS = ["stats", "microhomology", "mechanism", "network", "classifier",
         "lodo", "kegg", "timeline", "transfer_gene", "association",
         "phenotype_table"]


def test_every_analysis_is_listed():
    sub = jax_cli.build_parser()._subparsers._group_actions[0]
    what = sub.choices["analyze"]._actions[1]
    assert sorted(what.choices) == sorted(WHATS)


@pytest.mark.parametrize("what", WHATS)
def test_analyze_cli_matches_jax(cli_inputs, tmp_path, what):
    args = ["analyze", what, *_analyze_args(what, cli_inputs)]
    outs = []
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("torch", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.out")
        assert main(args + ["-f", out] + extra) == 0, name
        with open(out, "rb") as f:
            outs.append(f.read())
    assert len(outs[0]) > 20
    assert outs[1] == outs[0]
    if what in ("classifier", "lodo"):
        assert b'"n_markers": 0' not in outs[1]
    if what == "network":
        assert b'"n1": 0' not in outs[1]
