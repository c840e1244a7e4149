"""The port's A/B tool (localhgt_tpu_torch/tools/ab_reference.py) against
the JAX tool's (localhgt_tpu/tools/ab_reference.py) on the CPU: the
normalisation, the interval comparison and the truth loci on the same
inputs, the extraction side on a small simulated fixture, and the skipped
report where the reference engine's source is absent (it is not in the
repository)."""

import os

import pytest
import torch

from localhgt_tpu.config import Config, KmerConfig
from localhgt_tpu.tools import ab_reference as jax_ab
from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample
from localhgt_tpu_torch.tools import ab_reference

INTERVALS = [("c", 100, 130), ("c", 5, 300), ("c", 250, 400), ("d", 1, 20),
             ("d", -40, 90), ("e", 1000, 1049), ("e", 990, 1200),
             ("c", 401, 460), ("c", 500, 560)]
LENS = {"c": 450, "d": 500, "e": 5000}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    pa = SimParams(n_genomes=3, genome_len=15_000, hgt_num=2, depth=6,
                   snp_rate=0.01, seed=7)
    return simulate_sample(str(tmp_path_factory.mktemp("ab")), "ab", pa)


@pytest.mark.parametrize("lens", [LENS, None])
def test_normalize_matches_jax(lens):
    got = ab_reference._normalize(INTERVALS, lens)
    assert got == jax_ab._normalize(INTERVALS, lens)
    assert ab_reference._normalize(
        [("c", 100, 130), ("c", 5, 300), ("c", 250, 400), ("d", 1, 20)],
        {"c": 350, "d": 500}) == [("c", 5, 350)]


def test_compare_intervals_and_truth_loci_match_jax(fixture):
    _, _, _, truth = fixture
    loci = ab_reference.truth_loci_from_file(truth)
    assert loci == jax_ab.truth_loci_from_file(truth) and loci
    name = loci[0][0]
    ours = [(name, p - 80, p + 80) for n, p in loci if n == name]
    theirs = ab_reference._normalize(INTERVALS + ours[1:], LENS)
    for a, b in ((theirs, ours), (ours, theirs), ([], ours), ([], [])):
        assert ab_reference.compare_intervals(a, b, loci) == \
            jax_ab.compare_intervals(a, b, loci)


def test_run_extract_matches_jax_extraction(fixture):
    ref, fq1, fq2, _ = fixture
    cfg = Config().replace(kmer=KmerConfig(k=18, strict_sampling=True))
    got = ab_reference.run_extract(fq1, fq2, ref, cfg, "cpu")
    assert got
    assert got == jax_ab.run_tpu_extract(fq1, fq2, ref, cfg)


def test_run_ab_reports_skipped_without_the_source(tmp_path):
    """Neither tool finds the engine's source: both skip, alike, and
    simulate nothing."""
    assert not os.path.isfile(ab_reference.REFERENCE_SRC)
    want = jax_ab.run_ab(work_dir=str(tmp_path / "jax"))
    assert want == {"skipped": "reference source or g++ unavailable"}
    assert ab_reference.run_ab(str(tmp_path / "port"), device="cpu") == want
    assert ab_reference.run_ab(str(tmp_path / "port"), device="cpu",
                               src=str(tmp_path / "missing.cpp")) == want
    assert not (tmp_path / "port").exists()
