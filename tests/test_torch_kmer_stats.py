"""Port parity of tools/kmer_stats.py: the count-table occupancy rows of
the port (plain int8 tables, counted by the port's count step) equal the
JAX tool's rows exactly, on a small simulated sample."""

import pytest

from localhgt_tpu.sim.simulate import SimParams, simulate_sample
from localhgt_tpu.tools import kmer_stats as jax_kmer_stats
from localhgt_tpu_torch.tools import kmer_stats


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("kmer_stats"))
    pa = SimParams(n_genomes=3, genome_len=20_000, hgt_num=1, depth=4,
                   seed=5)
    _, fq1, fq2, _ = simulate_sample(out, "ks", pa)
    return fq1, fq2


@pytest.mark.parametrize("k", [16, 18, 20])
def test_table_stats_rows_match_jax(sample, k):
    fq1, fq2 = sample
    ratio = 0.5 if k == 18 else 1.0
    want = jax_kmer_stats.table_stats(fq1, fq2, k, ratio=ratio)
    got = kmer_stats.table_stats(fq1, fq2, k, "cpu", ratio=ratio)
    assert got == want
    assert 0 < got[0]["empty_rate"] < 1


def test_main_prints_one_row_per_hash(sample, capsys):
    fq1, _ = sample
    kmer_stats.main(["--fq1", fq1, "--kmin", "16", "--kmax", "16",
                     "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and '"k": 16' in lines[0]
