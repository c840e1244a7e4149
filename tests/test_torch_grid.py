"""Port parity of the scenario sweep (`sim/grid.py`) on the CPU: the same
grid through both packages' `run_grid` gives the same accuracy rows."""

import pytest
import torch

from localhgt_tpu.config import Config as JaxConfig
from localhgt_tpu.config import KmerConfig as JaxKmerConfig
from localhgt_tpu.sim import grid as jax_grid
from localhgt_tpu_torch.config import Config, KmerConfig
from localhgt_tpu_torch.sim import grid

K = 18


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread beside the other test
    processes (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_grid_quick_rows_equal_jax(tmp_path, monkeypatch):
    """run_grid(..., "quick") on a cut-down SimParams: the accuracy
    columns of both packages' rows and CSV headers agree."""
    small = dict(n_genomes=3, genome_len=12_000, hgt_num=1, depth=5)

    def cut(mod):
        orig = mod.SimParams
        monkeypatch.setattr(
            mod, "SimParams",
            lambda **kw: orig(**{**kw, **small}))

    cut(grid)
    cut(jax_grid)
    rows = grid.run_grid(str(tmp_path / "t"), "quick", "cpu",
                         Config().replace(kmer=KmerConfig(k=K)))
    jrows = jax_grid.run_grid(
        str(tmp_path / "j"), "quick",
        JaxConfig().replace(kmer=JaxKmerConfig(k=K)))
    assert len(rows) == len(jrows) == 2
    keys = ("sample", "snp_rate", "recall", "fdr", "f1", "n_called")
    for row, jrow in zip(rows, jrows):
        assert {k: row[k] for k in keys} == {k: jrow[k] for k in keys}
        assert list(row) == list(jrow)   # device memory: no key on the CPU
    assert sum(r["n_called"] for r in rows) > 0
    assert _bytes(tmp_path / "t" / "quick0.acc.csv") == _bytes(
        tmp_path / "j" / "quick0.acc.csv")
    with open(tmp_path / "t" / "grid_quick.csv") as f:
        assert f.readline().strip().split(",")[:7] == [
            "sample", "snp_rate", "recall", "fdr", "f1", "n_called",
            "wall_s"]
