"""The port's loss table (localhgt_tpu_torch/tools/loss_table.py) against
the JAX tool's (tools/loss_table.py) on a small simulated fixture at
k=18 on the CPU: the summary and every per-breakpoint record equal.

The JAX tool reads its fixture from a fixed directory and writes
`reports/loss_table_<scale>.json` beside its own parent directory, so it
runs from a copy under tmp_path whose fixture directory names tmp_path:
nothing in the repository is written."""

import importlib.util
import json
import os
import sys

import pytest
import torch

from localhgt_tpu_torch.config import Config, KmerConfig
from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample
from localhgt_tpu_torch.tools import loss_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = "tiny"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(tmp_path, monkeypatch, fx: str):
    """tools/loss_table.py, copied under tmp_path with its fixture
    directory pointed at `fx`; returns its record."""
    src = open(os.path.join(REPO, "tools", "loss_table.py")).read()
    fixed = 'fx = "/tmp/lht_bench"'
    assert src.count(fixed) == 1
    tools = tmp_path / "jax" / "tools"
    tools.mkdir(parents=True)
    (tools / "loss_table.py").write_text(src.replace(fixed, f"fx = {fx!r}"))
    monkeypatch.setattr(sys, "path", list(sys.path))  # it prepends its root
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    monkeypatch.setenv("LHT_BENCH_SCALE", SCALE)
    monkeypatch.setenv("LHT_BENCH_K", "18")
    spec = importlib.util.spec_from_file_location(
        "jax_loss_table_copy", tools / "loss_table.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    out = tmp_path / "jax" / "reports" / f"loss_table_{SCALE}.json"
    return json.loads(out.read_text())


def test_loss_table_matches_jax_tool(tmp_path, monkeypatch):
    fx = str(tmp_path / "fx")
    pa = SimParams(n_genomes=6, genome_len=30_000, hgt_num=3, depth=8,
                   snp_rate=0.01, seed=33)
    paths = simulate_sample(fx, f"bench_{SCALE}", pa)
    # the port first: the JAX tool's outdir run_<scale> lands in fx too
    got = loss_table.loss_table(*paths, Config().replace(
        kmer=KmerConfig(k=18)), "cpu", scale=SCALE)
    want = _jax_tool(tmp_path, monkeypatch, fx)
    assert got["summary"] == want["summary"]
    assert got["bkps"] == want["bkps"]
    s = got["summary"]
    assert s["n_truth_bkps"] == 6 and s["extracted"] > 0 and s["final"] > 0
    assert len(got["bkps"]) == s["n_truth_bkps"]


def test_loss_table_cli_writes_its_out(tmp_path):
    """main() on explicit paths runs on the asked device and writes the
    record to --out."""
    ref, fq1, fq2, truth = simulate_sample(str(tmp_path), "c", SimParams(
        n_genomes=3, genome_len=20_000, hgt_num=1, depth=5, snp_rate=0.01,
        seed=4))
    out = str(tmp_path / "loss.json")
    assert loss_table.main(["--ref", ref, "--fq1", fq1, "--fq2", fq2,
                            "--truth", truth, "-k", "18", "--out", out,
                            "--device", "cpu"]) == 0
    with open(out) as f:
        rec = json.load(f)
    assert rec["summary"]["scale"] is None and rec["summary"]["k"] == 18
    assert rec["summary"]["n_truth_bkps"] == len(rec["bkps"]) == 2
    with pytest.raises(SystemExit):  # neither --scale nor every path
        loss_table.main(["--ref", ref, "--out", out, "--device", "cpu"])
