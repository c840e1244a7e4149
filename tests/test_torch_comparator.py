"""The port's comparator tools (localhgt_tpu_torch/tools/comparator_run.py
and comparator_grid.py) against the JAX tools (tools/comparator_run.py,
loaded by path) on a small simulated fixture at k=18 on the CPU: the same
recall, FDR, F1 and number of calls in the k-mer row and the direct-mode
row, the reference engine reported as skipped, and nothing written outside
the work directory."""

import ast
import csv
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from localhgt_tpu_torch.sim.simulate import SimParams
from localhgt_tpu_torch.tools import comparator_grid, comparator_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_genomes=4, genome_len=20_000, hgt_num=2, depth=5,
            snp_rate=0.01, seed=42)
K = 18
SCORES = ("recall", "fdr", "f1", "n_called")
ROWS = {"localhgt_tpu_torch": "localhgt_tpu",
        "localhgt_tpu_torch_direct": "localhgt_tpu_direct"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _repo_state():
    return subprocess.run(
        ["git", "status", "--porcelain", "--untracked-files=all"], cwd=REPO,
        capture_output=True, text=True, check=True).stdout


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    before = _repo_state()
    work = tmp_path_factory.mktemp("cmp_port")
    out = comparator_run.run(str(work), K, pa=SimParams(**TINY),
                             device="cpu")
    assert _repo_state() == before
    return work, out


def test_comparator_rows_match_jax_tool(port_run, tmp_path, monkeypatch):
    from localhgt_tpu.sim.simulate import SimParams as JaxSimParams

    monkeypatch.setattr(sys, "path", list(sys.path))  # it prepends the repo
    spec = importlib.util.spec_from_file_location(
        "jax_comparator_run", os.path.join(REPO, "tools",
                                           "comparator_run.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    want = jax_tool.run(str(tmp_path), K, pa=JaxSimParams(**TINY))
    _, got = port_run
    for port_name, jax_name in ROWS.items():
        g, w = got["rows"][port_name], want["rows"][jax_name]
        assert {s: g[s] for s in SCORES} == {s: w[s] for s in SCORES}, \
            port_name
    assert got["rows"]["localhgt_tpu_torch"]["recall"] > 0
    assert got["rows"]["reference_extract_ref"] == \
        want["rows"]["reference_extract_ref"] == {"skipped": "no g++/source"}


def test_comparator_csv_in_the_work_directory(port_run):
    work, out = port_run
    with open(work / "comparator.csv") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == comparator_run.COLUMNS
    assert [r["tool"] for r in rows] == list(out["rows"])
    for r in rows[:2]:
        want = out["rows"][r["tool"]]
        assert [r[s] for s in SCORES] == [str(want[s]) for s in SCORES]
    # on the CPU the wrappers run their plain versions: no kernel launches
    direct = out["rows"]["localhgt_tpu_torch_direct"]["launches"]
    assert direct == {"sw_align": 0, "sw_score": 0, "vote_state": 0,
                      "seed_prefilter": 0, "k1_shapes": []}
    json.dumps(out)


def _jax_grid():
    """GRID of tools/comparator_grid.py, read without importing it (the
    tool sets a JAX cache directory when imported)."""
    tree = ast.parse(open(os.path.join(REPO, "tools",
                                       "comparator_grid.py")).read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and n.targets[0].id == "GRID")
    return eval(compile(ast.Expression(node.value), "GRID", "eval"),
                {"dict": dict})


def test_grid_scenarios_match_jax_tool_and_stay_in_the_work_directory(
        tmp_path):
    assert comparator_grid.GRID == _jax_grid()
    before = _repo_state()
    grid = [("snp0.01_depth4_n2", dict(snp_rate=0.01, depth=4, n_genomes=2,
                                        genome_len=12_000, hgt_num=1))]
    res = comparator_grid.run(str(tmp_path), K, device="cpu", grid=grid)
    assert _repo_state() == before
    assert [r["scenario"] for r in res] == ["snp0.01_depth4_n2"]
    with open(tmp_path / "comparator_grid.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["tool"] for r in rows] == list(res[0]["rows"])
    assert rows[0]["scenario"] == "snp0.01_depth4_n2"
    assert json.load(open(tmp_path / "comparator_grid.json")) == \
        json.loads(json.dumps(res))
