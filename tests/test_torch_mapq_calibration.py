"""The port's mapq calibration (localhgt_tpu_torch/tools/
mapq_calibration.py) against the JAX tool's (tools/mapq_calibration.py,
loaded by path) on the CPU: the same fixture, the same report, key for
key."""

import importlib.util
import os
import sys

import pytest
import torch

from localhgt_tpu_torch.tools import mapq_calibration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mapq_report_matches_jax_tool(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))  # it prepends the repo
    spec = importlib.util.spec_from_file_location(
        "jax_mapq_calibration", os.path.join(REPO, "tools",
                                             "mapq_calibration.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    want = jax_tool.run(str(tmp_path / "jax"))
    got = mapq_calibration.run(str(tmp_path / "torch"), "cpu")
    assert got == want
    assert got["n_unique"] > 1000 and got["n_repeat"] > 0
    assert got["unique_pass_rate"] > 0.99 and got["repeat_pass_rate"] < 0.05
