"""The port never imports jax, directly or through anything it imports:
the machine with the card has no jax, networkx or scikit-learn."""

import os
import pkgutil
import subprocess
import sys

import pytest

import localhgt_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(localhgt_tpu_torch.__path__,
                                              "localhgt_tpu_torch."))


def test_every_port_module_is_listed():
    mods = _port_modules()
    for name in ("localhgt_tpu_torch.cli", "localhgt_tpu_torch.ops.cuda_sw",
                 "localhgt_tpu_torch.ops.cuda_vote",
                 "localhgt_tpu_torch.pipeline.bkp",
                 "localhgt_tpu_torch.io.qc", "localhgt_tpu_torch.ops.nw",
                 "localhgt_tpu_torch.analysis.microhomology",
                 "localhgt_tpu_torch.analysis.mechanism",
                 "localhgt_tpu_torch.analysis.classifier",
                 "localhgt_tpu_torch.analysis.cohort",
                 "localhgt_tpu_torch.tools.validate_events",
                 "localhgt_tpu_torch.tools.kmer_stats"):
        assert name in mods


@pytest.mark.parametrize("entry", ["cli", "all"])
def test_port_imports_no_jax_networkx_sklearn(entry):
    mods = (["localhgt_tpu_torch.cli"] if entry == "cli"
            else _port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'networkx', 'sklearn') if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
