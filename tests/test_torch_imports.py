"""The port never imports jax, directly or through anything it imports:
the machine with the card has no jax, networkx or scikit-learn. Nor does it
import anything of the JAX package `localhgt_tpu`: it keeps its own copy of
every host module it uses, and `chip_smoke.py` runs without that package."""

import glob
import os
import pkgutil
import re
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
                 "localhgt_tpu_torch.tools.kmer_stats",
                 "localhgt_tpu_torch.config", "localhgt_tpu_torch.io.native",
                 "localhgt_tpu_torch.index.reference",
                 "localhgt_tpu_torch.pipeline.rawbkp",
                 "localhgt_tpu_torch.pipeline.event",
                 "localhgt_tpu_torch.sim.simulate",
                 "localhgt_tpu_torch.analysis.association"):
        assert name in mods


@pytest.mark.parametrize("entry", ["cli", "all"])
def test_port_imports_no_jax_networkx_sklearn(entry):
    mods = (["localhgt_tpu_torch.cli"] if entry == "cli"
            else _port_modules() + ["chip_smoke"])
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'networkx', 'sklearn',\n"
        "                              'localhgt_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# Raises on any import of the JAX package, then runs the port's simulator,
# `bkp` and `event` on the golden fixture of tests/test_golden.py (k=18).
BLOCKED_RUN = """
import importlib.abc, os, sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("localhgt_tpu", "jax"):
            raise ImportError(f"{name} is blocked in this run")
        return None


sys.meta_path.insert(0, Block())
import torch

torch.set_num_threads(1)
from localhgt_tpu_torch import cli
from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample

out = sys.argv[1]
pa = SimParams(n_genomes=6, genome_len=30_000, hgt_num=3, depth=8,
               snp_rate=0.01, seed=33)
ref, fq1, fq2, _ = simulate_sample(out, "gold", pa)
assert cli.main(["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2, "-s", "gold",
                 "-o", out, "-k", "18", "--device", "cpu"]) == 0
assert cli.main(["event", "-r", ref, "-b", out, "-f",
                 os.path.join(out, "gold.events.csv"), "-m", "200"]) == 0
"""


def test_cli_bkp_reproduces_golden_with_jax_package_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    gold = os.path.join(ROOT, "tests", "golden")
    for name in ("gold.acc.csv", "gold.events.csv"):
        with open(tmp_path / name, "rb") as f, \
                open(os.path.join(gold, name), "rb") as g:
            assert f.read() == g.read(), name


def test_no_source_line_imports_the_jax_package():
    files = glob.glob(os.path.join(ROOT, "localhgt_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 40
    pat = re.compile(r"^\s*(import|from)\s+localhgt_tpu(\.|\s|$)", re.M)
    bad = []
    for path in files:
        with open(path) as f:
            if pat.search(f.read()):
                bad.append(os.path.relpath(path, ROOT))
    assert not bad
