"""The import guard: the run's check compares whole top-level names, and
the reference's modules load neither JAX, the JAX package nor the port."""

import subprocess
import sys

from hgtbench import run

REFERENCE_MODULES = [
    "hgtbench.plainref.pipeline.bkp", "hgtbench.check", "hgtbench.score",
    "hgtbench.sim", "hgtbench.trace", "hgtbench.roofline",
    "hgtbench.cohort", "hgtbench.control", "hgtbench.plainref.io.qc"]


def test_reference_modules_load_nothing_forbidden():
    code = ("import importlib, sys\n"
            f"for m in {REFERENCE_MODULES!r}: importlib.import_module(m)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "localhgt_tpu",
                       "localhgt_tpu_torch"}, tops


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "localhgt_tpu_torch_fake", sys)
    monkeypatch.delitem(sys.modules, "localhgt_tpu", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert "localhgt_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "localhgt_tpu.ops", sys)
    assert "localhgt_tpu" in run.forbidden_modules()
