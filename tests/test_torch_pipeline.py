"""Port parity end to end on the CPU: the port's `bkp` and `event`, driven
through its CLI, reproduce the frozen golden outputs byte for byte
(tests/test_golden.py fixture, k=18), and direct mode (use_kmer=0,
tests/test_direct_mode.py fixture) writes the same acc.csv as the JAX
package."""

import os

import pytest
import torch

from localhgt_tpu.config import Config, KmerConfig
from localhgt_tpu.sim.simulate import SimParams, simulate_sample
from localhgt_tpu_torch import cli

GOLD = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The CPU runs are many small torch ops: with one intra-op thread
    they take a third of the CPU time that idle-spinning thread pools
    take when test files share the cores in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_golden"))
    pa = SimParams(n_genomes=6, genome_len=30_000, hgt_num=3, depth=8,
                   snp_rate=0.01, seed=33)
    ref, fq1, fq2, _ = simulate_sample(out, "gold", pa)
    assert cli.main(["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2,
                     "-s", "gold", "-o", out, "-k", "18",
                     "--device", "cpu"]) == 0
    ev = os.path.join(out, "gold.events.csv")
    assert cli.main(["event", "-r", ref, "-b", out, "-f", ev,
                     "-m", "200"]) == 0
    return os.path.join(out, "gold.acc.csv"), ev


def test_port_bkp_matches_golden_acc_csv(golden_run):
    acc, _ = golden_run
    assert _bytes(acc) == _bytes(os.path.join(GOLD, "gold.acc.csv"))


def test_port_event_matches_golden_events_csv(golden_run):
    _, ev = golden_run
    assert _bytes(ev) == _bytes(os.path.join(GOLD, "gold.events.csv"))


def test_port_direct_mode_matches_jax(tmp_path):
    from localhgt_tpu.pipeline.bkp import detect_breakpoint as jax_bkp
    from localhgt_tpu_torch.pipeline.bkp import detect_breakpoint

    pa = SimParams(n_genomes=4, genome_len=30_000, hgt_num=1, depth=8,
                   seed=7)
    ref, fq1, fq2, _ = simulate_sample(str(tmp_path), "d1", pa)
    cfg = Config().replace(kmer=KmerConfig(k=20))
    outs = []
    for name, run in (("jax", lambda o: jax_bkp(
            ref, fq1, fq2, "d1", o, cfg=cfg, use_kmer=False, mesh=None)),
            ("torch", lambda o: detect_breakpoint(
                ref, fq1, fq2, "d1", o, "cpu", cfg=cfg, use_kmer=False))):
        o = str(tmp_path / name)
        os.makedirs(o)
        outs.append(_bytes(run(o)))
    assert outs[0].count(b"\n") > 1  # the fixture calls breakpoints
    assert outs[1] == outs[0]


def test_unported_options_raise(tmp_path):
    """No option of `bkp` is left unported: --multi_chip on, the last one
    that raised, now gets as far as the JAX CLI does on missing inputs
    (exit 2; tests/test_torch_sharded.py runs it on real ones). `analyze`
    runs and writes the JAX CLI's JSON."""
    from localhgt_tpu import cli as jax_cli

    args = ["bkp", "-r", "x.fa", "--fq1", "a.fq", "--fq2", "b.fq",
            "-o", str(tmp_path), "--multi_chip", "on"]
    assert cli.main(args + ["--device", "cpu"]) == jax_cli.main(args) == 2
    acc = tmp_path / "gold.acc.csv"
    acc.write_bytes(_bytes(os.path.join(GOLD, "gold.acc.csv")))
    outs = []
    for name, main in (("jax", jax_cli.main), ("torch", cli.main)):
        out = tmp_path / f"{name}.json"
        assert main(["analyze", "stats", "-b", str(tmp_path),
                     "-f", str(out)]) == 0
        outs.append(out.read_bytes())
    assert b'"n_samples": 1' in outs[1]
    assert outs[1] == outs[0]
