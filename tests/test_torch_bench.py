"""The port's bench (localhgt_tpu_torch.bench) on the CPU: its record has
the keys of the JAX bench's record (bench.py:243-274) plus `card`, its
accuracy numbers are evaluate.score_bkps of the acc.csv it wrote, and no
device metric is written from a CPU run; a held lock and another process
on the card each fail with the error JSON."""

import ast
import fcntl
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from localhgt_tpu.sim import evaluate as jax_evaluate
from localhgt_tpu.sim.simulate import read_truth as jax_read_truth
from localhgt_tpu.utils import formats as jax_formats
from localhgt_tpu_torch import bench
from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample

JAX_BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench.py")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_record_keys() -> set:
    """Keys the JAX bench's main() puts into `rec` by name: its dict
    literal and its `rec[...] = ` assignments."""
    tree = ast.parse(open(JAX_BENCH).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if (isinstance(tgt, ast.Name) and tgt.id == "rec"
                    and isinstance(node.value, ast.Dict)):
                keys |= {k.value for k in node.value.keys}
            if (isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "rec"):
                keys.add(tgt.slice.value)
    return keys


def test_jax_record_keys_are_read_from_bench_py():
    assert _jax_record_keys() == {
        "metric", "value", "unit", "vs_baseline", "vs_baseline_cold",
        "wall_s", "wall_cold_s", "sim_wall_s", "n_pairs", "recall", "fdr",
        "f1", "k", "scale", "platform", "two_pass", "stage_walls",
        "stage_rss_gb", "batch_series", "counters", "trace_dir"}


@pytest.mark.parametrize("profiled", [False, True], ids=["plain", "profile"])
def test_bench_record_on_the_cpu(tmp_path, profiled):
    ref, fq1, fq2, truth = simulate_sample(str(tmp_path), "tiny", SimParams(
        n_genomes=4, genome_len=20_000, hgt_num=2, depth=5, snp_rate=0.01,
        seed=5))
    out = str(tmp_path / "run_tiny")
    os.makedirs(out)
    trace = str(tmp_path / "trace") if profiled else None
    rec = bench.run(ref, fq1, fq2, truth, "tiny", out, 18, "cpu",
                    two_pass=not profiled, trace_dir=trace, sim_wall=1.25)

    # the JAX record's keys; on the CPU no hbm_* and no device count step
    want = _jax_record_keys() - ({"trace_dir"} if not profiled else set())
    want |= set(jax_evaluate.resource_usage())
    want |= {"count_scatter_gbps_stage", "sw_gcups_stage", "sw_gcups_kernel",
             "card"}
    assert set(rec) == want
    assert rec["card"] is None and rec["platform"] == "cpu"
    assert rec["two_pass"] is (not profiled) and rec["scale"] == "tiny"
    assert rec["k"] == 18 and rec["sim_wall_s"] == 1.2
    with open(fq1) as f:
        assert rec["n_pairs"] == sum(1 for _ in f) // 4
    assert set(rec["stage_walls"]) == {"count", "scan", "peakset", "vote",
                                       "align", "rawbkp", "accbkp"}
    series = rec["batch_series"]
    assert "count_step_device_s" not in series
    assert series["count_batch_dispatch_s"]["n"] == \
        rec["counters"]["count_batches"]
    json.dumps(rec)

    rows, _, _ = jax_formats.read_acc_csv(os.path.join(out,
                                                       "bench_tiny.acc.csv"))
    called = [(r["from_ref"], int(r["from_pos"]), r["to_ref"],
               int(r["to_pos"])) for r in rows]
    score = jax_evaluate.score_bkps(
        jax_evaluate.truth_to_bkps(jax_read_truth(truth)), called)
    assert called and score.recall > 0
    assert (rec["recall"], rec["fdr"], rec["f1"]) == (
        score.recall, score.fdr, score.f1)
    if profiled:
        assert rec["trace_dir"] == trace
        with open(os.path.join(trace, "trace.json")) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert set(rec["stage_walls"]) <= names  # a span per stage


def test_bench_record_in_direct_mode_on_the_cpu(tmp_path):
    """--use_kmer 0: no k-mer stage runs, the record says so and lists K1's
    launch shapes (none on the CPU: the plain version runs), and the
    calls score as the JAX package's direct mode on the same fixture."""
    from localhgt_tpu.config import Config as JaxConfig
    from localhgt_tpu.config import KmerConfig as JaxKmerConfig
    from localhgt_tpu.pipeline.bkp import detect_breakpoint

    ref, fq1, fq2, truth = simulate_sample(str(tmp_path), "tiny", SimParams(
        n_genomes=3, genome_len=15_000, hgt_num=2, depth=5, snp_rate=0.01,
        seed=5))
    out = str(tmp_path / "run_tiny_direct")
    os.makedirs(out)
    rec = bench.run(ref, fq1, fq2, truth, "tiny", out, 18, "cpu",
                    two_pass=False, use_kmer=False)
    assert rec["use_kmer"] == 0 and rec["k1_launch_shapes"] == []
    assert set(rec["stage_walls"]) == {"align", "rawbkp", "accbkp"}
    acc = detect_breakpoint(ref, fq1, fq2, "jax", str(tmp_path), cfg=(
        JaxConfig().replace(kmer=JaxKmerConfig(k=18))), use_kmer=False)
    rows, _, _ = jax_formats.read_acc_csv(acc)
    called = [(r["from_ref"], int(r["from_pos"]), r["to_ref"],
               int(r["to_pos"])) for r in rows]
    score = jax_evaluate.score_bkps(
        jax_evaluate.truth_to_bkps(jax_read_truth(truth)), called)
    assert score.recall > 0
    assert (rec["recall"], rec["fdr"], rec["f1"]) == (
        score.recall, score.fdr, score.f1)


def test_second_lock_holder_fails_with_the_error_json(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setattr(bench, "FIXTURE_DIR", str(tmp_path))
    fd = os.open(str(tmp_path / bench.LOCK_NAME), os.O_CREAT | os.O_RDWR)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        os.write(fd, b"4242\n")
        with pytest.raises(SystemExit) as e:
            bench.main(["--scale", "species20", "--device", "cpu",
                        "--lock-timeout", "0.3"])
    finally:
        os.close(fd)
    assert e.value.code == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["error"] == "another bench holds the lock"
    assert rec["lock_holder_pid"] == "4242"
    assert rec["value"] == 0.0 and rec["metric"] == "bkp_pairs_per_sec"
    assert not os.path.exists(tmp_path / "run_species20")


def test_preflight_counts_out_self_and_ancestors(tmp_path, monkeypatch,
                                                 capsys):
    """nvidia-smi's rows other than this process and its ancestors, and
    another bench found in /proc, are contenders. Other processes of this
    machine may be reported too, so only these pids are asserted."""
    me, parent = os.getpid(), os.getppid()
    stranger = max(int(p) for p in os.listdir("/proc") if p.isdigit()) + 7
    # pid 1 is every process's ancestor: nvidia-smi in a PID namespace
    # can list this very process as the namespace's init
    apps = (f"{me}, python\n{parent}, pytest\n1, /process_api\n"
            f"{stranger}, /usr/bin/python3\n")
    other = subprocess.Popen([sys.executable, "-c", "import time; "
                              "time.sleep(60)", "localhgt_tpu_torch.bench"])
    try:
        for _ in range(100):  # until its cmdline is readable
            with open(f"/proc/{other.pid}/cmdline", "rb") as f:
                if b"localhgt_tpu_torch.bench" in f.read():
                    break
            time.sleep(0.05)
        found = {p["pid"]: p["cmd"] for p in
                 bench.other_card_processes(apps)}
    finally:
        other.kill()
        other.wait(timeout=10)
    assert found[stranger] == "/usr/bin/python3"
    assert "localhgt_tpu_torch.bench" in found[other.pid]
    assert not {me, parent, 1} & set(found)

    monkeypatch.setattr(bench, "FIXTURE_DIR", str(tmp_path))
    monkeypatch.setattr(bench, "_nvidia_smi", lambda query: apps)
    with pytest.raises(SystemExit) as e:
        bench.main(["--scale", "species20", "--device", "cpu"])
    assert e.value.code == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"pid": stranger, "cmd": "/usr/bin/python3"} in rec["contention"]
    assert "concurrent" in rec["error"]
    assert not os.path.exists(tmp_path / "run_species20")
