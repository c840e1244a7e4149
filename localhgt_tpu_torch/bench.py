"""Benchmark of the port: end-to-end `bkp` throughput on one CUDA card.

    python -m localhgt_tpu_torch.bench [--scale big|species20|scale1g]
        [-k 32] [--use_kmer 1|0] [--regen] [--lock-timeout 120] [--force]
        [--profile] [--device cuda] [--json PATH]

The counterpart of the JAX package's bench.py, at the same scales (the
same SimParams, seed 42): `big` (default) is 100 genomes x 1 Mbp, 50
HGTs, depth 5 (1,676,165 pairs); `species20` 20 x 150 kb (101,335
pairs); `scale1g` 205 x 5 Mbp, depth 3 (>= 1 Gbp, >= 10M pairs). `big`
and `species20` run `bkp` twice in one process: the first pass carries
the one-time costs (kernel builds and loads, the CUDA context, allocator
growth), the second is the headline `value`; both walls are reported
(`wall_s`, `wall_cold_s`). `scale1g` runs once. Each pass ends in a
device synchronize before its clock stops.

Prints ONE JSON line with the keys of the JAX bench's record (`metric`,
`value` in pairs/s, `vs_baseline` against the reference's ~1,805.6
pairs/s, stage walls, host RSS per stage, per-batch series, counters,
`hbm_peak_gb`/`hbm_in_use_gb` of the card, host CPU time and max RSS,
derived rates) plus `card`: the name and power limit nvidia-smi reads.
`--json PATH` also writes it there. Nothing is written in the repository.

Run hygiene, as in the JAX bench: fixtures are simulated once and cached
in `lht_bench_torch/` under the system's temporary directory; every
scale runs in its own `run_<scale>` directory with its own sample name;
an exclusive flock on `lht_bench_torch/.bench.lock` serializes benches
(a held lock fails after --lock-timeout seconds); a preflight fails
unless --force when another process uses the card (nvidia-smi's compute
apps other than this process and its ancestors) or another
`localhgt_tpu_torch.bench` runs. Both failures print an error JSON.

--profile runs the timed pass under torch.profiler (CPU and CUDA
activity); each pipeline stage is a span (utils/metrics.stage). The
Chrome trace goes to run_<scale>/trace/ and `trace_dir` into the JSON.

--use_kmer 0 runs `bkp` in direct mode (no k-mer stage: every read is
aligned against the whole reference) in run_<scale>_direct; its record
adds `use_kmer` (0) and `k1_launch_shapes`, the timed pass's launches of
kernel K1 as [B, M, N, launches] rows. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import fcntl
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

BASELINE_PAIRS_PER_SEC = 13_000_000 / (2 * 3600.0)
FIXTURE_DIR = os.path.join(tempfile.gettempdir(), "lht_bench_torch")
LOCK_NAME = ".bench.lock"
READ_LEN = 150  # the simulator's reads, the basis of metrics.derived

SCALES = {
    # name: (n_genomes, genome_len, hgt_num, depth, two-pass?)
    "species20": (20, 150_000, 10, 10, True),
    "big": (100, 1_000_000, 50, 5, True),
    "scale1g": (205, 5_000_000, 100, 3, False),
}


def _fail(reason: str, **extra):
    rec = {"metric": "bkp_pairs_per_sec", "value": 0.0, "unit": "pairs/s",
           "vs_baseline": 0.0, "error": reason}
    rec.update(extra)
    print(json.dumps(rec), flush=True)
    sys.exit(1)


def _ancestors(pid: int) -> set:
    """The chain of parents of `pid`, up to and including init (pid 1).
    In a PID namespace nvidia-smi may list every process on the card as
    the namespace's pid 1 (seen on the H100 machines this runs on), so
    there only the /proc scan below can find another bench."""
    out = {1}
    for _ in range(64):
        try:
            with open(f"/proc/{pid}/stat") as f:
                # the command may hold spaces: the parent follows the ")"
                pid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            break
        if pid <= 1:
            break
        out.add(pid)
    return out


def other_card_processes(apps_csv: str) -> list:
    """Processes other than this one and its ancestors that would share
    the card: the rows of `nvidia-smi --query-compute-apps=pid,
    process_name --format=csv,noheader` (given as `apps_csv`), and any
    other `localhgt_tpu_torch.bench` found in /proc."""
    me = os.getpid()
    mine = _ancestors(me) | {me}
    found = {}
    for line in apps_csv.splitlines():
        pid, _, name = line.partition(",")
        if pid.strip().isdigit() and int(pid) not in mine:
            found[int(pid)] = name.strip()[:160]
    for ent in os.listdir("/proc"):
        if not ent.isdigit() or int(ent) in mine:
            continue
        try:
            with open(f"/proc/{ent}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if "localhgt_tpu_torch.bench" in cmd:
            found[int(ent)] = cmd.strip()[:160]
    return [{"pid": p, "cmd": c} for p, c in sorted(found.items())]


def _nvidia_smi(query: str) -> str:
    """nvidia-smi's CSV answer to `query`; empty without nvidia-smi."""
    try:
        res = subprocess.run(["nvidia-smi", query, "--format=csv,noheader"],
                             capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return ""
    return res.stdout.strip()


def _card_line(device: torch.device) -> str | None:
    """Name and power limit of the card the numbers were taken on, as
    nvidia-smi gives them; None off the card."""
    if device.type != "cuda":
        return None
    lines = _nvidia_smi("--query-gpu=name,power.limit").splitlines()
    idx = device.index or 0
    return lines[idx] if idx < len(lines) else None


def _acquire_lock(fixture_dir: str, timeout_s: float) -> int:
    os.makedirs(fixture_dir, exist_ok=True)
    path = os.path.join(fixture_dir, LOCK_NAME)
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    deadline = time.time() + timeout_s
    while True:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            os.ftruncate(fd, 0)
            os.write(fd, f"{os.getpid()}\n".encode())
            return fd
        except BlockingIOError:
            left = deadline - time.time()
            if left <= 0:
                os.close(fd)
                try:
                    with open(path) as f:
                        holder = f.read().strip()
                except OSError:
                    holder = "?"
                _fail("another bench holds the lock", lock_holder_pid=holder)
            time.sleep(min(2.0, left))


def fixture_paths(scale: str, fixture_dir: str = FIXTURE_DIR) -> tuple:
    """(ref, fq1, fq2, truth) of a scale's cached fixture."""
    return tuple(os.path.join(fixture_dir, f"bench_{scale}.{ext}")
                 for ext in ("ref.fa", "1.fq", "2.fq", "true.sv.txt"))


def fixture(scale: str, fixture_dir: str, regen: bool = False) -> tuple:
    """fixture_paths of a scale, simulated unless cached."""
    from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample

    paths = fixture_paths(scale, fixture_dir)
    if not regen and all(os.path.isfile(p) for p in paths):
        return paths
    n_genomes, genome_len, hgt, depth, _ = SCALES[scale]
    pa = SimParams(n_genomes=n_genomes, genome_len=genome_len, hgt_num=hgt,
                   depth=depth, snp_rate=0.01, seed=42)
    return simulate_sample(fixture_dir, f"bench_{scale}", pa)


def run(ref: str, fq1: str, fq2: str, truth_path: str, scale: str,
        outdir: str, k: int, device, two_pass: bool,
        trace_dir: str | None = None, sim_wall: float = 0.0,
        use_kmer: bool = True) -> dict:
    """`bkp` on one fixture, once or twice (the second pass timed), and
    the bench's record of it. With `trace_dir` the timed pass runs under
    torch.profiler and its Chrome trace is written there; use_kmer=False
    runs direct mode."""
    from localhgt_tpu_torch.config import Config, KmerConfig
    from localhgt_tpu_torch.ops import cuda_sw
    from localhgt_tpu_torch.pipeline.bkp import detect_breakpoint
    from localhgt_tpu_torch.sim import evaluate
    from localhgt_tpu_torch.sim.simulate import read_truth
    from localhgt_tpu_torch.utils import device as device_mod
    from localhgt_tpu_torch.utils import formats, metrics

    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg = Config().replace(kmer=KmerConfig(k=k))
    sample = f"bench_{scale}"
    with open(fq1) as f:
        n_pairs = sum(1 for _ in f) // 4

    def one_pass():
        metrics.reset()
        if on_card:  # the first synchronize also creates the context
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        cuda_sw.sw_align.shapes.clear()
        t0 = time.time()
        acc = detect_breakpoint(ref, fq1, fq2, sample, outdir, device,
                                cfg=cfg, use_kmer=use_kmer)
        if on_card:
            torch.cuda.synchronize(device)
        return acc, time.time() - t0

    if two_pass:
        _, wall_cold = one_pass()
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            acc, wall = one_pass()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    else:
        acc, wall = one_pass()
    if not two_pass:
        wall_cold = wall

    rows, _, _ = formats.read_acc_csv(acc)
    called = [(r["from_ref"], int(r["from_pos"]), r["to_ref"],
               int(r["to_pos"])) for r in rows]
    score = evaluate.score_bkps(
        evaluate.truth_to_bkps(read_truth(truth_path)), called)
    pairs_per_sec = n_pairs / wall
    rec = {
        "metric": "bkp_pairs_per_sec",
        "value": round(pairs_per_sec, 1),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / BASELINE_PAIRS_PER_SEC, 3),
        "vs_baseline_cold": round(
            n_pairs / wall_cold / BASELINE_PAIRS_PER_SEC, 3),
        "wall_s": round(wall, 1),
        "wall_cold_s": round(wall_cold, 1),
        "sim_wall_s": round(sim_wall, 1),
        "n_pairs": n_pairs,
        "recall": score.recall,
        "fdr": score.fdr,
        "f1": score.f1,
        "k": k,
        "scale": scale,
        "platform": "gpu" if on_card else device.type,
        "two_pass": bool(two_pass),
        "stage_walls": metrics.stage_walls(),
        "stage_rss_gb": metrics.stage_rss(),
        "card": _card_line(device),
    }
    series = metrics.series_stats()
    if series:
        rec["batch_series"] = series
    cnt = metrics.counters()
    if cnt:
        rec["counters"] = {key: round(v, 1) for key, v in cnt.items()}
    if trace_dir:
        rec["trace_dir"] = trace_dir
    if not use_kmer:
        rec["use_kmer"] = 0
        rec["k1_launch_shapes"] = [
            [*shape, n] for shape, n in sorted(cuda_sw.sw_align.shapes.items())]
    mem = device_mod.memory_stats(device)
    if mem:  # GiB of the card's HBM3, under the JAX record's names
        rec["hbm_peak_gb"] = round(mem["device_peak_gib"], 3)
        rec["hbm_in_use_gb"] = round(mem["device_in_use_gib"], 3)
    rec.update(evaluate.resource_usage())  # host CPU time + max RSS
    rec.update(metrics.derived(n_pairs, READ_LEN, cfg.kmer.coder_num))
    return rec


def main(argv=None) -> int:
    from localhgt_tpu_torch.utils.device import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", default="big", choices=sorted(SCALES))
    ap.add_argument("-k", type=int, default=32,
                    help="k-mer length (default 32, the reference's)")
    ap.add_argument("--use_kmer", type=int, default=1, choices=(0, 1),
                    help="0: direct mode, no k-mer extraction stage")
    ap.add_argument("--regen", action="store_true",
                    help="simulate the fixture again")
    ap.add_argument("--lock-timeout", type=float, default=120.0,
                    help="seconds to wait for another bench's lock")
    ap.add_argument("--force", action="store_true",
                    help="run even when another process uses the card")
    ap.add_argument("--profile", action="store_true",
                    help="trace the timed pass with torch.profiler")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--json", default="", help="also write the record here")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    out = os.path.join(FIXTURE_DIR, f"run_{args.scale}"
                       + ("" if args.use_kmer else "_direct"))
    lock_fd = _acquire_lock(FIXTURE_DIR, args.lock_timeout)
    try:
        others = other_card_processes(
            _nvidia_smi("--query-compute-apps=pid,process_name"))
        if others and not args.force:
            _fail("concurrent process(es) on the card; timing would be "
                  "contended (pass --force to run anyway)",
                  contention=others)
        os.makedirs(out, exist_ok=True)
        t = time.time()
        ref, fq1, fq2, truth = fixture(args.scale, FIXTURE_DIR, args.regen)
        sim_wall = time.time() - t
        rec = run(ref, fq1, fq2, truth, args.scale, out, args.k, device,
                  SCALES[args.scale][4],
                  os.path.join(out, "trace") if args.profile else None,
                  sim_wall, use_kmer=bool(args.use_kmer))
    finally:
        os.close(lock_fd)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
