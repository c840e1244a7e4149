"""Device profile of the port's `bkp` on the `big` fixture (one CUDA card).

    python -m localhgt_tpu_torch.profile_bkp [--json out.json]

Simulates `big` (100 genomes x 1 Mbp, 50 HGTs, depth 5, seed 42) in a
temporary directory, then runs `bkp` at k=32 three times in one process:
a first run (kernel builds, CUDA context, allocator warm-up), a timed
run, and a run under `torch.profiler` with CUDA activity. It prints the
card's name and power limit, each run's wall and stage walls, the union
of the device-event intervals of the profiled run (the device's busy
share of its wall) and the device time per kernel name. Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
import time

import torch

BIG = dict(n_genomes=100, genome_len=1_000_000, hgt_num=50, depth=5,
           snp_rate=0.01, seed=42)
TOP = 30  # kernel names listed


def _busy_us(events) -> float:
    """Length of the union of the events' [start, end) intervals (us)."""
    busy = 0.0
    cur_s = cur_e = None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv=None) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from localhgt_tpu.sim.simulate import SimParams, simulate_sample
    from localhgt_tpu.utils import metrics
    from localhgt_tpu_torch import cli

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default="", help="also write the summary here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_bkp: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    work = tempfile.mkdtemp(prefix="lht_profile_")
    summary = {"card": card, "runs": {}}
    try:
        ref, fq1, fq2, _ = simulate_sample(work, "big", SimParams(**BIG))
        argv_bkp = ["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2, "-s", "big",
                    "-o", work, "-k", "32", "--device", "cuda"]

        def run(label):
            metrics.reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if cli.main(argv_bkp) != 0:
                raise SystemExit(f"bkp failed in the {label} run")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            summary["runs"][label] = {"wall_s": wall,
                                      "stages_s": metrics.stage_walls()}
            print(f"{label} run: wall {wall:.3f} s, stage walls (s) "
                  f"{json.dumps(metrics.stage_walls())}", flush=True)
            return wall

        run("first")
        run("timed")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run("profiled")
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = _busy_us(events) / 1e6
        summary["device_busy_s"] = busy
        summary["device_busy_share"] = busy / wall
        print(f"profiled run: {len(events)} device events, union busy "
              f"{busy:.3f} s = {100 * busy / wall:.2f}% of the wall")
        by_name = {}
        for e in events:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.end - e.time_range.start,
                               n + 1)
        top = sorted(by_name.items(), key=lambda x: -x[1][0])[:TOP]
        summary["kernels"] = [{"name": k, "ms": t / 1e3, "calls": n}
                              for k, (t, n) in top]
        print("device ms  calls  kernel")
        for k, (t, n) in top:
            print(f"{t / 1e3:9.1f} {n:6d}  {k[:110]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
