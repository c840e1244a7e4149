"""Walls of the port's `bkp` on the `big` fixture, one card against a mesh.

    python -m localhgt_tpu_torch.mesh_bkp [--shards N] [--json out.json]

Simulates `big` (100 genomes x 1 Mbp, 50 HGTs, depth 5, seed 42) in a
temporary directory, then runs `bkp` at k=32 five times in one process: a
first single-device run (kernel builds, CUDA context, allocator warm-up),
then single, mesh, mesh, single in turns. The mesh has N shards (default:
one per visible card) laid over the visible cards in turn, so on one card
all N sit on it and nothing can run faster than the single device. It
prints every card's name and power limit, each run's wall, stage walls
and device memory peak on card 0, and fails unless every mesh run writes
the single-device run's interval.txt, bed and acc.csv byte for byte.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import torch

from localhgt_tpu_torch.tune_vote import BIG

FILES = ("interval.txt", "interval.txt.bed", "acc.csv")


def main(argv=None) -> int:
    from localhgt_tpu_torch import cli
    from localhgt_tpu_torch.parallel.mesh import make_flat_mesh
    from localhgt_tpu_torch.pipeline.bkp import detect_breakpoint
    from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample
    from localhgt_tpu_torch.utils import metrics

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shards", type=int, default=0,
                    help="mesh entries (default: one per visible card)")
    ap.add_argument("--json", default="", help="also write the runs here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mesh_bkp: CUDA is not available")
    torch.cuda.init()  # the memory counters need the context
    cards = torch.cuda.device_count()
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card_lines = res.stdout.strip().splitlines()
    print("\n".join(card_lines), flush=True)
    mesh = make_flat_mesh([f"cuda:{i % cards}"
                           for i in range(args.shards or cards)])
    print(f"[mesh] {mesh.describe()}", flush=True)
    dev = torch.device("cuda:0")
    work = tempfile.mkdtemp(prefix="lht_mesh_")
    runs = []
    try:
        ref, fq1, fq2, _ = simulate_sample(work, "big", SimParams(**BIG))
        argv_bkp = ["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2, "-s", "big",
                    "-k", "32", "--device", str(dev)]
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv_bkp))
        for i, kind in enumerate(("first", "single", "mesh", "mesh",
                                  "single")):
            out = os.path.join(work, f"run{i}")
            os.makedirs(out)
            metrics.reset()
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            detect_breakpoint(ref, fq1, fq2, "big", out, dev, cfg=cfg,
                              mesh=mesh if kind == "mesh" else None)
            for d in mesh.distinct:
                torch.cuda.synchronize(d)
            run = {"kind": kind, "wall_s": time.perf_counter() - t,
                   "stage_walls_s": metrics.stage_walls(),
                   "card0_peak_gib":
                       torch.cuda.max_memory_allocated(dev) / 2**30}
            runs.append(run)
            print(f"[run {i}] {json.dumps(run)}", flush=True)
            for name in FILES:
                with open(os.path.join(out, f"big.{name}"), "rb") as f, open(
                        os.path.join(work, "run0", f"big.{name}"), "rb") as g:
                    if f.read() != g.read():
                        raise SystemExit(f"run {i} ({kind}): big.{name} "
                                         "differs from the first run's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = {"cards": card_lines, "shards": mesh.n,
               "distinct_devices": len(mesh.distinct), "runs": runs}
    print(json.dumps(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
