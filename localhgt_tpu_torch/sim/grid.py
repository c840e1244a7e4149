"""Scenario sweeps: the paper harness's evaluation grids on this framework.

Port of the batch-runner + evaluator roles
(paper_results/generate_run_scripts.py + evaluation.py __main__): sweep SNP
rate / depth / read length grids (simulation.py:339-817 scenario functions),
run the bkp pipeline on each sample, and score recall/FDR/F1 at the +-50bp
tolerance. Emits one CSV row per run.

    python -m localhgt_tpu_torch.sim.grid --out /tmp/grid --scenario snp

Copy of localhgt_tpu/sim/grid.py on the port's pipeline, plus `--device`
(default cuda; raises when CUDA is absent).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import time

from localhgt_tpu_torch.config import Config, KmerConfig
from localhgt_tpu_torch.sim import evaluate
from localhgt_tpu_torch.sim.simulate import SimParams, read_truth, simulate_sample

# grids follow simulation.py Parameters (:819-891) and the scenario
# functions of the paper harness (snp/depth/length/insert-size/donor/
# background-complexity/data-amount, simulation.py:339-817)
SCENARIOS = {
    "snp": [dict(snp_rate=r) for r in (0.01, 0.02, 0.03, 0.04, 0.05)],
    "depth": [dict(depth=d) for d in (10, 30, 50)],
    "readlen": [dict(read_len=l) for l in (75, 100, 150)],
    "insert": [dict(mean_frag=f) for f in (300, 350, 500, 700)],
    "donor": [dict(donor_in=True), dict(donor_in=False)],
    # CAMI-style community complexity: more background genomes around the
    # same number of implanted events
    "background": [dict(n_genomes=n) for n in (20, 40, 80)],
    "quick": [dict(snp_rate=0.01), dict(snp_rate=0.03)],
}

# data-amount sweep adjusts the down-sampling budget, not the simulation
AMOUNT_FRACTIONS = (1.0, 0.5, 0.25)


def run_one(outdir: str, name: str, sim_kw: dict, cfg: Config, device):
    from localhgt_tpu_torch.pipeline.bkp import detect_breakpoint
    from localhgt_tpu_torch.utils import device as device_mod
    from localhgt_tpu_torch.utils import formats, metrics

    pa = SimParams(
        n_genomes=20, genome_len=120_000, hgt_num=10, seed=hash(name) % 2**31,
        **sim_kw,
    )
    ref, fq1, fq2, truth_path = simulate_sample(outdir, name, pa)
    truth = read_truth(truth_path)
    metrics.reset()
    t0 = time.time()
    acc = detect_breakpoint(ref, fq1, fq2, name, outdir, device, cfg=cfg)
    wall = time.time() - t0
    rows, _, _ = formats.read_acc_csv(acc)
    called = [
        (r["from_ref"], int(r["from_pos"]), r["to_ref"], int(r["to_pos"]))
        for r in rows
    ]
    score = evaluate.score_bkps(evaluate.truth_to_bkps(truth), called)
    row = dict(
        sample=name, **sim_kw, recall=score.recall, fdr=score.fdr,
        f1=score.f1, n_called=score.n_called, wall_s=round(wall, 1),
    )
    # resource accounting next to accuracy, the /usr/bin/time -v role of the
    # paper harness (evaluation.py:205-240 extract_time/extract_mem)
    row.update(evaluate.resource_usage())
    row.update(device_mod.memory_stats(device))
    return row


def run_grid(outdir: str, scenario: str, device,
             cfg: Config | None = None):
    cfg = cfg or Config().replace(kmer=KmerConfig(k=24))
    os.makedirs(outdir, exist_ok=True)
    results = []
    if scenario == "amount":
        # data-amount sweep: same sample, shrinking down-sample budget
        # (simulation.py's data-amount scenario; --sample <=1 = proportion)
        for i, frac in enumerate(AMOUNT_FRACTIONS):
            c = cfg.replace(
                kmer=dataclasses.replace(cfg.kmer, sample=frac))
            results.append(run_one(outdir, f"amount{i}", {}, c, device))
            results[-1]["param"] = f"sample={frac}"
            print(results[-1], flush=True)
    else:
        for i, kw in enumerate(SCENARIOS[scenario]):
            name = f"{scenario}{i}"
            results.append(run_one(outdir, name, kw, cfg, device))
            print(results[-1], flush=True)
    out_csv = os.path.join(outdir, f"grid_{scenario}.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(results[0]))
        w.writeheader()
        w.writerows(results)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--scenario",
                    choices=list(SCENARIOS) + ["amount"], default="quick")
    ap.add_argument("-k", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every device step (default cuda; "
                    "raises when CUDA is absent)")
    a = ap.parse_args(argv)
    from localhgt_tpu_torch.utils import device as device_mod

    cfg = Config().replace(kmer=KmerConfig(k=a.k))
    run_grid(a.out, a.scenario, device_mod.resolve(a.device), cfg)


if __name__ == "__main__":
    main()
