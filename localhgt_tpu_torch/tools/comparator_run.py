"""The comparator table of one simulated truth fixture, on the port.

    python -m localhgt_tpu_torch.tools.comparator_run [workdir] [-k 32]
        [--device cuda]

The counterpart of tools/comparator_run.py (the paper harness's
comparator flow, paper_results/evaluation.py + run_lemon.sh). Rows:

  * localhgt_tpu_torch: `bkp` with the k-mer extraction stage (the
    default);
  * localhgt_tpu_torch_direct: `bkp` in direct mode (use_kmer=0, the
    reference's ground-truth mode, infer_HGT_breakpoint.py:36-97): every
    read aligned against the whole reference;
  * reference_extract_ref: the reference's compiled extract_ref engine,
    extraction stage only, scored as extraction-stage truth coverage
    (evaluation.py:64-76), beside localhgt_tpu_torch_extract_stage, the
    port's extraction on the same scoring; "skipped" where the engine's
    source or g++ is absent (tools/ab_reference.py);
  * lemon: any LEMON-format CSV dropped into the work directory as
    lemon.csv joins the table (evaluate.read_comparator_csv).

Each `bkp` row: recall / FDR / F1 at +-50 bp, the number of calls, wall
seconds, host CPU seconds and max RSS, and (in the JSON only) the launches
of kernels K1-K3 and K6 and K1's launches by (B, M, N) during the row. The
fixture (default: 20 genomes x 150 kbp, 10 HGTs, depth 10, snp 0.01, seed
42) and every output go under `workdir` (default: an `lht_comp_torch`
directory under the system's temporary directory), comparator.csv among
them; the JSON record goes to standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

WORKDIR = os.path.join(tempfile.gettempdir(), "lht_comp_torch")
FIXTURE_LABEL = "species20 snp0.01 depth10 seed42"
COLUMNS = ["tool", "stage", "recall", "fdr", "f1", "n_called",
           "extraction_truth_coverage", "n_intervals", "wall_s", "cpu_s",
           "max_rss_gb"]


def _launches() -> dict:
    from localhgt_tpu_torch.ops import cuda_seed, cuda_sw, cuda_vote

    return {"sw_align": cuda_sw.sw_align.launches,
            "sw_score": cuda_sw.sw_score.launches,
            "vote_state": cuda_vote.vote_state.launches,
            "seed_prefilter": cuda_seed.seed_prefilter.launches,
            "k1_shapes": dict(cuda_sw.sw_align.shapes)}


def _launch_delta(before: dict, after: dict) -> dict:
    out = {n: after[n] - before[n]
           for n in ("sw_align", "sw_score", "vote_state", "seed_prefilter")}
    shapes = {s: n - before["k1_shapes"].get(s, 0)
              for s, n in after["k1_shapes"].items()}
    out["k1_shapes"] = [[*s, n] for s, n in sorted(shapes.items()) if n]
    return out


def run(workdir: str = WORKDIR, k: int = 32, pa=None,
        fixture_label: str = FIXTURE_LABEL, device="cuda") -> dict:
    import torch

    from localhgt_tpu_torch.config import Config, KmerConfig
    from localhgt_tpu_torch.pipeline.bkp import detect_breakpoint
    from localhgt_tpu_torch.sim import evaluate
    from localhgt_tpu_torch.sim.simulate import (SimParams, read_truth,
                                                 simulate_sample)
    from localhgt_tpu_torch.tools import ab_reference

    device = torch.device(device)
    os.makedirs(workdir, exist_ok=True)
    pa = pa or SimParams(n_genomes=20, genome_len=150_000, hgt_num=10,
                         depth=10, snp_rate=0.01, seed=42)
    ref, fq1, fq2, truth_path = simulate_sample(workdir, "cmp", pa)
    truth = read_truth(truth_path)
    true_bkps = evaluate.truth_to_bkps(truth)
    true_loci = [(r, p) for (r, p, _, _) in true_bkps] + \
        [(r, p) for (_, _, r, p) in true_bkps]
    cfg = Config().replace(kmer=KmerConfig(k=k, strict_sampling=True))

    table = {}

    def bkp_row(name, **kw):
        n0 = _launches()
        t0 = time.perf_counter()
        r0 = evaluate.resource_usage()
        acc = detect_breakpoint(ref, fq1, fq2, name, workdir, device,
                                cfg=cfg, **kw)
        wall = time.perf_counter() - t0
        r1 = evaluate.resource_usage()
        calls = evaluate.read_localhgt_csv(acc)
        s = evaluate.score_bkps(true_bkps, calls)
        table[name] = {
            "stage": "full bkp pipeline",
            "recall": s.recall, "fdr": s.fdr, "f1": s.f1,
            "n_called": s.n_called, "wall_s": round(wall, 3),
            "cpu_s": round(r1["cpu_user_s"] + r1["cpu_sys_s"]
                           - r0["cpu_user_s"] - r0["cpu_sys_s"], 1),
            "max_rss_gb": r1["max_rss_gb"],
            "launches": _launch_delta(n0, _launches()),
        }

    bkp_row("localhgt_tpu_torch")
    bkp_row("localhgt_tpu_torch_direct", use_kmer=False)

    # reference engine: extraction stage (interval truth coverage + wall)
    binary = ab_reference.compile_reference(workdir)
    if binary is not None:
        t0 = time.perf_counter()
        ref_ivs = ab_reference.run_reference_extract(
            binary, fq1, fq2, ref, workdir, cfg, threads=1)
        wall = time.perf_counter() - t0
        table["reference_extract_ref"] = {
            "stage": "extraction only (downstream needs bwa/samtools)",
            "extraction_truth_coverage": _coverage(ref_ivs, true_loci),
            "n_intervals": len(ref_ivs), "wall_s": round(wall, 3),
        }
        ivs = ab_reference.run_extract(fq1, fq2, ref, cfg, device)
        table["localhgt_tpu_torch_extract_stage"] = {
            "stage": "extraction only (same scoring as the row above)",
            "extraction_truth_coverage": _coverage(ivs, true_loci),
            "n_intervals": len(ivs),
        }
    else:
        table["reference_extract_ref"] = {"skipped": "no g++/source"}

    # any LEMON-format CSV present joins the table (run_lemon.sh flow)
    lemon = os.path.join(workdir, "lemon.csv")
    if os.path.isfile(lemon):
        s = evaluate.score_bkps(true_bkps, evaluate.read_comparator_csv(lemon))
        table["lemon"] = {"stage": "full (external run)", "recall": s.recall,
                          "fdr": s.fdr, "f1": s.f1}

    out = {"fixture": fixture_label, "k": k, "device": str(device),
           "tolerance_bp": 50, "rows": table}
    with open(os.path.join(workdir, "comparator.csv"), "w") as f:
        f.write(",".join(COLUMNS) + "\n")
        for name, row in table.items():
            f.write(",".join([name] + [str(row.get(c, ""))
                                       for c in COLUMNS[1:]]) + "\n")
    return out


def _coverage(intervals, true_loci, tol: int = 50) -> float:
    """Fraction of true breakpoint loci inside the extracted intervals
    +-tol (check_if_bkp_in_extracted_ref, evaluation.py:64-76)."""
    hit = 0
    for r, p in true_loci:
        for name, s, e in intervals:
            if name == r and s - tol <= p <= e + tol:
                hit += 1
                break
    return round(hit / max(len(true_loci), 1), 4)


def main(argv=None) -> int:
    from localhgt_tpu_torch.utils.device import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("workdir", nargs="?", default=WORKDIR)
    ap.add_argument("-k", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.workdir, a.k, device=resolve(a.device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
