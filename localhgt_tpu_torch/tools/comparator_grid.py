"""The comparator over simulation scenarios, on the port.

    python -m localhgt_tpu_torch.tools.comparator_grid [workdir] [-k 32]
        [--device cuda]

The counterpart of tools/comparator_grid.py: `comparator_run.run` (the
port's k-mer pipeline, its direct mode and the reference extract_ref
engine's extraction stage) over the paper harness's scenario axes, SNP
rate, depth and community complexity (simulation.py:339-817 scenario
functions scored by evaluation.py), one fixture directory a scenario. Any
LEMON-format CSV dropped as <workdir>/<scenario>/lemon.csv joins its
scenario's rows. Writes comparator_grid.csv and comparator_grid.json into
`workdir` (default: an `lht_comp_grid_torch` directory under the system's
temporary directory) and prints one JSON line a scenario.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from localhgt_tpu_torch.tools import comparator_run

WORKDIR = os.path.join(tempfile.gettempdir(), "lht_comp_grid_torch")
# scenario axes, as tools/comparator_grid.py:28-35 (sim/grid.py SCENARIOS)
GRID = [
    ("snp0.01_depth10_n20", dict(snp_rate=0.01, depth=10, n_genomes=20)),
    ("snp0.03_depth10_n20", dict(snp_rate=0.03, depth=10, n_genomes=20)),
    ("snp0.05_depth10_n20", dict(snp_rate=0.05, depth=10, n_genomes=20)),
    ("snp0.01_depth5_n20", dict(snp_rate=0.01, depth=5, n_genomes=20)),
    ("snp0.01_depth30_n20", dict(snp_rate=0.01, depth=30, n_genomes=20)),
    ("snp0.01_depth10_n40", dict(snp_rate=0.01, depth=10, n_genomes=40)),
]
SUMMARY_KEYS = ("recall", "fdr", "f1", "extraction_truth_coverage", "wall_s")


def run(base: str = WORKDIR, k: int = 32, device="cuda", grid=GRID) -> list:
    """comparator_run.run over each scenario of `grid` ((label, SimParams
    fields) pairs; 150 kbp genomes, 10 HGTs and seed 42 unless a scenario
    says otherwise); writes the CSV and JSON into `base` and returns the
    scenarios' records."""
    from localhgt_tpu_torch.sim.simulate import SimParams

    results = []
    for label, kw in grid:
        pa = SimParams(**{"genome_len": 150_000, "hgt_num": 10, "seed": 42,
                          **kw})
        out = comparator_run.run(os.path.join(base, label), k, pa=pa,
                                 fixture_label=label, device=device)
        out["scenario"] = label
        results.append(out)
        print(json.dumps({"scenario": label, "rows": {
            n: {kk: vv for kk, vv in r.items() if kk in SUMMARY_KEYS}
            for n, r in out["rows"].items()}}), flush=True)

    cols = ["scenario"] + comparator_run.COLUMNS
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "comparator_grid.csv"), "w") as f:
        f.write(",".join(cols) + "\n")
        for out in results:
            for name, row in out["rows"].items():
                f.write(",".join([out["scenario"], name]
                                 + [str(row.get(c, "")) for c in cols[2:]])
                        + "\n")
    with open(os.path.join(base, "comparator_grid.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


def main(argv=None) -> int:
    from localhgt_tpu_torch.utils.device import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("workdir", nargs="?", default=WORKDIR)
    ap.add_argument("-k", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    a = ap.parse_args(argv)
    run(a.workdir, a.k, device=resolve(a.device))
    print(f"-> {a.workdir}/comparator_grid.csv")
    return 0


if __name__ == "__main__":
    sys.exit(main())
