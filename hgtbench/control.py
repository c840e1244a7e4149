"""The control of `correct`: the plain reference put in the program's
place with one guarantee of the configuration broken, compared with the
exact reference by check.py. It has to come out as not correct.

    python3 -m hgtbench.control --workload <cell> --seeds <n> [<n> ...]
        [--device cuda]

The configurations state exact int32 Smith-Waterman scores; the control
computes K1's scores as an 8-bit score lane would, saturating at 127
(`score_clip`, ops/sw_plain.py), the step down in precision that would
tempt a later change. For each seed it makes the cell's reference and one
pool sample from the seed, as run.py does, runs the reference twice on
that sample and prints one JSON line of check.py's numbers. Not run by
the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import tempfile

SCORE_CLIP = 127  # the largest score of a signed 8-bit lane


def as_program(out: dict) -> dict:
    """A reference result in the shape check.compare takes for the
    program's side: intervals as the lines of an interval.txt."""
    got = dict(out)
    got["intervals"] = [f"{c}\t{s}\t{e}" for c, s, e in out["intervals"]]
    return got


def control_numbers(config: dict, traffic: dict, seed: int, device,
                    workdir: str) -> dict:
    """check.py's numbers of the control against the reference, on the
    first pool sample of `seed`."""
    from hgtbench import check, cohort
    from hgtbench.plainref import config as ref_config
    from hgtbench.plainref.pipeline import bkp as ref_bkp
    from hgtbench.run import pipeline_config

    one = dict(traffic, pool=1)
    co = cohort.make(workdir, config, one, seed)
    s = co.pool[0]
    cfg = pipeline_config(ref_config.Config, ref_config.KmerConfig,
                           ref_config.ScanConfig, config)
    use_kmer = bool(config["use_kmer"])
    exact = ref_bkp.run(co.ref, s.fq1, s.fq2, device, cfg, use_kmer)
    low = cfg.replace(align=dataclasses.replace(cfg.align,
                                                score_clip=SCORE_CLIP))
    ctl = ref_bkp.run(co.ref, s.fq1, s.fq2, device, low, use_kmer)
    return check.compare(as_program(ctl), exact, use_kmer)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from hgtbench import registry

    cell = registry.Cell(registry.load_spec(), args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("hgtbench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        workdir = tempfile.mkdtemp(prefix="hgtbench-control-")
        try:
            nums = control_numbers(cell.config, cell.traffic, seed, device,
                                   workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
