"""mapq calibration report, on the port.

    python -m localhgt_tpu_torch.tools.mapq_calibration [outdir]
        [--device cuda]

The counterpart of tools/mapq_calibration.py. bwa cannot run here, so
the calibration is empirical against simulated truth: reads simulated
from known positions are aligned by the port's seed-and-extend aligner
(kernel K1), and the report checks that the bwa-model mapq
(align._bwa_mapq, mem_approx_mapq_se semantics) behaves the way the
reference's discordant-pair gate assumes (get_raw_bkp.py:55-61 keeps
pairs at mapq >= 20):

  * unique-region reads: mapq >= 20 pass rate should be ~1 (bwa gives
    unique 150 bp hits mapq 60);
  * reads from a duplicated (repeat) region: pass rate should be ~0 (two
    equal placements -> sub == score -> mapq 0).

The fixture: 4 genomes x 30 kb (seed 7) plus a genome that duplicates
genome 0's middle 5 kb, written to `outdir` (default: a `lht_mapq`
directory under the system's temporary directory). Prints the report
as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

WIDTH = 192            # mate 1 padded or cropped to this many bases
BATCH_READS = 1 << 14


def run(outdir: str, device) -> dict:
    from localhgt_tpu_torch.config import Config
    from localhgt_tpu_torch.index import reference
    from localhgt_tpu_torch.io import fastq
    from localhgt_tpu_torch.pipeline import align
    from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample

    device = torch.device(device)
    os.makedirs(outdir, exist_ok=True)
    cfg = Config()

    # --- fixture: normal genomes + one exact duplicated segment ---
    pa = SimParams(n_genomes=4, genome_len=30_000, hgt_num=1, depth=8, seed=7)
    ref, fq1, fq2, _ = simulate_sample(outdir, "mq", pa)
    # append a genome that duplicates genome 0's middle 5 kb verbatim: reads
    # from that window have two equal placements, bwa's mapq-0 case
    seq0_lines = []
    with open(ref) as f:
        for line in f:
            if line.startswith(">"):
                if seq0_lines:
                    break
                continue
            seq0_lines.append(line.strip())
    seq0 = "".join(seq0_lines)
    if len(seq0) < 15_000:
        raise RuntimeError("genome 0 is shorter than the duplicated window")
    with open(ref, "a") as f:
        f.write(">dup_genome_1\n" + seq0[10_000:15_000] + "\n")
    contigs = reference.build(ref)
    intervals = [(cid, 1, contigs.length_of(cid))
                 for cid in range(1, contigs.n + 1)]
    subref = align.build_subref(contigs, intervals)
    index = align.SeedIndex.build(subref, cfg.align.seed_len)
    bitmap = align.prefix_bitmap(index, device)

    stats = {"unique": [0, 0], "repeat": [0, 0]}
    mapqs = []
    for b1, _b2 in fastq.paired_batches(fq1, fq2, batch_reads=BATCH_READS,
                                        threads=cfg.threads):
        c = np.full((b1.n, WIDTH), 4, np.uint8)
        w = min(WIDTH, b1.codes.shape[1])
        c[:, :w] = b1.codes[:, :w]
        ln = np.minimum(b1.lengths, WIDTH).astype(np.int32)
        pf = align.seed_prefilter_device(
            torch.from_numpy(c).to(device), torch.from_numpy(ln).to(device),
            bitmap).cpu().numpy()
        t = align.align_batch(
            subref, index, c, ln, np.arange(b1.n, dtype=np.int64), 0,
            cfg.align, device, pf, threads=cfg.threads)
        mapped = t.contig > 0
        # a read is "repeat" if its placement lands inside the duplicated
        # window of genome 0 (or in the duplicate genome)
        g0 = 1
        dup = contigs.n
        in_dup = mapped & (
            ((t.contig == g0) & (t.pos >= 10_000) & (t.rend <= 15_000))
            | (t.contig == dup))
        for key, m in (("repeat", in_dup), ("unique", mapped & ~in_dup)):
            stats[key][0] += int((t.mapq[m] >= cfg.align.min_mapq).sum())
            stats[key][1] += int(m.sum())
        mapqs.append(t.mapq[mapped])
    mq = np.concatenate(mapqs) if mapqs else np.zeros(0, np.int16)

    return {
        "unique_pass_rate": round(
            stats["unique"][0] / max(stats["unique"][1], 1), 4),
        "repeat_pass_rate": round(
            stats["repeat"][0] / max(stats["repeat"][1], 1), 4),
        "n_unique": stats["unique"][1],
        "n_repeat": stats["repeat"][1],
        "mapq_hist": {str(b): int(((mq >= b) & (mq < b + 10)).sum())
                      for b in range(0, 61, 10)},
        "min_mapq_gate": cfg.align.min_mapq,
    }


def main(argv=None) -> int:
    from localhgt_tpu_torch.utils.device import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("outdir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "lht_mapq"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.outdir, resolve(args.device))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
