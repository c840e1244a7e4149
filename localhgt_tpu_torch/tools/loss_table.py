"""Per-stage truth-loss table of a fixture, on the port.

    python -m localhgt_tpu_torch.tools.loss_table --scale big [-k 32]
        [--out loss.json] [--device cuda]
    python -m localhgt_tpu_torch.tools.loss_table --ref ref.fa --fq1 a.fq
        --fq2 b.fq --truth true.sv.txt [-k 32] [--out loss.json]

The counterpart of tools/loss_table.py. Runs the `bkp` path on the
fixture while tracking, for every truth breakpoint pair, where it
survives:

    truth -> extraction intervals -> aligned split/cross support
          -> raw junctions -> accurate bkps -> final acc.csv

so that a recall drop is attributable to one stage from the record
alone. Extraction and the alignment loop are `bkp`'s own
(pipeline/extract.extract, pipeline/bkp.align_reads), so the table
measures what `bkp` runs. Matching tolerance is the reference's +-50 bp
(evaluation.py:22,138-187). `--scale` reads the bench's cached fixture
(localhgt_tpu_torch/bench.py; run the bench at that scale first). The
record ({"summary", "bkps"}) goes to --out, and the summary and every
lost breakpoint to standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

TOL = 50


def loss_table(ref: str, fq1: str, fq2: str, truth_path: str, cfg, device,
               scale: str | None = None) -> dict:
    """{"summary": stage counts, "bkps": one record per truth breakpoint}
    of `bkp` on this fixture at `cfg` on `device`."""
    from localhgt_tpu_torch.index import reference
    from localhgt_tpu_torch.pipeline import accbkp, align, extract, rawbkp
    from localhgt_tpu_torch.pipeline.bkp import align_reads
    from localhgt_tpu_torch.sim.simulate import read_truth
    from localhgt_tpu_torch.utils import formats

    truth = read_truth(truth_path)
    # truth bkp pairs: (receptor, insert_locus, donor, seg_start/seg_end)
    tb = []
    for t in truth:
        tb.append((t.receptor, t.insert_locus, t.donor, t.seg_start))
        tb.append((t.receptor, t.insert_locus, t.donor, t.seg_end))

    contigs = reference.build(ref)
    name2id = {contigs.name_of(c): c for c in range(1, contigs.n + 1)}
    res = extract.extract(fq1, fq2, contigs, cfg, device)
    intervals, cache = res.intervals, res.cache
    del res  # frees the peak map before alignment, as bkp does

    # stage 1: both endpoints inside an (padded) emitted interval
    iv_by_c = {}
    for cid, s, e in intervals:
        iv_by_c.setdefault(cid, []).append((s, e))

    def covered(name, pos):
        cid = name2id.get(name)
        return any(pos >= s - TOL and pos <= e + TOL
                   for s, e in iv_by_c.get(cid, []))

    subref = align.build_subref(contigs, intervals)
    index = align.SeedIndex.build(subref, cfg.align.seed_len)
    a1, a2, codes1, codes2, _ = align_reads(fq1, fq2, subref, index, cache,
                                            cfg, device)
    ins = rawbkp.estimate_insert(a1, a2, cfg.bkp)
    raw = rawbkp.call_raw_bkps(a1, a2, ins, cfg.bkp)
    accs = accbkp.find_accurate_bkps(raw, a1, a2, codes1, codes2, contigs,
                                     ins, cfg.bkp, subref, device,
                                     read_info=True)
    final = formats.dedup_rows(accs, cfg.bkp.dedup_cutoff)

    # stage 2: aligned evidence near the truth junction: cross pairs and
    # split reads linking (c1 near p1) <-> (c2 near p2)
    win = max(ins.insert_size, 500)

    def support(c1, p1, c2, p2):
        i1, i2 = name2id.get(c1), name2id.get(c2)
        cross = split = 0
        for x, y in ((a1, a2), (a2, a1)):
            m = (x.contig == i1) & (y.contig == i2) & \
                (np.abs(x.pos - p1) < win) & (np.abs(y.pos - p2) < win)
            cross += int(m.sum())
            s = (x.contig == i1) & (x.contig2 == i2) & \
                (np.abs(x.pos - p1) < win) & (np.abs(x.pos2 - p2) < win)
            split += int(s.sum())
        return cross, split

    def near_raw(c1, p1, c2, p2):
        i1, i2 = name2id.get(c1), name2id.get(c2)
        for r in raw:
            for (rc1, rp1, rc2, rp2) in ((r.c1, r.pos1, r.c2, r.pos2),
                                         (r.c2, r.pos2, r.c1, r.pos1)):
                if rc1 == i1 and rc2 == i2 and \
                        abs(rp1 - p1) < TOL and abs(rp2 - p2) < TOL:
                    return True
        return False

    def near_rows(rows, c1, p1, c2, p2):
        for r in rows:
            if isinstance(r, dict):
                f = (r["from_ref"], r["from_pos"], r["to_ref"], r["to_pos"])
            else:  # accbkp.AccBkp objects (contig ids + *_bkp coords)
                f = (r.from_ref, r.from_bkp, r.to_ref, r.to_bkp)
            for (rc1, rp1, rc2, rp2) in (f, (f[2], f[3], f[0], f[1])):
                rn1 = (contigs.name_of(rc1)
                       if isinstance(rc1, (int, np.integer)) else rc1)
                rn2 = (contigs.name_of(rc2)
                       if isinstance(rc2, (int, np.integer)) else rc2)
                if rn1 == c1 and rn2 == c2 and \
                        abs(int(rp1) - p1) < TOL and abs(int(rp2) - p2) < TOL:
                    return True
        return False

    records = []
    for (c1, p1, c2, p2) in tb:
        cross, split = support(c1, p1, c2, p2)
        records.append({
            "bkp": [c1, p1, c2, p2],
            "extracted": bool(covered(c1, p1) and covered(c2, p2)),
            "cross_pairs": cross,
            "split_reads": split,
            "raw": near_raw(c1, p1, c2, p2),
            "acc": near_rows(accs, c1, p1, c2, p2),
            "final": near_rows(final, c1, p1, c2, p2),
        })

    summary = {
        "scale": scale, "k": cfg.kmer.k, "n_truth_bkps": len(tb),
        "extracted": sum(r["extracted"] for r in records),
        "has_cross": sum(r["cross_pairs"] > 0 for r in records),
        "has_split": sum(r["split_reads"] > 0 for r in records),
        "raw": sum(r["raw"] for r in records),
        "acc": sum(r["acc"] for r in records),
        "final": sum(r["final"] for r in records),
        "n_intervals": len(intervals),
        "subref_bp": int(len(subref.codes)),
        "insert_size": ins.insert_size,
    }
    return {"summary": summary, "bkps": records}


def main(argv=None) -> int:
    from localhgt_tpu_torch.bench import fixture_paths
    from localhgt_tpu_torch.config import Config, KmerConfig
    from localhgt_tpu_torch.utils.device import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", default=None,
                    help="the bench's cached fixture of this scale")
    ap.add_argument("--ref")
    ap.add_argument("--fq1")
    ap.add_argument("--fq2")
    ap.add_argument("--truth", help="the simulator's true.sv.txt")
    ap.add_argument("-k", type=int, default=32)
    ap.add_argument("--out", required=True, help="JSON record written here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    if args.scale:
        paths = fixture_paths(args.scale)
    else:
        paths = [args.ref, args.fq1, args.fq2, args.truth]
        if not all(paths):
            ap.error("give --scale or all of --ref, --fq1, --fq2, --truth")
    for p in paths:
        if not os.path.isfile(p):
            sys.exit(f"fixture missing: {p}")
    cfg = Config().replace(kmer=KmerConfig(k=args.k))
    rec = loss_table(*paths, cfg, device, scale=args.scale)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec["summary"]))
    for r in rec["bkps"]:
        if not r["final"]:
            print("LOST:", json.dumps(r))
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
