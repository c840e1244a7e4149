"""Long-read / assembly validation of called HGT events on one device.

Port of localhgt_tpu/tools/validate_events.py (the method is described
there): reconstruct both junctions of each predicted insertion and count
the long reads that align across a junction with >= min_span bases on both
sides at >= min_identity. Where the JAX tool makes one K1 call per read and
orientation, this makes one per (event, junction): both orientations of
every read, each cut to the junction's length and right-padded with code 4
(padding the query that way leaves every K1 field unchanged), against the
junction. A read supports a junction when either orientation passes.
Junctions are up to 2 x flank = 1,000 columns wide, so K1 runs its
wide-reference variant there.

    python -m localhgt_tpu_torch.tools.validate_events \\
        -r ref.fa -e events.csv --long-reads lr.fq -o validated.csv
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

from localhgt_tpu_torch.io import fasta, fastq
from localhgt_tpu_torch.ops import coder, sw
from localhgt_tpu_torch.utils.device import resolve


def reconstruct_junctions(contigs: fasta.Contigs, receptor: str, locus: int,
                          donor: str, ds: int, de: int, reverse: bool,
                          flank: int = 500):
    """Return the two junction sequences (codes) of the predicted insertion:
    [receptor_left + seg_start_side] and [seg_end_side + receptor_right]."""
    rid = contigs.contig_id(receptor)
    did = contigs.contig_id(donor)
    seg = contigs.slice_codes(did, ds, de)
    if reverse:
        seg = coder.COMPLEMENT[seg][::-1]
    left = contigs.slice_codes(rid, max(0, locus - flank), locus)
    right = contigs.slice_codes(rid, locus, locus + flank)
    j1 = np.concatenate([left, seg[:flank]])
    j2 = np.concatenate([seg[-flank:], right])
    return j1, j2


def read_long_reads(path: str, max_reads: int) -> list:
    """Base codes of the first `max_reads` reads of a FASTQ file."""
    reads = []
    for b in fastq.iter_fastq_batches(path, batch_reads=4096, max_len=4096):
        for i in range(b.n):
            reads.append(b.codes[i, : b.lengths[i]])
            if len(reads) >= max_reads:
                return reads
    return reads


def junction_support(reads: list, junction: np.ndarray, device,
                     min_span: int = 200,
                     min_identity: float = 0.85) -> int:
    """Reads (either orientation) that align across the junction's middle
    with >= min_span bases on both sides at >= min_identity; one K1 call
    over [2 x reads] queries. Reads shorter than 2 x min_span are skipped."""
    jlen = len(junction)
    mid = jlen // 2
    queries = []
    for rd in reads:
        if len(rd) < 2 * min_span:
            continue
        for q in (rd, coder.COMPLEMENT[rd][::-1]):
            queries.append(q[: min(len(q), jlen)])
    if not queries:
        return 0
    Q = np.full((len(queries), max(len(q) for q in queries)), 4, np.uint8)
    for i, q in enumerate(queries):
        Q[i, : len(q)] = q
    R = np.broadcast_to(junction, (len(queries), jlen))
    out = sw.sw_align_tiled(Q, R, device)
    span_l = mid - out["rstart"]
    span_r = out["rend"] - mid
    ident = out["score"] / np.maximum(out["rend"] - out["rstart"] + 1, 1)
    ok = (span_l >= min_span) & (span_r >= min_span) & (ident >= min_identity)
    return int(ok.reshape(-1, 2).any(axis=1).sum())


def validate(ref_path: str, events_csv: str, long_reads_fq: str, device,
             min_span: int = 200, min_identity: float = 0.85,
             flank: int = 500, max_reads: int = 20000) -> list:
    """One row per event: its CSV fields, the supporting reads of each
    junction and whether both junctions have support."""
    contigs = fasta.read_fasta(ref_path)
    with open(events_csv) as f:
        events = list(csv.DictReader(f))
    reads = read_long_reads(long_reads_fq, max_reads)
    results = []
    for ev in events:
        junctions = reconstruct_junctions(
            contigs, ev["receptor"], int(ev["insert_locus"]), ev["donor"],
            int(ev["delete_start"]), int(ev["delete_end"]),
            ev["reverse_flag"] in ("True", "true", "1"), flank,
        )
        support = [junction_support(reads, j, device, min_span, min_identity)
                   for j in junctions]
        results.append({**ev, "junction1_reads": support[0],
                        "junction2_reads": support[1],
                        "validated": support[0] > 0 and support[1] > 0})
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-r", required=True, help="reference FASTA")
    ap.add_argument("-e", required=True, help="events CSV from `event`")
    ap.add_argument("--long-reads", required=True, help="long-read FASTQ")
    ap.add_argument("-o", default="validated_events.csv")
    ap.add_argument("--min-span", type=int, default=200)
    ap.add_argument("--min-identity", type=float, default=0.85)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the alignments (default cuda)")
    a = ap.parse_args(argv)
    rows = validate(a.r, a.e, a.long_reads, resolve(a.device),
                    a.min_span, a.min_identity)
    if rows:
        with open(a.o, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    print(f"{sum(r['validated'] for r in rows)}/{len(rows)} events validated")


if __name__ == "__main__":
    main()
