"""acc.csv / event CSV schemas — byte-compatible with the reference outputs.

acc.csv (accurate_bkp.py:921-933): a `#` comment line carrying the sample read
count and insert size, a 16-column header, then one row per breakpoint pair.
Downstream consumers re-parse the comment (infer_HGT_event.py:93-95,
evaluation.py:114-116), so the exact wording is preserved.
"""

from __future__ import annotations

import csv

HEADER = [
    "from_ref", "from_pos", "from_side", "from_strand", "to_ref", "to_pos",
    "to_side", "to_strand", "if_reverse", "read_seq", "ref_seq", "similarity",
    "from_split_reads", "to_split_reads", "cross_split_reads", "pair_end",
]


def write_acc_csv(path: str, accs, contigs, reads_num: int, insert_size: int):
    with open(path, "w", newline="") as f:
        print(
            "# the number of reads in the sample is: %s; Insert size is %s."
            % (reads_num, insert_size),
            file=f,
        )
        w = csv.writer(f)
        w.writerow(HEADER)
        for a in accs:
            w.writerow([
                contigs.name_of(a.from_ref), a.from_bkp, a.from_side,
                a.from_strand, contigs.name_of(a.to_ref), a.to_bkp, a.to_side,
                a.to_strand, a.if_reverse, a.read_str, a.ref_str,
                a.similarity, a.from_reads, a.to_reads, a.cross, a.pair_end,
            ])


def read_acc_csv(path: str):
    """Returns (rows, reads_num, insert_size); rows are dicts keyed by HEADER."""
    rows = []
    reads_num = 0
    insert_size = 0
    with open(path) as f:
        for rec in csv.reader(f):
            if not rec:
                continue
            if rec[0].startswith("#"):
                try:
                    reads_num = int(rec[0].split(";")[0].split(":")[1])
                    insert_size = int(
                        rec[0].split(";")[1].strip().rstrip(".").split()[-1]
                    )
                except (IndexError, ValueError):
                    pass
                continue
            if rec[0] == "from_ref":
                continue
            rows.append(dict(zip(HEADER, rec)))
    return rows, reads_num, insert_size


def dedup_rows(accs, cutoff: int = 50):
    """remove_repeat.py semantics: drop a row whose both coordinates are
    within `cutoff` of an already-kept row (either orientation)."""
    kept = []
    record = []
    for a in accs:
        ok = True
        for r0, p0, r4, p4 in record:
            if a.from_ref == r0 and abs(a.from_bkp - p0) < cutoff and \
               a.to_ref == r4 and abs(a.to_bkp - p4) < cutoff:
                ok = False
                break
            if a.to_ref == r0 and abs(a.to_bkp - p0) < cutoff and \
               a.from_ref == r4 and abs(a.from_bkp - p4) < cutoff:
                ok = False
                break
        if ok:
            record.append((a.from_ref, a.from_bkp, a.to_ref, a.to_bkp))
            kept.append(a)
    return kept
