"""Recall and FDR of called breakpoints against the simulator's truth: a
frozen copy of the port's sim/evaluate.py scoring (upstream's
paper_results/evaluation.py: a called pair matches a truth pair when its
contigs agree, in either orientation, and both positions lie within 50
bp)."""

from __future__ import annotations

import csv

TOLERATE_DIST = 50


def truth_to_bkps(truth) -> list[tuple[str, int, str, int]]:
    out = []
    for t in truth:
        out.append((t.receptor, t.insert_locus, t.donor, t.seg_start))
        out.append((t.receptor, t.insert_locus, t.donor, t.seg_end))
    return out


def _match(a, b, tol=TOLERATE_DIST) -> bool:
    if a[0] == b[0] and a[2] == b[2]:
        if abs(a[1] - b[1]) < tol and abs(a[3] - b[3]) < tol:
            return True
    if a[0] == b[2] and a[2] == b[0]:
        if abs(a[1] - b[3]) < tol and abs(a[3] - b[1]) < tol:
            return True
    return False


def score_bkps(true_bkps, called_bkps, tol=TOLERATE_DIST) -> dict:
    """{"recall", "fdr", "n_true", "n_called"}."""
    right = sum(1 for t in true_bkps
                if any(_match(t, c, tol) for c in called_bkps))
    false_pos = [c for c in called_bkps
                 if not any(_match(c, t, tol) for t in true_bkps)]
    return {"recall": right / len(true_bkps) if true_bkps else 0.0,
            "fdr": len(false_pos) / len(called_bkps) if called_bkps else 0.0,
            "n_true": len(true_bkps), "n_called": len(called_bkps)}


def called_bkps(acc_lines: list[str]) -> list[tuple[str, int, str, int]]:
    """(from_ref, from_pos, to_ref, to_pos) of every row of an acc.csv."""
    out = []
    for rec in csv.reader(acc_lines):
        if not rec or rec[0].startswith("#") or rec[0] == "from_ref":
            continue
        out.append((rec[0], int(rec[1]), rec[4], int(rec[5])))
    return out
