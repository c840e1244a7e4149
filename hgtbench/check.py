"""The comparison that decides `correct`: what one `bkp` run of the
program produced against what the plain reference (hgtbench/plainref)
works out from the same files. Every number is a count of records that
differ, and every limit is 0: the pipeline is integer and exact, so any
difference is a wrong answer.

- intervals, bed: lines of <sample>.interval.txt and its bed that one
  side has and the other has not (k-mer path only);
- subref_bp: the gap between the sub-reference lengths (the program's
  `subref_bp` counter; k-mer path only);
- alignments: rows of the two mates' alignment tables that differ in any
  field, plus the difference in their row counts;
- raw_junctions, acc_lines: raw junctions and acc.csv lines that one side
  has and the other has not.
"""

from __future__ import annotations

import collections

import numpy as np

LIMIT = 0


def _sym_diff(a, b) -> int:
    """Items of the multiset a not in b plus those of b not in a."""
    ca, cb = collections.Counter(a), collections.Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


def _table_rows_differing(t, u) -> int:
    """Rows of AlnTable t and u that differ in any field, plus the
    difference in their lengths; t None (no alignment ran) counts every
    row of u."""
    if t is None:
        return len(u)
    n, m = len(t), len(u)
    k = min(n, m)
    bad = np.zeros(k, bool)
    for f in t.__dataclass_fields__:
        a = np.asarray(getattr(t, f))[:k]
        b = np.asarray(getattr(u, f))[:k]
        bad |= a != b
    return int(bad.sum()) + abs(n - m)


def _raw_key(r) -> tuple:
    return (int(r.c1), int(r.pos1), int(r.min1), int(r.max1), int(r.c2),
            int(r.pos2), int(r.min2), int(r.max2), int(r.n_sup),
            bool(r.reverse))


def compare(prog: dict, ref: dict, use_kmer: bool) -> dict:
    """{number name: count} for one run. `prog` and `ref` hold
    "intervals" [str], "bed" [str], "subref_bp", "a1", "a2", "raw",
    "acc" [str]; the program's interval lines are its file's, the
    reference's its (cid, start, end) tuples written the same way. The
    program's "a1", "a2" and "raw" are absent where its run ended before
    aligning (an empty sub-reference)."""
    out = {}
    if use_kmer:
        ref_iv = [f"{c}\t{s}\t{e}" for c, s, e in ref["intervals"]]
        out["intervals"] = _sym_diff(prog["intervals"], ref_iv)
        out["bed"] = _sym_diff(prog["bed"], ref["bed"])
        out["subref_bp"] = abs(int(prog["subref_bp"]) - int(ref["subref_bp"]))
    out["alignments"] = (_table_rows_differing(prog.get("a1"), ref["a1"])
                         + _table_rows_differing(prog.get("a2"), ref["a2"]))
    out["raw_junctions"] = _sym_diff([_raw_key(r) for r in prog.get("raw", [])],
                                     [_raw_key(r) for r in ref["raw"]])
    out["acc_lines"] = _sym_diff(prog["acc"], ref["acc"])
    return out


def worst(readings: list) -> dict:
    """The largest reading of each number over several runs."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0), v)
    return out
