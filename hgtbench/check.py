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
  has and the other has not;
- qc_counts (QC only): the summed gaps of the pairs kept, the mates cut to
  their insert and the bases kept, between the program's `qc_*` counters
  and the reference's QC;
- refined_records (QC only): records of the two refined FASTQ files that
  differ, position by position, plus the difference in their record
  counts.
"""

from __future__ import annotations

import collections

import numpy as np

LIMIT = 0
# the QC counts compared: pairs_in and bases_in are the input's own
QC_COUNTS = ("pairs_out", "adapter_trimmed", "bases_out")


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
    aligning (an empty sub-reference). Where the reference ran QC, both
    hold "qc", the counts by name (the program's from its counters)."""
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
    if "qc" in ref:
        out["qc_counts"] = sum(abs(int(prog["qc"].get(k, 0)) - ref["qc"][k])
                               for k in QC_COUNTS)
    return out


def _fastq_records(data: bytes) -> list:
    """The records of a FASTQ file's bytes, four lines each with their
    newlines (the last one as far as it goes)."""
    lines = data.split(b"\n")
    lines = [ln + b"\n" for ln in lines[:-1]] + [lines[-1]] * bool(lines[-1])
    return [b"".join(lines[i:i + 4]) for i in range(0, len(lines), 4)]


def refined_records(prog: tuple, ref: tuple) -> int:
    """Records of the refined FASTQ files (the bytes of mate 1's and mate
    2's) that differ between the program and the reference, position by
    position, plus the difference in their record counts."""
    n = 0
    for a, b in zip(prog, ref):
        if a != b:
            ra, rb = _fastq_records(a), _fastq_records(b)
            n += sum(x != y for x, y in zip(ra, rb)) + abs(len(ra) - len(rb))
    return n


def worst(readings: list) -> dict:
    """The largest reading of each number over several runs."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0), v)
    return out
