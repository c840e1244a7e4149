"""The reference's read QC, for `bkp --refine_fq 1`: fastp at its default
settings (upstream runs `fastp -i fq1 -I fq2 -o ... -O ...`,
scripts/infer_HGT_breakpoint.py:99-109), written from fastp's rules.

1. Adapter trimming by overlap: read 1 is laid against the reverse
   complement of read 2 at every offset. An offset is acceptable where
   they overlap by at least 30 bases with at most 5 mismatches and at most
   20% of the overlap mismatched; of the acceptable offsets, the first in
   ascending order with the largest overlap gives the insert. Where the
   insert is shorter than a mate, the mate and its quality are cut to it.
2. The pair filter: both mates, as cut, need at least 15 bases, at most
   40% of their bases below Q15 and at most 5 N bases.

Kept pairs are written in their input order, each record as its name,
sequence, plus and quality lines. The overlap is a loop over offsets in
plain torch on the run's device, a block of pairs at a time; the cut, the
filter and the writer are loops over the block's pairs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hgtbench.plainref.ops.coder import _ASCII_TO_CODE, BASE_N

MIN_OVERLAP = 30      # fastp overlap_len_require
MAX_DIFF = 5          # fastp overlap_diff_limit
MAX_DIFF_PCT = 20     # fastp overlap_diff_percent_limit
QUALIFIED_PHRED = 15  # fastp qualified_quality_phred
MAX_UNQUALIFIED_PCT = 40  # fastp unqualified_percent_limit
MAX_N = 5             # fastp n_base_limit
MIN_LENGTH = 15       # fastp length_required

BLOCK_PAIRS = 1 << 16


@dataclass
class QCStats:
    pairs_in: int = 0
    pairs_out: int = 0
    adapter_trimmed: int = 0
    bases_in: int = 0
    bases_out: int = 0


def read_records(path: str) -> list:
    """The complete records of a FASTQ file, each its four lines as bytes;
    a trailing partial record is left out."""
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    n = data.count(b"\n") // 4
    return [tuple(lines[4 * i: 4 * i + 4]) for i in range(n)]


def _matrix(seqs: list, width: int) -> tuple[np.ndarray, np.ndarray]:
    """(uint8 [n, width] base codes, N past each end; int64 [n] lengths)."""
    lens = np.array([len(s) for s in seqs], np.int64)
    codes = np.full((len(seqs), width), BASE_N, np.uint8)
    codes[np.arange(width)[None, :] < lens[:, None]] = _ASCII_TO_CODE[
        np.frombuffer(b"".join(seqs), np.uint8)]
    return codes, lens


def insert_sizes(seq1: list, seq2: list, device) -> np.ndarray:
    """int64 [n]: each pair's insert by fastp's overlap rule, 0 where no
    offset is acceptable. Offset d lays read 1's base j against base j - d
    of read 2's reverse complement; the insert it implies is d + len2."""
    width = max([len(s) for s in seq1 + seq2] + [MIN_OVERLAP])
    c1, l1 = _matrix(seq1, width)
    c2, l2 = _matrix(seq2, width)
    c1 = torch.from_numpy(c1).to(device)
    len1 = torch.from_numpy(l1).to(device)[:, None]
    len2 = torch.from_numpy(l2).to(device)[:, None]
    # read 2 reverse-complemented, left-aligned: N stays N, padding stays N
    j = torch.arange(width, device=device)
    src = (len2 - 1 - j[None, :]).clamp(min=0)
    rc2 = torch.gather(torch.from_numpy(c2).to(device).long(), 1, src)
    rc2 = torch.where(rc2 < BASE_N, 3 - rc2, BASE_N)
    rc2 = torch.where(j[None, :] < len2, rc2, BASE_N).to(torch.uint8)
    best_ov = torch.zeros(len(seq1), dtype=torch.long, device=device)
    best_ins = torch.zeros(len(seq1), dtype=torch.long, device=device)
    for d in range(-(width - MIN_OVERLAP), width - MIN_OVERLAP + 1):
        lo, hi = max(0, d), min(width, width + d)
        pos = j[lo:hi][None, :]
        both = (pos < len1) & (pos - d < len2)
        ov = both.sum(dim=1)
        diff = (both & (c1[:, lo:hi] != rc2[:, lo - d: hi - d])).sum(dim=1)
        ok = ((ov >= MIN_OVERLAP) & (diff <= MAX_DIFF)
              & (100 * diff <= MAX_DIFF_PCT * ov))
        better = ok & (ov > best_ov)
        best_ov = torch.where(better, ov, best_ov)
        best_ins = torch.where(better, d + len2[:, 0], best_ins)
    return best_ins.cpu().numpy()


# the quality bytes at or above Q15, deleted to count those below it
_QUALIFIED = bytes(range(33 + QUALIFIED_PHRED, 256))


def passes(seq: list, qual: list) -> np.ndarray:
    """bool [n]: fastp's filter on each read as cut."""
    return np.array([
        len(s) >= MIN_LENGTH
        and 100 * len(q.translate(None, _QUALIFIED))
        <= MAX_UNQUALIFIED_PCT * len(q)
        and s.count(b"N") + s.count(b"n") <= MAX_N
        for s, q in zip(seq, qual)], bool)


def refine_fastq(fq1: str, fq2: str, out1: str, out2: str,
                 device) -> QCStats:
    """QC of a pair of FASTQ files into `out1`, `out2`; returns the counts
    (bases_in of the reads as read, bases_out of the kept reads as cut,
    adapter_trimmed the mates cut)."""
    r1, r2 = read_records(fq1), read_records(fq2)
    n = min(len(r1), len(r2))  # an unpaired tail is left out
    st = QCStats(pairs_in=n)
    with open(out1, "wb") as f1, open(out2, "wb") as f2:
        for a in range(0, n, BLOCK_PAIRS):
            b1, b2 = r1[a: a + BLOCK_PAIRS], r2[a: a + BLOCK_PAIRS]
            ins = insert_sizes([r[1] for r in b1], [r[1] for r in b2],
                               device)
            cut = []
            for block in (b1, b2):
                mates = []
                for r, i in zip(block, ins):
                    st.bases_in += len(r[1])
                    if 0 < i < len(r[1]):
                        st.adapter_trimmed += 1
                        r = (r[0], r[1][:i], r[2], r[3][:i])
                    mates.append(r)
                cut.append(mates)
            keep = (passes([r[1] for r in cut[0]], [r[3] for r in cut[0]])
                    & passes([r[1] for r in cut[1]], [r[3] for r in cut[1]]))
            kept = np.flatnonzero(keep)
            st.pairs_out += len(kept)
            for f, mates in ((f1, cut[0]), (f2, cut[1])):
                st.bases_out += sum(len(mates[k][1]) for k in kept)
                f.write(b"".join(b"\n".join(mates[k]) + b"\n"
                                 for k in kept))
    return st
