"""Read QC, the `--refine_fq` stage (fastp with default settings), on one
device.

Port of localhgt_tpu/io/qc.py (fastp's defaults are described there):
adapter trimming by the read1 x revcomp(read2) overlap, then fastp's read
filter. The overlap scan runs on `device` as plain torch over a block of
candidate offsets at a time; like the JAX scan it keeps, per pair, the
first offset in ascending order with the largest acceptable overlap. The
host side is vectorised per batch with numpy: records stay as offsets into
the file's bytes, and kept records go out as slices of those bytes, so
the refined FASTQs are byte-identical to the JAX package's without a
Python loop over every record.

Spans (utils/metrics.span), none inside another, all inside the caller's
`qc` stage: `qc.parse` (each advance of the batch reader), `qc.encode`
(both mates' codes), `qc.overlap` (the uploads, the scan on `device` and
the copy back of the inserts, its wait on the device included),
`qc.filter` (the trims, fastp's filter and the counts) and `qc.write`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from localhgt_tpu_torch.ops.coder import _ASCII_TO_CODE
from localhgt_tpu_torch.utils import metrics

OVERLAP_REQUIRE = 30      # fastp overlap_len_require
OVERLAP_DIFF_LIMIT = 5    # fastp overlap_diff_limit
OVERLAP_DIFF_PCT = 0.2    # fastp overlap_diff_percent_limit
QUALIFIED_PHRED = 15      # fastp qualified_quality_phred
UNQUALIFIED_PCT = 0.4     # fastp unqualified_percent_limit (40%)
N_BASE_LIMIT = 5          # fastp n_base_limit
LENGTH_REQUIRED = 15      # fastp length_required

BLOB_BYTES = 1 << 26      # bytes read from a FASTQ file at a time
BATCH_PAIRS = 1 << 15     # read pairs per overlap scan
SCAN_ELEMENTS = 1 << 26   # [pairs, offsets, width] elements per scan block


@dataclass
class QCStats:
    pairs_in: int = 0
    pairs_out: int = 0
    adapter_trimmed: int = 0
    bases_in: int = 0
    bases_out: int = 0
    batches: int = 0         # overlap scans run
    overlap_blocks: int = 0  # blocks of offsets the scans looped over
    overlap_cells: int = 0   # pairs x offsets x width the scans compared


def _offset_blocks(B: int, L: int) -> range:
    """The first offset of each block of candidate offsets that the
    overlap scan of B pairs at width L loops over: offsets -(L - 30) to
    L - 30, `step` a block, so that a block holds at most SCAN_ELEMENTS
    [pairs, offsets, width] elements."""
    span = L - OVERLAP_REQUIRE
    return range(-span, span + 1, max(1, SCAN_ELEMENTS // max(1, B * L)))


def _overlap_insert(codes1: torch.Tensor, len1: torch.Tensor,
                    codes2: torch.Tensor, len2: torch.Tensor) -> torch.Tensor:
    """Per-pair insert-size estimate from the read1 x revcomp(read2)
    overlap (localhgt_tpu/io/qc.py::_overlap_insert with max_len = the
    codes' width L).

    codes uint8 [B, L] (4 = N/pad), lengths int32 [B], on one device.
    Returns int32 [B]: the implied insert length, or 0 when no acceptable
    overlap exists."""
    B, L = codes1.shape
    dev = codes1.device
    j = torch.arange(L, device=dev)
    c1 = codes1.to(torch.int16)
    l1 = len1.long()[:, None]
    l2 = len2.long()[:, None]
    # revcomp read2, left-aligned
    idx = l2 - 1 - j[None, :]
    rc2 = torch.gather(codes2.to(torch.int16), 1, idx.clamp(0, L - 1))
    rc2 = torch.where(idx >= 0, rc2, 4)
    rc2 = torch.where(rc2 < 4, 3 - rc2, 4)
    # window s of the padded rows is read2 shifted right by d = L - s:
    # rc2w[:, s, j] = rc2[j - d], ok2w[:, s, j] = 0 <= j - d < len2
    rc2w = torch.nn.functional.pad(rc2, (L, L), value=4).unfold(1, L, 1)
    ok2w = torch.nn.functional.pad(j[None, :] < l2, (L, L)).unfold(1, L, 1)
    valid1 = (j[None, :] < l1)[:, None, :]

    best_ov = torch.zeros(B, dtype=torch.long, device=dev)
    best_ins = torch.zeros(B, dtype=torch.long, device=dev)
    blocks = _offset_blocks(B, L)
    for lo in blocks:
        d = torch.arange(lo, min(lo + blocks.step, blocks.stop), device=dev)
        s = L - d
        both = valid1 & ok2w[:, s, :]
        mism = (both & (c1[:, None, :] != rc2w[:, s, :])).sum(dim=2)
        # |{j : j < len1, 0 <= j - d < len2}|
        ov = (torch.minimum(l1, l2 + d[None, :])
              - d.clamp(min=0)[None, :]).clamp(min=0)
        lim = torch.clamp(
            (ov.to(torch.float32) * OVERLAP_DIFF_PCT).to(torch.long),
            max=OVERLAP_DIFF_LIMIT)
        ok = (ov >= OVERLAP_REQUIRE) & (mism <= lim)
        # the first offset of the block with the largest overlap; an
        # earlier block keeps a tie
        m, arg = torch.where(ok, ov, 0).max(dim=1)
        take = m > best_ov
        best_ins = torch.where(take, d[arg] + l2[:, 0], best_ins)
        best_ov = torch.where(take, m, best_ov)
    return torch.where(best_ov >= OVERLAP_REQUIRE, best_ins, 0).to(
        torch.int32)


@dataclass
class _Records:
    """Complete FASTQ records: bytes holding them and the [start, end) of
    each of their four lines in those bytes (end = the newline's offset)."""

    buf: np.ndarray    # uint8
    start: np.ndarray  # int64 [n, 4]
    end: np.ndarray    # int64 [n, 4]

    def __len__(self) -> int:
        return len(self.start)

    def split(self, n: int) -> tuple["_Records", "_Records"]:
        return (_Records(self.buf, self.start[:n], self.end[:n]),
                _Records(self.buf, self.start[n:], self.end[n:]))

    @staticmethod
    def concat(parts) -> "_Records":
        """One _Records of the parts in order; copies only their bytes."""
        parts = [p for p in parts if len(p)]
        if not parts:
            empty = np.zeros((0, 4), np.int64)
            return _Records(np.zeros(0, np.uint8), empty, empty)
        if len(parts) == 1:
            return parts[0]
        bufs, starts, ends, off = [], [], [], 0
        for p in parts:
            lo, hi = int(p.start[0, 0]), int(p.end[-1, 3]) + 1
            bufs.append(p.buf[lo:hi])
            starts.append(p.start - lo + off)
            ends.append(p.end - lo + off)
            off += hi - lo
        return _Records(np.concatenate(bufs), np.concatenate(starts),
                        np.concatenate(ends))

    def line_len(self, k: int) -> np.ndarray:
        return self.end[:, k] - self.start[:, k]

    def line_bytes(self, k: int, width: int) -> np.ndarray:
        """uint8 [len, width]: `width` bytes from the start of line k of
        every record (past the line's end, whatever follows it), gathered
        one row at a time from a sliding-window view of the bytes."""
        width = max(width, 1)
        buf = self.buf
        need = int(self.start[:, k].max(initial=0)) + width - len(buf)
        if need > 0:
            buf = np.concatenate([buf, np.zeros(need, np.uint8)])
        return np.lib.stride_tricks.sliding_window_view(buf, width)[
            self.start[:, k]]


def _records(path: str):
    """Yield the complete records of a FASTQ file, one _Records per blob
    of BLOB_BYTES; a trailing partial record is dropped, as in the JAX
    package's reader."""
    carry = b""
    with open(path, "rb") as f:
        while True:
            blob = f.read(BLOB_BYTES)
            if not blob and not carry:
                return
            data = carry + blob
            buf = np.frombuffer(data, dtype=np.uint8)
            nl = np.flatnonzero(buf == 10)
            nrec = len(nl) // 4
            if nrec == 0:
                if not blob:
                    return
                carry = data
                continue
            consumed = int(nl[nrec * 4 - 1]) + 1
            carry = data[consumed:] if blob and consumed < len(data) else b""
            end = nl[: nrec * 4].astype(np.int64)
            start = np.concatenate([[0], end[:-1] + 1])
            yield _Records(buf, start.reshape(nrec, 4), end.reshape(nrec, 4))
            if not blob:
                return


def _read_batches(path1: str, path2: str, batch: int = BATCH_PAIRS):
    """Yield paired (_Records, _Records) batches of at most `batch`
    records, strictly in record order. Records are buffered across blob
    boundaries, so R1/R2 stay paired when the two files' record byte sizes
    differ; an unpaired tail of either file is dropped."""
    it1, it2 = _records(path1), _records(path2)
    b1 = b2 = _Records.concat([])
    done1 = done2 = False
    while True:
        while len(b1) < batch and not done1:
            chunk = next(it1, None)
            done1 = chunk is None
            if chunk is not None:
                b1 = _Records.concat([b1, chunk])
        while len(b2) < batch and not done2:
            chunk = next(it2, None)
            done2 = chunk is None
            if chunk is not None:
                b2 = _Records.concat([b2, chunk])
        n = min(len(b1), len(b2), batch)
        if n == 0:
            return
        h1, b1 = b1.split(n)
        h2, b2 = b2.split(n)
        yield h1, h2


def _prefix(n: np.ndarray, width: int) -> np.ndarray:
    """bool [len(n), width]: column j < n[i]."""
    return np.arange(width)[None, :] < n[:, None]


def _passes(seq: np.ndarray, qual: np.ndarray, seq_len: np.ndarray,
            qual_len: np.ndarray) -> np.ndarray:
    """fastp's default read filter (length, quality, N bases) over the
    first seq_len bytes of `seq` and qual_len bytes of `qual` (rows of
    line_bytes): qc.py::_passes of each trimmed record, one bool each."""
    low = np.count_nonzero((qual < 33 + QUALIFIED_PHRED)
                           & _prefix(qual_len, qual.shape[1]), axis=1)
    low_frac = low / np.maximum(qual_len, 1)
    n_bases = np.count_nonzero(((seq == ord("N")) | (seq == ord("n")))
                               & _prefix(seq_len, seq.shape[1]), axis=1)
    return ((seq_len >= LENGTH_REQUIRED)
            & ~((qual_len > 0) & (low_frac > UNQUALIFIED_PCT))
            & (n_bases <= N_BASE_LIMIT))


def _write_records(f, rec: _Records, keep: np.ndarray, seq_len: np.ndarray,
                   qual_len: np.ndarray) -> None:
    """Write the kept records with their sequence and quality lines cut to
    seq_len and qual_len. A run of uncut records that lie back to back in
    the bytes goes out as one slice; a cut record goes out line by line."""
    idx = np.flatnonzero(keep)
    if not len(idx):
        return
    cut = ((seq_len[idx] != rec.line_len(1)[idx])
           | (qual_len[idx] != rec.line_len(3)[idx]))
    first, last = rec.start[idx, 0], rec.end[idx, 3] + 1
    brk = np.ones(len(idx), bool)
    brk[1:] = cut[1:] | cut[:-1] | (first[1:] != last[:-1])
    runs = np.flatnonzero(brk)
    buf = rec.buf
    for a, b in zip(runs, np.append(runs[1:], len(idx)) - 1):
        if not cut[a]:
            f.write(buf[first[a]:last[b]])
            continue
        i = idx[a]
        s0, s1, s2, s3 = rec.start[i]
        f.write(buf[s0:s1 + seq_len[i]])  # name line, cut sequence
        f.write(b"\n")
        f.write(buf[s2:s3 + qual_len[i]])  # plus line, cut quality
        f.write(b"\n")


def refine_fastq(fq1: str, fq2: str, out1: str, out2: str, device,
                 batch: int = BATCH_PAIRS) -> QCStats:
    """fastp-default QC: adapter-trim by PE overlap + pair filtering, the
    overlap scan on `device`. Writes the refined pair files (the reference
    names them `<sample>_refined_{1,2}.fq`) and returns QCStats."""
    st = QCStats()
    with open(out1, "wb") as f1, open(out2, "wb") as f2:
        for r1, r2 in metrics.spanned("qc.parse",
                                      _read_batches(fq1, fq2, batch)):
            with metrics.span("qc.encode"):
                width = max(int(r1.line_len(1).max()),
                            int(r2.line_len(1).max()), 1)
                width = -(-width // 32) * 32
                mates = []
                for rec in (r1, r2):
                    ln = rec.line_len(1)
                    seq = rec.line_bytes(1, width)
                    codes = np.where(_prefix(ln, width),
                                     _ASCII_TO_CODE[seq], 4)
                    mates.append((rec, ln, seq, codes.astype(np.uint8)))
            with metrics.span("qc.overlap"):
                ins = _overlap_insert(*(
                    torch.from_numpy(a).to(device)
                    for _, ln, _, codes in mates
                    for a in (codes, ln.astype(np.int32)))).cpu().numpy()
            with metrics.span("qc.filter"):
                st.pairs_in += len(r1)
                st.batches += 1
                blocks = _offset_blocks(len(r1), width)
                st.overlap_blocks += len(blocks)
                st.overlap_cells += (len(r1) * width
                                     * (blocks.stop - blocks.start))
                keep = np.ones(len(r1), bool)
                cut = []
                for rec, ln, seq, _ in mates:
                    trim = (ins > 0) & (ins < ln)
                    st.adapter_trimmed += int(trim.sum())
                    seq_len = np.where(trim, ins, ln)
                    qual_len = np.where(trim,
                                        np.minimum(rec.line_len(3), ins),
                                        rec.line_len(3))
                    qual = rec.line_bytes(3, int(qual_len.max()))
                    keep &= _passes(seq, qual, seq_len, qual_len)
                    cut.append((seq_len, qual_len))
                    st.bases_in += int(ln.sum())
                st.pairs_out += int(keep.sum())
                st.bases_out += sum(int(seq_len[keep].sum())
                                    for seq_len, _ in cut)
            with metrics.span("qc.write"):
                for f, rec, (seq_len, qual_len) in ((f1, r1, cut[0]),
                                                    (f2, r2, cut[1])):
                    _write_records(f, rec, keep, seq_len, qual_len)
    return st
