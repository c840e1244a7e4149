"""Vectorized FASTQ ingestion.

Replaces the reference's per-thread byte-range FASTQ streaming
(read_fastq/get_fq_start, src/extract_ref_normal_peak.cpp:44-89,981-1107) with
chunked numpy parsing: newline offsets via flatnonzero, sequence lines gathered
into padded [B, Lmax] code batches ready for device upload. A C++ reader with
the same record-boundary re-sync trick backs this when built
(localhgt_tpu_torch/io/csrc); this module is the always-available fallback and the
correctness reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from hgtbench.plainref.ops.coder import _ASCII_TO_CODE, BASE_N


@dataclass
class ReadBatch:
    codes: np.ndarray      # uint8 [B, Lmax], padded with BASE_N
    lengths: np.ndarray    # int32 [B]
    start_ordinal: int     # ordinal of first read in the file (0-based)

    @property
    def n(self) -> int:
        return len(self.lengths)


def _line_offsets(buf: np.ndarray) -> np.ndarray:
    return np.flatnonzero(buf == 10)


def _gather_lines(buf, starts, ends, lmax):
    """Gather variable-length byte ranges into a padded uint8 code matrix."""
    lengths = (ends - starts).astype(np.int32)
    idx = starts[:, None] + np.arange(lmax, dtype=np.int64)[None, :]
    np.minimum(idx, len(buf) - 1, out=idx)
    codes = _ASCII_TO_CODE[buf[idx]]
    mask = np.arange(lmax, dtype=np.int32)[None, :] >= lengths[:, None]
    codes[mask] = BASE_N
    return codes, lengths


def iter_fastq_batches(
    path: str, batch_reads: int = 1 << 18, max_len: int = 512,
    threads: int = 4,
) -> Iterator[ReadBatch]:
    """Stream a FASTQ file as padded code batches.

    Chunked numpy parsing only (the port reads with its C++ library);
    `threads` is accepted and unused.
    """
    chunk_bytes = 1 << 26
    carry = b""
    ordinal = 0
    with open(path, "rb") as f:
        while True:
            blob = f.read(chunk_bytes)
            if not blob and not carry:
                break
            data = carry + blob
            buf = np.frombuffer(data, dtype=np.uint8)
            nl = _line_offsets(buf)
            nrec = len(nl) // 4
            if nrec == 0:
                if not blob:
                    break
                carry = data
                continue
            consumed = nl[nrec * 4 - 1] + 1
            carry = data[consumed:] if consumed < len(data) else b""
            if not blob and consumed < len(data):
                carry = b""  # trailing partial record: drop

            line_starts = np.concatenate([[0], nl[:-1] + 1])
            seq_starts = line_starts[1 : nrec * 4 : 4]
            seq_ends = nl[1 : nrec * 4 : 4]
            lmax = int(np.max(seq_ends - seq_starts)) if nrec else 0
            lmax = min(lmax, max_len)
            for lo in range(0, nrec, batch_reads):
                hi = min(lo + batch_reads, nrec)
                codes, lengths = _gather_lines(
                    buf, seq_starts[lo:hi], seq_ends[lo:hi], lmax
                )
                yield ReadBatch(codes, lengths, ordinal)
                ordinal += hi - lo
            if not blob:
                break


def count_bases(path: str) -> tuple[int, int, int]:
    """(total_bases, n_reads, first_read_len) — cal_sam_ratio (cpp:1244-1270)."""
    total = 0
    n = 0
    first_len = 0
    for batch in iter_fastq_batches(path):
        total += int(batch.lengths.sum())
        if n == 0 and batch.n:
            first_len = int(batch.lengths[0])
        n += batch.n
    return total, n, first_len


def downsample_ratio(sample: float, fq1: str) -> float:
    """Reference down-sampling semantics (cpp:1392-1398): <=1 is a proportion,
    >1 a target base count; the pair's base count is 2x fq1's."""
    if sample <= 1:
        return float(sample)
    total, _, _ = count_bases(fq1)
    total *= 2
    if total == 0:
        return 1.0
    return min(1.0, float(sample) / total)


_MAX_RANDOM_NUM = 50_000_000  # reference MAX_RANDOM_NUM (cpp:40)


def accept_mask(start_ordinal: int, n: int, ratio: float, seed: int,
                strict: bool = False) -> np.ndarray:
    """Deterministic per-read-ordinal down-sampling.

    The reference uses a pregenerated 50M-float glibc rand array indexed by
    read ordinal (get_random, cpp:1332-1340) so acceptance is independent of
    thread count. Default mode keeps the ordinal-keyed determinism with a
    counter-mode hash (splitmix64) — same property, no 200 MB side table.
    strict=True reproduces the reference array bit-for-bit (the stream state
    matching a run where the index already exists, i.e. random_coder consumed
    no rand() calls — cpp:1404-1422).
    """
    if ratio >= 1.0:
        return np.ones(n, bool)
    if strict:
        raise ValueError("the reference has no glibc rand stream "
                         "(strict_sampling)")
    # splitmix64: wrapping 64-bit arithmetic is intended; pre-mask the seed
    # offset in Python ints so no numpy *scalar* overflow warning can fire
    # (array ops wrap silently, scalar ops warn)
    seed_off = (seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = (np.arange(start_ordinal, start_ordinal + n, dtype=np.uint64)
         + np.uint64(seed_off))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53) < ratio


def paired_batches(fq1: str, fq2: str, **kw) -> Iterator[tuple[ReadBatch, ReadBatch]]:
    """Iterate both mates in lockstep (same ordinals)."""
    it1 = iter_fastq_batches(fq1, **kw)
    it2 = iter_fastq_batches(fq2, **kw)
    for b1 in it1:
        b2 = next(it2, None)
        if b2 is None:
            break
        if b2.n != b1.n:
            m = min(b1.n, b2.n)
            b1 = ReadBatch(b1.codes[:m], b1.lengths[:m], b1.start_ordinal)
            b2 = ReadBatch(b2.codes[:m], b2.lengths[:m], b2.start_ordinal)
        yield b1, b2
