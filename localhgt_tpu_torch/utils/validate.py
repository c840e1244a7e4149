"""Input validation — the `check_input` equivalent.

The reference validates before launching the pipeline
(infer_HGT_breakpoint.py:123-166): required files exist, FASTQs are
uncompressed (the C++ engine byte-splits them, so gzip is rejected with a
friendly message), the reference looks like FASTA, and the output dir is
creatable. Tool-presence checks (bwa/samtools/fastp) have no analogue here —
the aligner and QC are in-process.
"""

from __future__ import annotations

import os

_GZIP_MAGIC = b"\x1f\x8b"
_BZ2_MAGIC = b"BZh"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


class InputError(ValueError):
    """A user-input problem with an actionable message (vs a raw traceback
    from deep inside the pipeline)."""


def _sniff(path: str, n: int = 4) -> bytes:
    with open(path, "rb") as f:
        return f.read(n)


def check_plain_text(path: str, kind: str) -> None:
    head = _sniff(path)
    if head[:2] == _GZIP_MAGIC or head[:3] == _BZ2_MAGIC or head == _ZSTD_MAGIC:
        raise InputError(
            f"{kind} {path!r} is compressed; decompress it first "
            "(the byte-range streaming reader needs plain text — the "
            "reference imposes the same constraint, "
            "infer_HGT_breakpoint.py:131-141)")


def check_fastq(path: str, label: str) -> None:
    if not path or not os.path.isfile(path):
        raise InputError(f"{label} file not found: {path!r}")
    if os.path.getsize(path) == 0:
        raise InputError(f"{label} file is empty: {path!r}")
    check_plain_text(path, label)
    head = _sniff(path, 1)
    if head != b"@":
        raise InputError(
            f"{label} {path!r} does not look like FASTQ "
            f"(first byte {head!r}, expected '@')")


def check_fasta(path: str) -> None:
    if not path or not os.path.isfile(path):
        raise InputError(f"reference FASTA not found: {path!r}")
    if os.path.getsize(path) == 0:
        raise InputError(f"reference FASTA is empty: {path!r}")
    check_plain_text(path, "reference FASTA")
    head = _sniff(path, 1)
    if head != b">":
        raise InputError(
            f"reference {path!r} does not look like FASTA "
            f"(first byte {head!r}, expected '>')")


def check_outdir(path: str) -> None:
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        raise InputError(f"cannot create output folder {path!r}: {e}")
    if not os.access(path, os.W_OK):
        raise InputError(f"output folder {path!r} is not writable")


def check_bkp_inputs(ref: str, fq1: str, fq2: str, outdir: str) -> None:
    """Everything `localhgt bkp` needs, checked up front
    (check_input, infer_HGT_breakpoint.py:123-166)."""
    check_fasta(ref)
    check_fastq(fq1, "--fq1")
    check_fastq(fq2, "--fq2")
    if os.path.realpath(fq1) == os.path.realpath(fq2):
        raise InputError("--fq1 and --fq2 point to the same file")
    check_outdir(outdir)


def check_event_inputs(ref: str, bkp_dir: str) -> None:
    """`localhgt event` inputs: the reference FASTA and a folder holding at
    least one *.acc.csv (read_samples, infer_HGT_event.py:73-84)."""
    check_fasta(ref)
    if not os.path.isdir(bkp_dir):
        raise InputError(f"breakpoint folder not found: {bkp_dir!r}")
    accs = [f for f in os.listdir(bkp_dir)
            if f.endswith(".acc.csv") and not f.endswith(".repeat.acc.csv")]
    if not accs:
        raise InputError(
            f"no *.acc.csv files in {bkp_dir!r}; run `localhgt bkp` first")
