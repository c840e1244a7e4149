"""Persistent reference index.

The reference's index (<ref>.k32.h3.index.dat) stores 4 bytes per position per
hash function — ~12x the FASTA size — because recomputing hashes costs k scalar
ops per position (read_ref, src/extract_ref_normal_peak.cpp:727-886; cost noted
at README.md:125-126, "a few hours" for UHGG). The bit-sliced hasher
(localhgt_tpu_torch.ops.encode) makes re-hashing as cheap as streaming, so this
index stores only the 2-bit packed sequence (+ N positions + contig table):
~ref_size/4 bytes, built at I/O speed, hash-seed independent. It also emits a
`<ref>.genome.len.txt` identical in format to the reference's
(name / 1-based index / len / cumulative len) for interoperability.
"""

from __future__ import annotations

import json
import os

import numpy as np

from localhgt_tpu_torch.io import fasta

INDEX_SUFFIX = ".lht.idx.npz"
VERSION = 1


def index_path(ref_path: str) -> str:
    return ref_path + INDEX_SUFFIX


def build(ref_path: str, force: bool = False) -> fasta.Contigs:
    """Build (or load cached) index for a reference FASTA."""
    ipath = index_path(ref_path)
    if not force and os.path.exists(ipath) and os.path.getmtime(ipath) >= os.path.getmtime(ref_path):
        return load(ref_path)
    contigs = fasta.read_fasta(ref_path)
    n = len(contigs.codes)
    is_n = contigs.codes >= 4
    codes2 = np.where(is_n, 0, contigs.codes).astype(np.uint8)
    pad = (-n) % 4
    if pad:
        codes2 = np.concatenate([codes2, np.zeros(pad, np.uint8)])
    packed = (
        codes2[0::4] | (codes2[1::4] << 2) | (codes2[2::4] << 4) | (codes2[3::4] << 6)
    )
    np.savez_compressed(
        ipath,
        version=np.int64(VERSION),
        names=json.dumps(contigs.names),
        lengths=contigs.lengths,
        offsets=contigs.offsets,
        packed=packed,
        total=np.int64(n),
        n_positions=np.flatnonzero(is_n).astype(np.int64),
    )
    write_len_file(ref_path, contigs)
    return contigs


def write_len_file(ref_path: str, contigs: fasta.Contigs):
    """genome.len.txt format parity (read_ref, cpp:773)."""
    cum = 0
    with open(ref_path + ".genome.len.txt", "w") as f:
        for i, name in enumerate(contigs.names):
            ln = int(contigs.lengths[i])
            cum += ln
            f.write(f"{name}\t{i + 1}\t{ln}\t{cum}\n")


def load(ref_path: str) -> fasta.Contigs:
    with np.load(index_path(ref_path)) as z:
        names = json.loads(str(z["names"]))
        lengths = z["lengths"]
        offsets = z["offsets"]
        packed = z["packed"]
        total = int(z["total"])
        n_positions = z["n_positions"]
    codes = np.zeros(len(packed) * 4, dtype=np.uint8)
    codes[0::4] = packed & 3
    codes[1::4] = (packed >> 2) & 3
    codes[2::4] = (packed >> 4) & 3
    codes[3::4] = (packed >> 6) & 3
    codes = codes[:total]
    codes[n_positions] = 4
    return fasta.Contigs(
        names=names, lengths=lengths, offsets=offsets, codes=codes
    ).finalize()
