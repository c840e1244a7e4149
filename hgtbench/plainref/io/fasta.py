"""FASTA ingestion into contiguous base-code arrays."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from hgtbench.plainref.ops.coder import _ASCII_TO_CODE


@dataclass
class Contigs:
    """A reference as one concatenated code array plus a contig table.

    Contig ids are 1-based to match the reference's interval/len-file
    convention (read_ref, extract_ref_normal_peak.cpp:761-831; genome.len.txt
    columns name/ref_index/len/cum_len).
    """

    names: list[str] = field(default_factory=list)
    lengths: np.ndarray = None     # int64 [n]
    offsets: np.ndarray = None     # int64 [n] start in `codes`
    codes: np.ndarray = None       # uint8 concatenated

    _name_to_id: dict = None

    def finalize(self):
        self._name_to_id = {n: i + 1 for i, n in enumerate(self.names)}
        return self

    @property
    def n(self) -> int:
        return len(self.names)

    def contig_id(self, name: str) -> int:
        return self._name_to_id[name]

    def name_of(self, cid: int) -> str:
        return self.names[cid - 1]

    def length_of(self, cid: int) -> int:
        return int(self.lengths[cid - 1])

    def contig_codes(self, cid: int) -> np.ndarray:
        o = self.offsets[cid - 1]
        return self.codes[o : o + self.lengths[cid - 1]]

    def slice_codes(self, cid: int, start: int, end: int) -> np.ndarray:
        """0-based [start, end) slice of a contig, clamped."""
        ln = self.length_of(cid)
        start = max(0, int(start))
        end = min(ln, int(end))
        if end <= start:
            return np.zeros(0, np.uint8)
        o = int(self.offsets[cid - 1])
        return self.codes[o + start : o + end]


def read_fasta(path: str) -> Contigs:
    names: list[str] = []
    parts: list[list[bytes]] = []
    current: list[bytes] | None = None
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                names.append(line[1:].split()[0].decode())
                current = []
                parts.append(current)
            elif current is not None and line:
                current.append(line)
    seqs = [b"".join(p) for p in parts]
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    offsets = np.zeros(len(seqs), dtype=np.int64)
    if len(seqs):
        offsets[1:] = np.cumsum(lengths)[:-1]
    blob = b"".join(seqs)
    codes = _ASCII_TO_CODE[np.frombuffer(blob, dtype=np.uint8)] if blob else np.zeros(0, np.uint8)
    return Contigs(names=names, lengths=lengths, offsets=offsets, codes=codes).finalize()


def write_fasta(path: str, records: list[tuple[str, str]], width: int = 80):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")
