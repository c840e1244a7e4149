"""The benchmark's sample generator: a frozen copy of the port's
sim/simulate.py (upstream's paper_results/simulation.py recipe: HGTs of
500-55,000 bp implanted first, half reversed, donor kept, then SNPs and
indels, then paired-end reads with a HiSeq-like quality profile), with one
change: the FASTQ and FASTA writers build each contig's records as one
byte array instead of one Python string a read. The files are byte-equal
to the port's `simulate_sample` on the same parameters and seed
(tests/test_hgtbench_sim.py holds that).

`make_reference` and `make_sample` split `simulate_sample` in two, so a
cohort shares one reference: the reference from one seed, each sample's
HGTs, mutations and reads from a seed of its own. `Planting` rewrites a
share of a sample's pairs into what QC (`bkp --refine_fq 1`) is there to
find: inserts shorter than the reads, and quality that fastp drops.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def revcomp(seq: str) -> str:
    return seq[::-1].translate(str.maketrans("ACGTacgt", "TGCAtgca"))


@dataclass
class SimParams:
    """The port's SimParams, field for field."""

    n_genomes: int = 20
    genome_len: int = 120_000
    hgt_num: int = 10
    snp_rate: float = 0.01
    indel_rate: float = 0.001
    depth: float = 10.0
    read_len: int = 150
    mean_frag: int = 350
    frag_sd: int = 10
    seq_error: float = 0.002
    min_hgt_len: int = 500
    max_hgt_len: int = 55_000
    donor_in: bool = True
    reverse_prob: float = 0.5
    seed: int = 0


@dataclass
class TruthEvent:
    receptor: str
    insert_locus: int
    donor: str
    seg_start: int
    seg_end: int
    reverse: bool


def random_genomes(pa: SimParams, rng, lengths=None) -> dict[str, str]:
    """pa.n_genomes random genomes of 0.8-1.2 x pa.genome_len, or of the
    given `lengths` (then no length is drawn from `rng`)."""
    out = {}
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    for i in range(pa.n_genomes):
        if lengths is None:
            ln = int(pa.genome_len * (0.8 + 0.4 * rng.random()))
        else:
            ln = int(lengths[i])
        seq = lut[rng.integers(0, 4, ln)].tobytes().decode()
        out[f"G{i:03d}_1"] = seq
    return out


def implant_hgts(genomes: dict[str, str], pa: SimParams, rng,
                 seg_fracs=None):
    """(edited genomes, truth list); one HGT per involved contig. With
    `seg_fracs` (pa.hgt_num numbers in [0, 1)), the k-th HGT's length is
    not drawn but takes the fraction seg_fracs[k] of the range the draw
    would have had."""
    new = dict(genomes)
    names = list(genomes)
    used: set[str] = set()
    truth: list[TruthEvent] = []
    tries = 0
    while len(truth) < pa.hgt_num and tries < 10_000:
        tries += 1
        a, b = rng.choice(len(names), 2, replace=False)
        rec, don = names[a], names[b]
        if rec in used or don in used:
            continue
        rec_seq, don_seq = new[rec], new[don]
        max_len = min(pa.max_hgt_len, len(don_seq) - 1200)
        if max_len <= pa.min_hgt_len + 1:
            continue
        if seg_fracs is None:
            seg_len = int(rng.integers(pa.min_hgt_len + 100, max_len))
        else:
            lo = pa.min_hgt_len + 100
            seg_len = lo + int(seg_fracs[len(truth)] * (max_len - lo))
        s = int(rng.integers(500, len(don_seq) - seg_len - 500))
        e = s + seg_len
        locus = int(rng.integers(500, len(rec_seq) - 500))
        seg = don_seq[s:e]
        rev = bool(rng.random() < pa.reverse_prob)
        if rev:
            seg = revcomp(seg)
        new[rec] = rec_seq[:locus] + seg + rec_seq[locus:]
        if pa.donor_in:
            new[don] = don_seq[:s] + don_seq[e:]
        else:
            del new[don]
        used.update((rec, don))
        truth.append(TruthEvent(rec, locus, don, s, e, rev))
    return new, truth


def mutate(seq: str, pa: SimParams, rng) -> str:
    """SNPs then indels at the configured rates."""
    arr = np.frombuffer(seq.encode(), dtype=np.uint8).copy()
    n_snp = int(len(arr) * pa.snp_rate)
    if n_snp:
        pos = rng.choice(len(arr), n_snp, replace=False)
        shift = rng.integers(1, 4, n_snp).astype(np.uint8)
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        inv = np.zeros(256, np.uint8)
        inv[lut] = np.arange(4)
        arr[pos] = lut[(inv[arr[pos]] + shift) % 4]
    n_ind = int(len(arr) * pa.indel_rate)
    if n_ind:
        s = arr.tobytes().decode()
        pieces = []
        last = 0
        luts = "ACGT"
        for p in sorted(rng.choice(len(s) - 1, n_ind, replace=False).tolist()):
            pieces.append(s[last:p])
            if rng.random() < 0.5:
                last = p + 1  # deletion
            else:
                pieces.append(luts[int(rng.integers(0, 4))])  # insertion
                last = p
        pieces.append(s[last:])
        return "".join(pieces)
    return arr.tobytes().decode()


_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTacgtN", b"TGCAtgcaN"):
    _COMP[_a] = _b
_BASE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _cycle_qualities(n: int, read_len: int, rng) -> np.ndarray:
    cyc = 38.0 - 8.0 * (np.arange(read_len) / max(read_len - 1, 1)) ** 2
    q = cyc[None, :] + rng.normal(0.0, 2.0, (n, read_len))
    return np.clip(q, 2, 40).astype(np.uint8)


def _quality_error_mask(quals: np.ndarray, mean_error: float, rng):
    p = 10.0 ** (-quals.astype(np.float64) / 10.0)
    scale = mean_error / max(p.mean(), 1e-12)
    return rng.random(quals.shape) < p * scale


def synthesize_reads(genomes: dict[str, str], pa: SimParams, rng):
    """Uniform-coverage paired-end reads, one contig at a time, drawn from
    `rng` in the port's order. Yields (chrom, starts int64 [n], mate 1 and
    mate 2 bases uint8 [n, L], their quality bytes uint8 [n, L])."""
    L = pa.read_len
    for chrom, seq in genomes.items():
        n = int(len(seq) * pa.depth / (2 * L))
        if n == 0 or len(seq) < pa.mean_frag + 20:
            continue
        arr = np.frombuffer(seq.encode(), dtype=np.uint8)
        frags = rng.normal(pa.mean_frag, pa.frag_sd, n).astype(int)
        np.clip(frags, L + 2, min(len(seq) - 1, 2 * pa.mean_frag), out=frags)
        starts = rng.integers(0, len(seq) - frags, n)
        j = np.arange(L)
        fwd = arr[starts[:, None] + j[None, :]]
        ends = starts + frags
        rev = _COMP[arr[ends[:, None] - 1 - j[None, :]]]
        swap = rng.random(n) < 0.5
        m1 = np.where(swap[:, None], rev, fwd)
        m2 = np.where(swap[:, None], fwd, rev)
        if pa.seq_error > 0:
            q1 = _cycle_qualities(n, L, rng)
            q2 = _cycle_qualities(n, L, rng)
            e1 = _quality_error_mask(q1, pa.seq_error, rng)
            e2 = _quality_error_mask(q2, pa.seq_error, rng)
            inv = np.zeros(256, np.uint8)
            inv[_BASE_LUT] = np.arange(4)
            m1 = np.where(e1, _BASE_LUT[(inv[m1] + rng.integers(1, 4, (n, L))) % 4], m1)
            m2 = np.where(e2, _BASE_LUT[(inv[m2] + rng.integers(1, 4, (n, L))) % 4], m2)
        else:
            q1 = q2 = np.full((n, L), 40, np.uint8)
        yield (chrom, starts, m1.astype(np.uint8), m2.astype(np.uint8),
               (q1 + 33).astype(np.uint8), (q2 + 33).astype(np.uint8))


# Illumina's adapters as read 1 and read 2 read into them (chip_smoke.py's)
ADAPTER_R1 = np.frombuffer(b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA", np.uint8)
ADAPTER_R2 = np.frombuffer(b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT", np.uint8)
LOW_PHRED = 2  # a collapsed quality tail, '#'


@dataclass
class Planting:
    """What QC is there to find, planted into raw pairs, in every chunk of
    n pairs: round(adapter_frac x n) pairs whose insert is shorter than the
    reads (adapter_insert bp, both ends included), so that both mates read
    through it into their adapter; and round(lowq_frac x n) other pairs
    whose read 2 falls to Q2 over its second half, more than fastp lets
    pass. Names and the pair count stay as they are."""

    adapter_frac: float = 0.0
    adapter_insert: tuple = (0, 0)
    lowq_frac: float = 0.0

    @classmethod
    def of(cls, traffic: dict):
        """The traffic's planting (keys adapter_frac with adapter_insert as
        "lo-hi", lowq_frac), or None where it plants nothing."""
        p = cls(adapter_frac=float(traffic.get("adapter_frac", 0)),
                lowq_frac=float(traffic.get("lowq_frac", 0)))
        if p.adapter_frac:
            lo, hi = (int(x) for x in traffic["adapter_insert"].split("-"))
            p.adapter_insert = (lo, hi)
        return p if p.adapter_frac or p.lowq_frac else None

    def apply(self, parts: list, rng) -> None:
        """Plants into the (chrom, starts, m1, m2, q1, q2) of one chunk's
        contigs (`synthesize_reads`' items), in place, drawing from `rng`."""
        sizes = np.cumsum([0] + [len(p[1]) for p in parts])
        n = int(sizes[-1])
        n_ad = int(round(self.adapter_frac * n))
        n_lq = int(round(self.lowq_frac * n))
        if n_ad + n_lq > n:
            raise ValueError(f"cannot plant {n_ad + n_lq} of {n} pairs")
        rows = rng.choice(n, n_ad + n_lq, replace=False)
        part = np.searchsorted(sizes, rows, side="right") - 1
        row = rows - sizes[part]
        lo, hi = self.adapter_insert
        inserts = rng.integers(lo, hi + 1, n_ad)
        for k in range(n_ad):
            _, _, m1, m2, _, _ = parts[part[k]]
            L = m1.shape[1]
            if not 0 < inserts[k] < L:
                raise ValueError(f"insert {inserts[k]} is no shorter than "
                                 f"the {L} bp reads")
            ins = m1[row[k], : inserts[k]].copy()
            tail = _BASE_LUT[rng.integers(0, 4, L)]
            m1[row[k]] = np.concatenate([ins, ADAPTER_R1, tail])[:L]
            m2[row[k]] = np.concatenate([_COMP[ins[::-1]], ADAPTER_R2,
                                         tail])[:L]
        for k in range(n_ad, n_ad + n_lq):
            q2 = parts[part[k]][5]
            q2[row[k], q2.shape[1] // 2:] = 33 + LOW_PHRED


def fastq_records(chrom: str, starts: np.ndarray, seqs: np.ndarray,
                  quals: np.ndarray) -> bytes:
    """The bytes of "@<chrom>-<start>-<i>\\n<seq>\\n+\\n<qual>\\n" for every
    read i of one contig, built as one array: each row holds its name,
    newline, sequence, "\\n+\\n", quality and newline, with the name's
    padding masked out."""
    n, L = seqs.shape
    names = np.char.add(np.char.add(f"@{chrom}-", starts.astype(str)),
                        np.char.add("-", np.arange(n).astype(str)))
    nlen = np.char.str_len(names)
    W = int(nlen.max()) + 1
    head = np.zeros((n, W), np.uint8)
    head[:, : W - 1] = np.frombuffer(names.astype(f"S{W - 1}").tobytes(),
                                     np.uint8).reshape(n, W - 1)
    head[np.arange(n), nlen] = 10
    rec = np.empty((n, W + 2 * L + 4), np.uint8)
    rec[:, :W] = head
    rec[:, W : W + L] = seqs
    rec[:, W + L : W + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, W + L + 3 : W + 2 * L + 3] = quals
    rec[:, W + 2 * L + 3] = 10
    keep = np.ones(rec.shape, bool)
    keep[:, :W] = np.arange(W)[None, :] <= nlen[:, None]
    return rec[keep].tobytes()


def write_fasta(path: str, records, width: int = 80) -> None:
    """The port's write_fasta, each sequence's lines built as one array."""
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(f">{name}\n".encode())
            b = np.frombuffer(seq.encode(), np.uint8)
            full = len(b) // width * width
            rows = np.empty((len(b) // width, width + 1), np.uint8)
            rows[:, :width] = b[:full].reshape(-1, width)
            rows[:, width] = 10
            f.write(rows.tobytes())
            if full < len(b):
                f.write(b[full:].tobytes() + b"\n")


def write_truth(path: str, truth: list[TruthEvent]) -> None:
    with open(path, "w") as f:
        for t in truth:
            f.write(
                f"{t.receptor} {t.insert_locus} {t.donor} {t.seg_start} "
                f"{t.seg_end} {t.reverse}\n"
            )


def read_truth(path: str) -> list[TruthEvent]:
    out = []
    with open(path) as f:
        for line in f:
            a = line.split()
            if len(a) >= 6:
                out.append(TruthEvent(a[0], int(a[1]), a[2], int(a[3]),
                                      int(a[4]), a[5] in ("True", "true", "1")))
    return out


def make_reference(outdir: str, sample: str, pa: SimParams, rng,
                   lengths=None):
    """The reference genomes from `rng` (of the given `lengths`, if any),
    written to <sample>.ref.fa. Returns (genomes, ref_path)."""
    os.makedirs(outdir, exist_ok=True)
    genomes = random_genomes(pa, rng, lengths)
    ref_path = os.path.join(outdir, f"{sample}.ref.fa")
    write_fasta(ref_path, list(genomes.items()))
    return genomes, ref_path


def make_sample(outdir: str, sample: str, pa: SimParams,
                genomes: dict[str, str], rng):
    """One sample against `genomes`: HGTs, mutations and reads from `rng`.
    Returns (fq1, fq2, truth_path, n_pairs)."""
    edited, truth = implant_hgts(genomes, pa, rng)
    edited = {c: mutate(s, pa, rng) for c, s in edited.items()}
    truth_path = os.path.join(outdir, f"{sample}.true.sv.txt")
    write_truth(truth_path, truth)
    fq1 = os.path.join(outdir, f"{sample}.1.fq")
    fq2 = os.path.join(outdir, f"{sample}.2.fq")
    n_pairs = 0
    with open(fq1, "wb") as f1, open(fq2, "wb") as f2:
        for chrom, starts, m1, m2, q1, q2 in synthesize_reads(edited, pa, rng):
            f1.write(fastq_records(chrom, starts, m1, q1))
            f2.write(fastq_records(chrom, starts, m2, q2))
            n_pairs += len(starts)
    return fq1, fq2, truth_path, n_pairs


def simulate_sample(outdir: str, sample: str, pa: SimParams):
    """The port's simulate_sample (reference drawn from the same rng as the
    sample), for the byte-equality test. Returns (ref, fq1, fq2, truth)."""
    rng = np.random.default_rng(pa.seed)
    genomes, ref_path = make_reference(outdir, sample, pa, rng)
    fq1, fq2, truth_path, _ = make_sample(outdir, sample, pa, genomes, rng)
    return ref_path, fq1, fq2, truth_path
