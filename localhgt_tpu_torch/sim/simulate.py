"""HGT truth-sample simulator.

Re-implements the recipe of the reference's paper harness
(paper_results/simulation.py): pick contig pairs from different species,
transplant a random 500-55,000 bp donor segment into the recipient (50%
reverse-complemented, donor optionally retained with the segment deleted),
add SNPs and indels, then synthesize paired-end reads at a target depth.
Truth is written in the same `<sample>.true.sv.txt` format
(simulation.py:201-270: recipient, insert_locus, donor, seg_start, seg_end,
reverse_flag) so the evaluator is interchangeable.

Reads are generated with a vectorized uniform-coverage Illumina-like model
(art_illumina is not available in this environment; simulation.py:280-306
shells out to it). Base qualities follow an HiSeq-style per-cycle profile
(high at the 5' end, decaying toward the 3' end, per-base jitter) and the
substitution-error probability at each base is derived from its emitted
quality, scaled so the mean error rate equals `seq_error` — i.e. errors and
quality strings are consistent, like art's empirical profiles. Genomes can
be synthetic random sequences (for unit fixtures) or loaded from a FASTA.

Ordering note (truth-coordinate correctness): HGTs are implanted FIRST and
SNPs/indels applied to the whole edited genomes AFTERWARD — exactly the
reference harness's ordering (random_HGT implants at simulation.py:209-258,
then add_snp/add_indel at :260-265, truth written pre-mutation at :255-256).
Truth coordinates live in the UN-mutated reference space and the pipeline
aligns reads against the un-mutated reference FASTA, so sample-side indels
cannot shift them: an indel between a read's start and the junction costs
the aligner a 1-2 bp gap, not a coordinate change.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from localhgt_tpu_torch.io import fasta
from localhgt_tpu_torch.ops import coder


def revcomp(seq: str) -> str:
    return seq[::-1].translate(str.maketrans("ACGTacgt", "TGCAtgca"))


@dataclass
class SimParams:
    """Defaults follow the species20 smoke fixture (README.md:57-63,
    simulation.py Parameters:819-891): 20 genomes, 20 HGT events, snp 0.01,
    depth 5-30, 150 bp reads, 350 bp fragments."""

    n_genomes: int = 20
    genome_len: int = 120_000
    hgt_num: int = 10
    snp_rate: float = 0.01
    indel_rate: float = 0.001   # snp/10 (simulation.py Parameters)
    depth: float = 10.0
    read_len: int = 150
    mean_frag: int = 350
    frag_sd: int = 10
    seq_error: float = 0.002
    min_hgt_len: int = 500
    max_hgt_len: int = 55_000
    donor_in: bool = True       # donor genome retained in the sample
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


def random_genomes(pa: SimParams, rng) -> dict[str, str]:
    """Synthetic species: 'G<i>_1' so genome-of-contig = name minus last '_'
    field (infer_HGT_event.py:38-39 convention)."""
    out = {}
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    for i in range(pa.n_genomes):
        ln = int(pa.genome_len * (0.8 + 0.4 * rng.random()))
        seq = lut[rng.integers(0, 4, ln)].tobytes().decode()
        out[f"G{i:03d}_1"] = seq
    return out


def implant_hgts(genomes: dict[str, str], pa: SimParams, rng):
    """Returns (edited genomes, truth list). Mirrors random_HGT
    (simulation.py:201-270): one HGT per involved contig, segment bounds at
    least 500 from the ends."""
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
        seg_len = int(rng.integers(pa.min_hgt_len + 100, max_len))
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
    """SNPs then indels at the configured rates (simulation.py:29-73)."""
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
    """HiSeq-style per-cycle quality profile: ~Q38 at the 5' end decaying
    quadratically toward ~Q30 at the 3' end, with per-base jitter — the
    shape of art_illumina's HS25 empirical profile (simulation.py:280-306
    uses `art_illumina -ss HS25`)."""
    cyc = 38.0 - 8.0 * (np.arange(read_len) / max(read_len - 1, 1)) ** 2
    q = cyc[None, :] + rng.normal(0.0, 2.0, (n, read_len))
    return np.clip(q, 2, 40).astype(np.uint8)


def _quality_error_mask(quals: np.ndarray, mean_error: float, rng):
    """Per-base substitution mask whose probability follows the emitted
    qualities (p = 10^(-q/10)), rescaled so the mean equals `mean_error` —
    errors and quality strings stay mutually consistent."""
    p = 10.0 ** (-quals.astype(np.float64) / 10.0)
    scale = mean_error / max(p.mean(), 1e-12)
    return rng.random(quals.shape) < p * scale


def synthesize_reads(genomes: dict[str, str], pa: SimParams, rng):
    """Uniform-coverage paired-end reads, fully vectorized per contig.

    Returns (reads1, reads2) as lists of (name, seq, qual) with mate1/mate2
    orientation FR like Illumina."""
    r1, r2 = [], []
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
            # substitute with a *different* base so the realized error rate
            # equals the target
            m1 = np.where(e1, _BASE_LUT[(inv[m1] + rng.integers(1, 4, (n, L))) % 4], m1)
            m2 = np.where(e2, _BASE_LUT[(inv[m2] + rng.integers(1, 4, (n, L))) % 4], m2)
        else:
            q1 = q2 = np.full((n, L), 40, np.uint8)
        qa1 = (q1 + 33).astype(np.uint8)
        qa2 = (q2 + 33).astype(np.uint8)
        for i in range(n):
            name = f"{chrom}-{starts[i]}-{i}"
            r1.append((name, m1[i].tobytes().decode(), qa1[i].tobytes().decode()))
            r2.append((name, m2[i].tobytes().decode(), qa2[i].tobytes().decode()))
    return r1, r2


def write_fastq(path: str, reads, qual_char: str = "I"):
    """Rows are (name, seq) — constant quality — or (name, seq, qual)."""
    with open(path, "w") as f:
        for rec in reads:
            if len(rec) == 2:
                name, seq = rec
                qual = qual_char * len(seq)
            else:
                name, seq, qual = rec
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")


def write_truth(path: str, truth: list[TruthEvent]):
    """Same column layout as <sample>.true.sv.txt (simulation.py:253-254)."""
    with open(path, "w") as f:
        for t in truth:
            f.write(
                f"{t.receptor} {t.insert_locus} {t.donor} {t.seg_start} "
                f"{t.seg_end} {t.reverse}\n"
            )


def read_truth(path: str) -> list[TruthEvent]:
    out = []
    for line in open(path):
        a = line.split()
        if len(a) >= 6:
            out.append(
                TruthEvent(a[0], int(a[1]), a[2], int(a[3]), int(a[4]),
                           a[5] in ("True", "true", "1"))
            )
    return out


def simulate_sample(outdir: str, sample: str, pa: SimParams,
                    ref_genomes: dict[str, str] | None = None):
    """Full fixture: reference FASTA + truth + paired FASTQs.

    Returns (ref_path, fq1, fq2, truth_path).
    """
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(pa.seed)
    genomes = ref_genomes if ref_genomes is not None else random_genomes(pa, rng)
    ref_path = os.path.join(outdir, f"{sample}.ref.fa")
    fasta.write_fasta(ref_path, list(genomes.items()))

    edited, truth = implant_hgts(genomes, pa, rng)
    edited = {c: mutate(s, pa, rng) for c, s in edited.items()}
    truth_path = os.path.join(outdir, f"{sample}.true.sv.txt")
    write_truth(truth_path, truth)

    r1, r2 = synthesize_reads(edited, pa, rng)
    fq1 = os.path.join(outdir, f"{sample}.1.fq")
    fq2 = os.path.join(outdir, f"{sample}.2.fq")
    write_fastq(fq1, r1)
    write_fastq(fq2, r2)
    return ref_path, fq1, fq2, truth_path
