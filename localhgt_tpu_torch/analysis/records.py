"""Cohort-level breakpoint records.

Re-implements the `Acc_Bkp` record + cohort loader that every downstream
analysis script in the reference copies (basic_statistics.py:23-66,
HGT_classifier.py:40-78, HGT_network.py:27-56, microhomology.py:35-66), plus
the abundance filter used when scoring real cohorts
(evaluation.py:110-133: keep a breakpoint iff
cross_split_reads / sample_read_count >= abun_cutoff, default 1e-7).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from localhgt_tpu_torch.utils import formats

BIN_SIZE = 100  # hgt_tag position bin (basic_statistics.py:53 `bin_size`)
ABUN_CUTOFF = 1e-7  # evaluation.py:1340


def genome_of(ref_name: str) -> str:
    """Contig -> genome: drop the last `_` field (infer_HGT_event.py:38-39)."""
    return "_".join(ref_name.split("_")[:-1])


@dataclass
class BkpRecord:
    """One acc.csv row, with the derived tags the analyses key on."""

    from_ref: str
    from_bkp: int
    from_side: str
    from_strand: str
    to_ref: str
    to_bkp: int
    to_side: str
    to_strand: str
    if_reverse: str
    similarity: float
    from_split_reads: int
    to_split_reads: int
    cross_split_reads: int
    pair_end: int

    @property
    def from_ref_genome(self) -> str:
        return genome_of(self.from_ref)

    @property
    def to_ref_genome(self) -> str:
        return genome_of(self.to_ref)

    @property
    def hgt_tag(self) -> str:
        """Binned junction identity (basic_statistics.py:53)."""
        return "&".join([
            self.from_ref, str(self.from_bkp // BIN_SIZE),
            self.to_ref, str(self.to_bkp // BIN_SIZE),
        ])

    @property
    def pair_tag(self) -> str:
        """Unordered genome-pair identity (basic_statistics.py:54)."""
        return "&".join(sorted([self.from_ref_genome, self.to_ref_genome]))

    @classmethod
    def from_row(cls, r: dict) -> "BkpRecord":
        return cls(
            from_ref=r["from_ref"], from_bkp=int(r["from_pos"]),
            from_side=r["from_side"], from_strand=r["from_strand"],
            to_ref=r["to_ref"], to_bkp=int(r["to_pos"]),
            to_side=r["to_side"], to_strand=r["to_strand"],
            if_reverse=r["if_reverse"],
            similarity=float(r["similarity"] or 0),
            from_split_reads=int(r["from_split_reads"] or 0),
            to_split_reads=int(r["to_split_reads"] or 0),
            cross_split_reads=int(r["cross_split_reads"] or 0),
            pair_end=int(r["pair_end"] or 0),
        )


@dataclass
class SampleBkps:
    """All retained breakpoints of one sample."""

    sample_id: str
    bkps: list = field(default_factory=list)
    reads_num: int = 0
    insert_size: int = 0
    # optional phenotype: (cohort, disease, full_disease_list)
    cohort: str = ""
    disease: str = ""
    full_disease: list = field(default_factory=list)


def read_sample(acc_path: str, abun_cutoff: float = ABUN_CUTOFF,
                drop_same_genome: bool = True) -> SampleBkps:
    """Load one acc.csv, applying the cohort filters every analysis uses:
    drop same-genome junctions (HGT_classifier.py:222-224) and, when the
    header carries a read count, drop junctions with
    cross_split_reads/reads_num < abun_cutoff (evaluation.py:119-127)."""
    rows, reads_num, insert_size = formats.read_acc_csv(acc_path)
    sid = os.path.basename(acc_path)
    for suf in (".repeat.acc.csv", ".acc.csv", ".csv"):
        if sid.endswith(suf):
            sid = sid[: -len(suf)]
            break
    out = SampleBkps(sid, reads_num=reads_num, insert_size=insert_size)
    for r in rows:
        b = BkpRecord.from_row(r)
        if drop_same_genome and b.from_ref_genome == b.to_ref_genome:
            continue
        if (abun_cutoff and reads_num
                and b.cross_split_reads / reads_num < abun_cutoff):
            continue
        out.bkps.append(b)
    return out


def load_cohort(result_dir: str, abun_cutoff: float = ABUN_CUTOFF,
                phenotypes: dict | None = None) -> list:
    """Load every `*.acc.csv` (skipping `*.repeat.acc.csv`) in a folder
    (HGT_network.py:189-204). `phenotypes` optionally maps sample_id ->
    (cohort, disease, full_disease_str) as read by `read_phenotype`
    (HGT_network.py:410-421); samples without a phenotype are kept with
    empty phenotype fields unless a dict is given (then they are dropped,
    matching the reference)."""
    samples = []
    for name in sorted(os.listdir(result_dir)):
        if not name.endswith(".acc.csv") or name.endswith(".repeat.acc.csv"):
            continue
        s = read_sample(os.path.join(result_dir, name), abun_cutoff)
        if not s.bkps:
            continue
        if phenotypes is not None:
            if s.sample_id not in phenotypes:
                continue
            ph = phenotypes[s.sample_id]
            s.cohort, s.disease = ph[0], ph[1]
            s.full_disease = ph[2].split(";") if len(ph) > 2 and ph[2] else []
        samples.append(s)
    return samples


def read_phenotype(pheno_csv: str) -> dict:
    """sample_id -> (cohort, disease, full_disease) from a phenotype CSV
    whose first column is the sample id (HGT_network.py:410-421)."""
    import csv

    out = {}
    with open(pheno_csv) as f:
        for row in csv.reader(f):
            if not row or row[0] in ("", "sample", "ID"):
                continue
            cohort = row[1] if len(row) > 1 else ""
            disease = row[2] if len(row) > 2 else ""
            full = row[3] if len(row) > 3 else disease
            out[row[0]] = (cohort, disease, full)
    return out
