"""Transferred-gene annotation and enrichment.

Port of the reusable core of the reference's transferred-gene study
(paper_results/analyze_transfer_gene.py):

  * GFF gene index with point / segment queries
    (Annotation.read_gff/given_point/given_seg, :144-210)
  * product classifier for HGT-machinery / CAZYmes / ARG classes
    (Annotation.classify_product, :248-289) and the IS-element test
    (if_IS, :291-296)
  * transfer-times counting: how many distinct insertion sites each
    donor segment reaches, at a 100-bp site granularity
    (Transfer_times.all_count_times, :329-421)
  * product-class counts over all transferred segments
    (count_product, :529-546) and interval merging (merge_intervals,
    :555-573)

The cohort-I/O layer here consumes this framework's event CSVs
(analysis.mechanism.EventRow); the hardcoded cohort paths, pandas plots
and KEGG/COG web fetches of the original are out of engine scope
(SURVEY.md section 2.4).
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from dataclasses import dataclass, field

import numpy as np

NEAR = 100            # gene-to-point slack bp (Annotation.__init__, :148)
MIN_GENE_FRAC = 0.5   # segment must cover this CDS fraction (:149)
SITE_WINDOW = 100     # insertion-site bin, bp (all_count_times, :337)


# product classifier (classify_product, :248-289) — same regexes, same
# LAST-match-wins ordering (each .search overwrites the classification)
_PATTERNS = (
    ("plasmid", re.compile(
        r"relax\S*|conjug\S*|mob\S*|plasmid|type IV|chromosome partitioning"
        r"|chromosome segregation")),
    ("phage", re.compile(
        r"capsid|phage|tail|head|tape measure|antiterminatio")),
    ("transposon", re.compile(
        r"transpos\S*|insertion|Tra[A-Z]|Tra[0-9]|IS[0-9]"
        r"|conjugate transposon")),
    ("Other_HGT_mechanisms", re.compile(
        r"integrase|excision\S*|exonuclease|recomb|toxin|restrict\S*"
        r"|resolv\S*|topoisomerase|reverse transcrip")),
    ("CAZYmes", re.compile(
        r"glycosyltransferase|glycoside hydrolase|xylan|monooxygenase"
        r"|rhamnos\S*|cellulose|sialidase|\S*ose($|\s|\-)"
        r"|acetylglucosaminidase|cellobiose|galact\S*|fructose|aldose"
        r"|starch|mannose|mannan\S*|glucan|lyase|glycosidase|pectin"
        r"|SusD|SusC|fructokinase|galacto\S*|arabino\S*")),
    ("ARG", re.compile(
        r"azole resistance|antibiotic resistance|TetR"
        r"|tetracycline resistance|VanZ|betalactam\S*|beta-lactam"
        r"|antimicrob\S*|lantibio\S*")),
)

_IS_PATTERN = re.compile(r"IS[0-9]")


def classify_product(product: str) -> str:
    """Gene-product class; LAST matching pattern wins, 'unclassified'
    otherwise — the exact overwrite order of classify_product
    (:248-289, each if-block unconditionally overwrites)."""
    out = "unclassified"
    for name, pat in _PATTERNS:
        if pat.search(product):
            out = name
    return out


def is_IS(product: str) -> bool:
    """IS-element product test (if_IS, :291-296)."""
    return bool(_IS_PATTERN.search(product))


def parse_attributes(detail: str) -> dict:
    """`ID=...;product=...` attribute column -> dict (understand_gene,
    :212-218); malformed fields without '=' are skipped."""
    out = {}
    for part in detail.strip().split(";"):
        kv = part.split("=", 1)
        if len(kv) == 2:
            out[kv[0]] = kv[1]
    return out


@dataclass
class _GenomeGenes:
    starts: np.ndarray
    ends: np.ndarray
    attrs: list


class GffAnnotation:
    """Per-genome gene interval index over a GFF file (read_gff, :155-170).

    Queries are vectorized over each genome's interval arrays instead of
    the reference's per-interval Python loop — cohort GFFs carry millions
    of CDS rows."""

    def __init__(self, gff_path: str | None = None,
                 near: int = NEAR, min_gene_frac: float = MIN_GENE_FRAC):
        self.near = near
        self.min_gene_frac = min_gene_frac
        self._by_genome: dict[str, _GenomeGenes] = {}
        if gff_path:
            self.read_gff(gff_path)

    def read_gff(self, path: str) -> None:
        tmp: dict[str, list] = defaultdict(list)
        for line in open(path):
            if line.startswith("#"):
                continue
            a = line.rstrip("\n").split("\t")
            if len(a) < 9:
                continue
            tmp[a[0]].append((int(a[3]), int(a[4]), parse_attributes(a[8])))
        for genome, rows in tmp.items():
            self._by_genome[genome] = _GenomeGenes(
                starts=np.asarray([r[0] for r in rows], np.int64),
                ends=np.asarray([r[1] for r in rows], np.int64),
                attrs=[r[2] for r in rows],
            )

    def genes_at_point(self, genome: str, locus: int) -> list:
        """Attribute dicts of genes within `near` bp of the locus
        (given_point, :172-185); ['NA'] when none, like the reference."""
        g = self._by_genome.get(genome)
        if g is None:
            return ["NA"]
        m = (locus >= g.starts - self.near) & (locus <= g.ends + self.near)
        hits = [g.attrs[i] for i in np.flatnonzero(m)]
        return hits if hits else ["NA"]

    def products_in_segment(self, genome: str, seg: tuple) -> list:
        """Products of genes covered >= min_gene_frac by [seg0, seg1]
        (given_seg, :187-210, including its two asymmetric overlap
        cases and CDS-length normalization)."""
        g = self._by_genome.get(genome)
        if g is None:
            return []
        s0, s1 = int(seg[0]), int(seg[1])
        cds_len = np.maximum(g.ends - g.starts, 1).astype(np.float64)
        case1 = (g.starts >= s0) & (g.starts <= s1) & \
            ((s1 - g.starts) / cds_len > self.min_gene_frac)
        case2 = (g.starts <= s0) & (g.ends >= s0) & \
            ((g.ends - s0) / cds_len > self.min_gene_frac)
        return [g.attrs[i].get("product", "")
                for i in np.flatnonzero(case1 | case2)]


def merge_intervals(intervals: list) -> list:
    """Overlap-merge sorted by start (merge_intervals, :555-573)."""
    merged: list = []
    for s, e in sorted(intervals, key=lambda x: x[0]):
        if not merged or s > merged[-1][1]:
            merged.append((s, e))
        else:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
    return merged


def segment_tag(ev, window: int = SITE_WINDOW) -> str:
    """Donor-segment identity at window granularity (all_count_times,
    :337-339)."""
    return "&".join([ev.donor, str(round(ev.delete_start / window)),
                     str(round(ev.delete_end / window))])


def insertion_site(ev, window: int = SITE_WINDOW) -> str:
    return f"{ev.receptor}&{round(ev.insert_locus / window)}"


def transfer_times(events, window: int = SITE_WINDOW) -> dict:
    """Distinct-insertion-site statistics per transferred segment across
    the cohort (Transfer_times.all_count_times core, :329-372):

      * site_histogram: {n_sites: n_segments}
      * multiple_fraction: fraction of segments seen at >1 site
      * per_sample_multiple: segments with >1 site within one sample
    """
    sites = defaultdict(set)
    per_sample = defaultdict(lambda: defaultdict(set))
    for ev in events:
        tag = segment_tag(ev, window)
        sites[tag].add(insertion_site(ev, window))
        per_sample[ev.sample][tag].add(insertion_site(ev, window))
    hist = Counter(len(v) for v in sites.values())
    n = max(len(sites), 1)
    sample_multi = {
        tag
        for sample_sets in per_sample.values()
        for tag, ss in sample_sets.items() if len(ss) > 1
    }
    return {
        "n_segments": len(sites),
        "site_histogram": dict(sorted(hist.items())),
        "multiple_fraction": round((len(sites) - hist.get(1, 0)) / n, 4),
        "per_sample_multiple": len(sample_multi),
    }


def product_class_counts(events, annotation: GffAnnotation) -> dict:
    """Product-class counts over all transferred segments (count_product,
    :529-546)."""
    counts: Counter = Counter()
    n_is = 0
    for ev in events:
        for product in annotation.products_in_segment(
                ev.donor, (ev.delete_start, ev.delete_end)):
            counts[classify_product(product)] += 1
            n_is += int(is_IS(product))
    out = dict(counts)
    out["IS_elements"] = n_is
    return out


def gene_length_stats(events) -> dict:
    """Transferred-segment length distribution (get_gene_lengths,
    :118-142 — the reusable part: lengths of the identified events)."""
    lens = np.asarray([ev.delete_end - ev.delete_start for ev in events],
                      np.int64)
    if not len(lens):
        return {"n": 0}
    return {
        "n": int(len(lens)),
        "mean": float(lens.mean()),
        "median": float(np.median(lens)),
        "p10": float(np.percentile(lens, 10)),
        "p90": float(np.percentile(lens, 90)),
    }


def analyze(events_csv: str, gff_path: str | None) -> dict:
    """CLI entry: full transferred-gene report for one event CSV."""
    from localhgt_tpu_torch.analysis.mechanism import read_events

    events = read_events(events_csv)
    report = {
        "n_events": len(events),
        "transfer_times": transfer_times(events),
        "segment_lengths": gene_length_stats(events),
    }
    if gff_path:
        ann = GffAnnotation(gff_path)
        report["product_classes"] = product_class_counts(events, ann)
    return report
