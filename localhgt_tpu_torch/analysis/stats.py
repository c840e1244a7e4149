"""Cohort-level breakpoint statistics (basic_statistics.py).

The reference script characterizes breakpoint distributions across samples:
per-sample junction counts, recurrent junction tags and genome pairs,
per-taxon participation, and Mann-Whitney comparisons of per-sample counts
between phenotype groups. This module provides those summaries as pure
functions over `records.SampleBkps` cohorts.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from localhgt_tpu_torch.analysis.taxonomy import Taxonomy


def per_sample_counts(samples) -> dict:
    """sample_id -> number of retained breakpoint pairs."""
    return {s.sample_id: len(s.bkps) for s in samples}


def recurrent_tags(samples, key: str = "hgt_tag") -> Counter:
    """How many samples carry each junction tag (`hgt_tag`, binned at 100 bp)
    or genome pair (`pair_tag`) (basic_statistics.py:53-54 tag definitions)."""
    c: Counter = Counter()
    for s in samples:
        c.update({getattr(b, key) for b in s.bkps})
    return c


def taxon_participation(samples, tax: Taxonomy | None = None,
                        level="genome") -> Counter:
    """Junction-end counts per taxon at a level — which taxa exchange most."""
    tax = tax or Taxonomy()
    c: Counter = Counter()
    for s in samples:
        for b in s.bkps:
            c[tax.taxon(b.from_ref_genome, level)] += 1
            c[tax.taxon(b.to_ref_genome, level)] += 1
    return c


def bkp_density(samples, contigs) -> dict:
    """sample_id -> breakpoints per Mbp of reference."""
    total_mbp = float(contigs.lengths.sum()) / 1e6
    return {s.sample_id: len(s.bkps) / total_mbp for s in samples}


def group_count_test(samples, group1: str, group2: str,
                     normalize_reads: bool = False) -> dict:
    """Mann-Whitney U on per-sample breakpoint counts between two phenotype
    groups (the basic_statistics comparison pattern). With
    `normalize_reads`, counts divide by the sample read count."""
    from scipy.stats import mannwhitneyu

    a, b = [], []
    for s in samples:
        v = len(s.bkps)
        if normalize_reads and s.reads_num:
            v = v / s.reads_num
        if s.disease == group1 or group1 in s.full_disease:
            a.append(v)
        elif s.disease == group2 or group2 in s.full_disease:
            b.append(v)
    out = {
        "n1": len(a), "n2": len(b),
        "mean1": float(np.mean(a)) if a else 0.0,
        "mean2": float(np.mean(b)) if b else 0.0,
        "p_value": float("nan"),
    }
    if a and b:
        r = mannwhitneyu(a, b, alternative="two-sided")
        out["u_stat"], out["p_value"] = float(r.statistic), float(r.pvalue)
    return out


def summary(samples, contigs=None) -> dict:
    """One-call cohort overview."""
    counts = per_sample_counts(samples)
    vals = np.array(list(counts.values())) if counts else np.zeros(1)
    out = {
        "n_samples": len(samples),
        "total_bkps": int(vals.sum()),
        "mean_bkps_per_sample": float(vals.mean()),
        "median_bkps_per_sample": float(np.median(vals)),
        "top_pairs": recurrent_tags(samples, "pair_tag").most_common(10),
        "top_junctions": recurrent_tags(samples, "hgt_tag").most_common(10),
    }
    if contigs is not None:
        dens = bkp_density(samples, contigs)
        out["mean_density_per_mbp"] = float(np.mean(list(dens.values())))
    return out
