"""Phenotype association of HGT markers + cohort phenotype-table assembly.

Reusable cores of two reference scripts:

* `paper_results/associtation_study.py` — case/control marker discovery:
  select comparable samples (select_sample, :813-842), count per-sample
  presence of genus-pair tags and binned breakpoint tags per group
  (extract_HGT, :276-309), and Fisher-exact test every tag with Bonferroni
  correction (select_diff_HGT :311-341, select_diff_breakpoint :473-500).
  The reference's plotting/KEGG-REST halves are visualization glue and are
  not ported (kegg enrichment lives in analysis.cohort with a
  caller-supplied pathway map).
* `paper_results/extract_phenotype.py` — building the sample -> phenotype
  table that every cohort analysis keys on: merge per-cohort metadata
  (sample name -> cohort/disease/full_disease/age/gender/BMI/bases,
  read_pheno :117-168) with SRA run -> sample-name mappings
  (read_sra_meta :87-115), and emit the phenotype CSV consumed by
  `records.read_phenotype`. The reference hard-codes per-cohort column
  quirks; here the join is the API and the caller supplies the records.

Everything is pure-Python/numpy over `records.SampleBkps` cohorts; no
device work (cohort-scale, not read-scale).
"""

from __future__ import annotations

import csv
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from localhgt_tpu_torch.analysis import records
from localhgt_tpu_torch.analysis.taxonomy import Taxonomy

BIN_SIZE = 5000  # breakpoint bin for bk tags (associtation_study.py:1049)


def bonferroni(pvals, alpha: float = 0.05) -> np.ndarray:
    """Bonferroni-adjusted p-values (min(p*m, 1)) — the reference uses
    statsmodels multipletests(method='bonferroni') (:338-341)."""
    p = np.asarray(pvals, dtype=float)
    return np.minimum(p * max(len(p), 1), 1.0)


def select_samples(samples, pheno: dict, group1: str, group2: str,
                   cohort: str = "all") -> dict:
    """sample_id -> group index (0 = group1, 1 = group2).

    Port of Marker.select_sample (associtation_study.py:813-842): a sample
    qualifies iff its full_disease holds exactly one entry, 'control'
    samples must be 'healthy', the disease is non-empty, the cohort matches
    the focus (or 'all'), and the disease (or full_disease) equals one of
    the two groups."""
    sel = {}
    for s in samples:
        ph = pheno.get(s.sample_id)
        if ph is None:
            continue
        s_cohort, disease, full = ph[0], ph[1], ph[2]
        full_list = full.split(";") if full else [""]
        if len(full_list) != 1:
            continue
        if disease == "control" and full_list[0] != "healthy":
            continue
        if disease == "":
            continue
        if cohort != "all" and s_cohort != cohort:
            continue
        if disease == group1 or group1 in full_list:
            sel[s.sample_id] = 0
        elif disease == group2 or group2 in full_list:
            sel[s.sample_id] = 1
    return sel


def _bk_tags(bkp, bin_size: int):
    """The two binned breakpoint tags of a row (Acc_Bkp.bk1_tag/bk2_tag,
    associtation_study.py:80-81: contig & round(pos / bin_size))."""
    return (f"{bkp.from_ref}&{round(bkp.from_bkp / bin_size)}",
            f"{bkp.to_ref}&{round(bkp.to_bkp / bin_size)}")


def extract_tag_counts(samples, selected: dict, tax: Taxonomy, level,
                       bin_size: int = BIN_SIZE):
    """Per-group presence counts (extract_HGT, :276-309).

    Returns (pair_counts, bk_counts, n_by_group):
      pair_counts: tag -> [n_group1_samples, n_group2_samples] where the
        tag is the sorted taxa pair at `level` ('NA'-sided pairs skipped,
        Acc_Bkp :72-78);
      bk_counts: same for binned breakpoint tags (both endpoints);
      n_by_group: [n1, n2] selected sample counts.
    Presence is per sample (each sample counts a tag at most once)."""
    pair_counts: dict = defaultdict(lambda: [0, 0])
    bk_counts: dict = defaultdict(lambda: [0, 0])
    n_by_group = [0, 0]
    for s in samples:
        g = selected.get(s.sample_id)
        if g is None:
            continue
        n_by_group[g] += 1
        seen_pairs = set()
        seen_bks = set()
        for b in s.bkps:
            t1 = tax.taxon(records.genome_of(b.from_ref), level)
            t2 = tax.taxon(records.genome_of(b.to_ref), level)
            for bt in _bk_tags(b, bin_size):
                if bt not in seen_bks:
                    seen_bks.add(bt)
                    bk_counts[bt][g] += 1
            # unnamed taxa ('x__' or missing) make the pair untestable
            if not t1 or not t2 or t1.endswith("__") or t2.endswith("__"):
                continue
            tag = "&".join(sorted([t1, t2]))
            if tag not in seen_pairs:
                seen_pairs.add(tag)
                pair_counts[tag][g] += 1
    return dict(pair_counts), dict(bk_counts), n_by_group


def fisher_markers(counts: dict, n_by_group, group1: str, group2: str,
                   alpha: float = 0.05):
    """Fisher-exact each tag's 2x2 presence table, Bonferroni-correct.

    Port of select_diff_HGT / select_diff_breakpoint (:311-341, :473-500):
    a = carriers in group1, b = group1 non-carriers, c/d likewise for
    group2; two-sided Fisher; rows sorted by adjusted p. Returns a list of
    dicts with tag, p, odds ratio, per-group frequencies, p_adj and the
    significance flag at `alpha`."""
    from scipy.stats import fisher_exact

    n1, n2 = n_by_group
    rows = []
    for tag, (a, c) in counts.items():
        b, d = n1 - a, n2 - c
        odds, p = fisher_exact([[a, b], [c, d]])
        rows.append({
            "tag": tag, "p_value": float(p), "oddsratio": float(odds),
            "n_carriers": int(a),
            group1: (a / n1 if n1 else 0.0),
            group2: (c / n2 if n2 else 0.0),
        })
    padj = bonferroni([r["p_value"] for r in rows], alpha)
    for r, pa in zip(rows, padj):
        r["p_adj"] = float(pa)
        r["significant"] = bool(pa < alpha)
    rows.sort(key=lambda r: (r["p_adj"], r["p_value"]))
    return rows


def association_study(result_dir: str, pheno_csv: str, tax: Taxonomy,
                      group1: str, group2: str, level="genus",
                      cohort: str = "all", bin_size: int = BIN_SIZE,
                      abun_cutoff: float = records.ABUN_CUTOFF,
                      alpha: float = 0.05) -> dict:
    """End-to-end case/control association over a results folder.

    The equivalent of associtation_study.py __main__ (:1045-1100)
    minus plotting: load the cohort (abundance-filtered), select comparable
    samples, count tag presence, Fisher-test pairs and breakpoints."""
    samples = records.load_cohort(result_dir, abun_cutoff=abun_cutoff)
    pheno = records.read_phenotype(pheno_csv)
    selected = select_samples(samples, pheno, group1, group2, cohort)
    pair_counts, bk_counts, n_by_group = extract_tag_counts(
        samples, selected, tax, level, bin_size)
    pairs = fisher_markers(pair_counts, n_by_group, group1, group2, alpha)
    bks = fisher_markers(bk_counts, n_by_group, group1, group2, alpha)
    return {
        "group1": group1, "group2": group2, "level": str(level),
        "cohort": cohort,
        "n_samples": {group1: n_by_group[0], group2: n_by_group[1]},
        "n_pair_tags": len(pair_counts), "n_bk_tags": len(bk_counts),
        "diff_pairs": [r for r in pairs if r["significant"]],
        "diff_breakpoints": [r for r in bks if r["significant"]],
        "top_pairs": pairs[:20],
        "top_breakpoints": bks[:20],
    }


# --------------------------------------------------------------------------
# Phenotype-table assembly (extract_phenotype.py core)
# --------------------------------------------------------------------------


@dataclass
class PhenotypeTable:
    """Join of cohort metadata and run -> sample mappings; emits the
    phenotype CSV that records.read_phenotype / select_samples consume.

    The reference builds this by special-casing each cohort's metadata
    column layout (extract_phenotype.py:87-168); the generic core is the
    two-step join: register sample-level metadata, then map sequencing-run
    ids onto sample names so results keyed by run id inherit the
    phenotype."""

    by_sample: dict = field(default_factory=dict)  # name -> record dict
    run_to_sample: dict = field(default_factory=dict)

    def add_sample(self, sample_name: str, cohort: str, disease: str,
                   full_disease: str = "", age=0, gender: str = "nan",
                   bmi=0, bases: float = 0.0) -> None:
        """Register one sample's metadata (read_pheno :117-168). gender is
        normalized to the reference's {male: 0, female: 1, nan: 2} codes."""
        gender_code = {"male": 0, "female": 1}.get(str(gender).lower(), 2)
        self.by_sample[sample_name] = {
            "sample": sample_name, "cohort": cohort, "disease": disease,
            "full_disease": full_disease or disease,
            "age": int(age) if str(age) not in ("", "nan") else 0,
            "gender": gender_code,
            "bmi": round(float(bmi)) if str(bmi) not in ("", "nan") else 0,
            "bases": float(bases) if str(bases) not in ("", "nan") else 0.0,
        }

    def map_run(self, run_id: str, sample_name: str) -> None:
        """Associate a sequencing-run id (e.g. an SRA accession) with a
        registered sample (read_sra_meta :87-115); unknown samples are
        ignored, matching the reference's `continue`."""
        if sample_name in self.by_sample:
            self.run_to_sample[run_id] = sample_name

    def rows(self):
        """One row per known id (runs first, then unmapped sample names),
        shaped for records.read_phenotype: id, cohort, disease, full."""
        seen = set()
        for run_id, name in sorted(self.run_to_sample.items()):
            rec = self.by_sample[name]
            seen.add(name)
            yield [run_id, rec["cohort"], rec["disease"],
                   rec["full_disease"], rec["age"], rec["gender"],
                   rec["bmi"], rec["bases"]]
        for name, rec in sorted(self.by_sample.items()):
            if name not in seen:
                yield [name, rec["cohort"], rec["disease"],
                       rec["full_disease"], rec["age"], rec["gender"],
                       rec["bmi"], rec["bases"]]

    def write_csv(self, path: str) -> int:
        """Write the phenotype table; returns the row count."""
        n = 0
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["sample", "cohort", "disease", "full_disease",
                        "age", "gender", "bmi", "bases"])
            for row in self.rows():
                w.writerow(row)
                n += 1
        return n

    @classmethod
    def from_metadata_csv(cls, meta_csv: str,
                          sample_col="sample", cohort_col="cohort",
                          disease_col="disease", full_col="full_disease",
                          run_col="run") -> "PhenotypeTable":
        """Build from one flat metadata CSV with named columns — the
        common case once a cohort's metadata has been normalized (the
        reference does this normalization per cohort by hand)."""
        t = cls()
        with open(meta_csv) as f:
            rd = csv.DictReader(f)
            for row in rd:
                name = row.get(sample_col, "").strip()
                if not name:
                    continue
                t.add_sample(
                    name, row.get(cohort_col, ""), row.get(disease_col, ""),
                    row.get(full_col, ""), row.get("age", 0),
                    row.get("gender", "nan"), row.get("bmi", 0),
                    row.get("bases", 0.0))
                run = row.get(run_col, "").strip()
                if run and run != "NA":
                    t.map_run(run, name)
        return t
