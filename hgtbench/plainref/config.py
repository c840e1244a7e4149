"""Typed configuration of the HGT detection engine (copy of
localhgt_tpu/config.py, field for field).

Centralizes every tunable and magic constant that the reference pipeline
(deepomicslab/LocalHGT) scatters across C++ globals and Python module
constants:

- C++ engine globals: reference src/extract_ref_normal_peak.cpp:21-41
- CLI defaults: reference scripts/localhgt.py:45-79
- accurate_bkp constants: reference scripts/accurate_bkp.py:23-27
- event constants: reference scripts/infer_HGT_event.py:68-71
- remove_repeat cutoff: reference scripts/remove_repeat.py:12
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KmerConfig:
    """k-mer sketch parameters (reference extract_ref argv, pipeline.sh:35)."""

    k: int = 32                     # k-mer length (localhgt.py:56)
    coder_num: int = 3              # number of hash functions, 1-9 (localhgt.py:58)
    seed: int = 1                   # PRNG seed for coder permutation (localhgt.py:62)
    least_depth: int = 3            # saturating count cap (extract_ref_normal_peak.cpp:23)
    sample: float = 2e9             # down-sample: <=1 proportion, >1 target bp (localhgt.py:61)
    strict_sampling: bool = False   # bit-exact glibc-rand down-sampling stream
    #                                 (get_random, cpp:1332-1340) instead of
    #                                 the default counter-hash stream

    @property
    def table_size(self) -> int:
        return 1 << self.k


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Reference-scan / divergence-peak parameters.

    Reference: slide_window + Peaks (extract_ref_normal_peak.cpp:21-41,204-301,550-725).
    """

    window: int = 500               # good-window width (slide_window:557)
    hit_ratio: float = 0.1          # >=1-coder hit fraction (localhgt.py:64)
    match_ratio: float = 0.08       # all-coder hit fraction (localhgt.py:65)
    peak_w: int = 5                 # PEAK_W: 5-bp sum width (cpp:32)
    peak_diff: int = 2              # DIFF: left-right threshold (cpp:31)
    skip_a: int = 1                 # SKIP_A: offset stride (cpp:36)
    # SKIP_S = k, SKIP_N = 2*k are derived from KmerConfig.k (cpp:1377-1378)
    merge_close_peak: int = 50      # peaks in same 50-bp bin merge (Peaks:210)
    ref_near: int = 500             # interval padding around a kept peak (cpp:30, Peaks:212)
    ref_gap: int = 500              # merge intervals closer than this (Peaks:211)
    max_peak: int = 300_000_000     # capacity cap (cpp:38, localhgt.py:60)
    min_reads: int = 1              # MIN_READS: votes to keep a peak (cpp:37)
    min_base_num: int = 6           # MIN_BASE_NUM: voting bases per pair (cpp:29)
    good_pad: int = 1000            # good windows padded by 2*window (slide_window:618,625)
    min_frag_len: int = 50          # drop emitted fragments shorter than this (get_bed_file.py:16)


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Seed-and-extend aligner replacing `bwa mem` + samtools plumbing.

    Score scheme mirrors bwa-mem defaults; thresholds mirror the BAM filters
    the reference applies (pipeline.sh:48, get_raw_bkp.py:55-61).
    """

    match: int = 1
    mismatch: int = -4
    gap_open: int = -6
    gap_extend: int = -1
    seed_len: int = 19              # exact seed length for candidate location votes
    seed_stride: int = 5            # sample a seed every N read positions
    max_candidates: int = 4         # candidate locations scored per read end
    window_pad: int = 32            # ref window slack around a candidate diagonal
    min_mapq: int = 20              # read mapping-quality filter (localhgt.py:55, -q)
    min_seed_votes: int = 2         # min diagonal votes to extend a candidate
    min_split_len: int = 20         # min non-overlap for a split alignment
    #                                 (extractSplitReads_BwaMem.py minNonOverlap default)
    max_tlen: int = 1000            # proper-pair insert cap (get_raw_bkp.py:27)
    score_clip: int = 0             # the benchmark's control only: > 0
    #                                 saturates K1's plain scores there


@dataclasses.dataclass(frozen=True)
class BkpConfig:
    """Breakpoint calling thresholds.

    Reference: get_raw_bkp.py / accurate_bkp.py / remove_repeat.py.
    """

    mapq_min: int = 20                      # discordant-read mapq floor (get_raw_bkp.py:55)
    insert_sigma: float = 2.0               # insert = mean + 2*sd (get_raw_bkp.py:787)
    insert_sample_reads: int = 10000        # reads used for the estimate (get_raw_bkp.py:42)
    cluster_max_dist: int = 50              # raw-bkp cluster radius (accurate_bkp.py:102)
    min_match_score: float = 0.8            # SW accept ratio (accurate_bkp.py:23)
    min_seq_len: int = 15                   # min clipped-seq length (accurate_bkp.py:24)
    bkp2end: int = 15                       # split lands too near segment end (accurate_bkp.py:27)
    max_refs_sim: float = 0.4               # repeat-guard flank similarity (accurate_bkp.py Acc_Bkp)
    refs_check_len: int = 50                # flank half-width for the guard (compare_two_refs)
    around_cutoff: int = 20                 # support-read window (count_reads_for_norm)
    search_scale: int = 2                   # scan +-2*rlen around cluster (choose_acc_from_cluster)
    dedup_cutoff: int = 50                  # near-duplicate removal (remove_repeat.py:12)
    keep_xa: int = 1                        # retain multi-hit reads (-a, localhgt.py:54)


@dataclasses.dataclass(frozen=True)
class EventConfig:
    """HGT event matching (reference infer_HGT_event.py:51-71,400-412)."""

    min_split_reads: int = 2        # -n: cross_split_reads floor (localhgt.py event -n)
    min_hgt_len: int = 500          # -m: min transferred length
    max_diff: int = 20              # endpoint match tolerance (Match.max_diff)
    bin_size: int = 100             # hgt_tag binning / ambiguity DBSCAN eps (Match.bin_size)
    window: int = 200               # contig-end exclusion window (Match.window)
    pop_sample: int = 200           # cohort samples for ambiguity check (remove_ambiguity_pop)
    max_ambiguity_clusters: int = 2 # DBSCAN cluster cap (check_if_match:189)
    seed: int = 1                   # ambiguity-subsample RNG seed: the
    # reference's remove_ambiguity_pop shuffles UNSEEDED
    # (infer_HGT_event.py:258), so two identical runs can emit different
    # event sets on >pop_sample cohorts; this framework seeds it


@dataclasses.dataclass(frozen=True)
class Config:
    kmer: KmerConfig = dataclasses.field(default_factory=KmerConfig)
    scan: ScanConfig = dataclasses.field(default_factory=ScanConfig)
    align: AlignConfig = dataclasses.field(default_factory=AlignConfig)
    bkp: BkpConfig = dataclasses.field(default_factory=BkpConfig)
    event: EventConfig = dataclasses.field(default_factory=EventConfig)
    threads: int = 10               # host-side IO threads (-t, localhgt.py:57)
    count_ckpt: str = ""            # directory for stage-A count-table
    #                                 checkpoints; extends the reference's
    #                                 only resume point (the persistent ref
    #                                 index, extract_ref_normal_peak.cpp:
    #                                 1401-1413) to the hours-long counting
    #                                 pass at UHGG scale. Empty = disabled.

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config()
