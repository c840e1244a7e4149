"""A/B the extraction stage against the reference's `extract_ref` engine,
on the port.

    python -m localhgt_tpu_torch.tools.ab_reference [--workdir DIR]
        [-k 30] [--genomes 20] [--genome-len 150000] [--hgt 10]
        [--depth 10] [--seed 42] [--source PATH] [--device cuda]

The counterpart of localhgt_tpu/tools/ab_reference.py. The reference's
novel component is the k-mer extraction stage
(src/extract_ref_normal_peak.cpp:1342-1519, invoked at pipeline.sh:35): it
emits `interval.txt`, the HGT-candidate reference intervals that the whole
downstream alignment runs against. This tool compiles that C++ source,
runs it and the port's extraction (`pipeline/extract.py::extract`, on
`device`) on the same simulated fixture with the same seed, k and ratios,
and reports interval-level agreement:

  * bp-level overlap (intersection / union) of the two interval sets after
    the get_bed_file.py:14-18 normalization (clamp start >= 1, drop
    fragments < 50 bp),
  * truth-locus coverage of each side (every true breakpoint +-50 bp must be
    inside the extracted sub-reference for the downstream caller to see it:
    evaluation.py:64-76 `check_if_bkp_in_extracted_ref`),
  * raw counts and sizes.

The reference's source is not part of this repository: the tool looks
for it under `reference/src/` at the repository's root, or at `--source`.
Where it, or g++, is absent, `run_ab` returns {"skipped": ...} and
simulates nothing. The fixture and the engine's build go under
`--workdir` (default: an `lht_ab_torch` directory under the system's
temporary directory).

Deliberate divergences from the reference engine (why 100% bp-identity is
not the bar; truth coverage and high overlap are):

  1. Deterministic counters. The reference's count tables and peak votes
     are updated by racy unsynchronized threads (cpp:1082-1085); it runs
     with threads=1 here so that its output is deterministic, and the
     port's rank-capped scatter reproduces the single-thread semantics
     min(total, cap) exactly.
  2. Window stencil at chunk halos. The port's scan evaluates the same
     telescoped window sums in closed form (ops/scan.py) over halo-padded
     chunks, which cannot change window values (halo >= window + 2k).
  3. Interval stitching across threads. count_filtered_peak
     (cpp:515-548) emits per-thread interval runs with a dangling
     `chr=1,start=1,end=1` seed row per thread and does not merge
     intervals that span thread boundaries; with threads=1 only the
     seed-row artifact remains, which the get_bed_file length filter
     drops. The port merges globally (ops/scan.py::final_intervals):
     the same covered bp.
  4. Tail positions. The reference scan stops window evaluation k-mers
     short of each contig end in a way that depends on its index layout;
     the port clamps interval ends to the contig length.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

# the reference's source, where the repository holds it (it does not yet)
REFERENCE_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "reference", "src", "extract_ref_normal_peak.cpp")
MIN_FRAG = 50  # get_bed_file.py:16
WORKDIR = os.path.join(tempfile.gettempdir(), "lht_ab_torch")


def compile_reference(out_dir: str, src: str = REFERENCE_SRC) -> str | None:
    """g++ -O2 -std=c++11 -pthread <src> -> <out_dir>/extract_ref.

    Returns the binary path, or None when the source or toolchain is
    unavailable (the A/B is then skipped, not failed)."""
    if not os.path.isfile(src):
        return None
    os.makedirs(out_dir, exist_ok=True)
    binary = os.path.join(out_dir, "extract_ref")
    if (os.path.isfile(binary)
            and os.path.getmtime(binary) >= os.path.getmtime(src)):
        return binary
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++11", "-pthread", src, "-o", binary],
            check=True, capture_output=True, timeout=600,
        )
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    return binary


def run_reference_extract(binary: str, fq1: str, fq2: str, ref: str,
                          out_dir: str, cfg, threads: int = 1) -> list:
    """Run the compiled engine exactly as pipeline.sh:35 does; returns
    normalized (contig_name, start, end) intervals.

    threads=1 keeps the reference's racy saturating counters deterministic
    (divergence 1 above)."""
    os.makedirs(out_dir, exist_ok=True)
    interval = os.path.join(out_dir, "interval.txt")
    argv = [
        binary, fq1, fq2, ref, interval,
        str(cfg.scan.hit_ratio), str(cfg.scan.match_ratio), str(threads),
        str(cfg.kmer.k), str(cfg.scan.max_peak), str(cfg.kmer.coder_num),
        str(cfg.kmer.seed), str(float(cfg.kmer.sample)),
    ]
    subprocess.run(argv, check=True, capture_output=True, timeout=3600)
    names, lens = _read_genome_len(ref + ".genome.len.txt")
    return _normalize(_parse_interval_txt(interval, names), lens)


def _read_genome_len(path: str):
    """ref_index -> (name, len) from the engine's genome.len.txt
    (read_ref cpp:773; consumed by get_bed_file.py:46-53)."""
    names, lens = {}, {}
    with open(path) as f:
        for line in f:
            a = line.split()
            if len(a) >= 3:
                names[int(a[1])] = a[0]
                lens[a[0]] = int(a[2])
    return names, lens


def _parse_interval_txt(path: str, names: dict) -> list:
    out = []
    with open(path) as f:
        for line in f:
            a = line.split()
            if len(a) != 3:
                continue
            idx, s, e = int(a[0]), int(a[1]), int(a[2])
            if idx in names:
                out.append((names[idx], s, e))
    return out


def _normalize(intervals: list, contig_lens: dict | None = None) -> list:
    """get_bed_file.py:14-18 semantics: clamp start >= 1, drop < MIN_FRAG;
    merge overlapping/touching intervals per contig for stable comparison."""
    per: dict = {}
    for name, s, e in intervals:
        s = max(1, s)
        if contig_lens and name in contig_lens:
            e = min(e, contig_lens[name])
        if e - s < MIN_FRAG:
            continue
        per.setdefault(name, []).append((s, e))
    out = []
    for name in sorted(per):
        runs = sorted(per[name])
        cs, ce = runs[0]
        for s, e in runs[1:]:
            if s <= ce:
                ce = max(ce, e)
            else:
                out.append((name, cs, ce))
                cs, ce = s, e
        out.append((name, cs, ce))
    return out


def run_extract(fq1: str, fq2: str, ref: str, cfg, device) -> list:
    """The port's extraction stage on `device` -> the same normalized
    (name, start, end) form."""
    from localhgt_tpu_torch.index import reference as ref_index
    from localhgt_tpu_torch.pipeline import extract as extract_mod

    contigs = ref_index.build(ref)
    res = extract_mod.extract(fq1, fq2, contigs, cfg, device)
    ivs = [(contigs.name_of(cid), s, e) for cid, s, e in res.intervals]
    lens = {contigs.name_of(c): contigs.length_of(c)
            for c in range(1, contigs.n + 1)}
    return _normalize(ivs, lens)


def _coverage(intervals: list) -> dict:
    cov: dict = {}
    for name, s, e in intervals:
        cov.setdefault(name, []).append((s, e))
    return cov


def _covered(cov: dict, name: str, lo: int, hi: int) -> bool:
    return any(s <= lo and hi <= e for s, e in cov.get(name, ()))


def _overlap_bp(a: list, b: list) -> int:
    cb = _coverage(b)
    total = 0
    for name, s, e in a:
        for s2, e2 in cb.get(name, ()):
            total += max(0, min(e, e2) - max(s, s2))
    return total


def compare_intervals(ref_ivs: list, tpu_ivs: list, truth_loci: list,
                      tol: int = 50) -> dict:
    """Agreement report. truth_loci: [(contig_name, pos), ...]. The keys
    are the JAX tool's: `_tpu` names the side under test, the port here."""
    bp_ref = sum(e - s for _, s, e in ref_ivs)
    bp_tpu = sum(e - s for _, s, e in tpu_ivs)
    inter = _overlap_bp(ref_ivs, tpu_ivs)
    union = bp_ref + bp_tpu - inter
    cov_ref, cov_tpu = _coverage(ref_ivs), _coverage(tpu_ivs)
    hit_ref = hit_tpu = 0
    for name, pos in truth_loci:
        if _covered(cov_ref, name, pos - tol, pos + tol):
            hit_ref += 1
        if _covered(cov_tpu, name, pos - tol, pos + tol):
            hit_tpu += 1
    n = max(1, len(truth_loci))
    return {
        "n_intervals_ref": len(ref_ivs),
        "n_intervals_tpu": len(tpu_ivs),
        "bp_ref": bp_ref,
        "bp_tpu": bp_tpu,
        "bp_intersection": inter,
        "bp_jaccard": round(inter / union, 4) if union else 1.0,
        "recall_vs_ref": round(inter / bp_ref, 4) if bp_ref else 1.0,
        "n_truth_loci": len(truth_loci),
        "truth_coverage_ref": round(hit_ref / n, 4),
        "truth_coverage_tpu": round(hit_tpu / n, 4),
    }


def truth_loci_from_file(truth_path: str) -> list:
    """Every breakpoint locus implied by a true.sv.txt row: the insertion
    site on the receptor and both ends of the donor segment
    (simulation.py truth schema; evaluation.py:64-76)."""
    from localhgt_tpu_torch.sim.simulate import read_truth

    loci = []
    for ev in read_truth(truth_path):
        loci.append((ev.receptor, ev.insert_locus))
        loci.append((ev.donor, ev.seg_start))
        loci.append((ev.donor, ev.seg_end))
    return loci


def run_ab(work_dir: str = WORKDIR, k: int = 30, n_genomes: int = 20,
           genome_len: int = 150_000, hgt_num: int = 10, depth: int = 10,
           seed: int = 42, threads: int = 1, device="cuda",
           src: str = REFERENCE_SRC) -> dict:
    """Full A/B: simulate the fixture, run both engines, compare."""
    import torch

    from localhgt_tpu_torch.config import Config, KmerConfig
    from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample

    binary = compile_reference(work_dir, src)
    if binary is None:
        return {"skipped": "reference source or g++ unavailable"}
    pa = SimParams(n_genomes=n_genomes, genome_len=genome_len,
                   hgt_num=hgt_num, depth=depth, snp_rate=0.01, seed=seed)
    ref, fq1, fq2, truth_path = simulate_sample(work_dir, "ab", pa)
    cfg = Config().replace(kmer=KmerConfig(k=k, strict_sampling=True))
    ref_ivs = run_reference_extract(binary, fq1, fq2, ref, work_dir, cfg,
                                    threads=threads)
    tpu_ivs = run_extract(fq1, fq2, ref, cfg, torch.device(device))
    report = compare_intervals(ref_ivs, tpu_ivs,
                               truth_loci_from_file(truth_path))
    report["k"] = k
    return report


def main(argv=None) -> int:
    from localhgt_tpu_torch.utils.device import resolve

    p = argparse.ArgumentParser(
        description="A/B the port's extraction vs the reference extract_ref")
    p.add_argument("--workdir", default=WORKDIR)
    p.add_argument("-k", type=int, default=30)
    p.add_argument("--genomes", type=int, default=20)
    p.add_argument("--genome-len", type=int, default=150_000)
    p.add_argument("--hgt", type=int, default=10)
    p.add_argument("--depth", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--source", default=REFERENCE_SRC,
                   help="the reference's extract_ref_normal_peak.cpp")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    a = p.parse_args(argv)
    report = run_ab(a.workdir, k=a.k, n_genomes=a.genomes,
                    genome_len=a.genome_len, hgt_num=a.hgt, depth=a.depth,
                    seed=a.seed, device=resolve(a.device), src=a.source)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
