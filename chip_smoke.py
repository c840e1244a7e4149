#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (localhgt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one CUDA card, nvcc and g++

Phases, each fatal on failure:
  1. environment: card name and power limit (nvidia-smi), torch, CUDA, nvcc;
  2. build kernels K1/K2 (csrc/sw.cu) and K3 (csrc/vote.cu), one nvcc
     each, in parallel;
  3. each kernel against its plain torch version on the card, exact integer
     equality, both timed with CUDA events and printed beside the kernel's
     bound (the larger of its bytes over 3.35 TB/s and its integer
     operations over SMs x 64 lanes x the SM clock): at the bkp path's
     shapes, K1/K2 also at validate_events' wide reference (B=512,
     M=N=1,000), K3 also at the main path's candidate density, at a ragged
     B and at a P that is no multiple of 4;
  4. simulate the `big` fixture (100 genomes x 1 Mbp, 50 HGTs, depth 5,
     seed 42) in a temporary directory;
  5. `bkp` at k=32 through the port's CLI entry on the card: every kernel
     must launch, recall >= 0.90 and FDR <= 0.05 (+-50 bp);
  6. `event` on the output folder through the port's CLI;
  7. `bkp --refine_fq 1` at k=32 after 2% of the pairs were rewritten to a
     short insert with an adapter tail: every such pair comes out trimmed
     to its insert, the phase-5 gate holds and K1-K3 launch;
  8. `analyze microhomology` and `mechanism` on the phase-5/6 outputs,
     `classifier` and `lodo` on a seeded toy cohort, on the card;
  9. `validate_events` on the event calls that match truth, with long
     reads cut from the truth junctions (1% substitutions) plus as many
     from random reference windows: >= 90% validated, and K1's
     wide-reference variant launches;
 10. `kmer_stats` at k=24 on one mate of `big`.
Each phase's kernel launches are counted from 0 just before it and read
just after. The last two lines of standard output are the kernels' JSON
record and {"ok": true, "device": {...}}. Imports nothing of JAX and
nothing of the JAX package `localhgt_tpu`.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BIG = dict(n_genomes=100, genome_len=1_000_000, hgt_num=50, depth=5,
           snp_rate=0.01, seed=42)
# the JAX package's own results on this fixture at k=32 (BENCH_r05.json)
JAX_REFERENCE = {"intervals": 188, "subref_bp": 224_902, "final_bkps": 92,
                 "recall": 0.92}
MIN_RECALL, MAX_FDR = 0.90, 0.05
ADAPTER_FRAC = 0.02   # pairs rewritten to a short insert before QC
LONG_READ_LEN = 800   # validate_events: flank 500, min_span 200
MIN_VALIDATED = 0.90
SOURCE = "localhgt_tpu_torch/csrc/sw.cu"
K1_TPU = "localhgt_tpu/ops/pallas_sw.py:208"
K2_TPU = "localhgt_tpu/ops/pallas_sw.py:89"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64
# Integer operations a cell of the recurrences of sw_align_plain and
# sw_score_plain, a fused add-max (DPX) counted as one. K2: substitution
# (compare, select), diagonal add-max-0, F add, H1 max, T0 add, prefix
# max, E add-max, Mf add-max, best max = 10. K1 adds the row-best pack
# (multiply-add) and, for the origins, start_O add, diagonal origin
# (compare, select), and a select or compare-select behind each of the
# five maxima (1 + 2 + 2 + 2 + 1) = 22.
K1_OPS_PER_CELL, K2_OPS_PER_CELL = 22, 10
# K3, counted from the data: 2G operations (compare, select-max) per
# non-zero candidate and 3G (compare, increment or victim search and
# insert) per position that has one
K3_OPS_PER_CANDIDATE, K3_OPS_PER_HIT = 16, 24


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def int32_ops_per_s() -> float:
    """SMs x 64 INT32 lanes x the SM clock nvidia-smi reads as the card's
    maximum."""
    import torch

    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(res.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[env] {sms} SMs, clocks.max.sm {mhz:.0f} MHz")
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def sw_inputs(rng, B: int, M: int, N: int, tie_heavy: bool):
    """Reads planted in their reference windows with mutations; tie-heavy
    inputs use a 2-letter alphabet and 1-5 bp insertions (ROADMAP F1)."""
    alpha = 2 if tie_heavy else 4
    q = rng.integers(0, alpha, (B, M)).astype(np.uint8)
    r = rng.integers(0, alpha, (B, N)).astype(np.uint8)
    for b in range(0, B, 2):
        ins = int(rng.integers(1, 6))
        cut = int(rng.integers(4, M - 4))
        seg = np.concatenate([q[b, :cut],
                              rng.integers(0, alpha, ins).astype(np.uint8),
                              q[b, cut:]])
        off = int(rng.integers(0, max(1, N - len(seg))))
        seg = seg[: N - off]
        mut = rng.random(len(seg)) < 0.02
        seg[mut] = rng.integers(0, alpha, int(mut.sum()))
        r[b, off:off + len(seg)] = seg
    q[rng.random(q.shape) < 0.002] = 4
    return q, r


def check_kernels(dev) -> list:
    """Phase 3: the kernels' records, keyed by the wrapper and counter
    that phases 5-9 read their launches from."""
    import torch

    from localhgt_tpu_torch import tune_vote
    from localhgt_tpu_torch.ops import cuda_sw, cuda_vote

    rng = np.random.default_rng(2024)
    ops_per_s = int32_ops_per_s()
    out = []

    def compare(name, replaces, kern, plain, reps, nbytes, ops,
                source=SOURCE):
        """nbytes: every input read once and every output written once;
        ops: the integer operations these inputs need."""
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        ms = tune_vote.time_ms(kern, reps)
        plain_ms = tune_vote.time_ms(plain, 2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"[kernels] {name}: max_abs_err={err} kernel {ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms by {bound_by} (bytes {bytes_ms:.3f}, "
            f"operations {ops_ms:.3f}; {bound_ms / ms:.1%} of the bound "
            f"reached), plain torch {plain_ms:.3f} ms, library call: none")
        if err != 0:
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err})")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

    def sw_pair(B, M, N, tie):
        q, r = sw_inputs(rng, B, M, N, tie)
        return torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)

    def sw_both(B, M, N, tie, sfx, k2: bool):
        """K1 (and K2 when asked) on one input; returns K1's record."""
        qd, rd = sw_pair(B, M, N, tie)
        cells = B * M * N
        rec = compare(
            "sw_align" + sfx, K1_TPU, lambda: cuda_sw.sw_align(qd, rd),
            lambda: cuda_sw.sw_align_plain(qd, rd), 10,
            B * (M + N) + B * 20, cells * K1_OPS_PER_CELL)
        if k2:
            compare("sw_score" + sfx, K2_TPU,
                    lambda: cuda_sw.sw_score(qd, rd),
                    lambda: cuda_sw.sw_score_plain(qd, rd), 10,
                    B * (M + N) + B * 4, cells * K2_OPS_PER_CELL)
        return rec

    # K1 at the align stage's shapes: 150-bp reads in a 192-wide batch,
    # reference window 192 + 2*32
    out.append(sw_both(8192, 192, 256, False, "", False))
    sw_both(8192, 192, 256, True, "_tie_heavy", False)
    # K2 at the accbkp window-scan shapes (clip length padded to 32s)
    qd, rd = sw_pair(8192, 160, 160, False)
    out.append(compare(
        "sw_score", K2_TPU, lambda: cuda_sw.sw_score(qd, rd),
        lambda: cuda_sw.sw_score_plain(qd, rd), 10,
        8192 * 320 + 8192 * 4, 8192 * 160 * 160 * K2_OPS_PER_CELL))
    del qd, rd

    # K3 at the vote's shapes: 3 hash functions, 65,536 pairs, 2 x 128
    # k-mer starts, 8 slots. Dense seeded input (40 genomes, registers
    # overflow and evict), the main path's density (tune_vote.REAL_SHARE),
    # a ragged B (the last batch of `big`), and an odd P with a ragged B
    # (the 4-byte copy path)
    def vote(name, genome, pk):
        C, B, P = pk.shape
        hits = int(cuda_vote.vote_state(genome, pk)[3].sum())
        return compare(
            name, "localhgt_tpu/ops/pallas_vote.py:111",
            lambda: cuda_vote.vote_state(genome, pk),
            lambda: cuda_vote.vote_state_plain(genome, pk), 10,
            2 * C * B * P * 4 + B * (3 * 8 + 1) * 4,
            int((pk != 0).sum()) * K3_OPS_PER_CANDIDATE
            + hits * K3_OPS_PER_HIT,
            source="localhgt_tpu_torch/csrc/vote.cu")

    dense = tune_vote.dense_inputs(dev)
    out.append(vote("vote_state", *dense))
    vote("vote_state_ragged",
         *(x[:, :37_765].contiguous() for x in dense))
    vote("vote_state_odd_p",
         *(x[:, :4_097, :203].contiguous() for x in dense))
    del dense
    vote("vote_state_real_density", *tune_vote.real_like_inputs(dev))
    # K1 and K2 at validate_events' shape: 512 queries against junction
    # windows 2 x 500 bp wide, the one-block-per-alignment variant. K2's
    # wide variant runs on no path of the port; its check stays out of the
    # kernels record, whose launches come from the paths.
    out.append(sw_both(512, 1000, 1000, False, "_wide", True))
    sw_both(512, 1000, 1000, True, "_wide_tie_heavy", True)
    return out


def counters():
    """{record name: (wrapper, counter attribute)} of every kernel."""
    from localhgt_tpu_torch.ops import cuda_sw, cuda_vote

    return {"sw_align": (cuda_sw.sw_align, "launches"),
            "sw_score": (cuda_sw.sw_score, "launches"),
            "vote_state": (cuda_vote.vote_state, "launches"),
            "sw_align_wide": (cuda_sw.sw_align, "wide_launches")}


def drive(dev, fn):
    """Run fn() with every launch count set to 0 just before; returns
    (fn's result, {record name: launches}, wall seconds)."""
    import torch

    for w, attr in counters().values():
        setattr(w, attr, 0)
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t
    return res, {n: getattr(w, a) for n, (w, a) in counters().items()}, wall


def run_bkp(dev, ref, fq1, fq2, truth, outdir, extra: list) -> dict:
    """`bkp -k 32` through the port's CLI; checks the accuracy gate and
    that K1-K3 launched; returns the launch counts."""
    import torch

    from localhgt_tpu_torch.sim import evaluate
    from localhgt_tpu_torch.sim.simulate import read_truth
    from localhgt_tpu_torch.utils import formats, metrics
    from localhgt_tpu_torch import cli
    from localhgt_tpu_torch.utils import device as device_mod

    tag = "[bkp" + ("_refine" if extra else "") + "]"
    os.makedirs(outdir, exist_ok=True)
    metrics.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    rc, launches, wall = drive(dev, lambda: cli.main(
        ["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2, "-s", "big",
         "-o", outdir, "-k", "32", "--device", str(dev), *extra]))
    if rc != 0:
        raise SystemExit(f"bkp exited {rc}")
    c = metrics.counters()
    rows, _, _ = formats.read_acc_csv(os.path.join(outdir, "big.acc.csv"))
    called = [(r["from_ref"], int(r["from_pos"]), r["to_ref"],
               int(r["to_pos"])) for r in rows]
    score = evaluate.score_bkps(
        evaluate.truth_to_bkps(read_truth(truth)), called)
    n_pairs = int(c.get("n_pairs", 0))
    log(f"{tag} wall {wall:.1f} s, {n_pairs} pairs, "
        f"{n_pairs / wall:.0f} pairs/s")
    log(f"{tag} stage walls (s): {json.dumps(metrics.stage_walls())}")
    if extra:
        log(f"{tag} QCStats: " + json.dumps(
            {k[3:]: int(v) for k, v in c.items() if k.startswith("qc_")}))
    log(f"{tag} intervals {int(c.get('n_intervals', 0))} | sub-reference "
        f"{int(c.get('subref_bp', 0))} bp | mapped pairs "
        f"{int(c.get('mapped_pairs', 0))} | raw junctions "
        f"{int(c.get('raw_junctions', 0))} | final breakpoints "
        f"{int(c.get('final_bkps', 0))}")
    log(f"{tag} recall {score.recall:.4f} FDR {score.fdr:.4f} "
        f"F1 {score.f1:.4f}; JAX package on this fixture: "
        f"{json.dumps(JAX_REFERENCE)}")
    log(f"{tag} device memory peak "
        f"{device_mod.memory_stats(dev)['device_peak_gib']:.2f} GiB")
    log(f"{tag} kernel launches: {json.dumps(launches)}")
    if min(launches[n] for n in ("sw_align", "sw_score", "vote_state")) <= 0:
        raise SystemExit(f"a kernel of the bkp path never launched: "
                         f"{launches}")
    if score.recall < MIN_RECALL or score.fdr > MAX_FDR:
        raise SystemExit(f"accuracy below the gate: recall {score.recall} "
                         f"(>= {MIN_RECALL}), FDR {score.fdr} (<= {MAX_FDR})")
    return launches


def plant_adapters(fq1: str, fq2: str, frac: float, seed: int) -> dict:
    """Rewrite `frac` of the pairs in place to a short insert (60-120 bp of
    the pair's read 1) followed by an Illumina adapter and random bases;
    returns {read name: insert length}."""
    rng = np.random.default_rng(seed)
    adapters = ("AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
                "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT")
    comp = str.maketrans("ACGT", "TGCA")
    with open(fq1) as f:
        r1 = f.read().split("\n")
    with open(fq2) as f:
        r2 = f.read().split("\n")
    n = len(r1) // 4
    planted = {}
    for i in np.flatnonzero(rng.random(n) < frac):
        seq = r1[4 * i + 1]
        size = int(rng.integers(60, 121))
        ins = seq[:size]
        tail = "".join("ACGT"[k] for k in rng.integers(0, 4, len(seq)))
        r1[4 * i + 1] = (ins + adapters[0] + tail)[: len(seq)]
        r2[4 * i + 1] = (ins.translate(comp)[::-1] + adapters[1]
                         + tail)[: len(r2[4 * i + 1])]
        planted[r1[4 * i][1:]] = size
    for path, lines in ((fq1, r1), (fq2, r2)):
        with open(path, "w") as f:
            f.write("\n".join(lines))
    return planted


def check_trimmed(refined: str, planted: dict) -> None:
    with open(refined) as f:
        lines = f.read().split("\n")
    got = {lines[k][1:]: len(lines[k + 1])
           for k in range(0, len(lines) - 3, 4) if lines[k][1:] in planted}
    bad = sum(got.get(name) != size for name, size in planted.items())
    log(f"[bkp_refine] planted short-insert pairs: {len(planted)}, out and "
        f"trimmed to their insert: {len(planted) - bad}")
    if bad:
        raise SystemExit(f"{bad} planted pairs not trimmed to their insert")


def write_toy_cohort(folder: str, seed: int) -> str:
    """40 samples in two cohorts: one group-specific junction each (every
    9th sample carries the other group's) and a random one; returns the
    phenotype CSV."""
    from localhgt_tpu_torch.utils import formats

    rng = np.random.default_rng(seed)
    os.makedirs(folder)
    pheno = ["sample,cohort,disease,full"]
    for i in range(40):
        crc = (i % 2 == 0) != (i % 9 == 0)
        pos = 150 if crc else 850
        rows = [["gA_1", pos + int(rng.integers(0, 40)), "right", "+",
                 "gB_1", pos + 800, "left", "+", "False", "", "", "0.9", 4,
                 5, 6, 7],
                [f"gN{int(rng.integers(0, 6))}_1", 500, "right", "+",
                 "gZ_1", 900, "left", "-", "True", "", "", "0.9", 4, 5, 6,
                 7]]
        with open(os.path.join(folder, f"s{i}.acc.csv"), "w") as f:
            f.write("# the number of reads in the sample is: 100000; "
                    "Insert size is 300.\n" + ",".join(formats.HEADER) + "\n")
            f.writelines(",".join(map(str, r)) + "\n" for r in rows)
        group = "CRC" if i % 2 == 0 else "control"
        pheno.append(f"s{i},{'cA' if i < 20 else 'cB'},{group},{group}")
    path = os.path.join(folder, "pheno.csv")
    with open(path, "w") as f:
        f.write("\n".join(pheno) + "\n")
    return path


def run_analyses(dev, work: str, ref: str, events: str) -> None:
    from localhgt_tpu_torch import cli

    toy = os.path.join(work, "toy_cohort")
    pheno = write_toy_cohort(toy, 5)
    jobs = {"microhomology": ["-b", work, "-r", ref],
            "mechanism": ["-r", ref, "-e", events],
            "classifier": ["-b", toy, "--pheno", pheno, "--markers", "5"],
            "lodo": ["-b", toy, "--pheno", pheno, "--markers", "5"]}
    res = {}
    for what, args in jobs.items():
        out = os.path.join(work, f"{what}.json")
        t = time.perf_counter()
        if cli.main(["analyze", what, *args, "-f", out,
                     "--device", str(dev)]) != 0:
            raise SystemExit(f"analyze {what} failed")
        with open(out) as f:
            res[what] = json.load(f)
        summary = res[what]
        if what == "mechanism":
            kinds = sorted({c["del_mechanism"] for c in summary})
            summary = {"n_events": len(summary), "del_mechanisms": kinds,
                       "homology": [c["homology"] for c in summary]}
        elif what == "microhomology":
            summary = {k: v for k, v in summary.items()
                       if not k.endswith("_freq")}
        log(f"[analyze] {what} ({time.perf_counter() - t:.1f} s): "
            f"{json.dumps(summary)}")
    mh = res["microhomology"]
    if not (mh["n_hgt"] > 0 and mh["n_random"] == 10000
            and np.isfinite(mh["p_value"])):
        raise SystemExit(f"microhomology summary out of range: {mh}")
    if not res["mechanism"]:
        raise SystemExit("mechanism classified no event")
    if not (res["classifier"]["auc"] >= 0.8
            and res["lodo"]["weighted_mean"] >= 0.8):
        raise SystemExit("classifier/lodo AUC below 0.8 on the toy cohort")


def run_validate(dev, work: str, ref: str, events: str, truth: str) -> dict:
    """validate_events on the event calls that match truth; returns the
    launch counts."""
    from localhgt_tpu_torch.io import fasta
    from localhgt_tpu_torch.ops import coder
    from localhgt_tpu_torch.sim.evaluate import TOLERATE_DIST
    from localhgt_tpu_torch.sim.simulate import read_truth
    from localhgt_tpu_torch.tools.validate_events import reconstruct_junctions
    from localhgt_tpu_torch.tools import validate_events

    truth = read_truth(truth)
    with open(events) as f:
        calls = list(csv.DictReader(f))

    def matches(c, t):
        return (c["receptor"] == t.receptor and c["donor"] == t.donor
                and abs(int(c["insert_locus"]) - t.insert_locus)
                < TOLERATE_DIST
                and abs(int(c["delete_start"]) - t.seg_start) < TOLERATE_DIST
                and abs(int(c["delete_end"]) - t.seg_end) < TOLERATE_DIST)

    true_calls = [c for c in calls if any(matches(c, t) for t in truth)]
    if not true_calls:
        raise SystemExit("no event call matches truth")
    sel = os.path.join(work, "true_calls.csv")
    with open(sel, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(true_calls[0]))
        w.writeheader()
        w.writerows(true_calls)
    contigs = fasta.read_fasta(ref)
    rng = np.random.default_rng(11)
    reads = []
    for t in truth:
        for j in reconstruct_junctions(contigs, t.receptor, t.insert_locus,
                                       t.donor, t.seg_start, t.seg_end,
                                       t.reverse):
            lo = max(0, (len(j) - LONG_READ_LEN) // 2
                     + int(rng.integers(-20, 21)))
            rd = j[lo:lo + LONG_READ_LEN].copy()
            sub = rng.random(len(rd)) < 0.01
            rd[sub] = (rd[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
            reads.append(coder.COMPLEMENT[rd][::-1] if rng.random() < 0.5
                         else rd)
    for _ in range(len(reads)):
        cid = int(rng.integers(1, contigs.n + 1))
        p = int(rng.integers(0, contigs.length_of(cid) - LONG_READ_LEN))
        reads.append(contigs.slice_codes(cid, p, p + LONG_READ_LEN))
    lr = os.path.join(work, "long_reads.fq")
    with open(lr, "w") as f:
        for i, rd in enumerate(reads):
            seq = "".join("ACGTN"[c] for c in rd)
            f.write(f"@lr{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    out = os.path.join(work, "validated.csv")
    _, launches, wall = drive(dev, lambda: validate_events.main(
        ["-r", ref, "-e", sel, "--long-reads", lr, "-o", out,
         "--device", str(dev)]))
    with open(out) as f:
        rows = list(csv.DictReader(f))
    ok = sum(r["validated"] == "True" for r in rows)
    log(f"[validate] {len(calls)} event calls, {len(true_calls)} match "
        f"truth, {ok} validated by {len(reads)} long reads in {wall:.1f} s; "
        f"kernel launches: {json.dumps(launches)}")
    if ok < MIN_VALIDATED * len(true_calls):
        raise SystemExit(f"validated {ok} of {len(true_calls)} true calls "
                         f"(< {MIN_VALIDATED:.0%})")
    if launches["sw_align_wide"] <= 0:
        raise SystemExit("K1's wide-reference variant never launched")
    return launches


def run_kmer_stats(dev, fq1: str) -> None:
    from localhgt_tpu_torch.tools import kmer_stats

    t = time.perf_counter()
    rows = kmer_stats.table_stats(fq1, None, 24, dev)
    log(f"[kmer_stats] k=24 on one mate in {time.perf_counter() - t:.1f} s: "
        f"{json.dumps(rows)}")
    if not all(0 < r["empty_rate"] < 1 for r in rows):
        raise SystemExit("kmer_stats: empty rate out of (0, 1)")


def run_pipeline(dev, kernels: list) -> None:
    from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample
    from localhgt_tpu_torch import cli

    work = tempfile.mkdtemp(prefix="lht_smoke_")
    try:
        t = time.perf_counter()
        ref, fq1, fq2, truth = simulate_sample(work, "big", SimParams(**BIG))
        log(f"[simulate] big fixture in {time.perf_counter() - t:.1f} s")

        launches = run_bkp(dev, ref, fq1, fq2, truth, work, [])
        ev = os.path.join(work, "big.events.csv")
        if cli.main(["event", "-r", ref, "-b", work, "-f", ev]) != 0:
            raise SystemExit("event failed")
        with open(ev) as f:
            log(f"[event] {sum(1 for _ in f) - 1} events")

        t = time.perf_counter()
        planted = plant_adapters(fq1, fq2, ADAPTER_FRAC, 3)
        log(f"[bkp_refine] rewrote {len(planted)} pairs to a short insert "
            f"with an adapter tail in {time.perf_counter() - t:.1f} s")
        refined = os.path.join(work, "refined")
        run_bkp(dev, ref, fq1, fq2, truth, refined, ["--refine_fq", "1"])
        check_trimmed(os.path.join(refined, "big_refined_1.fq"), planted)

        run_analyses(dev, work, ref, ev)
        launches["sw_align_wide"] = run_validate(
            dev, work, ref, ev, truth)["sw_align_wide"]
        run_kmer_stats(dev, fq1)
        for rec in kernels:
            rec["launches"] = launches[rec["name"]]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; it needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    try:
        from localhgt_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke.py: run it from the repository's root ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    log(f"[env] {card_line()}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"[env] {nvcc.stdout.strip().splitlines()[-1]}")
    t = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(_build.build, n) for n in ("sw", "vote")]:
            fut.result()
    log(f"[build] K1/K2 sw.cu + K3 vote.cu in {time.perf_counter() - t:.1f} s")

    kernels = check_kernels(dev)
    run_pipeline(dev, kernels)
    if "jax" in sys.modules:
        raise SystemExit("jax was imported")
    log(f"[wall] chip_smoke.py {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
