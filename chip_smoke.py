#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (localhgt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one CUDA card, nvcc and g++

Phases, each fatal on failure:
  1. environment: card name and power limit (nvidia-smi), torch, CUDA, nvcc;
  2. build kernels K1/K2 (csrc/sw.cu), K3 (csrc/vote.cu), K4/K5
     (csrc/kmer.cu) and K6 (csrc/seed.cu), one nvcc each, in parallel;
  3. each kernel against its plain torch version on the card, exact integer
     equality, both timed with CUDA events and printed beside the kernel's
     bound (the larger of its bytes over 3.35 TB/s and its integer
     operations over SMs x 64 lanes x the SM clock): at the bkp path's
     shapes (K2 at every window width accbkp makes from 150-bp reads: 96,
     128 and 160; K1 at the main path's median batch of 152, the record,
     and in a full tile of 8,192), K1/K2 also at validate_events' wide
     reference (B=512, M=N=1,000), K1/K2 also where the reference is
     wider than their block and they run in bands, a block a band in a
     thread-block cluster (B=64, M=800, N = 4,097, 6,000 and 8,192, and
     past the cluster's reach of 8 bands B=4, M=200, N=40,000 and B=2,
     M=600, N=70,000: 18 bands in three rounds, with more query rows than
     the ring between two blocks holds; random and tie-heavy inputs),
     K3 also at the main path's candidate density, at a ragged B, at a P
     that is no multiple of 4 and at the sharded vote's B; K4 (the
     canonical hashes, bit-equal at every position) at the count, scan,
     peak-set and vote shapes, K4's count epilogue and K5 (the run-capped
     table update, one launch for the three key rows into three k=32
     tables, its time also given a row) on a 65,536-read batch at depth 5;
     K6 (the align stage's seed prefilter) at bkp's batch (65,536 reads
     of 150 bp padded to 192, the bitmap of a random 225 kbp
     sub-reference) and direct mode's (16,384 reads, a random 100 Mbp
     reference), its bound from the probes the function needs; the card's
     clocks, temperature and power are printed before and after the
     records;
  4. simulate the `big` fixture (100 genomes x 1 Mbp, 50 HGTs, depth 5,
     seed 42) in a temporary directory;
  5. `bkp` at k=32 through the port's CLI entry on the card: every kernel
     must launch, K4 in the scan, peak-set and vote stages, K4's count
     epilogue and K5 in the count stage, K5 once a count batch (for all
     three tables), K6 twice an align batch (once a mate), all in the
     align stage; recall >= 0.90 and FDR <= 0.05
     (+-50 bp); logs the (B, N) of K2's launches and the (B, M, N) of
     K1's;
  6. `event` on the output folder through the port's CLI, then the
     multi-device path on one card: `bkp --multi_chip on` through the CLI
     (a mesh of one shard) and `detect_breakpoint` over a mesh of four
     shards that all sit on the card; each must write phase 5's
     interval.txt, bed and acc.csv byte for byte, K3 must launch once per
     shard and vote batch, K1 at least as often as in phase 5, K6 as
     often, K4's count epilogue and K5 never (the mesh count has its own
     step);
  7. `bkp --refine_fq 1` at k=32 after 2% of the pairs were rewritten to a
     short insert with an adapter tail: every such pair comes out trimmed
     to its insert, the phase-5 gate holds and K1-K3 launch;
  8. `analyze microhomology` and `mechanism` on the phase-5/6 outputs,
     `classifier` and `lodo` on a seeded toy cohort, on the card;
  9. `validate_events` on the event calls that match truth, with long
     reads cut from the truth junctions (1% substitutions) plus as many
     from random reference windows: >= 90% validated, and K1's
     wide-reference variant launches;
 10. `kmer_stats` at k=24 on one mate of `big`: K4's count epilogue and
     K5 launch, K5 once a count batch;
 11. `tools.mapq_calibration.run` on the card: its report equals the JAX
     package's (reports/mapq_calibration.json) key for key, and K1 and
     K6 launch;
 12. `python -m localhgt_tpu_torch.bench --scale species20` as a child
     process: it exits 0 and its record is on the card ("gpu", the card's
     name), holds the fixture's 101,335 pairs, recall >= 0.90, FDR <=
     0.05, all seven stage walls, and the count stage's four spans
     (`count.parse`, `.pad`, `.upload`, `.step`) in its counters, their
     sum within the count wall;
 13. `tools.comparator_run.run` on its default fixture (20 x 150 kbp,
     depth 10, snp 0.01, seed 42) at k=32: the k-mer row and the
     direct-mode row (`bkp --use_kmer 0`) equal the JAX package's
     (reports/comparator.csv) in recall, fdr, f1 and n_called, the
     reference engine's row reads skipped, K1, K2 and K6 launch in the
     direct row, whose K1 launches by (B, M, N) are logged, K6 in the
     k-mer row.
Phase 5b runs between phases 6 and 7, on the fixture as simulated:
`tools.loss_table` on `big` at k=32, whose summary must equal the JAX
package's (reports/loss_table_big.json) key for key, with K1-K3 and K6
launched.
Each phase's kernel launches are counted from 0 just before it and read
just after. The last two lines of standard output are the kernels' JSON
record and {"ok": true, "device": {...}}. Imports nothing of JAX and
nothing of the JAX package `localhgt_tpu`.
"""

from __future__ import annotations

import collections
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
REPO = os.path.dirname(os.path.abspath(__file__))
# the JAX package's own loss table on `big` and mapq report, both written
# on the TPU (tools/loss_table.py, tools/mapq_calibration.py)
LOSS_TABLE_REF = os.path.join(REPO, "reports", "loss_table_big.json")
MAPQ_REF = os.path.join(REPO, "reports", "mapq_calibration.json")
# the JAX package's comparator rows on the comparator's default fixture
COMPARATOR_REF = os.path.join(REPO, "reports", "comparator.csv")
COMPARATOR_ROWS = {"localhgt_tpu_torch": "localhgt_tpu",
                   "localhgt_tpu_torch_direct": "localhgt_tpu_direct"}
COMPARATOR_SCORES = ("recall", "fdr", "f1", "n_called")
# references wider than the kernels' block (4,096 columns): bands, a block
# each in a cluster; (B, M, N), the last two past the cluster's 8 bands
# (round-robin, the wrap edge), the last with 18 bands and more query rows
# than the ring between two blocks holds (256)
BAND_SHAPES = ((64, 800, 4097), (64, 800, 6000), (64, 800, 8192),
               (4, 200, 40_000), (2, 600, 70_000))
BENCH_SCALE, BENCH_PAIRS = "species20", 101_335
BENCH_TIMEOUT_S = 300
STAGES = ("count", "scan", "peakset", "vote", "align", "rawbkp", "accbkp")
COUNT_SPANS = ("parse", "pad", "upload", "step")  # count.<part> spans
# the JAX package's own results on this fixture at k=32 (BENCH_r05.json)
JAX_REFERENCE = {"intervals": 188, "subref_bp": 224_902, "final_bkps": 92,
                 "recall": 0.92}
MIN_RECALL, MAX_FDR = 0.90, 0.05
ADAPTER_FRAC = 0.02   # pairs rewritten to a short insert before QC
KMER = 32             # `bkp -k` of every run here: the default config
SHARDS = 4            # mesh entries on the one card in the sharded phase
LONG_READ_LEN = 800   # validate_events: flank 500, min_span 200
MIN_VALIDATED = 0.90
SOURCE = "localhgt_tpu_torch/csrc/sw.cu"
K1_TPU = "localhgt_tpu/ops/pallas_sw.py:208"
K2_TPU = "localhgt_tpu/ops/pallas_sw.py:89"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64
# Integer operations a cell, over the 64 lanes of an SM's integer pipe:
# only what that pipe alone can issue (compares, selects, maxima, byte
# permutes). Adds are left out: they also issue as multiply-adds on the
# FMA pipe, beside the integer pipe.
# K1 needs the winner of every maximum (its origin registers), so the
# three-input forms do not serve it. On sm_90a `__vibmax_s32` compiles to
# a compare and a select (`cuobjdump -sass`: no max with a predicate
# result), so a maximum with its winner is a compare and two selects. In
# the Gotoh form a cell is: substitution (one byte permute, as in K2) 1;
# max(diag + sub, 0) (one add-max) 1; the diagonal's origin (compare
# H > 0, select the carried origin or the cell's index) 2; H1, H, E and F
# 3 each; the best cell (compare, selects of its H, index and origin) 4
# = 20. The cell's five adds (the two gap steps, open + ext onto H1 and
# onto H, the cell's index) are not counted. The kernel's steady loop at
# align's windows issues 20.5 such instructions a cell (32 lanes x 8
# columns: 96 selects, 50 compares, 8 permutes, 8 add-maxima and 2 logic
# ops in a step of 8 cells; 19.9 in the wide 32 x 16), where the
# row-by-row kernel it replaced issued 29.5.
# K2, the score alone, needs no origin behind a maximum, so Hopper's
# three-input forms apply; in the Gotoh form (header of csrc/sw.cu) a cell
# is: substitution (one byte permute out of the column's table word),
# H1 = max(diag + sub, F, 0) (one add-max-relu), H = max(H1, E), E
# (add-max), F (add-max), and half a three-input max for the best = 5.5
# permutes and maxima, which only the integer pipe runs. The cell's two
# other adds (open + ext onto H1 and onto H) are left out: adds also run
# on the FMA pipe as multiply-adds, and all 7.5 instructions at the 128
# lanes a clock an SM's schedulers feed take less time than the 5.5 at 64.
# (sw_score_plain's prefix-max form, with a compare and a select for the
# substitution and two-input maxima, counts 10: the kernel runs in less
# time than that count allows.)
K1_OPS_PER_CELL, K2_OPS_PER_CELL = 20, 5.5
# K3, counted from the data: 2G operations (compare, select-max) per
# non-zero candidate and 3G (compare, increment or victim search and
# insert) per position that has one
K3_OPS_PER_CANDIDATE, K3_OPS_PER_HIT = 16, 24
# K4, a window start: 4 funnel shifts and 4 shifts for the windows, the
# valid compare, 3 bit reversals with their shifts and 2 complements = 17,
# and per hash function 3 ANDs and 2 ORs a strand and the minimum = 11
# (the ballots are 16 a warp, half an instruction a lane)
K4_OPS_PER_START, K4_OPS_PER_HASH = 17, 11
KMER_SOURCE = "localhgt_tpu_torch/csrc/kmer.cu"
# K4 and K5 replace no Pallas kernel: the jitted XLA count step and the
# hashing XLA fuses into the JAX package's scan, peak-set and vote
K4_XLA = "localhgt_tpu/ops/encode.py:91 (XLA, no Pallas kernel)"
K4_COUNT_XLA = "localhgt_tpu/ops/count.py:223-234 (XLA, no Pallas kernel)"
K5_XLA = "localhgt_tpu/ops/count.py:242-248 (XLA, no Pallas kernel)"
SECTOR_BYTES = 32  # the unit in which a byte of the table is read and written
K4_STAGES = ("scan", "peakset", "vote")  # bkp's callers of K4
K4_COUNT = ("count_keys", "run_capped_update")  # the count step's kernels
SEED_SOURCE = "localhgt_tpu_torch/csrc/seed.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def card_state() -> str:
    """The card's SM and memory clocks, temperature and power draw now."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
         "power.draw", "--format=csv,noheader"], capture_output=True,
        text=True, check=True)
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


def check_kernels(dev) -> list:
    """Phase 3: the kernels' records, keyed by the wrapper and counter
    that phases 5-9 read their launches from."""
    import torch

    from localhgt_tpu_torch import tune_sw, tune_vote
    from localhgt_tpu_torch.ops import cuda_sw, cuda_vote

    rng = np.random.default_rng(2024)
    ops_per_s = int32_ops_per_s()
    out = []
    log(f"[card] before phase 3's records: {card_state()}")

    def max_err(g, w) -> int:
        """Largest |g - w|, read only where the two differ (a k=32 table
        is 4 GiB)."""
        diff = g != w
        if not bool(diff.any()):
            return 0
        return int((g[diff].long() - w[diff].long()).abs().max())

    def compare(name, replaces, kern, plain, reps, nbytes, ops,
                source=SOURCE):
        """nbytes: every input read once and every output written once;
        ops: the integer operations these inputs need."""
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(max_err(g, w) for g, w in zip(got, want))
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
        q, r = tune_sw.sw_inputs(rng, B, M, N, tie)
        return torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)

    def sw_both(B, M, N, tie, sfx, k1: bool, k2: bool) -> list:
        """K1 and K2, as asked, on one input; returns their records."""
        qd, rd = sw_pair(B, M, N, tie)
        cells = B * M * N
        recs = []
        if k1:
            recs.append(compare(
                "sw_align" + sfx, K1_TPU, lambda: cuda_sw.sw_align(qd, rd),
                lambda: cuda_sw.sw_align_plain(qd, rd), 10,
                B * (M + N) + B * 20, cells * K1_OPS_PER_CELL))
        if k2:
            recs.append(compare(
                "sw_score" + sfx, K2_TPU, lambda: cuda_sw.sw_score(qd, rd),
                lambda: cuda_sw.sw_score_plain(qd, rd), 10,
                B * (M + N) + B * 4, cells * K2_OPS_PER_CELL))
        return recs

    # K1 at the align stage's shapes: 150-bp reads in a 192-wide batch,
    # reference window 192 + 2*32; the record at the median batch the main
    # path launches (152 on `big`), a full tile of 8,192 only logged
    out += sw_both(152, 192, 256, False, "", True, False)
    sw_both(8192, 192, 256, False, "_b8192", True, False)
    sw_both(8192, 192, 256, True, "_tie_heavy", True, False)
    # K2 at the accbkp window-scan shapes (clip length padded to 32s):
    # 160 is the record, 96 and 128 show what a narrower window costs
    out += sw_both(8192, 160, 160, False, "", False, True)
    sw_both(8192, 160, 160, True, "_tie_heavy", False, True)
    sw_both(8192, 128, 128, False, "_n128", False, True)
    sw_both(8192, 96, 96, False, "_n96", False, True)

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
    # the sharded vote's launch: a 32,768-pair batch over SHARDS shards
    vote("vote_state_shard_rows",
         *(x[:, : 32_768 // SHARDS].contiguous() for x in dense))
    del dense
    vote("vote_state_real_density", *tune_vote.real_like_inputs(dev))
    # K1 and K2 at validate_events' shape: 512 queries against junction
    # windows 2 x 500 bp wide, the one-block-per-alignment variants. K2's
    # runs on no path of the port (no caller of sw_score has N > 512), so
    # its record carries 0 launches.
    out += sw_both(512, 1000, 1000, False, "_wide", True, True)
    sw_both(512, 1000, 1000, True, "_wide_tie_heavy", True, True)
    # K1 and K2 past their block's 4,096 columns: a block a band, the bands
    # of an alignment in a cluster; past 8 bands round-robin with the wrap
    # edge. No path of the port has such a window (0 launches on each).
    t = time.perf_counter()
    for B, M, N in BAND_SHAPES:
        out += sw_both(B, M, N, False, f"_bands_n{N}", True, True)
        out += sw_both(B, M, N, True, f"_bands_n{N}_tie_heavy", True, True)
    log(f"[kernels] band rows in {time.perf_counter() - t:.1f} s")
    out += kmer_rows(dev, rng, compare)
    out += seed_rows(dev, compare)
    log(f"[card] after phase 3's records: {card_state()}")
    return out


def kmer_rows(dev, rng, compare) -> list:
    """Phase 3's K4 and K5 rows at k=32 and three hash functions. K4 at
    the count step's batch (65,536 reads padded to 192: the record), the
    scan's 8 chunks of 2^20, the peak set's chunk of 2^22 + k and the
    vote's 32,768-pair mate batch; its count epilogue and K5 on a count
    batch of depth-5 reads, K5 in one launch for the three sorted key rows
    into three k=32 tables (4 GiB each) that already hold that batch's
    counts."""
    import torch

    from localhgt_tpu_torch.ops import count, cuda_kmer, encode
    from localhgt_tpu_torch.tune_kmer import depth5_reads

    k, C, cap, kw = KMER, 3, 3, 128
    masks, _ = encode.hasher_for(k, C, seed=1)
    out = []

    def hashes(name, shape, record):
        codes = rng.integers(0, 4, shape).astype(np.uint8)
        codes[rng.random(shape) < 0.01] = 4
        codes = torch.from_numpy(codes).to(dev)
        n = codes.numel()
        rec = compare(
            name, K4_XLA,
            lambda: cuda_kmer.canonical_hashes(codes, masks, k),
            lambda: encode.canonical_hashes_plain(codes, masks, k), 10,
            n + n * (8 * C + 1), n * (K4_OPS_PER_START + C * K4_OPS_PER_HASH),
            source=KMER_SOURCE)
        if record:
            out.append(rec)

    hashes("canonical_hashes", (65_536, 192), True)
    hashes("canonical_hashes_scan", (8, 1 << 20), False)
    hashes("canonical_hashes_peakset", (1, (1 << 22) + k), False)
    hashes("canonical_hashes_vote", (32_768, 192), False)

    B, L = 65_536, 192
    codes = torch.from_numpy(depth5_reads(rng, B, L, 2_000_000)).to(dev)
    lengths = torch.full((B,), 150, dtype=torch.int32, device=dev)
    accept = torch.from_numpy(rng.random(B) < 0.98).to(dev)
    # the epilogue's windows start below kw and need codes 0..kw + k - 2
    W = kw if 0 < kw < L else L
    out.append(compare(
        "count_keys", K4_COUNT_XLA,
        lambda: cuda_kmer.count_keys(codes, lengths, accept, masks, k, kw),
        lambda: count.count_keys_plain(codes, lengths, accept, masks, k, kw),
        10, B * min(L, W + k - 1) + 5 * B + 4 * C * B * W,
        B * kw * (K4_OPS_PER_START + C * K4_OPS_PER_HASH),
        source=KMER_SOURCE))

    s = torch.sort(cuda_kmer.count_keys(codes, lengths, accept, masks, k,
                                        kw), dim=1).values
    n_runs, sectors = [], 0
    for row in s:
        s64 = row.to(torch.int64) & count.SENTINEL
        starts = torch.ones_like(s64, dtype=torch.bool)
        starts[1:] = s64[1:] != s64[:-1]
        runs = s64[starts & (s64 != count.SENTINEL)]
        n_runs.append(runs.numel())
        sectors += int(torch.unique(runs // SECTOR_BYTES).numel())
    log(f"[kernels] K5 rows: {s.shape[0]} x {s.shape[1]} keys, {n_runs} "
        f"runs, {sectors} table sectors")
    t_kern = [count.make_table(k, dev) for _ in range(C)]
    t_plain = [count.make_table(k, dev) for _ in range(C)]
    count.run_capped_update_plain(t_kern, s, cap)
    for a, b in zip(t_plain, t_kern):
        a.copy_(b)

    def kern():
        cuda_kmer.run_capped_update(t_kern, s, cap)
        return tuple(t_kern)

    def plain():
        count.run_capped_update_plain(t_plain, s, cap)
        return tuple(t_plain)

    rec = compare(
        "run_capped_update", K5_XLA, kern, plain, 10,
        4 * s.numel() + 2 * SECTOR_BYTES * sectors, 0, source=KMER_SOURCE)
    # one launch for the C rows; a row's share, as a launch a row timed it
    rec["ms_per_row"] = rec["ms"] / C
    log(f"[kernels] run_capped_update: {rec['ms_per_row']:.4f} ms a row "
        f"({C} rows a launch)")
    out.append(rec)
    del t_kern, t_plain
    torch.cuda.empty_cache()
    return out


def seed_rows(dev, compare) -> list:
    """Phase 3's K6 rows: bkp's batch (the record) and direct mode's
    (tune_seed.inputs, edge rows included), each bound by the work these
    inputs need: the windows of each read up to its first hit, their
    codes and the distinct bitmap sectors of their probes."""
    import torch

    from localhgt_tpu_torch import tune_seed
    from localhgt_tpu_torch.ops import cuda_seed
    from localhgt_tpu_torch.pipeline import align

    out = []
    for kind, sfx in (("bkp", ""), ("direct", "_direct")):
        codes, lengths, bitmap = tune_seed.inputs(kind, dev)
        work = tune_seed.prefilter_work(codes, lengths, bitmap)
        log(f"[kernels] seed_prefilter{sfx} {tuple(codes.shape)}: "
            f"{json.dumps(work)}")
        rec = compare(
            "seed_prefilter" + sfx, tune_seed.K6_XLA,
            lambda: cuda_seed.seed_prefilter(codes, lengths, bitmap),
            lambda: align.seed_prefilter_plain(codes, lengths, bitmap), 10,
            work["bytes"], work["windows"] * tune_seed.K6_OPS_PER_WINDOW,
            source=SEED_SOURCE)
        rec["shape"] = list(codes.shape)
        out.append(rec)
        del codes, lengths, bitmap
        torch.cuda.empty_cache()
    return out


def counters():
    """{record name: (wrapper, counter attribute)} of every kernel."""
    from localhgt_tpu_torch.ops import cuda_kmer, cuda_seed, cuda_sw
    from localhgt_tpu_torch.ops import cuda_vote

    return {"sw_align": (cuda_sw.sw_align, "launches"),
            "sw_score": (cuda_sw.sw_score, "launches"),
            "vote_state": (cuda_vote.vote_state, "launches"),
            "sw_align_wide": (cuda_sw.sw_align, "wide_launches"),
            "sw_score_wide": (cuda_sw.sw_score, "wide_launches"),
            "sw_align_bands": (cuda_sw.sw_align, "band_launches"),
            "sw_score_bands": (cuda_sw.sw_score, "band_launches"),
            "canonical_hashes": (cuda_kmer.canonical_hashes, "launches"),
            "count_keys": (cuda_kmer.count_keys, "launches"),
            "run_capped_update": (cuda_kmer.run_capped_update, "launches"),
            "seed_prefilter": (cuda_seed.seed_prefilter, "launches")}


def counter_of(record: str) -> str:
    """The counter of a kernel record: the band records of every width
    and input share their kernel's band counter, K6's direct-mode record
    its kernel's counter."""
    head, bands, _ = record.partition("_bands")
    return head + bands if bands else record.removesuffix("_direct")


def drive(dev, fn):
    """Run fn() with every launch count set to 0 just before; returns
    (fn's result, {record name: launches}, wall seconds)."""
    import torch

    from localhgt_tpu_torch.ops import cuda_kmer, cuda_seed, cuda_sw

    for w, attr in counters().values():
        setattr(w, attr, 0)
    cuda_kmer.canonical_hashes.stages.clear()
    cuda_seed.seed_prefilter.stages.clear()
    cuda_sw.sw_align.shapes.clear()
    cuda_sw.sw_score.shapes.clear()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t
    return res, {n: getattr(w, a) for n, (w, a) in counters().items()}, wall


def check_k5_batches(tag: str, launches: dict) -> None:
    """K5 launches once a count batch (K4's count epilogue once a batch
    too), for all the tables together."""
    log(f"{tag} count batches (K4 count epilogue launches) "
        f"{launches['count_keys']}, K5 launches "
        f"{launches['run_capped_update']}")
    if launches["run_capped_update"] != launches["count_keys"]:
        raise SystemExit(f"{tag} K5 launched {launches['run_capped_update']}"
                         f" times, not once for each of "
                         f"{launches['count_keys']} count batches")


def run_bkp(dev, ref, fq1, fq2, truth, outdir, extra: list) -> dict:
    """`bkp -k 32` through the port's CLI; checks the accuracy gate and
    that K1-K3 launched; returns the launch counts."""
    import torch

    from localhgt_tpu_torch.ops import cuda_kmer, cuda_seed, cuda_sw
    from localhgt_tpu_torch.pipeline import extract
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
         "-o", outdir, "-k", str(KMER), "--device", str(dev), *extra]))
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
    stages = dict(cuda_kmer.canonical_hashes.stages)
    log(f"{tag} K4 launches by stage: {json.dumps(stages)}")
    by_bn = collections.Counter()
    for (B, _, N), n in cuda_sw.sw_score.shapes.items():
        by_bn[(B, N)] += n
    log(f"{tag} K2 launches by (B, N): " + ", ".join(
        f"({B}, {N}) x {n}" for (B, N), n in sorted(by_bn.items())))
    k1 = sorted(cuda_sw.sw_align.shapes.items())
    log(f"{tag} K1 launches by (B, M, N): " + ", ".join(
        f"{shape} x {n}" for shape, n in k1))
    if min(launches[n] for n in ("sw_align", "sw_score", "vote_state",
                                 *K4_COUNT)) <= 0 or \
            min(stages.get(st, 0) for st in K4_STAGES) <= 0:
        raise SystemExit(f"a kernel of the bkp path never launched: "
                         f"{launches}; K4 by stage {stages}")
    launches["canonical_hashes_stages"] = stages
    check_k5_batches(tag, launches)
    # the sub-reference (< 32 Mbp) keeps align's batches at the count's
    # 65,536 reads, cached or read again
    seed_stages = dict(cuda_seed.seed_prefilter.stages)
    batches = -(-n_pairs // extract.COUNT_BATCH_READS)
    log(f"{tag} K6 launches {launches['seed_prefilter']} for {batches} "
        f"align batches of two mates; by stage {json.dumps(seed_stages)}")
    if launches["seed_prefilter"] != 2 * batches or \
            seed_stages.get("align") != 2 * batches:
        raise SystemExit(f"{tag} K6 launched {launches['seed_prefilter']} "
                         f"times ({seed_stages}), not twice for each of "
                         f"{batches} align batches")
    launches["seed_prefilter_stages"] = seed_stages
    if score.recall < MIN_RECALL or score.fdr > MAX_FDR:
        raise SystemExit(f"accuracy below the gate: recall {score.recall} "
                         f"(>= {MIN_RECALL}), FDR {score.fdr} (<= {MAX_FDR})")
    return launches


def run_sharded(dev, ref, fq1, fq2, work: str, single: dict) -> None:
    """`bkp` at k=32 over a device mesh, twice: `--multi_chip on` through
    the CLI (one shard: what one card gives) and `detect_breakpoint` over
    SHARDS entries that all name the card, so that table slices, stream
    merging and the reductions run as on as many cards. Each run's files
    must equal those of the single-device run in `work`; `single` holds
    that run's launch counts."""
    import torch

    from localhgt_tpu_torch import cli
    from localhgt_tpu_torch.parallel.mesh import make_flat_mesh
    from localhgt_tpu_torch.pipeline import extract
    from localhgt_tpu_torch.pipeline.bkp import detect_breakpoint
    from localhgt_tpu_torch.utils import device as device_mod
    from localhgt_tpu_torch.utils import metrics

    args = ["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2, "-s", "big",
            "-k", str(KMER), "--device", str(dev)]
    cfg = cli.config_from_args(cli.build_parser().parse_args(args))
    mesh = make_flat_mesh([dev] * SHARDS)

    def library_run(out):
        detect_breakpoint(ref, fq1, fq2, "big", out, dev, cfg=cfg, mesh=mesh)
        return 0

    runs = {
        "cli_on": (1, lambda out: cli.main(
            args + ["-o", out, "--multi_chip", "on"])),
        f"mesh_{SHARDS}": (SHARDS, library_run),
    }
    for name, (n, run) in runs.items():
        out = os.path.join(work, f"sharded_{name}")
        os.makedirs(out)
        metrics.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        rc, launches, wall = drive(dev, lambda: run(out))
        if rc != 0:
            raise SystemExit(f"sharded bkp ({name}) exited {rc}")
        n_pairs = int(metrics.counters()["n_pairs"])
        log(f"[sharded {name}] {n} shards on 1 distinct device, wall "
            f"{wall:.1f} s, {n_pairs} pairs; stage walls (s): "
            f"{json.dumps(metrics.stage_walls())}")
        log(f"[sharded {name}] device memory peak "
            f"{device_mod.memory_stats(dev)['device_peak_gib']:.2f} GiB; "
            f"kernel launches: {json.dumps(launches)}")
        for suffix in ("interval.txt", "interval.txt.bed", "acc.csv"):
            with open(os.path.join(out, f"big.{suffix}"), "rb") as f, \
                    open(os.path.join(work, f"big.{suffix}"), "rb") as g:
                if f.read() != g.read():
                    raise SystemExit(f"sharded bkp ({name}): big.{suffix} "
                                     "differs from the single-device run's")
        batches = -(-n_pairs // extract.VOTE_BATCH_READS)
        if launches["vote_state"] != n * batches:
            raise SystemExit(
                f"sharded bkp ({name}): K3 launched "
                f"{launches['vote_state']} times, not once for each of {n} "
                f"shards and {batches} vote batches")
        if launches["canonical_hashes"] <= 0:
            raise SystemExit(f"sharded bkp ({name}): K4 never launched")
        if launches["run_capped_update"] or launches["count_keys"]:
            raise SystemExit(f"sharded bkp ({name}): the mesh count "
                             f"launched the single-device count step's "
                             f"kernels: {launches}")
        if launches["sw_align"] < single["sw_align"]:
            raise SystemExit(
                f"sharded bkp ({name}): K1 launched {launches['sw_align']} "
                f"times, the single-device run {single['sw_align']}")
        if launches["seed_prefilter"] != single["seed_prefilter"]:
            raise SystemExit(
                f"sharded bkp ({name}): K6 launched "
                f"{launches['seed_prefilter']} times, the single-device run "
                f"{single['seed_prefilter']}")
        shutil.rmtree(out)


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
    from localhgt_tpu_torch.ops import coder, cuda_sw
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
        f"kernel launches: {json.dumps(launches)}; K1 launches by (B, M, "
        f"N): {sorted(cuda_sw.sw_align.shapes.items())}")
    if ok < MIN_VALIDATED * len(true_calls):
        raise SystemExit(f"validated {ok} of {len(true_calls)} true calls "
                         f"(< {MIN_VALIDATED:.0%})")
    if launches["sw_align_wide"] <= 0:
        raise SystemExit("K1's wide-reference variant never launched")
    return launches


def run_kmer_stats(dev, fq1: str) -> None:
    from localhgt_tpu_torch.tools import kmer_stats

    rows, launches, wall = drive(
        dev, lambda: kmer_stats.table_stats(fq1, None, 24, dev))
    log(f"[kmer_stats] k=24 on one mate in {wall:.1f} s: "
        f"{json.dumps(rows)}; kernel launches: {json.dumps(launches)}")
    if not all(0 < r["empty_rate"] < 1 for r in rows):
        raise SystemExit("kmer_stats: empty rate out of (0, 1)")
    if min(launches[n] for n in K4_COUNT) <= 0:
        raise SystemExit(f"kmer_stats: the count step's kernels never "
                         f"launched: {launches}")
    check_k5_batches("[kmer_stats]", launches)


def run_loss_table(dev, ref, fq1, fq2, truth) -> None:
    """Phase 5b: the loss table of `big` at k=32 against the JAX
    package's."""
    from localhgt_tpu_torch.config import Config, KmerConfig
    from localhgt_tpu_torch.tools.loss_table import loss_table

    with open(LOSS_TABLE_REF) as f:
        want = json.load(f)
    cfg = Config().replace(kmer=KmerConfig(k=KMER))
    rec, launches, wall = drive(dev, lambda: loss_table(
        ref, fq1, fq2, truth, cfg, dev, scale="big"))
    same = sum(a == b for a, b in zip(rec["bkps"], want["bkps"]))
    log(f"[loss_table] {wall:.1f} s: {json.dumps(rec['summary'])}; "
        f"{same} of {len(want['bkps'])} per-breakpoint records equal the "
        f"JAX package's; kernel launches: {json.dumps(launches)}")
    if rec["summary"] != want["summary"]:
        raise SystemExit(f"loss table summary differs from the JAX "
                         f"package's: {json.dumps(want['summary'])}")
    if min(launches[n] for n in ("sw_align", "sw_score", "vote_state",
                                 "seed_prefilter")) <= 0:
        raise SystemExit(f"a kernel of the loss table never launched: "
                         f"{launches}")


def run_mapq(dev, work: str) -> None:
    """Phase 11: the mapq calibration against the JAX package's report."""
    from localhgt_tpu_torch.tools import mapq_calibration

    with open(MAPQ_REF) as f:
        want = json.load(f)
    rep, launches, wall = drive(dev, lambda: mapq_calibration.run(
        os.path.join(work, "mapq"), dev))
    log(f"[mapq] {wall:.1f} s: {json.dumps(rep)}; kernel launches: "
        f"{json.dumps(launches)}")
    if rep != want:
        raise SystemExit(f"mapq report differs from the JAX package's: "
                         f"{json.dumps(want)}")
    if min(launches["sw_align"], launches["seed_prefilter"]) <= 0:
        raise SystemExit(f"K1 or K6 never launched in the mapq calibration: "
                         f"{launches}")


def run_bench() -> None:
    """Phase 12: the bench at species20 as a user runs it, in a child
    process."""
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "localhgt_tpu_torch.bench", "--scale",
         BENCH_SCALE], cwd=REPO, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        raise SystemExit(f"bench exited {res.returncode}: "
                         f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    rec = json.loads(lines[-1])
    log(f"[bench] {BENCH_SCALE} in {wall:.1f} s: {lines[-1]}")
    counters = rec.get("counters", {})
    spans = [counters.get(f"count.{p}_s") for p in COUNT_SPANS]
    # the record rounds each counter to 0.1 s
    count_spans_ok = None not in spans and sum(spans) <= rec.get(
        "stage_walls", {}).get("count", 0) + 0.05 * len(spans)
    bad = [f"{key} = {rec.get(key)!r}" for key, ok in (
        ("platform", rec.get("platform") == "gpu"),
        ("n_pairs", rec.get("n_pairs") == BENCH_PAIRS),
        ("recall", rec.get("recall", 0) >= MIN_RECALL),
        ("fdr", rec.get("fdr", 1) <= MAX_FDR),
        ("stage_walls", set(STAGES) <= set(rec.get("stage_walls", ()))),
        ("counters", count_spans_ok),
        ("card", bool(rec.get("card")))) if not ok]
    if bad:
        raise SystemExit(f"bench record out of its gate: {bad}")


def run_comparator(dev, work: str) -> dict:
    """Phase 13: the comparator's k-mer and direct-mode rows against the
    JAX package's; returns the direct row's launches."""
    from localhgt_tpu_torch.tools import comparator_run

    with open(COMPARATOR_REF) as f:
        want = {r["tool"]: r for r in csv.DictReader(f)}
    out, launches, wall = drive(dev, lambda: comparator_run.run(
        os.path.join(work, "comparator"), KMER, device=dev))
    rows = out["rows"]
    for name, jax_name in COMPARATOR_ROWS.items():
        row = rows[name]
        got = {c: str(row[c]) for c in COMPARATOR_SCORES}
        log(f"[comparator] {name}: {json.dumps(got)}, wall {row['wall_s']} "
            f"s, cpu {row['cpu_s']} s, max RSS {row['max_rss_gb']} GB; "
            f"kernel launches: {json.dumps(row['launches'])}")
        if got != {c: want[jax_name][c] for c in COMPARATOR_SCORES}:
            raise SystemExit(f"comparator row {name} differs from the JAX "
                             f"package's {jax_name}: {want[jax_name]}")
    log(f"[comparator] {wall:.1f} s; reference engine: "
        f"{json.dumps(rows['reference_extract_ref'])}; kernel launches: "
        f"{json.dumps(launches)}")
    if "skipped" not in rows["reference_extract_ref"]:
        raise SystemExit("the reference engine's row ran: its source is "
                         "not in the repository")
    direct = rows["localhgt_tpu_torch_direct"]["launches"]
    if min(direct["sw_align"], direct["sw_score"],
           direct["seed_prefilter"]) <= 0:
        raise SystemExit(f"K1, K2 or K6 never launched in direct mode: "
                         f"{direct}")
    if rows["localhgt_tpu_torch"]["launches"]["seed_prefilter"] <= 0:
        raise SystemExit("K6 never launched in the comparator's k-mer row")
    return direct


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
        run_sharded(dev, ref, fq1, fq2, work, launches)
        # before phase 7 rewrites the FASTQ files
        run_loss_table(dev, ref, fq1, fq2, truth)

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
        run_mapq(dev, work)
        run_bench()
        direct = run_comparator(dev, work)
        for rec in kernels:
            rec["launches"] = launches[counter_of(rec["name"])]
            if rec["name"] == "canonical_hashes":
                rec["launches_by_stage"] = launches["canonical_hashes_stages"]
            elif rec["name"] == "seed_prefilter":
                rec["launches_by_stage"] = launches["seed_prefilter_stages"]
            elif rec["name"] == "seed_prefilter_direct":
                # main-path launches above; direct mode's own, phase 13
                rec["launches_direct_mode"] = direct["seed_prefilter"]
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
    with ThreadPoolExecutor(4) as pool:
        for fut in [pool.submit(_build.build, n)
                    for n in ("sw", "vote", "kmer", "seed")]:
            fut.result()
    log(f"[build] K1/K2 sw.cu + K3 vote.cu + K4/K5 kmer.cu + K6 seed.cu in "
        f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    kernels = check_kernels(dev)
    log(f"[kernels] phase 3 in {time.perf_counter() - t:.1f} s")
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
