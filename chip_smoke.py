#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (localhgt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one CUDA card, nvcc and g++

Phases, each fatal on failure:
  1. environment: card name and power limit (nvidia-smi), torch, CUDA, nvcc;
  2. build kernels K1/K2 (csrc/sw.cu) and K3 (csrc/vote.cu) with nvcc;
  3. each kernel against its plain torch version on the card, at the main
     path's shapes, exact integer equality, both timed with CUDA events;
  4. simulate the `big` fixture (100 genomes x 1 Mbp, 50 HGTs, depth 5,
     seed 42) in a temporary directory;
  5. `bkp` at k=32 through the port's CLI entry on the card: every kernel
     must launch, recall >= 0.90 and FDR <= 0.05 (+-50 bp);
  6. `event` on the output folder through the port's CLI.
The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

BIG = dict(n_genomes=100, genome_len=1_000_000, hgt_num=50, depth=5,
           snp_rate=0.01, seed=42)
# the JAX package's own results on this fixture at k=32 (BENCH_r05.json)
JAX_REFERENCE = {"intervals": 188, "subref_bp": 224_902, "final_bkps": 92,
                 "recall": 0.92}
MIN_RECALL, MAX_FDR = 0.90, 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean ms per call on the current stream, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    import torch

    from localhgt_tpu_torch.ops import cuda_sw, cuda_vote

    rng = np.random.default_rng(2024)
    out = []

    def compare(name, source, replaces, kern, plain, reps):
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        ms = time_ms(kern, reps)
        plain_ms = time_ms(plain, 2)
        log(f"[kernels] {name}: max_abs_err={err} kernel {ms:.3f} ms, "
            f"plain torch {plain_ms:.3f} ms")
        if err != 0:
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err})")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms}

    # K1 at the align stage's shapes: 150-bp reads in a 192-wide batch,
    # reference window 192 + 2*32
    for tie in (False, True):
        q, r = sw_inputs(rng, 8192, 192, 256, tie)
        qd, rd = torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)
        rec = compare(
            "sw_align" + ("_tie_heavy" if tie else ""),
            "localhgt_tpu_torch/csrc/sw.cu",
            "localhgt_tpu/ops/pallas_sw.py:208",
            lambda: cuda_sw.sw_align(qd, rd),
            lambda: cuda_sw.sw_align_plain(qd, rd), reps=10)
        if not tie:
            out.append(rec)
    # K2 at the accbkp window-scan shapes (clip length padded to 32s)
    q, r = sw_inputs(rng, 8192, 160, 160, False)
    qd, rd = torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)
    out.append(compare(
        "sw_score", "localhgt_tpu_torch/csrc/sw.cu",
        "localhgt_tpu/ops/pallas_sw.py:89",
        lambda: cuda_sw.sw_score(qd, rd),
        lambda: cuda_sw.sw_score_plain(qd, rd), reps=10))
    # K3 at the vote's shapes: 3 hash functions, 65,536 pairs, 2 x 128
    # k-mer starts, 8 slots; 40 genomes so registers overflow and evict
    C, B, P, n_peaks = 3, 65_536, 256, 5000
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    peak_contig = torch.randint(1, 41, (n_peaks + 1,), generator=gen,
                                device=dev, dtype=torch.int32)
    peak_contig[0] = 0
    pk = torch.randint(1, n_peaks + 1, (C, B, P), generator=gen, device=dev,
                       dtype=torch.int32)
    density = torch.rand((1, B, 1), generator=gen, device=dev) * 0.6
    pk = torch.where(torch.rand((C, B, P), generator=gen, device=dev)
                     < density, pk, 0)
    genome = peak_contig[pk.long()]
    out.append(compare(
        "vote_state", "localhgt_tpu_torch/csrc/vote.cu",
        "localhgt_tpu/ops/pallas_vote.py:111",
        lambda: cuda_vote.vote_state(genome, pk),
        lambda: cuda_vote.vote_state_plain(genome, pk), reps=10))
    return out


def run_pipeline(dev, kernels: list) -> None:
    import torch

    from localhgt_tpu.sim import evaluate
    from localhgt_tpu.sim.simulate import SimParams, read_truth, \
        simulate_sample
    from localhgt_tpu.utils import formats, metrics
    from localhgt_tpu_torch import cli
    from localhgt_tpu_torch.ops import cuda_sw, cuda_vote
    from localhgt_tpu_torch.utils import device as device_mod

    work = tempfile.mkdtemp(prefix="lht_smoke_")
    try:
        t = time.perf_counter()
        ref, fq1, fq2, truth = simulate_sample(work, "big", SimParams(**BIG))
        log(f"[simulate] big fixture in {time.perf_counter() - t:.1f} s")

        wrappers = {"sw_align": cuda_sw.sw_align,
                    "sw_score": cuda_sw.sw_score,
                    "vote_state": cuda_vote.vote_state}
        for w in wrappers.values():
            w.launches = 0
        metrics.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        rc = cli.main(["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2,
                       "-s", "big", "-o", work, "-k", "32",
                       "--device", str(dev)])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t
        launches = {n: w.launches for n, w in wrappers.items()}
        if rc != 0:
            raise SystemExit(f"bkp exited {rc}")
        counters = metrics.counters()
        rows, _, _ = formats.read_acc_csv(os.path.join(work, "big.acc.csv"))
        called = [(r["from_ref"], int(r["from_pos"]), r["to_ref"],
                   int(r["to_pos"])) for r in rows]
        score = evaluate.score_bkps(
            evaluate.truth_to_bkps(read_truth(truth)), called)
        mem = device_mod.memory_stats(dev)
        n_pairs = int(counters.get("n_pairs", 0))
        log(f"[bkp] wall {wall:.1f} s, {n_pairs} pairs, "
            f"{n_pairs / wall:.0f} pairs/s")
        log(f"[bkp] stage walls (s): {json.dumps(metrics.stage_walls())}")
        log("[bkp] intervals {} | sub-reference {} bp | mapped pairs {} | "
            "raw junctions {} | final breakpoints {}".format(
                int(counters.get("n_intervals", 0)),
                int(counters.get("subref_bp", 0)),
                int(counters.get("mapped_pairs", 0)),
                int(counters.get("raw_junctions", 0)),
                int(counters.get("final_bkps", 0))))
        log(f"[bkp] recall {score.recall:.4f} FDR {score.fdr:.4f} "
            f"F1 {score.f1:.4f}; JAX package on this fixture: "
            f"{json.dumps(JAX_REFERENCE)}")
        log(f"[bkp] device memory peak {mem['device_peak_gib']:.2f} GiB")
        log(f"[bkp] kernel launches: {json.dumps(launches)}")
        for rec in kernels:
            rec["launches"] = launches[rec["name"]]
        if min(launches.values()) <= 0:
            raise SystemExit(f"a kernel of the main path never launched: "
                             f"{launches}")
        if score.recall < MIN_RECALL or score.fdr > MAX_FDR:
            raise SystemExit(f"accuracy below the gate: recall "
                             f"{score.recall} (>= {MIN_RECALL}), FDR "
                             f"{score.fdr} (<= {MAX_FDR})")

        ev = os.path.join(work, "big.events.csv")
        if cli.main(["event", "-r", ref, "-b", work, "-f", ev]) != 0:
            raise SystemExit("event failed")
        with open(ev) as f:
            n_events = sum(1 for _ in f) - 1
        log(f"[event] {n_events} events")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import torch

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
    for name in ("sw", "vote"):
        _build.build(name)
    log(f"[build] K1/K2 sw.cu + K3 vote.cu in {time.perf_counter() - t:.1f} s")

    kernels = check_kernels(dev)
    run_pipeline(dev, kernels)
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
