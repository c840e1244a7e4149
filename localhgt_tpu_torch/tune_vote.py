"""Time kernel K3 (csrc/vote.cu) in several tilings on one CUDA card.

    python -m localhgt_tpu_torch.tune_vote [--real] [--parent DIR]
                                           [--json out.json]

Builds csrc/vote.cu once per (pairs per block, tile positions, ring
stages, probe) variant with `-DLHT_VOTE_*` flags, all nvcc runs started together,
and the default variant also with `-Xptxas -v`. Every variant is held
exactly against `vote_state_plain` on the dense seeded input (C=3,
B=65,536, P=256, 40 genomes) and then timed with CUDA events on that
input, on an input whose share of non-zero candidates is that of a real
`big` batch (`REAL_SHARE`), on a ragged B and on a P that is no multiple
of 4. `--real` also
simulates the `big` fixture, runs `bkp` at k=32 with a hook on the vote
that prints every batch's shape and non-zero share, and times the variants
on the first real batch. `--parent DIR` times `vote_state` of another
checkout of the package (a subprocess in DIR) on the same dense input.
It prints the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

# (pairs per block, positions per tile, stages, probe); the first is the
# default of csrc/vote.cu. Probe 1 times the scan without the device-memory
# traffic and probe 2 the copies without the scan: both give wrong results
# and are only timed.
VARIANTS = [(128, 16, 2, 0), (64, 16, 2, 0), (128, 8, 2, 0), (64, 8, 2, 0),
            (128, 8, 3, 0), (128, 4, 2, 0), (64, 32, 2, 0), (128, 16, 2, 1),
            (128, 16, 2, 2), (128, 8, 2, 1), (128, 8, 2, 2), (64, 32, 2, 2)]
# Non-zero share of the candidates over the 26 vote batches of `bkp` on
# `big` at k=32, where every pair has some (0.5265 to 0.5302 a batch,
# printed by --real on an NVIDIA H100 80GB HBM3): the 16 GiB direct map is
# dense, so most k-mers of a read meet a peak of some genome
REAL_SHARE = 0.528
SHAPE = (3, 65_536, 256)
BIG = dict(n_genomes=100, genome_len=1_000_000, hgt_num=50, depth=5,
           snp_rate=0.01, seed=42)

PARENT_SNIPPET = """
import json, sys, torch
sys.path.insert(0, {here!r})
from localhgt_tpu_torch.tune_vote import dense_inputs, time_ms
sys.path.pop(0)
for m in [m for m in sys.modules if m.startswith("localhgt_tpu_torch")]:
    del sys.modules[m]
from localhgt_tpu_torch.ops import cuda_vote
dev = torch.device("cuda:0")
genome, pk = dense_inputs(dev)
print(json.dumps({{"parent_dense_ms": time_ms(
    lambda: cuda_vote.vote_state(genome, pk), 10)}}))
"""


def time_ms(fn, reps: int) -> float:
    """Mean ms per call on the current stream, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _candidates(dev, shape, density, seed: int, n_genomes: int = 40,
                n_peaks: int = 5000):
    """(genome, pk) int32 [C, B, P]: each candidate is a random peak with
    probability density[b] (a [1, B, 1] tensor), else 0."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    peak_contig = torch.randint(1, n_genomes + 1, (n_peaks + 1,),
                                generator=gen, device=dev, dtype=torch.int32)
    peak_contig[0] = 0
    pk = torch.randint(1, n_peaks + 1, shape, generator=gen, device=dev,
                       dtype=torch.int32)
    keep = torch.rand(shape, generator=gen, device=dev) < density.to(dev)
    pk = torch.where(keep, pk, 0)
    return peak_contig[pk.long()], pk


def dense_inputs(dev, shape=SHAPE, seed: int = 7):
    """Every pair has its own density in [0, 0.6) and 40 genomes to meet,
    so registers overflow and evict."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    density = torch.rand((1, shape[1], 1), generator=gen) * 0.6
    return _candidates(dev, shape, density, seed)


def real_like_inputs(dev, shape=SHAPE, seed: int = 8,
                     share: float = REAL_SHARE):
    """Every candidate is set with probability `share`, to a peak of one
    of 100 genomes: the density of the main path's batches on `big`."""
    return _candidates(dev, shape, torch.full((1, shape[1], 1), share),
                       seed, n_genomes=100)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def build_variants():
    """{variant: loaded library}; one nvcc per variant, started together."""
    from localhgt_tpu_torch import _build
    from localhgt_tpu_torch.ops import cuda_vote

    def one(v):
        flags = (f"-DLHT_VOTE_PAIRS={v[0]}", f"-DLHT_VOTE_TILE={v[1]}",
                 f"-DLHT_VOTE_STAGES={v[2]}", f"-DLHT_VOTE_PROBE={v[3]}")
        if v == VARIANTS[0]:
            flags += ("-Xptxas", "-v")
        lib = ctypes.CDLL(str(_build.build("vote", flags)))
        lib.lht_vote_state.argtypes = cuda_vote.SIGNATURE
        lib.lht_vote_state.restype = ctypes.c_int
        return lib

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(zip(VARIANTS, pool.map(one, VARIANTS)))


def equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def real_batches(dev) -> list:
    """Run `bkp` on `big` at k=32 and return [(genome, pk)] of its first
    vote batch; prints every batch's shape and non-zero shares."""
    from localhgt_tpu_torch import cli
    from localhgt_tpu_torch.ops import cuda_vote
    from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample

    kept, inner = [], cuda_vote.vote_state

    def hook(genome, pk, n_slots=8):
        nz = pk != 0
        print(f"[real] batch {tuple(pk.shape)}: non-zero candidates "
              f"{nz.float().mean().item():.6f}, pairs with any "
              f"{nz.any(dim=2).any(dim=0).float().mean().item():.6f}, "
              f"positions with any {nz.any(dim=0).float().mean().item():.6f}",
              flush=True)
        if not kept:
            kept.append((genome.clone(), pk.clone()))
        return inner(genome, pk, n_slots)

    hook.launches = 0
    work = tempfile.mkdtemp(prefix="lht_tune_")
    try:
        ref, fq1, fq2, _ = simulate_sample(work, "big", SimParams(**BIG))
        cuda_vote.vote_state = hook
        rc = cli.main(["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2, "-s",
                       "big", "-o", work, "-k", "32", "--device", str(dev)])
        if rc != 0:
            raise SystemExit(f"bkp exited {rc}")
    finally:
        cuda_vote.vote_state = inner
        shutil.rmtree(work, ignore_errors=True)
    return kept


def main(argv=None) -> int:
    from localhgt_tpu_torch.ops import cuda_vote

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--real", action="store_true",
                    help="also time on the first vote batch of bkp on big")
    ap.add_argument("--parent", default="",
                    help="another checkout whose vote_state is timed too")
    ap.add_argument("--json", default="", help="also write the times here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_vote: CUDA is not available")
    dev = torch.device("cuda:0")
    print(card_line(), flush=True)
    libs = build_variants()

    inputs = {"dense": dense_inputs(dev),
              "real_like": real_like_inputs(dev)}
    C, B, P = SHAPE
    inputs["dense_ragged"] = tuple(
        x[:, : B - 12_345].contiguous() for x in inputs["dense"])
    inputs["odd_p"] = tuple(
        x[:, :4097, :203].contiguous() for x in inputs["dense"])
    if args.real:
        inputs["real"] = real_batches(dev)[0]
    out = {"card": card_line(), "times_ms": {}}
    for name, (genome, pk) in inputs.items():
        want = cuda_vote.vote_state_plain(genome, pk)
        for v, lib in libs.items():
            got = cuda_vote.launch(lib, genome, pk)
            torch.cuda.synchronize()
            if not v[3] and not equal(got, want):
                raise SystemExit(f"variant {v} disagrees with the plain "
                                 f"version on {name}")
            ms = time_ms(lambda: cuda_vote.launch(lib, genome, pk), 20)
            out["times_ms"].setdefault(name, {})[str(v)] = ms
            print(f"[tune] {name} {tuple(pk.shape)} "
                  f"pairs/tile/stages/probe {v}: "
                  f"{ms:.4f} ms", flush=True)
    if args.parent:
        res = subprocess.run(
            [sys.executable, "-c", PARENT_SNIPPET.format(
                here=str(Path(__file__).resolve().parent.parent))],
            cwd=args.parent, capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"parent timing failed:\n{res.stderr}")
        out.update(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"[tune] parent's vote_state on dense: "
              f"{out['parent_dense_ms']:.4f} ms", flush=True)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
