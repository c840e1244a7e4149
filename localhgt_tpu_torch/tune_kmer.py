"""Time kernels K4 and K5 (csrc/kmer.cu) on one CUDA card, beside a probe
of what the card takes to touch K5's table sectors.

    python -m localhgt_tpu_torch.tune_kmer [--parent DIR] [--real]
                                           [--json out.json]

Builds csrc/kmer.cu as the package does and once more with the probe
(`-DLHT_KMER_PROBE`) and `-Xptxas -v` (every kernel's registers and
spills), the two nvcc runs started together. Inputs are those of
chip_smoke.py's K4 and K5 rows: a count batch of 65,536 depth-5 reads
padded to 192 (lengths 150, kw 128, k=32, three hash functions, cap 3),
its keys sorted (8,388,608 a row) and three k=32 tables (4 GiB each) that
already hold the batch; K4 at the count, scan, peak-set and vote shapes.
K4 count and K5 (one launch for the three rows) are held exactly against
`count_keys_plain` and `run_capped_update_plain`, then timed through the
package's wrappers with CUDA events after a warm-up, twice in a row. The
probe (`lht_kmer_probe`, on no path of the package) adds 1 at each run
head of a row, the heads compacted by torch beforehand, one thread a
head, a row after another, in the sorted order and shuffled: as one
32-bit atomic add whose result is not read (`red`, the least the card
takes to touch these sectors) and as a byte load and store (`rmw`).
`--parent DIR` times another checkout's `count_keys`, `canonical_hashes`
and `run_capped_update` through its own wrappers (a subprocess in DIR,
on the same inputs, saved under the temporary directory), before and
after this build's times. `--real` adds the first count batch of `bkp`
on `big` at k=32 (the fixture simulated in a temporary directory; the run
stops at that batch). It prints the card's name and power limit. Imports
nothing of JAX.
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

import numpy as np
import torch

from localhgt_tpu_torch.tune_vote import BIG, card_line, time_ms

PROBE = ("-DLHT_KMER_PROBE", "-Xptxas", "-v")  # -v: registers, spills
K, C, CAP, KW = 32, 3, 3, 128
COUNT_SHAPE = (65_536, 192)
K4_SHAPES = {"count": (65_536, 192), "scan": (8, 1 << 20),
             "peakset": (1, (1 << 22) + 32), "vote": (32_768, 192)}
REPS = 20

PARENT_SNIPPET = """
import inspect, json, sys, torch
sys.path.insert(0, {here!r})
from localhgt_tpu_torch.tune_vote import time_ms
sys.path.pop(0)
for m in [m for m in sys.modules if m.startswith("localhgt_tpu_torch")]:
    del sys.modules[m]
from localhgt_tpu_torch.ops import count, cuda_kmer
dev = torch.device("cuda:0")
data = torch.load({inputs!r})
masks = data["masks"].numpy()
out = {{}}
for name, codes in data["k4"].items():
    codes = codes.to(dev)
    out["K4 " + name] = time_ms(
        lambda: cuda_kmer.canonical_hashes(codes, masks, {k}), {reps})
    del codes
# one row at a time (the wrapper's signature before one launch took the
# C rows) or the C rows in one call
per_row = "table" in inspect.signature(cuda_kmer.run_capped_update).parameters
for tag, b in data["batches"].items():
    codes, lengths, accept = (b[n].to(dev) for n in ("codes", "lengths",
                                                     "accept"))
    bm = b["masks"].numpy()
    out["K4 count " + tag] = time_ms(lambda: cuda_kmer.count_keys(
        codes, lengths, accept, bm, {k}, b["kw"]), {reps})
    s = b["sorted"].to(dev)
    tables = [count.make_table({k}, dev) for _ in range(s.shape[0])]
    for t, row in zip(tables, s):
        s64 = row.to(torch.int64) & count.SENTINEL
        count.scatter_delta(t, s64, count.rank_capped_contrib(s64[None],
                                                              {cap})[0])
    if per_row:
        def k5():
            for t, row in zip(tables, s):
                cuda_kmer.run_capped_update(t, row, {cap})
    else:
        def k5():
            cuda_kmer.run_capped_update(tables, s, {cap})
    out["K5 " + tag] = time_ms(k5, {reps})
    del tables, s, codes, lengths, accept
    torch.cuda.empty_cache()
print(json.dumps({{"parent_ms": out}}))
"""


def depth5_reads(rng, B: int, L: int, genome_len: int) -> np.ndarray:
    """codes uint8 [B, L]: 150-bp reads at random starts and strands of a
    random genome of `genome_len` bases, padded with N to L, so that a
    k-mer recurs about B * 150 / genome_len times, as at `big`'s depth 5
    (1% substitutions)."""
    from localhgt_tpu_torch.ops import coder

    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    starts = rng.integers(0, genome_len - 150, B)
    reads = genome[starts[:, None] + np.arange(150)[None, :]]
    rc = rng.random(B) < 0.5
    reads[rc] = coder.COMPLEMENT[reads[rc]][:, ::-1]
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    codes = np.full((B, L), 4, np.uint8)
    codes[:, :150] = reads
    return codes


def count_batch(rng):
    """(codes, lengths, accept) of chip_smoke.py's count rows, on the
    host: depth-5 reads of a 2 Mbp genome, lengths 150, 98% accepted."""
    B, L = COUNT_SHAPE
    codes = torch.from_numpy(depth5_reads(rng, B, L, 2_000_000))
    lengths = torch.full((B,), 150, dtype=torch.int32)
    accept = torch.from_numpy(rng.random(B) < 0.98)
    return codes, lengths, accept


def real_batch(dev):
    """(codes, lengths, accept, masks, kw) of the first count batch of
    `bkp` on `big` at k=32, on the host; bkp stops there."""
    from localhgt_tpu_torch import cli
    from localhgt_tpu_torch.ops import count
    from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample

    class Captured(Exception):
        pass

    kept, inner = {}, count.count_reads_step

    def hook(tables, codes, lengths, accept, masks, k, cap=3, clip=True,
             kw=0):
        kept.update(codes=codes.cpu(), lengths=lengths.cpu(),
                    accept=accept.cpu(), masks=np.asarray(masks), kw=kw,
                    k=k, cap=cap)
        raise Captured

    work = tempfile.mkdtemp(prefix="lht_tune_")
    try:
        ref, fq1, fq2, _ = simulate_sample(work, "big", SimParams(**BIG))
        count.count_reads_step = hook
        try:
            cli.main(["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2, "-s",
                      "big", "-o", work, "-k", str(K), "--device",
                      str(dev)])
        except Captured:
            pass
    finally:
        count.count_reads_step = inner
        shutil.rmtree(work, ignore_errors=True)
    if not kept or kept["k"] != K or kept["cap"] != CAP:
        raise SystemExit(f"tune_kmer: no count batch at k={K}, cap={CAP} "
                         f"was captured")
    print(f"[real] first count batch: codes {tuple(kept['codes'].shape)}, "
          f"kw {kept['kw']}, lengths {int(kept['lengths'].min())} to "
          f"{int(kept['lengths'].max())}, accepted "
          f"{int(kept['accept'].sum())}", flush=True)
    return kept


def build_probe():
    """The probe's library (the package's kernels beside the probe), built
    while the package's own build runs."""
    from localhgt_tpu_torch import _build
    from localhgt_tpu_torch.ops import cuda_kmer

    with ThreadPoolExecutor(2) as pool:
        package = pool.submit(cuda_kmer._lib)
        path = _build.build("kmer", PROBE)
        package.result()
    lib = ctypes.CDLL(str(path))
    lib.lht_kmer_probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]
    lib.lht_kmer_probe.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise SystemExit(f"{what}: CUDA error {err} at launch")


def probe_launch(lib, heads, table, red: bool) -> None:
    _check(lib.lht_kmer_probe(heads.data_ptr(), heads.numel(),
                              table.data_ptr(), int(red),
                              torch.cuda.current_stream().cuda_stream),
           "lht_kmer_probe")


def run_heads(row):
    """The run heads of one sorted key row other than the sentinel, in the
    row's order (int32 bit patterns)."""
    starts = torch.ones_like(row, dtype=torch.bool)
    starts[1:] = row[1:] != row[:-1]
    return row[starts & (row != -1)].contiguous()


def time_batch(tag: str, batch: dict, probe_lib, dev, out) -> None:
    """Hold K4 count and K5 to the plain versions on one count batch, then
    time them and the probe; records go to out["times_ms"]."""
    from localhgt_tpu_torch.ops import count, cuda_kmer

    times = out["times_ms"].setdefault(tag, {})
    codes, lengths, accept = (batch[n].to(dev) for n in ("codes", "lengths",
                                                         "accept"))
    kw, masks = batch["kw"], batch["masks"]
    want = count.count_keys_plain(codes, lengths, accept, masks, K, kw)
    if not torch.equal(cuda_kmer.count_keys(codes, lengths, accept, masks,
                                            K, kw), want):
        raise SystemExit(f"K4 count disagrees with count_keys_plain ({tag})")
    for key in ("K4 count", "K4 count again"):
        times[key] = time_ms(lambda: cuda_kmer.count_keys(
            codes, lengths, accept, masks, K, kw), REPS)

    s = torch.sort(want, dim=1).values
    del want
    runs = [run_heads(row) for row in s]
    sectors = sum(int(torch.unique(
        (r.to(torch.int64) & count.SENTINEL) // 32).numel()) for r in runs)
    print(f"[{tag}] K5 rows: {s.shape[0]} x {s.shape[1]} keys, "
          f"{[r.numel() for r in runs]} runs, {sectors} table sectors",
          flush=True)
    times["K5 runs"] = [r.numel() for r in runs]
    times["K5 sectors"] = sectors
    tables = [count.make_table(K, dev) for _ in range(s.shape[0])]
    count.run_capped_update_plain(tables, s, CAP)  # the batch's counts
    want = [t.clone() for t in tables]
    count.run_capped_update_plain(want, s, CAP)
    got = [t.clone() for t in tables]
    cuda_kmer.run_capped_update(got, s, CAP)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit(f"K5 disagrees with run_capped_update_plain ({tag})")
    del got, want
    for key in ("K5", "K5 again"):
        times[key] = time_ms(
            lambda: cuda_kmer.run_capped_update(tables, s, CAP), REPS)
    # the probe, sorted and shuffled
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    shuffled = [r[torch.randperm(r.numel(), generator=gen, device=dev)]
                for r in runs]
    want = tables[0].clone()
    want[runs[0].to(torch.int64) & count.SENTINEL] += 1
    for red in (False, True):
        got = tables[0].clone()
        probe_launch(probe_lib, runs[0], got, red)
        if not torch.equal(got, want):
            raise SystemExit(f"the probe did not add 1 at each run head "
                             f"({tag}, red={red})")
        del got
    del want
    for mode, red in (("red", True), ("rmw", False)):
        for order, heads in (("sorted", runs), ("shuffled", shuffled)):
            def probe():
                for t, h in zip(tables, heads):
                    probe_launch(probe_lib, h, t, red)
            times[f"probe {mode} {order}"] = time_ms(probe, REPS)
    del tables, runs, shuffled
    torch.cuda.empty_cache()
    rows = s.shape[0]
    for key in [k for k in times if k.startswith(("K5", "probe "))]:
        if isinstance(times[key], float):
            print(f"[tune] {tag} {key}: {times[key]:.4f} ms, "
                  f"{times[key] / rows:.4f} ms a row", flush=True)
    for key in [k for k in times if k.startswith("K4 ")]:
        print(f"[tune] {tag} {key}: {times[key]:.4f} ms", flush=True)


def parent_ms(parent: str, inputs: str) -> dict:
    """{"K4 count smoke": ms, "K5 smoke": ms, ...} of the checkout in
    `parent`, through its own wrappers."""
    res = subprocess.run(
        [sys.executable, "-c", PARENT_SNIPPET.format(
            here=str(Path(__file__).resolve().parent.parent), inputs=inputs,
            k=K, cap=CAP, reps=REPS)],
        cwd=parent, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"parent timing failed:\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])["parent_ms"]


def main(argv=None) -> int:
    from localhgt_tpu_torch.ops import cuda_kmer, encode

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default="",
                    help="another checkout whose K4 and K5 are timed too")
    ap.add_argument("--real", action="store_true",
                    help="also time the first count batch of bkp on big")
    ap.add_argument("--json", default="", help="also write the times here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_kmer: CUDA is not available")
    dev = torch.device("cuda:0")
    print(card_line(), flush=True)
    probe_lib = build_probe()
    masks, _ = encode.hasher_for(K, C, seed=1)
    rng = np.random.default_rng(2024)
    codes, lengths, accept = count_batch(rng)
    batches = {"smoke": dict(codes=codes, lengths=lengths, accept=accept,
                             kw=KW, masks=masks)}
    if args.real:
        batches["real"] = real_batch(dev)
    k4_codes = {}
    for name, shape in K4_SHAPES.items():
        c = rng.integers(0, 4, shape).astype(np.uint8)
        c[rng.random(shape) < 0.01] = 4
        k4_codes[name] = torch.from_numpy(c)

    out = {"card": card_line(), "times_ms": {}}
    tmp = tempfile.mkdtemp(prefix="lht_tune_kmer_")
    try:
        inputs = str(Path(tmp) / "inputs.pt")
        if args.parent:  # parent, this build, parent: in turns on one card
            # the sorted rows are made from this build's keys, which equal
            # the plain version's
            for tag, b in batches.items():
                keys = cuda_kmer.count_keys(
                    b["codes"].to(dev), b["lengths"].to(dev),
                    b["accept"].to(dev), b["masks"], K, b["kw"])
                b["sorted"] = torch.sort(keys, dim=1).values.cpu()
                del keys
            torch.save({"masks": torch.from_numpy(masks.astype(np.int64)),
                        "k4": k4_codes,
                        "batches": {t: {
                            **{n: b[n] for n in ("codes", "lengths",
                                                 "accept", "kw", "sorted")},
                            "masks": torch.from_numpy(
                                np.asarray(b["masks"]).astype(np.int64))}
                            for t, b in batches.items()}}, inputs)
            torch.cuda.empty_cache()
            out["parent_ms"] = parent_ms(args.parent, inputs)
        k4 = out["times_ms"].setdefault("K4", {})
        for name, c in k4_codes.items():
            c = c.to(dev)
            got = cuda_kmer.canonical_hashes(c, masks, K)
            want = encode.canonical_hashes_plain(c, masks, K)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"K4 disagrees with canonical_hashes_plain "
                                 f"at {name}")
            del got, want
            k4[name] = time_ms(
                lambda: cuda_kmer.canonical_hashes(c, masks, K), REPS)
            print(f"[tune] K4 {name} {tuple(c.shape)}: {k4[name]:.4f} ms",
                  flush=True)
            del c
            torch.cuda.empty_cache()
        for tag, b in batches.items():
            time_batch(tag, b, probe_lib, dev, out)
        if args.parent:
            out["parent_again_ms"] = parent_ms(args.parent, inputs)
            for key, ms in out["parent_ms"].items():
                print(f"[tune] {key} parent: {ms:.4f} ms before, "
                      f"{out['parent_again_ms'][key]:.4f} ms after",
                      flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(card_line(), flush=True)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
