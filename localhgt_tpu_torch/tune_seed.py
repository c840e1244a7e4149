"""Time kernel K6 (csrc/seed.cu) on one CUDA card, beside the eager plain
version and a probe of the bitmap's random sectors.

    python -m localhgt_tpu_torch.tune_seed [--json out.json]

Builds csrc/seed.cu as the package does and once more with the probe
(`-DLHT_SEED_PROBE`) and `-Xptxas -v` (registers and spills), the two nvcc
runs started together. Inputs are those of chip_smoke.py's K6 rows:
`bkp`'s batch (65,536 reads of 150 bp padded to 192, the bitmap of a
random 225 kbp sub-reference, 1% of the reads cut from it on either
strand) and direct mode's (16,384 reads against the bitmap of a random
100 Mbp reference, about 2% of its bits set), each with the edge rows of
`edge_rows`. K6 is held exactly against `align.seed_prefilter_plain`, then
timed with CUDA events after a warm-up, twice, beside the plain version on
the card (the parent's path) and the probe (`lht_seed_probe`, on no path
of the package: the same two loads a window start and the same early
exit at scattered addresses, no codes read). It prints the work the
function needs (`prefilter_work`), the card's name and power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from localhgt_tpu_torch.tune_vote import card_line, time_ms

PROBE = ("-DLHT_SEED_PROBE", "-Xptxas", "-v")  # -v: registers, spills
WIN = 16                       # bases a window (align.PREFILTER_LEN)
READ_LEN, WIDTH = 150, 192     # `big`'s reads in bkp's batches
SHAPES = {"bkp": (65_536, WIDTH), "direct": (16_384, WIDTH)}
# big's sub-reference at k=32 is 224,902 bp; direct mode's reference is
# the whole of it (100 Mbp on big)
REF_BP = {"bkp": 225_000, "direct": 100_000_000}
PLANTED = 0.01                 # reads cut from the reference
N_RATE = 0.001                 # non-base codes in the random reads
SECTOR_BYTES = 32
# Integer operations a window start, counted from seed.cu: 3 funnel shifts
# and 3 shifts for the windows, the valid compare, 2 Morton spreads of 8
# and the 2 that join them, hr's complement, bit reversal and pair swap
# (5), the two word indices, bit shifts and masks and the OR (7), and the
# tile's 3 ballots, 3 reversals and 3 predicates a lane = 44
K6_OPS_PER_WINDOW = 44
REPS = 20
K6_XLA = "localhgt_tpu/pipeline/align.py:367-394 (XLA, no Pallas kernel)"
# prefixes the edge rows plant: all-T (the bitmap's last word, bit 31),
# another in the last word, and bit 31 of a word in the middle
EDGE_PREFIXES = (0xFFFFFFFF, 0xFFFFFFE5, 0x9ABCDE1F)


def forward_prefixes(seq: torch.Tensor) -> torch.Tensor:
    """The distinct forward hashes of every 16-base window of one
    sequence of bases (uint8 [R], no non-base), sorted, as int64."""
    n = seq.numel() - WIN + 1
    s = seq.to(torch.int64)
    h = torch.zeros(n, dtype=torch.int64, device=seq.device)
    for z in range(WIN):
        h = (h << 2) | s[z:z + n]
    return torch.unique(h)


def bitmap_of(prefixes, dev) -> torch.Tensor:
    """align.prefix_bitmap of a seed index with these prefixes."""
    from localhgt_tpu_torch.pipeline import align

    pre = np.asarray(prefixes, dtype=np.int64).astype(np.uint32)
    return align.prefix_bitmap(SimpleNamespace(prefix32=np.sort(pre)), dev)


def prefix_bases(p: int, reverse: bool) -> np.ndarray:
    """The 16 bases whose forward hash (or, with `reverse`, whose
    reverse-complement hash) is p."""
    z = np.arange(WIN)
    if reverse:
        return (3 - ((p >> (2 * z)) & 3)).astype(np.uint8)
    return ((p >> (2 * (WIN - 1 - z))) & 3).astype(np.uint8)


def edge_rows(codes: np.ndarray, lengths: np.ndarray, rng) -> None:
    """Overwrite the first 12 rows in place with the edge cases: lengths 0,
    15, 16 and L (random bases to the end), windows of EDGE_PREFIXES at
    the first and last starts on either strand, an N inside a planted
    window, a window one base past the length, and a read of all N."""
    L = codes.shape[1]
    t16 = prefix_bases(EDGE_PREFIXES[0], False)
    fwd1, rev2 = (prefix_bases(EDGE_PREFIXES[1], False),
                  prefix_bases(EDGE_PREFIXES[2], True))
    rows = [(0, None, 0), (15, t16[:15], 0), (16, t16, 0),
            (L, fwd1, L - WIN), (L, rev2, L - WIN), (L, rev2, 0),
            (READ_LEN, fwd1, READ_LEN - WIN), (READ_LEN - 1, fwd1,
                                               READ_LEN - WIN),
            (READ_LEN, fwd1, 40), (READ_LEN, None, 0), (L, None, 0),
            (L, t16, 100)]
    for i, (n, bases, at) in enumerate(rows):
        lengths[i] = n
        if n == L:
            codes[i, READ_LEN:] = rng.integers(0, 4, L - READ_LEN)
        if bases is not None:
            codes[i, at:at + len(bases)] = bases
    codes[8, 47] = 4       # an N inside the planted window at 40
    codes[9, :] = 4        # all N
    codes[10, ::15] = 4    # an N in every window


def reads(rng, B: int, L: int, ref: np.ndarray) -> tuple:
    """(codes uint8 [B, L], lengths int32 [B]): random 150-bp reads padded
    with N, N_RATE of their bases N, PLANTED of them cut from `ref` at a
    random start on either strand with 1% substitutions."""
    from localhgt_tpu_torch.ops import coder

    r = rng.integers(0, 4, (B, READ_LEN)).astype(np.uint8)
    r[rng.random(r.shape) < N_RATE] = 4
    cut = np.flatnonzero(rng.random(B) < PLANTED)
    starts = rng.integers(0, len(ref) - READ_LEN, len(cut))
    seg = ref[starts[:, None] + np.arange(READ_LEN)[None, :]]
    rc = rng.random(len(cut)) < 0.5
    seg[rc] = coder.COMPLEMENT[seg[rc]][:, ::-1]
    sub = rng.random(seg.shape) < 0.01
    seg[sub] = (seg[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    r[cut] = seg
    codes = np.full((B, L), 4, np.uint8)
    codes[:, :READ_LEN] = r
    lengths = np.full(B, READ_LEN, np.int32)
    edge_rows(codes, lengths, rng)
    return codes, lengths


def inputs(kind: str, dev, seed: int = 2024, shape=None, ref_bp=None):
    """(codes, lengths, bitmap) of one of chip_smoke.py's K6 rows on
    `dev`; shape and ref_bp default to SHAPES[kind] and REF_BP[kind]."""
    rng = np.random.default_rng(seed)
    B, L = shape or SHAPES[kind]
    n_ref = ref_bp or REF_BP[kind]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ref = torch.randint(0, 4, (n_ref,), generator=gen, device=dev,
                        dtype=torch.uint8)
    pre = torch.cat([forward_prefixes(ref), torch.tensor(
        EDGE_PREFIXES, dtype=torch.int64, device=dev)])
    bitmap = bitmap_of(torch.unique(pre).cpu().numpy(), dev)
    codes, lengths = reads(rng, B, L, ref[: min(n_ref, 1 << 24)].cpu().numpy())
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev),
            bitmap)


def prefilter_work(codes: torch.Tensor, lengths: torch.Tensor,
                   bitmap: torch.Tensor) -> dict:
    """What the prefilter needs of these inputs: each read's window starts
    up to and including its first hit (every start up to min(length, L) -
    16 where none hits), their two probes (the hit window's reverse one
    only where its forward one missed), the distinct 32-byte bitmap sectors
    those probes touch and the bytes: the codes those windows cover, the
    lengths, the output and 32 bytes for each distinct sector."""
    from localhgt_tpu_torch.pipeline import align

    B, L = codes.shape
    hf, hr, ok = align.prefilter_windows(codes, lengths)
    mf = ok & align.bitmap_bit(bitmap, hf)
    mr = ok & align.bitmap_bit(bitmap, hr)
    hit = mf | mr
    n = hf.shape[1]
    first = torch.where(hit.any(1), hit.to(torch.uint8).argmax(1),
                        torch.full_like(lengths, n, dtype=torch.int64))
    last = torch.minimum(first, lengths.long().clamp(max=L) - WIN)
    j = torch.arange(n, device=codes.device)[None, :]
    need = ok & (j <= first[:, None])
    need_r = need & ~((j == first[:, None]) & mf)
    sectors = int(torch.unique(torch.cat(
        [hf[need] >> 8, hr[need_r] >> 8])).numel())
    has = last >= 0
    code_bytes = int((last[has] + WIN).sum())
    return {"windows": int((last[has] + 1).sum()),
            "probes": int(need.sum() + need_r.sum()),
            "sectors": sectors, "code_bytes": code_bytes,
            "reads_hit": int(hit.any(1).sum()),
            "bytes": code_bytes + 5 * B + SECTOR_BYTES * sectors}


def build_probe():
    """The probe's library (K6 beside the probe), built while the
    package's own build runs."""
    from localhgt_tpu_torch import _build
    from localhgt_tpu_torch.ops import cuda_seed

    with ThreadPoolExecutor(2) as pool:
        package = pool.submit(cuda_seed._lib)
        path = _build.build("seed", PROBE)
        package.result()
    lib = ctypes.CDLL(str(path))
    lib.lht_seed_probe.argtypes = cuda_seed.SIGNATURES["lht_seed_prefilter"]
    lib.lht_seed_probe.restype = ctypes.c_int
    return lib


def probe(lib, codes, lengths, bitmap) -> torch.Tensor:
    out = torch.empty(codes.shape[0], dtype=torch.bool, device=codes.device)
    err = lib.lht_seed_probe(codes.data_ptr(), codes.shape[0],
                             codes.shape[1], lengths.data_ptr(),
                             bitmap.data_ptr(), out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"lht_seed_probe: CUDA error {err} at launch")
    return out


def main(argv=None) -> int:
    from localhgt_tpu_torch.ops import cuda_seed
    from localhgt_tpu_torch.pipeline import align

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default="", help="also write the times here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_seed: CUDA is not available")
    dev = torch.device("cuda:0")
    print(card_line(), flush=True)
    lib = build_probe()
    out = {"card": card_line(), "times_ms": {}, "work": {}}
    for kind in SHAPES:
        codes, lengths, bitmap = inputs(kind, dev)
        got = cuda_seed.seed_prefilter(codes, lengths, bitmap)
        want = align.seed_prefilter_plain(codes, lengths, bitmap)
        if not torch.equal(got, want):
            bad = torch.nonzero(got != want).flatten()[:10].tolist()
            raise SystemExit(f"K6 disagrees with seed_prefilter_plain at "
                             f"{kind}, rows {bad}")
        work = prefilter_work(codes, lengths, bitmap)
        work["bits_set"] = sum(int(((bitmap >> b) & 1).sum())
                               for b in range(32))
        out["work"][kind] = work
        t = out["times_ms"].setdefault(kind, {})
        for key in ("K6", "K6 again"):
            t[key] = time_ms(
                lambda: cuda_seed.seed_prefilter(codes, lengths, bitmap), REPS)
        t["probe"] = time_ms(lambda: probe(lib, codes, lengths, bitmap), REPS)
        t["plain"] = time_ms(
            lambda: align.seed_prefilter_plain(codes, lengths, bitmap), 3)
        t["bound bytes"] = work["bytes"] / 3.35e12 * 1e3
        print(f"[tune] {kind} {tuple(codes.shape)}: {json.dumps(work)}",
              flush=True)
        print(f"[tune] {kind}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in t.items()), flush=True)
        del codes, lengths, bitmap, got, want
        torch.cuda.empty_cache()
    print(card_line(), flush=True)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
