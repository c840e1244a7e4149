"""k-mer table occupancy analyzer on one device.

Port of localhgt_tpu/tools/kmer_stats.py (the study it reproduces is
described there): the empty rate and the "weak" rate (entries other than
the saturation depth) of each 2^k canonical-hash count table of a sample,
counted on `device` by the stage-A count step (ops/count.py). The port's
tables are plain int8 [2^k] at every k, so nothing is unpacked.

    python -m localhgt_tpu_torch.tools.kmer_stats --fq1 s.1.fq --fq2 s.2.fq \\
        --kmin 16 --kmax 24
"""

from __future__ import annotations

import argparse
import json

import torch

from localhgt_tpu_torch.io import fastq
from localhgt_tpu_torch.ops import count, encode
from localhgt_tpu_torch.pipeline.extract import COUNT_BATCH_READS
from localhgt_tpu_torch.utils.device import resolve


def table_stats(fq1: str, fq2: str | None, k: int, device, ratio: float = 1.0,
                seed: int = 1, coder_num: int = 3, least_depth: int = 3):
    """One row per hash function: k, hash, ratio, table_size, empty_rate,
    weak_rate (the JAX tool's rows)."""
    masks, _ = encode.hasher_for(k, coder_num, seed)
    tables = [count.make_table(k, device) for _ in range(coder_num)]
    for path in (p for p in (fq1, fq2) if p):
        for b in fastq.iter_fastq_batches(path, batch_reads=COUNT_BATCH_READS):
            acc = fastq.accept_mask(b.start_ordinal, b.n, ratio, seed)
            count.count_reads_step(
                tables, torch.from_numpy(b.codes).to(device),
                torch.from_numpy(b.lengths).to(device),
                torch.from_numpy(acc).to(device), masks, k, least_depth)
    size = 1 << k
    out = []
    for i, t in enumerate(tables):
        empty = int((t == 0).sum())
        weak = int((t != least_depth).sum())
        out.append({
            "k": k, "hash": i, "ratio": ratio, "table_size": size,
            "empty_rate": empty / size, "weak_rate": weak / size,
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fq1", required=True)
    ap.add_argument("--fq2", default=None)
    ap.add_argument("--kmin", type=int, default=16)
    ap.add_argument("--kmax", type=int, default=26)
    ap.add_argument("--ratios", type=float, nargs="*", default=[1.0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the count tables (default cuda)")
    a = ap.parse_args(argv)
    dev = resolve(a.device)
    for k in range(a.kmin, a.kmax + 1, 2):
        for r in a.ratios:
            for row in table_stats(a.fq1, a.fq2, k, dev, r, a.seed):
                print(json.dumps(row))


if __name__ == "__main__":
    main()
