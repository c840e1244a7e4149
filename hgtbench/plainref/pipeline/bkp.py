"""The reference's `bkp`: the port's pipeline/bkp.py, frozen, on one
device and with the plain versions of every kernel, returning what the
benchmark compares instead of writing it: the intervals and their bed
lines, the sub-reference's length, both mates' alignment tables, the raw
junctions and the lines of <sample>.acc.csv.

Differences from the port, none of which changes a result: the reference
FASTA is read directly (the port caches an index of it beside the file),
FASTQ is parsed by numpy, seeds are looked up by numpy, QC is io/qc.py
(written from fastp's rules, not the port's vectorised copy) and there is
no mesh.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time

import numpy as np
import torch

from hgtbench.plainref.config import Config
from hgtbench.plainref.io import fasta, fastq, qc
from hgtbench.plainref.pipeline import accbkp, align, extract, rawbkp
from hgtbench.plainref.utils import formats

log = logging.getLogger("hgtbench.plainref.bkp")


class CompactRows:
    """Row-indexable view over the sparse subset of read rows that accbkp
    needs (split candidates, ~0.1% of reads), so the full code matrix never
    stays resident. Indexing a row that was not kept raises."""

    def __init__(self, row_ids: np.ndarray, data: np.ndarray):
        self.row_ids = row_ids  # sorted global row indices
        self.data = data

    @classmethod
    def concat(cls, parts: list, width: int) -> "CompactRows":
        if not parts:
            return cls(np.zeros(0, np.int64), np.zeros((0, width), np.uint8))
        return cls(np.concatenate([p[0] for p in parts]),
                   np.concatenate([p[1] for p in parts]))

    def has(self, i: int) -> bool:
        j = int(np.searchsorted(self.row_ids, i))
        return j < len(self.row_ids) and self.row_ids[j] == i

    def __getitem__(self, i: int) -> np.ndarray:
        j = int(np.searchsorted(self.row_ids, i))
        if j >= len(self.row_ids) or self.row_ids[j] != i:
            raise KeyError(f"read row {i} was not retained (not a split read)")
        return self.data[j]


def align_reads(fq1: str, fq2: str, subref: align.SubRef,
                index: align.SeedIndex, cache: dict | None, cfg: Config,
                device):
    """Align every read pair against the sub-reference, as `bkp` does:
    the device seed prefilter, then align.align_batch (K1's plain version) per mate
    and batch. Returns (a1, a2, codes1, codes2, n_pairs): the mates'
    tables with pairs that have no mapped end dropped (positionally
    paired), the CompactRows of the split candidates' codes, and the
    number of pairs read.

    `cache`: extract's stage-A code cache ({fq path: [CachedBatch]}) or
    None to re-read the FASTQ files; it is emptied before returning."""
    tables1, tables2 = [], []
    codes1, codes2 = [], []
    n_pairs = 0
    # a large sub-reference multiplies seed hits per read, so the batch
    # shrinks to bound the host seeding temporaries
    batch_reads = 1 << 16 if len(subref.codes) < (32 << 20) else 1 << 14
    # the seed prefilter always runs: without it every read goes through
    # host seeding. An empty index gives an empty bitmap, which keeps no
    # read, as host seeding would find no seed.
    bitmap = align.prefix_bitmap(index, device)
    # the stage-A code cache feeds alignment directly (no FASTQ re-read).
    # As in the JAX package, cached batches keep their 1<<16 rows and so
    # bypass the 1<<14 shrink above for a large sub-reference: kept as it
    # is, the outputs must stay equal
    if cache is not None and any(
            e1.n != e2.n for e1, e2 in zip(cache[fq1], cache[fq2])):
        cache.clear()
        cache = None

    def raw_batches():
        """(c1, l1, c1_np, l1_np, c2, l2, c2_np, l2_np, n); the first two
        of each mate are tensors for the prefilter."""
        if cache is not None:
            for e1, e2 in zip(cache[fq1], cache[fq2]):
                yield (e1.codes, e1.lengths, e1.codes_np, e1.lengths_np,
                       e2.codes, e2.lengths, e2.codes_np, e2.lengths_np,
                       e1.n)
            return
        width = None
        for b1, b2 in fastq.paired_batches(fq1, fq2, batch_reads=batch_reads,
                                           threads=cfg.threads):
            if width is None:
                width = max(
                    64,
                    -(-max(b1.codes.shape[1], b2.codes.shape[1]) // 64) * 64)
            out = []
            for b in (b1, b2):
                c = _pad_to(b.codes, width)
                ln = np.minimum(b.lengths, width).astype(np.int32)
                out.extend([torch.from_numpy(c), torch.from_numpy(ln), c, ln])
            yield (*out, b1.n)

    row_base = 0
    width = None
    for c1d, l1d, c1n, l1n, c2d, l2d, c2n, l2n, n in raw_batches():
        width = c1n.shape[1]
        ids = np.arange(row_base, row_base + n, dtype=np.int64)
        batch_t = {}
        for mate, cd, ld, cn, ln, codes_all in (
            (0, c1d, l1d, c1n, l1n, codes1), (1, c2d, l2d, c2n, l2n, codes2),
        ):
            pfm = align.seed_prefilter_device(
                cd.to(device), ld.to(device), bitmap).cpu().numpy()
            t = align.align_batch(
                subref, index, cn, ln, ids, mate, cfg.align, device, pfm,
                threads=cfg.threads)
            batch_t[mate] = t
            # retain code rows ONLY for split candidates (contig2 >= 0)
            keep = np.flatnonzero(t.contig2 >= 0)
            codes_all.append((keep + row_base, cn[keep]))
        # drop pairs with no mapped end (tables stay positionally paired)
        keep_pair = (batch_t[0].contig > 0) | (batch_t[1].contig > 0)
        tables1.append(_take_rows(batch_t[0], keep_pair))
        tables2.append(_take_rows(batch_t[1], keep_pair))
        row_base += n
        n_pairs += n
    a1 = align.AlnTable.concat(tables1)
    a2 = align.AlnTable.concat(tables2)
    if cache is not None:  # free the code cache before accbkp
        cache.clear()
    return (a1, a2, CompactRows.concat(codes1, width or 64),
            CompactRows.concat(codes2, width or 64), n_pairs)


def run(ref_path: str, fq1: str, fq2: str, device, cfg: Config,
        use_kmer: bool = True, refine_fq: bool = False) -> dict:
    """`bkp` on one sample; returns {"intervals": [(cid, s, e)], "bed":
    [str], "subref_bp": int, "a1", "a2": AlnTable, "raw": [RawBkp],
    "acc": [str]} (acc: the lines of acc.csv). With `refine_fq` the pairs
    go through QC first (into a temporary directory), and the result also
    holds "refined": the bytes of the two refined FASTQ files, and "qc":
    the QC's counts by name."""
    if refine_fq:
        with tempfile.TemporaryDirectory() as tmp:
            r1 = os.path.join(tmp, "ref_refined_1.fq")
            r2 = os.path.join(tmp, "ref_refined_2.fq")
            t0 = time.perf_counter()
            st = qc.refine_fastq(fq1, fq2, r1, r2, torch.device(device))
            log.info("qc: %d of %d pairs kept, %d mates cut, %d of %d "
                     "bases kept, %.1f s", st.pairs_out, st.pairs_in,
                     st.adapter_trimmed, st.bases_out, st.bases_in,
                     time.perf_counter() - t0)
            out = run(ref_path, r1, r2, device, cfg, use_kmer)
            out["qc"] = dataclasses.asdict(st)
            refined = []
            for path in (r1, r2):
                with open(path, "rb") as f:
                    refined.append(f.read())
            out["refined"] = tuple(refined)
        return out
    device = torch.device(device)
    contigs = fasta.read_fasta(ref_path)
    cache = None
    bed: list = []
    if use_kmer:
        res = extract.extract(fq1, fq2, contigs, cfg, device)
        intervals, cache, bed = list(res.intervals), res.cache, list(res.bed)
        del res
    else:
        intervals = [
            (cid, 1, contigs.length_of(cid)) for cid in range(1, contigs.n + 1)
        ]
    subref = align.build_subref(contigs, intervals)
    out = {"intervals": [tuple(int(x) for x in iv) for iv in intervals],
           "bed": bed, "subref_bp": int(len(subref.codes))}
    with tempfile.TemporaryDirectory() as tmp:
        acc_path = os.path.join(tmp, "ref.acc.csv")
        if len(subref.codes) == 0:
            formats.write_acc_csv(acc_path, [], contigs, 0, 0)
            out.update(a1=align.AlnTable.empty(), a2=align.AlnTable.empty(),
                       raw=[])
        else:
            index = align.SeedIndex.build(subref, cfg.align.seed_len)
            a1, a2, codes1, codes2, n_pairs = align_reads(
                fq1, fq2, subref, index, cache, cfg, device)
            ins = rawbkp.estimate_insert(a1, a2, cfg.bkp)
            raw = rawbkp.call_raw_bkps(a1, a2, ins, cfg.bkp)
            accs = accbkp.find_accurate_bkps(
                raw, a1, a2, codes1, codes2, contigs, ins, cfg.bkp,
                subref if use_kmer else None, device, read_info=True)
            accs = formats.dedup_rows(accs, cfg.bkp.dedup_cutoff)
            formats.write_acc_csv(acc_path, accs, contigs, 2 * n_pairs,
                                  ins.insert_size)
            out.update(a1=a1, a2=a2, raw=raw)
        with open(acc_path) as f:
            out["acc"] = f.read().splitlines()
    return out


def _pad_to(codes: np.ndarray, width: int) -> np.ndarray:
    if codes.shape[1] >= width:
        return codes[:, :width]
    out = np.full((codes.shape[0], width), 4, np.uint8)
    out[:, : codes.shape[1]] = codes
    return out


def _take_rows(t: align.AlnTable, mask: np.ndarray) -> align.AlnTable:
    return align.AlnTable(
        **{f: getattr(t, f)[mask] for f in t.__dataclass_fields__}
    )
