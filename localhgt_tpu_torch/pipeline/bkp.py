"""End-to-end HGT breakpoint detection (`localhgt bkp`).

Port of localhgt_tpu/pipeline/bkp.py::detect_breakpoint: read QC (with
refine_fq: adapter trimming and fastp's filter, io/qc.py) -> extract (k-mer
stage, unless use_kmer=0) -> sub-reference + seed index -> seed-and-extend
alignment (kernel K1) -> insert size -> raw junctions -> split-read SW
refinement (kernel K2) -> dedup -> <sample>.acc.csv. The k-mer stage runs
kernel K3. Every device step runs on the explicit `device`, or, with a
mesh, extraction and the K1 extension run over the mesh's shards
(parallel/extract_sharded.py, ops.sw.sw_align_sharded). There is no
dispatch lookahead.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from localhgt_tpu_torch.config import Config
from localhgt_tpu_torch.index import reference
from localhgt_tpu_torch.io import fastq
from localhgt_tpu_torch.pipeline import rawbkp
from localhgt_tpu_torch.utils import formats, hostmem, metrics, validate
from localhgt_tpu_torch.io import qc
from localhgt_tpu_torch.parallel import extract_sharded
from localhgt_tpu_torch.parallel.mesh import make_flat_mesh
from localhgt_tpu_torch.pipeline import accbkp, align, extract

log = logging.getLogger("localhgt_tpu_torch.bkp")


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
                device, mesh=None):
    """Align every read pair against the sub-reference, as `bkp` does:
    the device seed prefilter, then align.align_batch (kernel K1) per mate
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
    for c1d, l1d, c1n, l1n, c2d, l2d, c2n, l2n, n in metrics.spanned(
            "align.parse", raw_batches()):
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
                threads=cfg.threads, mesh=mesh)
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


def detect_breakpoint(
    ref_path: str,
    fq1: str,
    fq2: str,
    sample: str,
    outdir: str,
    device,
    cfg: Config | None = None,
    use_kmer: bool = True,
    read_info: bool = True,
    refine_fq: bool = False,
    mesh=None,
) -> str:
    """Run breakpoint detection on `device`; returns the path of
    <sample>.acc.csv.

    `mesh`: a parallel.mesh.DeviceMesh to run extraction and the K1
    extension over its shards (outputs identical to single-device);
    "force" for the mesh over every visible CUDA device, or over one
    shard on `device` when that is the CPU; "auto" for that mesh when
    more than one CUDA device is visible. None = single device."""
    device = torch.device(device)
    cfg = cfg or Config()
    validate.check_bkp_inputs(ref_path, fq1, fq2, outdir)
    hostmem.cap_mmap_threshold()  # glibc retention, see utils/hostmem.py
    t0 = time.time()
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(message)s", datefmt="%H:%M:%S",
    )

    if refine_fq:
        # fastp-equivalent QC (refine_fastq, infer_HGT_breakpoint.py:99-109)
        r1 = os.path.join(outdir, f"{sample}_refined_1.fq")
        r2 = os.path.join(outdir, f"{sample}_refined_2.fq")
        with metrics.stage("qc"):
            st = qc.refine_fastq(fq1, fq2, r1, r2, device)
        for name, value in dataclasses.asdict(st).items():
            metrics.add(f"qc_{name}", value)
        log.info("qc: %d/%d pairs kept, %d adapter trims",
                 st.pairs_out, st.pairs_in, st.adapter_trimmed)
        fq1, fq2 = r1, r2

    with metrics.span("reference"):
        contigs = reference.build(ref_path)
    log.info("reference: %d contigs, %d bp", contigs.n, len(contigs.codes))

    if mesh in ("auto", "force"):
        want = mesh == "force" or (device.type == "cuda"
                                   and torch.cuda.device_count() > 1)
        mesh = None
        if want:
            mesh = make_flat_mesh(None if device.type == "cuda"
                                  else [device])
    if mesh is not None:
        log.info("multi-device extraction: %s", mesh.describe())

    cache = None
    if use_kmer:
        if mesh is not None:
            res = extract_sharded.extract_sharded(fq1, fq2, contigs, cfg,
                                                  mesh)
        else:
            res = extract.extract(fq1, fq2, contigs, cfg, device)
        intervals, cache = res.intervals, res.cache
        with metrics.span("write"):
            iv_path = os.path.join(outdir, f"{sample}.interval.txt")
            with open(iv_path, "w") as f:
                for cid, s, e in intervals:
                    f.write(f"{cid}\t{s}\t{e}\n")
            with open(iv_path + ".bed", "w") as f:
                f.write("\n".join(res.bed) + ("\n" if res.bed else ""))
        del res  # frees the peak map before alignment
        log.info("extraction: %d intervals (%.1fs)", len(intervals),
                 time.time() - t0)
    else:
        intervals = [
            (cid, 1, contigs.length_of(cid)) for cid in range(1, contigs.n + 1)
        ]

    with metrics.span("subref"):
        subref = align.build_subref(contigs, intervals)
    metrics.add("n_intervals", len(intervals))
    metrics.add("subref_bp", len(subref.codes))
    log.info("sub-reference: %d segments, %d bp", len(subref.seg_off),
             len(subref.codes))
    if len(subref.codes) == 0:
        acc_path = os.path.join(outdir, f"{sample}.acc.csv")
        with metrics.span("write"):
            formats.write_acc_csv(acc_path, [], contigs, 0, 0)
        return acc_path
    with metrics.span("seed_index"):
        index = align.SeedIndex.build(subref, cfg.align.seed_len)

    # --- align all read pairs ---
    t1 = time.time()
    with metrics.stage("align"):
        a1, a2, codes1, codes2, n_pairs = align_reads(
            fq1, fq2, subref, index, cache, cfg, device, mesh)
        mapped = int(((a1.contig > 0) | (a2.contig > 0)).sum())
        metrics.add("mapped_pairs", mapped)
        metrics.add("n_pairs", n_pairs)
    log.info("aligned %d pairs (%d with a mapped end) in %.1fs",
             n_pairs, mapped, time.time() - t1)

    # --- breakpoint calling ---
    with metrics.stage("rawbkp"):
        ins = rawbkp.estimate_insert(a1, a2, cfg.bkp)
        log.info("read length %d, insert size %d (n=%d)",
                 ins.rlen, ins.insert_size, ins.n)
        raw = rawbkp.call_raw_bkps(a1, a2, ins, cfg.bkp)
    metrics.add("raw_junctions", len(raw))
    log.info("raw junctions: %d", len(raw))

    with metrics.stage("accbkp"):
        accs = accbkp.find_accurate_bkps(
            raw, a1, a2, codes1, codes2, contigs, ins, cfg.bkp,
            subref if use_kmer else None, device, read_info=read_info,
        )
        accs = formats.dedup_rows(accs, cfg.bkp.dedup_cutoff)
    metrics.add("final_bkps", len(accs))
    log.info("final breakpoints: %d", len(accs))

    acc_path = os.path.join(outdir, f"{sample}.acc.csv")
    with metrics.span("write"):
        formats.write_acc_csv(acc_path, accs, contigs, 2 * n_pairs,
                              ins.insert_size)
    log.info("total %.1fs -> %s", time.time() - t0, acc_path)
    return acc_path


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
