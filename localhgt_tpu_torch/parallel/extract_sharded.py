"""Multi-device extraction: the full `extract` stage over a device mesh.

Port of localhgt_tpu/parallel/extract_sharded.py with the same function
names, over the explicit `DeviceMesh` of parallel/mesh.py (one process,
plain loops over the shards, collectives as explicit copies):

* **Count tables sharded, queries move.** Each int8 [2^k] table is cut
  into one slice of consecutive hashes per shard. Read batches are cut by
  rows over the same shards: every shard hashes, sorts and rank-caps its
  OWN rows (`count.sorted_contrib`), the compacted (hash, delta) streams
  go to every shard, and each scatters the hashes of its slice. The
  per-shard caps sum and then clip to min(total_occurrences, cap), the
  single-device semantics. A table takes one rank-capped stream per shard
  and batch, so the deferred clip comes n times as often.
* **Scan: distributed lookup.** Halo blocks of ALL contigs form one
  stream, cut by rows over the shards. A block's owner hashes it; for the
  counts the *queries* move: every table owner answers for its slice and
  the answers are summed at the block's owner. The tables never gather.
* **Vote: replicated RankMap.** The hash -> peak-id structure is the
  RankMap of pipeline/peaks.py, built once and copied to each distinct
  device, so vote lookups are local. Every shard votes its rows into a
  zero delta through `peaks.vote_core` (kernel K3) and the deltas are
  summed.
* **Peakset build:** member hashing runs once, the count-table presence
  filter goes through the distributed lookup.

Interval outputs equal the single-device `extract()` and the JAX mesh
path exactly. No stage-A code cache is kept: the vote and the alignment
re-read the FASTQ files.

Dropped on purpose, each output-neutral: `jnp.packbits` of the masks (a
device-to-host transfer saving), `_scatter_slice_packed` and the packed
branch of the lookups (the port has no 4-bit packed tables),
`layout.assert_lane_efficient`, `donate_argnums` (torch updates the
slices in place), and `_pad_read_batch`'s fixed row count (nothing is
compiled per shape; a short last batch is cut as it is, and a shard
whose share is empty does nothing).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from localhgt_tpu_torch.config import Config
from localhgt_tpu_torch.io import fasta, fastq
from localhgt_tpu_torch.ops import count, encode, scan
from localhgt_tpu_torch.parallel.mesh import (DeviceMesh, make_flat_mesh,
                                              replicate, shard_rows)
from localhgt_tpu_torch.pipeline import extract as extract_mod
from localhgt_tpu_torch.pipeline import peaks as peaks_mod
from localhgt_tpu_torch.utils import metrics

log = logging.getLogger("localhgt_tpu_torch.sharded")

__all__ = ["make_flat_mesh", "count_kmers_sharded", "scan_reference_sharded",
           "build_peakset_sharded", "vote_peaks_sharded", "extract_sharded"]


def slice_bounds(size: int, n: int) -> list:
    """[(lo, hi)] hash ranges of the n table slices: equal slices of
    ceil(size / n) hashes, the last one shorter when n does not divide."""
    step = -(-size // n)
    return [(min(i * step, size), min((i + 1) * step, size))
            for i in range(n)]


def make_sharded_table(mesh: DeviceMesh, k: int) -> list:
    """One zero int8 slice per shard, on the shard's device."""
    return [torch.zeros(hi - lo, dtype=torch.int8, device=d) for (lo, hi), d
            in zip(slice_bounds(1 << k, mesh.n), mesh.devices)]


def _all_gather(mesh: DeviceMesh, parts: list) -> list:
    """The concatenation of every shard's 1-D part, on every shard's
    device (one copy per distinct device)."""
    whole = {d: torch.cat([p.to(d) for p in parts]) for d in mesh.distinct}
    return [whole[d] for d in mesh.devices]


# --------------------------------------------------------------------------
# stage A: sharded counting
# --------------------------------------------------------------------------


def count_step_sharded(mesh: DeviceMesh, tables, codes, lengths, accept,
                       masks, k: int, cap: int, kw: int = 0) -> None:
    """One sharded count step, updating the table slices in place.

    tables: [coder][shard] int8 slices; codes uint8 [B, L], lengths int32
    [B], accept bool [B] host tensors, cut by rows over the shards. The
    deferred clip is the caller's (`count.clip_every_batches`)."""
    streams = [[] for _ in tables]   # [coder][shard] (hashes, deltas)
    for c, ln, acc in zip(shard_rows(mesh, codes), shard_rows(mesh, lengths),
                          shard_rows(mesh, accept)):
        if c.shape[0] == 0:
            continue
        s, contrib = count.sorted_contrib(c, ln, acc, masks, k, cap, kw)
        for i in range(len(tables)):
            # compaction drops the zero deltas, the sentinel 0xFFFFFFFF
            # among them: it lies inside the last slice's hash range
            live = contrib[i] != 0
            streams[i].append((s[i][live], contrib[i][live]))
    for i, slices in enumerate(tables):
        hs = _all_gather(mesh, [h for h, _ in streams[i]])
        ds = _all_gather(mesh, [d for _, d in streams[i]])
        for t, (lo, hi), h, d in zip(slices, slice_bounds(1 << k, mesh.n),
                                     hs, ds):
            mine = (h >= lo) & (h < hi)   # exact: hashes are int64
            t.index_add_(0, h[mine] - lo, d[mine])


def _clip_sharded(tables, cap: int) -> None:
    for slices in tables:
        count.clip_tables(slices, cap)


def count_kmers_sharded(mesh: DeviceMesh, fq1, fq2, masks, cfg: Config,
                        batch_reads: int = extract_mod.COUNT_BATCH_READS):
    """Stage A over the mesh. Returns (tables [coder][shard], ratio,
    n_pairs)."""
    k = cfg.kmer.k
    cap = cfg.kmer.least_depth
    count.check_least_depth(k, cap)  # a mesh gives the single device's answer
    tables = [make_sharded_table(mesh, k) for _ in range(cfg.kmer.coder_num)]
    ratio = fastq.downsample_ratio(cfg.kmer.sample, fq1)
    clip_every = count.clip_every_batches(cap, streams=mesh.n)
    n_pairs = 0
    width = None
    since_clip = 0
    nb = 0
    for path in (fq1, fq2):
        for b in fastq.iter_fastq_batches(path, batch_reads=batch_reads,
                                          threads=cfg.threads):
            if width is None:
                width = extract_mod._batch_width(b.codes.shape[1])
            acc = fastq.accept_mask(b.start_ordinal, b.n, ratio,
                                    cfg.kmer.seed, cfg.kmer.strict_sampling)
            codes, lengths, acc = extract_mod._pad_read_batch(b, acc, width)
            lmax = int(b.lengths.max()) if b.n else 0
            count_step_sharded(
                mesh, tables, torch.from_numpy(codes),
                torch.from_numpy(lengths), torch.from_numpy(acc), masks, k,
                cap, kw=extract_mod._kw(width, lmax, k))
            since_clip += 1
            if since_clip >= clip_every:
                _clip_sharded(tables, cap)
                since_clip = 0
            if path == fq1:
                n_pairs += b.n
            nb += 1
    _clip_sharded(tables, cap)
    metrics.add("count_batches", nb)
    return tables, ratio, n_pairs


# --------------------------------------------------------------------------
# stage B: sharded scan over position blocks
# --------------------------------------------------------------------------


def _distributed_lookup(mesh: DeviceMesh, slices, q: torch.Tensor):
    """int32 counts of int64 queries q (any shape, on any device of the
    mesh) against one sharded table: q goes to every slice's owner, each
    answers for its slice (0 elsewhere), and the answers are summed on
    q's device."""
    size = sum(t.shape[0] for t in slices)
    q_on = {d: q.to(d) for d in mesh.distinct}
    total = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    for t, (lo, hi), d in zip(slices, slice_bounds(size, mesh.n),
                              mesh.devices):
        if hi == lo:
            continue
        idx = q_on[d] - lo
        mine = (idx >= 0) & (idx < hi - lo)
        ans = torch.where(mine, t[torch.where(mine, idx, 0)], 0)
        total += ans.to(device=q.device, dtype=torch.int32)
    return total


def scan_step_sharded(mesh: DeviceMesh, tables, codes_blocks, true_lens,
                      masks, k: int, scan_cfg, cap: int):
    """One sharded scan step over halo blocks: codes_blocks uint8 [NB, Lc]
    and true_lens int64 [NB] host tensors, cut by rows over the shards.
    Returns bool [NB, Lc] good and peak masks on the host."""
    goods, peaks = [], []
    for codes, tl in zip(shard_rows(mesh, codes_blocks),
                         shard_rows(mesh, true_lens)):
        if codes.shape[0] == 0:
            continue
        h, v = encode.canonical_hashes(codes, masks, k)      # [C, b, L]
        rows = [torch.where(v & (h[i] != 0),
                            _distributed_lookup(mesh, slices, h[i]), 0)
                for i, slices in enumerate(tables)]
        del h, v
        g, p = scan.scan_hits(torch.stack(rows, dim=-2), k, scan_cfg, cap,
                              true_len=tl)
        goods.append(g.cpu())
        peaks.append(p.cpu())
    return torch.cat(goods).numpy(), torch.cat(peaks).numpy()


def scan_reference_sharded(mesh: DeviceMesh, tables, contigs: fasta.Contigs,
                           masks, cfg: Config, block: int = 1 << 18):
    """Stage B: all contigs' halo blocks in one stream, max(n, 8) blocks a
    step (the step count follows reference bp / block, not the contig
    count). Returns per-contig peak lists like extract.scan_reference."""
    k = cfg.kmer.k
    halo = cfg.scan.window + 4 * k + 64
    Lc = block + 2 * halo

    blocks = []           # (cid, core_start, core_len)
    for cid in range(1, contigs.n + 1):
        L = contigs.length_of(cid)
        if L <= k:
            continue
        for s in range(0, L, block):
            blocks.append((cid, s, min(block, L - s)))
    good = {cid: np.zeros(contigs.length_of(cid), bool)
            for cid in range(1, contigs.n + 1)}
    peak = {cid: np.zeros(contigs.length_of(cid), bool)
            for cid in range(1, contigs.n + 1)}
    NB = max(mesh.n, 8)
    for base in range(0, len(blocks), NB):
        chunk = blocks[base : base + NB]
        codes_b = np.full((len(chunk), Lc), 4, np.uint8)
        lens_b = np.zeros(len(chunk), np.int64)
        for j, (cid, s, ln) in enumerate(chunk):
            cs = max(0, s - halo)
            seq = contigs.contig_codes(cid)[cs : s + ln + halo]
            codes_b[j, : len(seq)] = seq
            lens_b[j] = len(seq)
        gb, pb = scan_step_sharded(
            mesh, tables, torch.from_numpy(codes_b),
            torch.from_numpy(lens_b), masks, k, cfg.scan,
            cfg.kmer.least_depth)
        for j, (cid, s, ln) in enumerate(chunk):
            cs = max(0, s - halo)
            good[cid][s : s + ln] = gb[j][s - cs : s - cs + ln]
            peak[cid][s : s + ln] = pb[j][s - cs : s - cs + ln]
    per_contig = []
    total_peaks = 0
    for cid in range(1, contigs.n + 1):
        if contigs.length_of(cid) <= k:
            continue
        ivs = scan.good_intervals(good[cid], cfg.scan.window,
                                  pad=cfg.scan.good_pad)
        pos, mem, gid = scan.peaks_in_intervals(peak[cid], ivs,
                                                cfg.scan.merge_close_peak)
        if total_peaks + len(pos) > cfg.scan.max_peak:
            keep = max(0, cfg.scan.max_peak - total_peaks)
            sel = gid < keep
            pos, mem, gid = pos[:keep], mem[sel], gid[sel]
        total_peaks += len(pos)
        per_contig.append((cid, pos, mem, gid))
        if total_peaks >= cfg.scan.max_peak:
            break
    return per_contig


# --------------------------------------------------------------------------
# peakset build (sharded count filter) + vote (replicated rank map)
# --------------------------------------------------------------------------


class _ShardedTable:
    """One sharded count table behind `count.table_lookup`'s indexing, so
    `peaks._member_keys` filters members through the distributed lookup."""

    def __init__(self, mesh: DeviceMesh, slices):
        self.mesh, self.slices = mesh, slices

    def __getitem__(self, h: torch.Tensor) -> torch.Tensor:
        return _distributed_lookup(self.mesh, self.slices, h)


def build_peakset_sharded(mesh: DeviceMesh, per_contig, contigs, tables,
                          masks, k: int) -> peaks_mod.PeakSet:
    """The peak table and its RankMap, built on the first shard's device.
    Consumes `per_contig`."""
    pcontig, ppos, gpos, pids = peaks_mod._flatten_members(
        per_contig, contigs, k)
    total = len(contigs.codes)
    dev = mesh.devices[0]
    lookups = [_ShardedTable(mesh, slices) for slices in tables]
    CH = peaks_mod.MAP_BUILD_CHUNK

    def pair_batches():
        for base in range(0, max(total, 1), CH):
            lo = int(np.searchsorted(gpos, base))
            hi = int(np.searchsorted(gpos, base + CH))
            if hi == lo:
                continue
            codes = np.full(CH + k, 4, np.uint8)
            avail = contigs.codes[base : base + CH + k]
            codes[: len(avail)] = avail
            h, v = encode.canonical_hashes(
                torch.from_numpy(codes).to(dev)[None, :], masks, k)
            yield peaks_mod._member_keys(
                h[:, 0, :], v[0, :], lookups,
                torch.from_numpy(gpos[lo:hi] - base).to(dev),
                torch.from_numpy(pids[lo:hi]).to(dev))

    rmap = peaks_mod.build_rankmap(pair_batches, k, dev)
    return peaks_mod.PeakSet(contig=pcontig, pos=ppos, rmap=rmap)


def vote_step_sharded(mesh: DeviceMesh, peak_filter, rmaps, pcs, codes1,
                      len1, codes2, len2, accept, masks, k: int,
                      min_base_num: int, kw: int = 0) -> None:
    """One sharded vote step: the host batch is cut by rows, every shard
    votes its rows into a zero delta on its device (kernel K3 on a CUDA
    device), and the deltas are added to `peak_filter` in place.

    rmaps, pcs: the RankMap and the peak-contig table on every shard's
    device (`replicate`)."""
    parts = [shard_rows(mesh, x) for x in (codes1, len1, codes2, len2,
                                           accept)]
    for rmap, pc, c1, l1, c2, l2, acc in zip(rmaps, pcs, *parts):
        if c1.shape[0] == 0:
            continue
        delta = torch.zeros(peak_filter.shape, dtype=torch.int32,
                            device=c1.device)
        peaks_mod.vote_core(
            delta,
            peaks_mod.rank_vote_candidates(c1, l1, masks, rmap, k, kw),
            peaks_mod.rank_vote_candidates(c2, l2, masks, rmap, k, kw),
            pc, acc, min_base_num, 8)
        peak_filter += delta.to(peak_filter.device)


def vote_peaks_sharded(mesh: DeviceMesh, pset, fq1, fq2, masks, cfg: Config,
                       ratio,
                       batch_reads: int = extract_mod.VOTE_BATCH_READS
                       ) -> np.ndarray:
    """Stage C over the mesh, on a FASTQ re-read: int32 peak votes [P+1]."""
    if pset.rmap is None:
        return np.zeros(pset.n + 1, np.int32)
    k = cfg.kmer.k
    wps = replicate(mesh, pset.rmap.wp)
    pidss = replicate(mesh, pset.rmap.pids)
    rmaps = [peaks_mod.RankMap(wp, pids, k) for wp, pids in zip(wps, pidss)]
    pcs = replicate(mesh, torch.from_numpy(pset.contig.astype(np.int32)))
    pf = torch.zeros(pset.n + 1, dtype=torch.int32, device=mesh.devices[0])
    width = None
    for b1, b2 in fastq.paired_batches(fq1, fq2, batch_reads=batch_reads,
                                       threads=cfg.threads):
        if width is None:
            width = extract_mod._batch_width(
                max(b1.codes.shape[1], b2.codes.shape[1]))
        acc = fastq.accept_mask(b1.start_ordinal, b1.n, ratio,
                                cfg.kmer.seed, cfg.kmer.strict_sampling)
        c1, l1, acc_p = extract_mod._pad_read_batch(b1, acc, width)
        c2, l2, _ = extract_mod._pad_read_batch(b2, acc, width)
        lmax = int(max(b1.lengths.max() if b1.n else 0,
                       b2.lengths.max() if b2.n else 0))
        vote_step_sharded(
            mesh, pf, rmaps, pcs,
            *(torch.from_numpy(a) for a in (c1, l1, c2, l2, acc_p)), masks,
            k, cfg.scan.min_base_num, kw=extract_mod._kw(width, lmax, k))
    return pf.cpu().numpy()


# --------------------------------------------------------------------------
# the full sharded stage
# --------------------------------------------------------------------------


def _sync(mesh: DeviceMesh) -> None:
    for d in mesh.distinct:
        extract_mod._sync(d)


def extract_sharded(fq1: str, fq2: str, contigs: fasta.Contigs, cfg: Config,
                    mesh: DeviceMesh | None = None,
                    scan_block: int = 1 << 18) -> extract_mod.ExtractResult:
    """Multi-device `extract()`: same inputs, same outputs, sharded
    stages; no code cache in the result."""
    mesh = mesh or make_flat_mesh()
    masks, _ = encode.hasher_for(cfg.kmer.k, cfg.kmer.coder_num,
                                 cfg.kmer.seed)
    t = time.time()
    log.info("stage A (%s): k-mer counting", mesh.describe())
    with metrics.stage("count"):
        tables, ratio, n_pairs = count_kmers_sharded(mesh, fq1, fq2, masks,
                                                     cfg)
        _sync(mesh)
    log.info("counted %d pairs (ratio %.4f) in %.1fs", n_pairs, ratio,
             time.time() - t)

    t = time.time()
    with metrics.stage("scan"):
        per_contig = scan_reference_sharded(mesh, tables, contigs, masks,
                                            cfg, block=scan_block)
    n_raw = sum(len(p) for _, p, _, _ in per_contig)
    log.info("raw candidate peaks: %d in %.1fs", n_raw, time.time() - t)

    t = time.time()
    with metrics.stage("peakset"):
        pset = build_peakset_sharded(mesh, per_contig, contigs, tables,
                                     masks, cfg.kmer.k)
        _sync(mesh)
    del tables  # the vote never touches the count tables: free them
    log.info("peakset (%d peaks) built in %.1fs", pset.n, time.time() - t)

    t = time.time()
    with metrics.stage("vote"):
        votes = vote_peaks_sharded(mesh, pset, fq1, fq2, masks, cfg, ratio)
    log.info("vote pass in %.1fs", time.time() - t)

    intervals, bed, n_kept = extract_mod.intervals_from_votes(
        votes, pset, contigs, cfg)
    log.info("kept %d peaks -> %d intervals", n_kept, len(intervals))
    return extract_mod.ExtractResult(intervals, bed, pset, votes, n_pairs,
                                     ratio)
