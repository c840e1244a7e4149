"""Seed-and-extend read alignment against the extracted sub-reference.

Port of localhgt_tpu/pipeline/align.py. The dataclasses and host helpers
(sub-reference, seed index, candidate grouping, mapq model) are copied from
the JAX package line for line; `align_batch` runs its Smith-Waterman
extension in kernel K1, and the seed prefilter, a 2^27-word prefix bitmap
plus a forward/reverse-complement probe, is kept on the device: kernel K6
on a card.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from localhgt_tpu_torch.config import AlignConfig
from localhgt_tpu_torch.io import fasta, native
from localhgt_tpu_torch.ops import cuda_seed
from localhgt_tpu_torch.ops import sw as swmod
from localhgt_tpu_torch.ops.coder import COMPLEMENT
from localhgt_tpu_torch.utils import metrics



@dataclass
class SubRef:
    codes: np.ndarray        # uint8 [R] concatenated segments, N separators
    seg_contig: np.ndarray   # int32 [S] original contig id (1-based)
    seg_start: np.ndarray    # int64 [S] original 0-based start
    seg_off: np.ndarray      # int64 [S] offset into codes
    seg_len: np.ndarray      # int64 [S]

    def lift(self, flat_pos: np.ndarray):
        """Flat coordinates -> (contig id, original position)."""
        flat_pos = np.asarray(flat_pos, dtype=np.int64)
        seg = np.searchsorted(self.seg_off, flat_pos, side="right") - 1
        seg = np.clip(seg, 0, len(self.seg_off) - 1)
        within = flat_pos - self.seg_off[seg]
        contig = self.seg_contig[seg]
        orig = self.seg_start[seg] + np.clip(within, 0, self.seg_len[seg] - 1)
        return contig, orig, seg


SEP = 24  # N bases between segments; > gap affordable by the SW scoring


def build_subref(contigs: fasta.Contigs, intervals) -> SubRef:
    """intervals: iterable of (contig_id, start_1based, end_1based_incl)."""
    segs = []
    for cid, s1, e1 in intervals:
        codes = contigs.slice_codes(cid, s1 - 1, e1)
        if len(codes) == 0:
            continue
        segs.append((cid, s1 - 1, codes))
    if not segs:
        return SubRef(
            np.zeros(0, np.uint8), np.zeros(0, np.int32), np.zeros(0, np.int64),
            np.zeros(0, np.int64), np.zeros(0, np.int64),
        )
    sep = np.full(SEP, 4, np.uint8)
    parts = []
    offs = []
    off = 0
    for cid, s0, codes in segs:
        offs.append(off)
        parts.append(codes)
        parts.append(sep)
        off += len(codes) + SEP
    blob = np.concatenate(parts)
    return SubRef(
        codes=blob,
        seg_contig=np.array([c for c, _, _ in segs], np.int32),
        seg_start=np.array([s for _, s, _ in segs], np.int64),
        seg_off=np.array(offs, np.int64),
        seg_len=np.array([len(c) for _, _, c in segs], np.int64),
    )


def _pack_seeds(codes: np.ndarray, s: int) -> tuple[np.ndarray, np.ndarray]:
    """2-bit packed s-mer at every start position; invalid (contains N) flagged.

    codes: uint8 [..., L]. Returns (hash uint64 [..., L-s+1], valid bool).
    """
    L = codes.shape[-1]
    n = L - s + 1
    if n <= 0:
        shp = codes.shape[:-1] + (0,)
        return np.zeros(shp, np.uint64), np.zeros(shp, bool)
    return _pack_seeds_at(codes, s, np.arange(n))


def _pack_seeds_at(codes: np.ndarray, s: int, starts: np.ndarray):
    """_pack_seeds evaluated only at the given start positions — the seeding
    hot path samples every `seed_stride` positions, so hashing all L-s+1
    windows first wastes ~stride x the work."""
    h = np.zeros(codes.shape[:-1] + (len(starts),), np.uint64)
    bad = np.zeros(h.shape, dtype=np.int32)
    for z in range(s):
        col = codes[..., starts + z]
        h = (h << np.uint64(2)) | (col.astype(np.uint64) & np.uint64(3))
        bad += (col >= 4).astype(np.int32)
    return h, bad == 0


PREFILTER_LEN = 16  # seed-prefix bases for the device membership test (32 bits)


@dataclass
class SeedIndex:
    s: int
    sorted_hash: np.ndarray   # uint64 [K]
    sorted_pos: np.ndarray    # int64 [K]
    # sorted unique 32-bit hashes of the first PREFILTER_LEN seed bases,
    # padded to a pow2 bucket (pad = last element, keeps order + membership):
    # the device prefilter tests read windows against this set
    prefix32: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))

    @classmethod
    def build(cls, subref: SubRef, s: int):
        h, valid = _pack_seeds(subref.codes, s)
        pos = np.flatnonzero(valid).astype(np.int64)
        hv = h[valid]
        order = np.argsort(hv, kind="stable")
        hv = hv[order]
        pre = np.unique(
            (hv >> np.uint64(2 * (s - PREFILTER_LEN))).astype(np.uint32)
        ) if s >= PREFILTER_LEN and len(hv) else np.zeros(0, np.uint32)
        if len(pre):
            cap = 1 << (len(pre) - 1).bit_length()
            pre = np.concatenate(
                [pre, np.full(cap - len(pre), pre[-1], np.uint32)])
        return cls(s, hv, pos[order], prefix32=pre)

    def lookup(self, query_hash: np.ndarray, max_occ: int):
        """Return (hit_query_idx, hit_pos): up to max_occ subref positions per
        query seed (high-frequency seeds truncated, like bwa's occ cap)."""
        lo = np.searchsorted(self.sorted_hash, query_hash, side="left")
        hi = np.searchsorted(self.sorted_hash, query_hash, side="right")
        cnt = np.minimum(hi - lo, max_occ)
        total = int(cnt.sum())
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        qidx = np.repeat(np.arange(len(query_hash)), cnt)
        # per-hit offset within its run
        offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        return qidx, self.sorted_pos[np.repeat(lo, cnt) + offs]


@dataclass
class AlnTable:
    """Primary (+ optional split) alignment per read end, original coords.

    Convention mirrors SAM/pysam fields used downstream: `pos` is the 0-based
    leftmost reference coordinate; `strand` 1 means the read aligned
    reverse-complemented and `qstart/qend` (inclusive) are on the oriented
    (stored) sequence, exactly like CIGAR soft-clips on a reverse-strand SAM
    record.
    """

    read_id: np.ndarray
    mate: np.ndarray
    contig: np.ndarray
    pos: np.ndarray
    rend: np.ndarray
    strand: np.ndarray
    qstart: np.ndarray
    qend: np.ndarray
    score: np.ndarray
    mapq: np.ndarray
    rlen: np.ndarray
    # split (SA) alignment; contig2 == -1 when absent
    contig2: np.ndarray
    pos2: np.ndarray
    rend2: np.ndarray
    strand2: np.ndarray
    qstart2: np.ndarray
    qend2: np.ndarray
    score2: np.ndarray
    # bwa XA equivalent: an overlapping alternative placement scored within
    # 80% of the primary exists (bwa mem's XA drop ratio; consumed by
    # get_raw_bkp.py:55-77 when -a 0 drops XA-tagged reads)
    has_alt: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))

    def __len__(self):
        return len(self.read_id)

    @classmethod
    def empty(cls):
        z8, z16 = np.zeros(0, np.int8), np.zeros(0, np.int16)
        z32, z64 = np.zeros(0, np.int32), np.zeros(0, np.int64)
        return cls(z64, z8, z32.copy(), z64.copy(), z64.copy(), z8.copy(),
                   z32.copy(), z32.copy(), z32.copy(), z16, z32.copy(),
                   z32.copy(), z64.copy(), z64.copy(), z8.copy(),
                   z32.copy(), z32.copy(), z32.copy(), np.zeros(0, bool))

    @classmethod
    def concat(cls, tables):
        tables = [t for t in tables if len(t)]
        if not tables:
            return cls.empty()
        kw = {
            f: np.concatenate([getattr(t, f) for t in tables])
            for f in cls.__dataclass_fields__
        }
        return cls(**kw)


def _group_candidates(qidx, diag, qoff, n_queries, gap, max_candidates, min_votes):
    """Cluster seed hits into candidate locations per (query) row.

    Returns dense arrays [n_queries, max_candidates]: diag_repr (int64),
    votes, qmin, qmax, valid mask. Vectorized: sort by (query, diag), split
    runs where query changes or diag jumps by > gap, segment-reduce, rank by
    votes within query.
    """
    C = max_candidates
    out_diag = np.zeros((n_queries, C), np.int64)
    out_votes = np.zeros((n_queries, C), np.int32)
    out_qmin = np.zeros((n_queries, C), np.int32)
    out_qmax = np.zeros((n_queries, C), np.int32)
    out_ok = np.zeros((n_queries, C), bool)
    if len(qidx) == 0:
        return out_diag, out_votes, out_qmin, out_qmax, out_ok
    order = np.lexsort((diag, qidx))
    q = qidx[order]
    d = diag[order]
    o = qoff[order]
    new = np.ones(len(q), bool)
    new[1:] = (q[1:] != q[:-1]) | (d[1:] - d[:-1] > gap)
    gid = np.cumsum(new) - 1
    ng = gid[-1] + 1
    g_votes = np.bincount(gid, minlength=ng)
    g_q = q[new]
    g_diag = d[new]
    g_qmin = np.full(ng, 1 << 30, np.int64)
    np.minimum.at(g_qmin, gid, o)
    g_qmax = np.zeros(ng, np.int64)
    np.maximum.at(g_qmax, gid, o)
    keep = g_votes >= min_votes
    g_q, g_diag, g_votes, g_qmin, g_qmax = (
        a[keep] for a in (g_q, g_diag, g_votes, g_qmin, g_qmax)
    )
    if len(g_q) == 0:
        return out_diag, out_votes, out_qmin, out_qmax, out_ok
    # rank groups within each query by votes desc
    order2 = np.lexsort((-g_votes, g_q))
    g_q, g_diag, g_votes, g_qmin, g_qmax = (
        a[order2] for a in (g_q, g_diag, g_votes, g_qmin, g_qmax)
    )
    first = np.ones(len(g_q), bool)
    first[1:] = g_q[1:] != g_q[:-1]
    rank = np.arange(len(g_q)) - np.maximum.accumulate(
        np.where(first, np.arange(len(g_q)), 0)
    )
    sel = rank < C
    rr = rank[sel]
    qq = g_q[sel]
    out_diag[qq, rr] = g_diag[sel]
    out_votes[qq, rr] = g_votes[sel]
    out_qmin[qq, rr] = g_qmin[sel]
    out_qmax[qq, rr] = g_qmax[sel]
    out_ok[qq, rr] = True
    return out_diag, out_votes, out_qmin, out_qmax, out_ok


def _bwa_mapq(p_score, comp_score, sub_n, aln_len, cfg) -> np.ndarray:
    """bwa-mem's published mapq model (mem_approx_mapq_se, bwamem.c):

        sub  = max(best competitor, min_seed_len * a)
        iden = 1 - (l*a - score) / (a + b) / l          # percent identity
        tmp  = (l < 50 ? 1 : log(50)/log(l)) * iden^2
        mapq = 6.02 * (score - sub) / a * tmp^2
        mapq -= 4.343 * ln(sub_n + 1);  clip [0, 60];  0 when sub >= score

    replacing the round-2 linear heuristic clip(6*(score-comp)) so the
    mapq >= 20 gates downstream (get_raw_bkp.py:55-61, accurate_bkp) see
    bwa-calibrated values: short or repetitive placements drop below 20 the
    way bwa drops them, instead of saturating at 60 whenever no competitor
    was found. frac_rep (bwa's repeat-fraction damping) has no analog here
    and is treated as 0. Validated by tools/mapq_calibration.py + the
    tightened gates in tests/test_direct_mode.py (r2 ask #6)."""
    a = float(cfg.match)
    b = float(-cfg.mismatch)
    score = p_score.astype(np.float64)
    sub = np.maximum(comp_score.astype(np.float64), a * cfg.seed_len)
    l = np.maximum(aln_len.astype(np.float64), 1.0)
    identity = np.clip(1.0 - (l * a - score) / (a + b) / l, 0.0, 1.0)
    tmp = np.where(l < 50.0, 1.0, np.log(50.0) / np.log(np.maximum(l, 2.0)))
    tmp = tmp * identity * identity
    mapq = (6.02 * (score - sub) / a * tmp * tmp + 0.499).astype(np.int64)
    mapq -= (4.343 * np.log1p(sub_n.astype(np.float64)) + 0.499).astype(np.int64)
    mapq = np.clip(mapq, 0, 60)
    return np.where(sub >= score, 0, mapq).astype(np.int16)


BITMAP_WORDS = cuda_seed.BITMAP_WORDS  # 2^32 prefix bits



def _expand_table(t: AlnTable, pf_idx: np.ndarray, read_ids: np.ndarray,
                  lengths: np.ndarray, mate: int) -> AlnTable:
    """Scatter a prefilter-subset AlnTable back to full batch rows; rows the
    prefilter dropped are unmapped (contig -1), exactly what the full path
    returns for reads with no seed hits."""
    n = len(read_ids)
    full = AlnTable(
        read_id=read_ids.astype(np.int64),
        mate=np.full(n, mate, np.int8),
        contig=np.full(n, -1, np.int32),
        pos=np.zeros(n, np.int64),
        rend=np.zeros(n, np.int64),
        strand=np.zeros(n, np.int8),
        qstart=np.zeros(n, np.int32),
        qend=np.zeros(n, np.int32),
        score=np.zeros(n, np.int32),
        mapq=np.zeros(n, np.int16),
        rlen=lengths.astype(np.int32),
        contig2=np.full(n, -1, np.int32),
        pos2=np.zeros(n, np.int64),
        rend2=np.zeros(n, np.int64),
        strand2=np.zeros(n, np.int8),
        qstart2=np.zeros(n, np.int32),
        qend2=np.zeros(n, np.int32),
        score2=np.zeros(n, np.int32),
        has_alt=np.zeros(n, bool),
    )
    for f in AlnTable.__dataclass_fields__:
        getattr(full, f)[pf_idx] = getattr(t, f)
    return full


def _revcomp_batch(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Reverse-complement padded reads, keeping padding at the tail."""
    B, L = codes.shape
    out = np.full_like(codes, 4)
    comp = COMPLEMENT[codes]
    idx = lengths[:, None] - 1 - np.arange(L)[None, :]
    valid = idx >= 0
    rows = np.broadcast_to(np.arange(B)[:, None], (B, L))
    out[valid] = comp[rows[valid], idx[valid]]
    return out


def prefix_bitmap(index: SeedIndex, device) -> torch.Tensor:
    """Exact presence bitmap int32 [2^27] over the 32-bit seed-prefix space.

    Distinct prefixes map to distinct (word, bit) cells, so a scatter-ADD
    of single bits is an exact OR; bit 31 is negative in int32 and stays
    exact in two's complement. The prefixes are sorted with their pow2
    padding repeating the tail value, so only each run's first entry adds
    (a repeated add of one bit would carry into its neighbour)."""
    pre = torch.from_numpy(index.prefix32.astype(np.int64)).to(device)
    bm = torch.zeros(BITMAP_WORDS, dtype=torch.int32, device=device)
    if len(pre) == 0:
        return bm
    uniq = torch.ones_like(pre, dtype=torch.bool)
    uniq[1:] = pre[1:] != pre[:-1]
    pre = pre[uniq]
    bit = 1 << (pre & 31)
    bit = torch.where(bit >= 1 << 31, bit - (1 << 32), bit)  # bit 31 < 0
    bm.index_add_(0, pre >> 5, bit.to(torch.int32))
    return bm


def seed_prefilter_device(codes: torch.Tensor, lengths: torch.Tensor,
                          bitmap: torch.Tensor) -> torch.Tensor:
    """bool [B] on the device: True iff the read has a window whose
    PREFILTER_LEN-base hash, forward or reverse-complement, is the prefix
    of some indexed seed. Exact membership, so no read the host seeding
    could seed is dropped. Kernel K6 on a CUDA device, seed_prefilter_plain
    on the CPU."""
    if codes.device.type == "cuda":
        return cuda_seed.seed_prefilter(codes, lengths, bitmap)
    if codes.device.type != "cpu":
        raise ValueError(f"seed_prefilter_device: unsupported device "
                         f"{codes.device}")
    return seed_prefilter_plain(codes, lengths, bitmap)


def seed_prefilter_plain(codes: torch.Tensor, lengths: torch.Tensor,
                         bitmap: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K6 on any device: the JAX package's jitted
    `pf`, one int64 window hash a step over the PREFILTER_LEN bases."""
    hf, hr, ok = prefilter_windows(codes, lengths)
    return (ok & (bitmap_bit(bitmap, hf) | bitmap_bit(bitmap, hr))).any(dim=1)


def prefilter_windows(codes: torch.Tensor, lengths: torch.Tensor):
    """(hf, hr, ok) [B, L - PREFILTER_LEN + 1]: each window start's forward
    and reverse-complement hash (int64) and whether the window lies in the
    read and holds bases only."""
    pl = PREFILTER_LEN
    B, L = codes.shape
    n = L - pl + 1
    c = codes.to(torch.int64)
    hf = torch.zeros((B, n), dtype=torch.int64, device=codes.device)
    hr = torch.zeros_like(hf)
    bad = torch.zeros((B, n), dtype=torch.int32, device=codes.device)
    for z in range(pl):
        col = c[:, z : z + n]
        hf = (hf << 2) | (col & 3)
        hr = hr | (((3 - col) & 3) << (2 * z))
        bad += (col >= 4).to(torch.int32)
    inwin = (torch.arange(n, device=codes.device)[None, :]
             <= lengths[:, None].long() - pl)
    return hf, hr, (bad == 0) & inwin


def bitmap_bit(bitmap: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Whether hash h (int64) has its bit set in the prefix bitmap."""
    w = bitmap[h >> 5].to(torch.int64)
    return ((w >> (h & 31)) & 1) != 0


def align_batch(subref: SubRef, index: SeedIndex, codes: np.ndarray,
                lengths: np.ndarray, read_ids: np.ndarray, mate: int,
                cfg: AlignConfig, device, pf_mask: np.ndarray,
                threads: int = 8, mesh=None) -> AlnTable:
    """Align one batch of single-end reads; returns per-read records
    (unmapped reads included with contig=-1 so pairing stays positional).

    `pf_mask`: the seed-prefilter result for this batch (bool [B], from
    seed_prefilter_device); only the reads it keeps are seeded. The host
    logic is the reference's line for line; the SW extension is kernel K1
    on `device`, or with `mesh` (parallel.mesh.DeviceMesh) data-parallel
    over the mesh's shards."""
    full_ids, full_lengths = read_ids, lengths
    pf_idx = np.flatnonzero(pf_mask)
    real = lengths > 0
    metrics.add("prefilter_in", int(real.sum()))
    metrics.add("prefilter_kept", int((pf_mask & real).sum()))
    if len(pf_idx) == 0:
        return _expand_table(AlnTable.empty(), pf_idx, full_ids,
                             full_lengths, mate)
    codes = codes[pf_idx]
    lengths = lengths[pf_idx]
    read_ids = read_ids[pf_idx]

    B, L = codes.shape
    C = cfg.max_candidates

    # --- seed lookup on both strands (the C++ library of io/csrc) ---
    with metrics.span("align.seed"):
        hits = native.seed_hits(
            codes, lengths, index.sorted_hash, index.sorted_pos,
            cfg.seed_len, cfg.seed_stride, 32, threads=threads,
        )
        if hits is None:
            raise RuntimeError(
                "seed lookup needs localhgt_tpu_torch/io/csrc, built with g++ "
                "at first use; the build failed")
        hr, ho, hp, hs = hits
        cand = []
        for strand in (0, 1):
            m = hs == strand
            cand.append(
                _group_candidates(
                    hr[m].astype(np.int64), hp[m] - ho[m],
                    ho[m].astype(np.int64), B, gap=cfg.window_pad,
                    max_candidates=C, min_votes=cfg.min_seed_votes,
                )
                + (strand,)
            )

        # merge strands: 2C candidates per read
        diag_all = np.concatenate([c[0] for c in cand], axis=1)
        votes_all = np.concatenate([c[1] for c in cand], axis=1)
        ok_all = np.concatenate([c[4] for c in cand], axis=1)
        strand_all = np.concatenate(
            [np.full((B, C), c[5], np.int8) for c in cand], axis=1
        )
        # keep top-C by votes across strands
        order = np.argsort(-np.where(ok_all, votes_all, -1), axis=1,
                           kind="stable")[:, :C]
        rows = np.arange(B)[:, None]
        diag_c = diag_all[rows, order]
        ok_c = ok_all[rows, order]
        strand_c = strand_all[rows, order]

    # --- batched extension: only real candidates reach kernel K1 ---
    with metrics.span("align.sw"):
        W = int(L + 2 * cfg.window_pad)
        win_start = diag_c - cfg.window_pad
        np.clip(win_start, 0, max(len(subref.codes) - W, 0), out=win_start)
        sel = np.flatnonzero(ok_c.reshape(-1))
        score = np.zeros((B, C), np.int32)
        qs = np.zeros((B, C), np.int32)
        qe = np.zeros((B, C), np.int32)
        rs = np.zeros((B, C), np.int64)
        re_ = np.zeros((B, C), np.int64)
        if len(sel) and len(subref.codes):
            n_sel = len(sel)
            b_idx = sel // C
            c_idx = sel % C
            ws = win_start.reshape(-1)[sel]
            gather = ws[:, None] + np.arange(W)[None, :]
            np.clip(gather, 0, len(subref.codes) - 1, out=gather)
            ref_w = subref.codes[gather]
            strands = strand_c.reshape(-1)[sel]
            q_sel = codes[b_idx]
            rows1 = np.flatnonzero(strands == 1)
            if len(rows1):  # revcomp only the selected reverse-strand rows
                q_sel[rows1] = _revcomp_batch(
                    codes[b_idx[rows1]], lengths[b_idx[rows1]]
                )
            out = swmod.sw_align_tiled(
                q_sel, ref_w, device, mesh=mesh,
                match=cfg.match, mismatch=cfg.mismatch,
                gap_open=cfg.gap_open, gap_ext=cfg.gap_extend,
            )
            score[b_idx, c_idx] = out["score"][:n_sel]
            qs[b_idx, c_idx] = out["qstart"][:n_sel]
            qe[b_idx, c_idx] = out["qend"][:n_sel]
            rs[b_idx, c_idx] = out["rstart"][:n_sel] + ws
            re_[b_idx, c_idx] = out["rend"][:n_sel] + ws

    # --- per-candidate segment validity (one reference sequence each) ---
    if len(subref.seg_off):
        seg_s = np.searchsorted(subref.seg_off, rs.reshape(-1), "right") - 1
        seg_e = np.searchsorted(subref.seg_off, re_.reshape(-1), "right") - 1
        same_seg_c = (seg_s == seg_e).reshape(B, C)
    else:
        same_seg_c = np.zeros((B, C), bool)
    valid_c = ok_c & same_seg_c

    # --- primary selection ---
    prim = np.argmax(np.where(valid_c, score, -1), axis=1)
    p_score = score[rows[:, 0], prim]
    p_valid = valid_c[rows[:, 0], prim]
    mapped = p_valid & (p_score >= cfg.match * cfg.seed_len)

    def pick(a):
        return a[rows[:, 0], prim]

    p_qs, p_qe = pick(qs), pick(qe)
    p_rs, p_re = pick(rs), pick(re_)
    p_strand = pick(strand_c)

    # --- split / competitor separation, in the original read frame ---
    ln = lengths[:, None]
    qs_f = np.where(strand_c == 1, ln - 1 - qe, qs)
    qe_f = np.where(strand_c == 1, ln - 1 - qs, qe)
    p_qs_f = qs_f[rows[:, 0], prim][:, None]
    p_qe_f = qe_f[rows[:, 0], prim][:, None]
    ov_lo = np.maximum(qs_f, p_qs_f)
    ov_hi = np.minimum(qe_f, p_qe_f)
    overlap = np.maximum(0, ov_hi - ov_lo + 1)
    span = qe_f - qs_f + 1
    nonov_self = span - overlap
    nonov_prim = (p_qe_f - p_qs_f + 1) - overlap
    is_prim = np.zeros_like(score, bool)
    is_prim[rows[:, 0], prim] = True
    competitor = (~is_prim) & valid_c & (overlap > span // 2)
    comp_score = np.where(competitor, score, 0).max(axis=1)
    alt_like = competitor & (
        score.astype(np.int64) * 10 >= (p_score[:, None].astype(np.int64) * 8)
    ) & (score > 0)
    has_alt = alt_like.any(axis=1)
    mapq = _bwa_mapq(p_score, comp_score, alt_like.sum(axis=1),
                     np.maximum(p_qe - p_qs, p_re - p_rs) + 1, cfg)
    splitable = (
        (~is_prim) & valid_c
        & (np.minimum(nonov_self, nonov_prim) >= cfg.min_split_len)
        & (score >= cfg.match * cfg.seed_len)
    )
    split_idx = np.argmax(np.where(splitable, score, -1), axis=1)
    has_split = splitable[rows[:, 0], split_idx]

    def pick2(a):
        return a[rows[:, 0], split_idx]

    # --- lift to original coordinates ---
    contig, orig_pos, _ = subref.lift(p_rs)
    _, orig_end, _ = subref.lift(p_re)
    contig2, orig_pos2, _ = subref.lift(pick2(rs))
    _, orig_end2, _ = subref.lift(pick2(re_))

    n = B
    table = AlnTable(
        read_id=read_ids.astype(np.int64),
        mate=np.full(n, mate, np.int8),
        contig=np.where(mapped, contig, -1).astype(np.int32),
        pos=np.where(mapped, orig_pos, 0).astype(np.int64),
        rend=np.where(mapped, orig_end, 0).astype(np.int64),
        strand=p_strand.astype(np.int8),
        qstart=p_qs.astype(np.int32),
        qend=p_qe.astype(np.int32),
        score=p_score.astype(np.int32),
        mapq=np.where(mapped, mapq, 0).astype(np.int16),
        rlen=lengths.astype(np.int32),
        contig2=np.where(mapped & has_split, contig2, -1).astype(np.int32),
        pos2=np.where(has_split, orig_pos2, 0).astype(np.int64),
        rend2=np.where(has_split, orig_end2, 0).astype(np.int64),
        strand2=pick2(strand_c).astype(np.int8),
        qstart2=pick2(qs).astype(np.int32),
        qend2=pick2(qe).astype(np.int32),
        score2=np.where(has_split, pick2(score), 0).astype(np.int32),
        has_alt=mapped & has_alt,
    )
    return _expand_table(table, pf_idx, full_ids, full_lengths, mate)
