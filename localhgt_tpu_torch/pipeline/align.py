"""Seed-and-extend read alignment against the extracted sub-reference.

Port of the device parts of localhgt_tpu/pipeline/align.py: `align_batch`
(its Smith-Waterman extension runs in kernel K1) and the seed prefilter,
a 2^27-word prefix bitmap plus a forward/reverse-complement probe kept on
the device. The dataclasses and host helpers are re-exported from the JAX
package unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from localhgt_tpu.config import AlignConfig
from localhgt_tpu.pipeline.align import (  # noqa: F401  (re-exports)
    PREFILTER_LEN, SEP, AlnTable, SeedIndex, SubRef, _bwa_mapq,
    _expand_table, _group_candidates, _revcomp_batch, build_subref)
from localhgt_tpu.utils import metrics
from localhgt_tpu_torch.ops import sw as swmod

BITMAP_WORDS = 1 << 27  # 2^32 prefix bits


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
    could seed is dropped."""
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
    ok = (bad == 0) & inwin

    def member(h):
        w = bitmap[h >> 5].to(torch.int64)
        return ((w >> (h & 31)) & 1) != 0

    return (ok & (member(hf) | member(hr))).any(dim=1)


def align_batch(subref: SubRef, index: SeedIndex, codes: np.ndarray,
                lengths: np.ndarray, read_ids: np.ndarray, mate: int,
                cfg: AlignConfig, device, pf_mask: np.ndarray,
                threads: int = 8) -> AlnTable:
    """Align one batch of single-end reads; returns per-read records
    (unmapped reads included with contig=-1 so pairing stays positional).

    `pf_mask`: the seed-prefilter result for this batch (bool [B], from
    seed_prefilter_device); only the reads it keeps are seeded. The host
    logic is the reference's line for line; the SW extension is kernel K1
    on `device`."""
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

    # --- seed lookup on both strands (the JAX package's C++ library) ---
    from localhgt_tpu.io import native

    hits = native.seed_hits(
        codes, lengths, index.sorted_hash, index.sorted_pos,
        cfg.seed_len, cfg.seed_stride, 32, threads=threads,
    )
    if hits is None:
        raise RuntimeError(
            "seed lookup needs localhgt_tpu/io/csrc, built with g++ at first "
            "use; the build failed")
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
            q_sel, ref_w, device,
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
