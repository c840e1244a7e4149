"""Precise breakpoint refinement (port of localhgt_tpu/pipeline/accbkp.py).

The host logic (clustering, split reads, support counting, refinement) is
imported from the JAX package unchanged. The functions that reach the
Smith-Waterman scorer are copied here line for line, with one change: the
four SW sites (`_window_scores`, `_score_tasks`, `_batch_recheck`,
`_recheck`) call kernel K2 through localhgt_tpu_torch.ops.sw on an
explicit `device`, which is threaded through the callers.
"""

from __future__ import annotations

import logging

import numpy as np

from localhgt_tpu.config import BkpConfig
from localhgt_tpu.io import fasta
from localhgt_tpu.ops import coder
from localhgt_tpu.pipeline.accbkp import (  # noqa: F401  (re-exports)
    AccBkp, AlnIndex, Cluster, SplitRead, _enumerate_tasks, _make_acc,
    _recheck_key, _revcomp, _sort_support, _window_rows, attach_split_reads,
    cluster_raw_bkps, count_support, make_split_reads)
from localhgt_tpu.pipeline.align import AlnTable, SubRef
from localhgt_tpu.pipeline.rawbkp import InsertStats, RawBkp
from localhgt_tpu_torch.ops import sw as swmod

log = logging.getLogger("localhgt_tpu_torch.accbkp")


def _window_scores(seq: np.ndarray, contig_codes: np.ndarray, lo: int,
                   hi: int, left_windows: bool, revcomp_ref: bool, device):
    """Batched scores of `seq` vs every candidate window pb in [lo, hi).

    left_windows: window = ref[pb-len(seq) : pb]; else ref[pb : pb+len(seq)].
    Window start clamp mirrors extract_ref_seq's floor at 1 (:339-342).
    Returns float scores [hi-lo] (score / len(seq)).
    """
    sl = len(seq)
    n = hi - lo
    if n <= 0 or sl == 0:
        return np.zeros(0, np.float32)
    pb = np.arange(lo, hi, dtype=np.int64)
    if left_windows:
        starts = pb - sl
    else:
        starts = pb
    starts = np.maximum(starts, 1)
    gather = starts[:, None] + np.arange(sl)[None, :]
    gather = np.clip(gather, 0, max(len(contig_codes) - 1, 0))
    wins = contig_codes[gather]
    oob = (starts[:, None] + np.arange(sl)[None, :]) >= len(contig_codes)
    wins = np.where(oob, 4, wins).astype(np.uint8)
    if revcomp_ref:
        wins = coder.COMPLEMENT[wins][:, ::-1]
    # pad width to a 32-multiple bucket; N-padding cannot score
    sl_pad = -(-sl // 32) * 32
    q = np.full((n, sl_pad), 4, np.uint8)
    q[:, :sl] = seq[None, :]
    w = np.full((n, sl_pad), 4, np.uint8)
    w[:, :sl] = wins
    scores = swmod.sw_score_tiled(q, w, device)
    return scores.astype(np.float32) / sl


def _score_tasks(tasks, contigs: fasta.Contigs, device,
                 max_rows: int = 1 << 16):
    """Batched window scores for every task: builds all (query, window) rows
    host-side, runs sw_score_tiled in few large calls, returns per-task
    (best_offset, best_ratio)."""
    results = {}
    if not tasks:
        return results
    W = max(32, -(-max(len(t["seq"]) for t in tasks) // 32) * 32)
    rows_q, rows_r, spans = [], [], []
    for t in tasks:
        q, w = _window_rows(t, contigs, W)
        rows_q.append(q)
        rows_r.append(w)
        spans.append(len(q))
    qs = np.concatenate(rows_q)
    rs = np.concatenate(rows_r)
    scores = np.concatenate([
        swmod.sw_score_tiled(qs[i: i + max_rows], rs[i: i + max_rows], device)
        for i in range(0, len(qs), max_rows)
    ]) if len(qs) else np.zeros(0, np.int32)
    off = 0
    for t, n in zip(tasks, spans):
        sl = len(t["seq"])
        if n == 0 or sl == 0:
            results[(t["ci"], t["ri"], t["side"])] = (0, 0.0)
            off += n
            continue
        sc = scores[off: off + n].astype(np.float32) / sl
        best = int(np.argmax(sc))
        results[(t["ci"], t["ri"], t["side"])] = (best, float(sc[best]))
        off += n
    return results


def choose_acc_from_cluster(cl: Cluster, contigs: fasta.Contigs, rlen: int,
                            cfg: BkpConfig, device, ci: int = 0,
                            scored: dict | None = None,
                            recheck_memo: dict | None = None):
    """choose_acc_from_cluster (:398-496). Window scores come from the
    pre-batched `scored` map when given (falling back to a per-task device
    call); the sequential read order, early exits and cluster position state
    are replicated exactly."""
    inte = cfg.search_scale * rlen
    if scored is None:
        _sort_support(cl)
    for ri, sr in enumerate(cl.support_reads):
        if sr.end_point:
            continue
        extract_dir = "right" if cl.direction else "left"
        acc1 = acc2 = None
        score1 = score2 = 0.0

        for side in (1, 2):
            seq = sr.seq1 if side == 1 else sr.seq2
            if len(seq) <= cfg.min_seq_len or sr.clipped != side:
                continue
            positions = cl.ref1_positions if side == 1 else cl.ref2_positions
            ref_id = cl.ref1 if side == 1 else cl.ref2
            lo = positions[0] - inte
            hi = positions[-1] + inte
            left_windows = sr.clipped_direction == extract_dir
            if scored is not None:
                if (ci, ri, side) not in scored:
                    continue
                best, sc = scored[(ci, ri, side)]
            else:
                ratios = _window_scores(
                    seq, contigs.contig_codes(ref_id), lo, hi,
                    left_windows, cl.direction, device,
                )
                if len(ratios) == 0:
                    continue
                best = int(np.argmax(ratios))
                sc = float(ratios[best])
            if sc <= cfg.min_match_score:
                continue
            pb = lo + best
            if side == 1:
                to_side = "left" if sr.clipped_direction == "right" else "right"
                if sr.clipped_direction == "right":
                    from_side = "left" if cl.direction else "right"
                else:
                    from_side = "right" if cl.direction else "left"
                cl.pos1 = pb
                cl.pos2 = sr.pos2
                score1 = sc
                acc1 = _make_acc(cl, from_side, to_side, seq, sc, contigs,
                                 left_windows, rlen)
            else:
                from_side = "left" if sr.clipped_direction == "right" else "right"
                if sr.clipped_direction == "right":
                    to_side = "left" if cl.direction else "right"
                else:
                    to_side = "right" if cl.direction else "left"
                cl.pos2 = pb
                cl.pos1 = sr.pos1
                score2 = sc
                acc2 = _make_acc(cl, from_side, to_side, seq, sc, contigs,
                                 left_windows, rlen)

        if cl.pos1 > 0 and cl.pos2 > 0:
            if score1 > cfg.min_match_score and acc1 is not None and \
               _recheck_cached(acc1, contigs, cfg, recheck_memo, device):
                return acc1
            if score2 > cfg.min_match_score and acc2 is not None and \
               _recheck_cached(acc2, contigs, cfg, recheck_memo, device):
                return acc2
            return None
    return None


def _recheck_cached(acc, contigs, cfg, memo, device):
    if memo is not None:
        hit = memo.get(_recheck_key(acc))
        if hit is not None:
            return hit
    return _recheck(acc, contigs, cfg, device)


def _batch_recheck(coords, contigs: fasta.Contigs, cfg: BkpConfig,
                   device) -> dict:
    """Repeat-guard similarity for many (from_ref, from_bkp, to_ref, to_bkp)
    candidates in one device call (two SW rows per candidate: forward and
    revcomp orientation — compare_two_refs, accurate_bkp.py:528-551)."""
    coords = list(dict.fromkeys(coords))
    out = {}
    if not coords:
        return out
    clw = cfg.refs_check_len
    rows_q, rows_r, meta = [], [], []
    W = 2 * clw + 32
    W = -(-W // 32) * 32
    for c in coords:
        fr, fb, tr, tb = c
        a = contigs.slice_codes(fr, max(fb - clw, 1), fb + clw)
        b = contigs.slice_codes(tr, max(tb - clw, 1), tb + clw)
        if len(a) == 0 or len(b) == 0:
            out[c] = True
            continue
        pa = np.full(W, 4, np.uint8)
        pa[: len(a)] = a
        par = np.full(W, 4, np.uint8)
        ar = _revcomp(a)
        par[: len(ar)] = ar
        pb = np.full(W, 4, np.uint8)
        pb[: len(b)] = b
        rows_q += [pa, par]
        rows_r += [pb, pb]
        meta.append((c, len(a)))
    if meta:
        scores = swmod.sw_score_tiled(np.stack(rows_q), np.stack(rows_r),
                                      device)
        for i, (c, la) in enumerate(meta):
            sim = float(max(scores[2 * i], scores[2 * i + 1])) / la
            out[c] = sim <= cfg.max_refs_sim
    return out


def _recheck(acc: AccBkp, contigs: fasta.Contigs, cfg: BkpConfig,
             device) -> bool:
    """Repeat guard (compare_two_refs/recheck, :528-551): the two +-50bp
    flanks must not look alike in either orientation."""
    cl = cfg.refs_check_len
    a = contigs.slice_codes(acc.from_ref, max(acc.from_bkp - cl, 1),
                            acc.from_bkp + cl)
    b = contigs.slice_codes(acc.to_ref, max(acc.to_bkp - cl, 1),
                            acc.to_bkp + cl)
    if len(a) == 0 or len(b) == 0:
        return True
    n = -(-max(len(a), len(b)) // 32) * 32
    pa = np.full(n, 4, np.uint8)
    pa[: len(a)] = a
    pb = np.full(n, 4, np.uint8)
    pb[: len(b)] = b
    par = np.full(n, 4, np.uint8)
    ar = _revcomp(a)
    par[: len(ar)] = ar
    q = np.stack([pa, par])
    r = np.stack([pb, pb])
    scores = swmod.sw_score(q, r, device)
    sim = float(scores.max()) / len(a)
    return sim <= cfg.max_refs_sim


def find_accurate_bkps(
    raw: list[RawBkp], a1: AlnTable, a2: AlnTable,
    codes1: np.ndarray, codes2: np.ndarray,
    contigs: fasta.Contigs, ins: InsertStats, cfg: BkpConfig,
    subref: SubRef | None, device, read_info: bool = True,
) -> list[AccBkp]:
    clusters = cluster_raw_bkps(raw, cfg)
    log.info("breakpoint cluster number: %d", len(clusters))
    splits = make_split_reads(a1, codes1, ins.rlen, subref, cfg) + \
        make_split_reads(a2, codes2, ins.rlen, subref, cfg)
    log.info("split reads: %d", len(splits))
    attach_split_reads(clusters, splits, ins.insert_size)
    # phase 1: every window-scan task scored in one batched device pass
    tasks = _enumerate_tasks(clusters, ins.rlen, cfg)
    scored = _score_tasks(tasks, contigs, device)
    # phase 2: pre-batch the repeat-guard rechecks for every candidate that
    # could clear min_match_score (superset of what the sequential pass uses)
    cand_coords = []
    for t in tasks:
        best, sc = scored[(t["ci"], t["ri"], t["side"])]
        if sc <= cfg.min_match_score:
            continue
        pb = t["lo"] + best
        if t["side"] == 1:
            cand_coords.append((t["ref1"], pb, t["ref2"], t["sr_pos2"]))
        else:
            cand_coords.append((t["ref1"], t["sr_pos1"], t["ref2"], pb))
    recheck_memo = _batch_recheck(cand_coords, contigs, cfg, device)
    # phase 3: exact sequential accept logic, consuming the batched results
    accs = []
    for ci, cl in enumerate(clusters):
        if not cl.support_reads:
            continue
        acc = choose_acc_from_cluster(cl, contigs, ins.rlen, cfg, device,
                                      ci=ci, scored=scored,
                                      recheck_memo=recheck_memo)
        if acc is not None:
            accs.append(acc)
    log.info("rough number of acc bkps: %d", len(accs))
    if read_info and accs:
        index = AlnIndex(a1, a2)
        for acc in accs:
            count_support(acc, index, ins, cfg)
    for acc in accs:
        acc.refine()
    return accs
