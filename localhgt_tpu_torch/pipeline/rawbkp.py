"""Raw HGT junction calling from discordant read pairs.

Port of scripts/get_raw_bkp.py operating on the in-memory AlnTable instead of
a BAM: estimate insert size from proper pairs (getInsertSize, :33-49), collect
pairs whose mates map to different contigs (calCrossReads, :51-77), bucket by
(contig-pair, orientation class) (clasifyData, :137-211), density-cluster each
bucket with DBSCAN(eps=insert/2, min_samples=1) (clusterBasedOnDensity,
:226-247) and emit one junction row per cluster with the class-specific
representative positions (worker, :599-678; flags in print_junction, :572-582).

The reference processes each unordered contig pair from the perspective of the
contig first encountered in the position-sorted BAM, i.e. the smaller
reference id — we use min(contig id).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from localhgt_tpu_torch.config import BkpConfig
from localhgt_tpu_torch.pipeline.align import AlnTable


@dataclass
class RawBkp:
    c1: int
    pos1: int
    min1: int
    max1: int
    c2: int
    pos2: int
    min2: int
    max2: int
    n_sup: int
    reverse: bool


@dataclass
class InsertStats:
    mean: float
    sd: float
    insert_size: int
    rlen: int
    n: int


def pair_tlen(a1: AlnTable, a2: AlnTable) -> np.ndarray:
    """SAM-convention template length for same-contig pairs (0 otherwise)."""
    same = (a1.contig == a2.contig) & (a1.contig > 0) & (a2.contig > 0)
    lo = np.minimum(a1.pos, a2.pos)
    hi = np.maximum(a1.rend, a2.rend)
    return np.where(same, hi - lo + 1, 0)


def estimate_insert(a1: AlnTable, a2: AlnTable, cfg: BkpConfig) -> InsertStats:
    """Mean/sd of template length over proper pairs; insert = mean + 2*sd
    (get_raw_bkp.py:785-789). Proper: same contig, FR orientation,
    0 < tlen < 1000 (readFilter, :23-31)."""
    tlen = pair_tlen(a1, a2)
    fr = a1.strand != a2.strand
    ok = (tlen > 0) & (tlen < 1000) & fr
    vals = tlen[ok][: cfg.insert_sample_reads]
    rl = np.concatenate([a1.rlen[ok], a2.rlen[ok]])[: cfg.insert_sample_reads]
    if len(vals) < 2:
        return InsertStats(350.0, 50.0, 450, int(rl.mean()) if len(rl) else 150, 0)
    mean = float(vals.mean())
    sd = math.sqrt(float(((vals - mean) ** 2).sum()) / (len(vals) - 1))
    return InsertStats(
        mean, sd, int(mean + cfg.insert_sigma * sd),
        int(rl.mean()), len(vals),
    )


# orientation class ids: (on_key_record_is_read1, is_reverse, mate_is_reverse)
# -> (representative rule, reverse flag). Rules: which of sorted pos lists'
# ends represent the junction (worker, get_raw_bkp.py:628-675).
_CLASS = {
    # (is_read1, rev, mrev): (rule, reverse_flag)
    (True, False, True): ("max_min", False),   # read1pos_pos
    (True, False, False): ("max_max", True),   # read1pos_neg
    (True, True, True): ("min_min", True),     # read1neg_pos
    (True, True, False): ("min_max", False),   # read1neg_neg
    (False, False, True): ("max_min", False),  # read2neg_neg
    (False, False, False): ("max_max", True),  # read2neg_pos
    (False, True, True): ("min_min", True),    # read2pos_neg
    (False, True, False): ("min_max", False),  # read2pos_pos
}


def _dbscan_labels(xy: np.ndarray, eps: float) -> np.ndarray:
    """DBSCAN with min_samples=1 == connected components of the eps-ball graph
    (Euclidean). Uses sklearn when available for exact parity."""
    try:
        from sklearn.cluster import DBSCAN

        return DBSCAN(eps=eps, min_samples=1).fit(xy).labels_
    except ImportError:  # pragma: no cover
        n = len(xy)
        parent = list(range(n))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for i in range(n):
            for j in range(i + 1, n):
                if np.hypot(*(xy[i] - xy[j])) <= eps:
                    parent[find(i)] = find(j)
        roots = {}
        return np.array([roots.setdefault(find(i), len(roots)) for i in range(n)])


def call_raw_bkps(a1: AlnTable, a2: AlnTable, ins: InsertStats,
                  cfg: BkpConfig) -> list[RawBkp]:
    mapped = (a1.contig > 0) & (a2.contig > 0)
    cross = mapped & (a1.contig != a2.contig)
    q = (a1.mapq >= cfg.mapq_min) & (a2.mapq >= cfg.mapq_min)
    if not cfg.keep_xa and len(a1.has_alt) == len(q):
        # -a 0: drop pairs where either end has an XA-grade alternative
        # placement (calCrossReads, get_raw_bkp.py:55-77)
        q &= ~a1.has_alt & ~a2.has_alt
    sel = np.flatnonzero(cross & q)
    if len(sel) == 0:
        return []

    c1 = a1.contig[sel]
    c2 = a2.contig[sel]
    key_is_m1 = c1 <= c2
    key_c = np.where(key_is_m1, c1, c2)
    oth_c = np.where(key_is_m1, c2, c1)
    key_pos = np.where(key_is_m1, a1.pos[sel], a2.pos[sel])
    oth_pos = np.where(key_is_m1, a2.pos[sel], a1.pos[sel])
    key_read1 = np.where(key_is_m1, a1.mate[sel] == 0, a2.mate[sel] == 0)
    key_rev = np.where(key_is_m1, a1.strand[sel], a2.strand[sel]).astype(bool)
    oth_rev = np.where(key_is_m1, a2.strand[sel], a1.strand[sel]).astype(bool)

    out: list[RawBkp] = []
    order = np.lexsort((oth_pos, key_pos, oth_c, key_c))
    kc, oc = key_c[order], oth_c[order]
    kp, op_ = key_pos[order], oth_pos[order]
    r1, kr, orv = key_read1[order], key_rev[order], oth_rev[order]
    bounds = np.flatnonzero(
        np.concatenate([[True], (kc[1:] != kc[:-1]) | (oc[1:] != oc[:-1])])
    ).tolist() + [len(kc)]
    eps = ins.insert_size / 2
    for bi in range(len(bounds) - 1):
        lo, hi = bounds[bi], bounds[bi + 1]
        for cls, (rule, revflag) in _CLASS.items():
            m = (
                (r1[lo:hi] == cls[0])
                & (kr[lo:hi] == cls[1])
                & (orv[lo:hi] == cls[2])
            )
            idx = np.flatnonzero(m) + lo
            if len(idx) == 0:
                continue
            xy = np.stack([kp[idx], op_[idx]], axis=1).astype(float)
            labels = _dbscan_labels(xy, eps)
            for lab in np.unique(labels):
                if lab < 0:
                    continue
                pts = idx[labels == lab]
                A = np.sort(kp[pts])
                B = np.sort(op_[pts])
                p1 = int(A[-1] if rule.startswith("max") else A[0])
                p2 = int(B[0] if rule.endswith("min") else B[-1])
                out.append(
                    RawBkp(
                        int(kc[lo]), p1, int(A[0]), int(A[-1]),
                        int(oc[lo]), p2, int(B[0]), int(B[-1]),
                        len(pts), revflag,
                    )
                )
    return out
