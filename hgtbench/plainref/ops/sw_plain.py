"""Plain torch Smith-Waterman: the port's plain versions of its kernels
K1 (`sw_align_plain`) and K2 (`sw_score_plain`), frozen here as the
benchmark's reference, with one addition for the control: `score_clip`
> 0 saturates every H cell at that value, as an 8-bit score lane would
(127), which breaks the exact-score guarantee on purpose.
"""

from __future__ import annotations

import torch

NEG = -(1 << 28)


def _shift_down(x: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """y[:, j] = x[:, j-s] for j >= s else fill (along the column axis)."""
    return torch.nn.functional.pad(x[:, :-s], (s, 0), value=fill)


def _substitution_rows(r: torch.Tensor, match: int, mismatch: int):
    """int32 [5, B, N]: the substitution score of every reference column
    against query code c = 0..4 (code 4, and reference code 4, never
    match)."""
    codes = torch.arange(5, device=r.device)[:, None, None]
    hit = (r[None].long() == codes) & (codes < 4)
    return torch.where(hit, match, mismatch).to(torch.int32)


def _row_substitution(sub_by_code: torch.Tensor, q_col: torch.Tensor):
    """[B, N] substitution scores of one query row (codes q_col [B])."""
    q_col = q_col.clamp(max=4)
    B, N = sub_by_code.shape[1:]
    return torch.gather(sub_by_code, 0,
                        q_col.view(1, B, 1).expand(1, B, N))[0]


def sw_align_plain(q: torch.Tensor, r: torch.Tensor, match=1, mismatch=-4,
                   gap_open=-6, gap_ext=-1, score_clip=0) -> torch.Tensor:
    """Plain torch version of K1: the Pallas _sw_align_kernel body over
    [B, N] tensors, with E's log-step shift-max written as a cummax.
    Returns int32 [B, 5] = score, qstart, qend, rstart, rend (all 0 when
    score <= 0)."""
    B, M = q.shape
    N = r.shape[1]
    dev = q.device
    i32 = torch.int32
    o, e, np1 = gap_open, gap_ext, N + 1
    sub_by_code = _substitution_rows(r, match, mismatch)
    qq = q.long()
    jpos = torch.arange(N, dtype=i32, device=dev)[None, :]

    def maxpair(av, ao, bv, bo):
        # ties keep a's origin
        return torch.maximum(av, bv), torch.where(bv > av, bo, ao)

    H = torch.zeros((B, N), dtype=i32, device=dev)
    O = torch.zeros_like(H)
    Mf = torch.full((B, N), NEG, dtype=i32, device=dev)
    MfO = torch.zeros_like(H)
    bH = torch.zeros((B, 1), dtype=i32, device=dev)
    bPack, bO, bI = bH.clone(), bH.clone(), bH.clone()
    for i in range(M):
        sub = _row_substitution(sub_by_code, qq[:, i])
        Hd = _shift_down(H, 1, 0)
        Od = _shift_down(O, 1, 0)
        start_O = i * np1 + jpos
        diag = Hd + sub
        diagO = torch.where(Hd > 0, Od, start_O)
        F = Mf + (o + i * e)
        H1, O1 = maxpair(torch.clamp_min(diag, 0), diagO, F, MfO)
        T0 = H1 - jpos * e
        T = torch.cummax(T0, dim=1).values
        # origin of the LATEST j' <= j holding the prefix max: the last
        # record point at or before j (the Pallas shift-max keeps the
        # current value on ties)
        last = torch.cummax(torch.where(T0 == T, jpos, -1), dim=1).values
        TO = torch.gather(O1, 1, last.long())
        Tm = _shift_down(T, 1, NEG)
        TmO = _shift_down(TO, 1, 0)
        # H >= 0 already: H1 >= 0, and E replaces it only when greater
        H, O = maxpair(H1, O1, Tm + o + jpos * e, TmO)
        if score_clip:
            H = torch.clamp_max(H, score_clip)
        Mf, MfO = maxpair(Mf, MfO, H - i * e, O)
        # row best: max H, then min j (pack is unique per j); in int64,
        # since H * N passes 2^31 where scores grow with the row (Pallas
        # packs in int32, and its row best wraps there)
        rowPack, rowJ = (H.long() * N + (N - 1 - jpos)).max(dim=1,
                                                             keepdim=True)
        rowH = torch.div(rowPack, N, rounding_mode="floor")
        rowO = torch.gather(O, 1, rowJ)
        better = rowH > bH
        bPack = torch.where(better, rowPack, bPack)
        bO = torch.where(better, rowO, bO)
        bI = torch.where(better, i, bI)
        bH = torch.where(better, rowH, bH)
    score = torch.clamp_min(bH, 0)
    rend = (N - 1) - (bPack - bH * N)
    qstart = torch.div(bO, np1, rounding_mode="floor")
    rstart = bO - qstart * np1
    zero = score <= 0
    fields = [torch.where(zero, 0, x) for x in (qstart, bI, rstart, rend)]
    return torch.cat([score, *fields], dim=1).to(i32)


def sw_score_plain(q: torch.Tensor, r: torch.Tensor, match=1, mismatch=-2,
                   gap_open=-3, gap_ext=-1, score_clip=0) -> torch.Tensor:
    """Plain torch version of K2: the Pallas _sw_score_kernel body over
    [B, N] tensors, with E's log-step shift-max written as a cummax.
    Returns int32 [B]."""
    B, M = q.shape
    N = r.shape[1]
    dev = q.device
    i32 = torch.int32
    o, e = gap_open, gap_ext
    sub_by_code = _substitution_rows(r, match, mismatch)
    qq = q.long()
    jpos = torch.arange(N, dtype=i32, device=dev)[None, :]
    H = torch.zeros((B, N), dtype=i32, device=dev)
    Mf = torch.full((B, N), NEG, dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    for i in range(M):
        sub = _row_substitution(sub_by_code, qq[:, i])
        Hd = _shift_down(H, 1, 0)
        F = Mf + (o + i * e)
        H1 = torch.maximum(torch.clamp_min(Hd + sub, 0), F)
        T = torch.cummax(H1 - jpos * e, dim=1).values
        Tm = _shift_down(T, 1, NEG)
        H = torch.maximum(H1, Tm + o + jpos * e)
        if score_clip:
            H = torch.clamp_max(H, score_clip)
        Mf = torch.maximum(Mf, H - i * e)
        best = torch.maximum(best, H.amax(dim=1))
    return best.to(i32)
