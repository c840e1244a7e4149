"""Batched semi-global alignment with ungapped-block tracking.

Port of localhgt_tpu/ops/nw.py::nw_max_ungapped (the formulation and the
tie order are described there) as plain torch over [B, N+1] rows, on the
device of its inputs. The JAX package runs it as plain XLA, not as a
Pallas kernel, so it stays plain torch here; the horizontal-gap prefix
scan with "latest open wins ties" is a cummax plus the gather at the last
record point, as in ops/cuda_sw.py::sw_align_plain.
"""

from __future__ import annotations

import torch

NEG = -(1 << 28)


def _pick(take_b, a, b):
    return tuple(torch.where(take_b, y, x) for x, y in zip(a, b))


def _maxtri(a, b):
    """max on (value, run, maxrun) triples; ties keep `a`."""
    return _pick(b[0] > a[0], a, b)


def nw_max_ungapped(query: torch.Tensor, ref: torch.Tensor, match=2,
                    mismatch=-3, gap_open=-5, gap_ext=-2):
    """Semi-global alignment score + longest ungapped block.

    query uint8 [B, M], ref uint8 [B, N] base codes on one device (4 = N,
    aligns as a mismatch). Returns (score int32 [B], max_run int32 [B]) on
    that device, equal to the JAX package's for the same inputs."""
    B, M = query.shape
    N = ref.shape[1]
    dev = query.device
    i32 = torch.int32
    o, e = gap_open, gap_ext
    jpos = torch.arange(N + 1, dtype=i32, device=dev)[None, :]
    Z1 = torch.zeros((B, 1), dtype=i32, device=dev)
    ref_l = ref.long()
    qq = query.long()

    Hp = torch.zeros((B, N + 1), dtype=i32, device=dev)
    Rp = torch.zeros_like(Hp)
    Mp = torch.zeros_like(Hp)
    Fv = torch.full((B, N + 1), NEG, dtype=i32, device=dev)
    Fr = torch.zeros_like(Hp)
    Fm = torch.zeros_like(Hp)
    col_v, col_m = [], []
    for i in range(M):
        q = qq[:, i:i + 1]
        sub = torch.where((ref_l == q) & (q < 4) & (ref_l < 4),
                          match, mismatch).to(i32)
        # vertical gap (consumes a query base); tie prefers a fresh open
        Fv, Fr, Fm = _maxtri((Hp + (o + e), torch.zeros_like(Rp), Mp),
                             (Fv + e, Fr, Fm))
        diag_r = Rp[:, :-1] + 1
        diag = (Hp[:, :-1] + sub, diag_r, torch.maximum(Mp[:, :-1], diag_r))
        cand = _maxtri(diag, (Fv[:, 1:], Fr[:, 1:], Fm[:, 1:]))
        # column 0: the free leading query gap
        base_v, base_r, base_m = (torch.cat([Z1, c], 1) for c in cand)
        # horizontal gap: E[j] = max_{j'<j} base[j'] + o + (j-j')*e, the
        # latest j' on ties
        A_v = base_v + o - jpos * e
        P_v = torch.cummax(A_v, dim=1).values
        last = torch.cummax(torch.where(A_v == P_v, jpos, -1), dim=1).values
        P_m = torch.gather(base_m, 1, last.long())
        E_v = torch.cat([torch.full_like(Z1, NEG),
                         P_v[:, :-1] + jpos[:, 1:] * e], 1)
        E_m = torch.cat([Z1, P_m[:, :-1]], 1)
        Hp, Rp, Mp = _maxtri((base_v, base_r, base_m),
                             (E_v, torch.zeros_like(base_r), E_m))
        col_v.append(Hp[:, -1])
        col_m.append(Mp[:, -1])
    zero = torch.zeros(B, dtype=i32, device=dev)
    col_v = torch.stack(col_v)
    col_m = torch.stack(col_m)
    # free trailing gaps: the best of the last column (earliest row on
    # ties, then the empty alignment), then of the last row (earliest
    # column on ties)
    ci = col_v.argmax(0, keepdim=True)  # the first maximum
    last_col = _maxtri((col_v.amax(0), zero, torch.gather(col_m, 0, ci)[0]),
                       (zero, zero, zero))
    ri = Hp.argmax(1, keepdim=True)
    last_row = (Hp.amax(1), zero, torch.gather(Mp, 1, ri)[:, 0])
    best = _maxtri(last_col, last_row)
    return best[0], best[2]
