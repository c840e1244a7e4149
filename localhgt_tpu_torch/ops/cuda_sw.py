"""Kernels K1 and K2: batched affine-gap Smith-Waterman.

`sw_align` replaces localhgt_tpu/ops/pallas_sw.py::sw_align_pallas and
`sw_score` replaces pallas_sw.py::sw_score_pallas. Each wrapper runs the
CUDA kernel of `csrc/sw.cu` for CUDA tensors and its plain torch version
(`sw_align_plain`, `sw_score_plain`: the Pallas bodies over [B, N]
tensors) for CPU tensors, and raises on anything else.
Each wrapper counts its kernel launches in `<wrapper>.launches`, those of
the wide-reference variant (N > NARROW_MAX_N) also in
`<wrapper>.wide_launches`, those that run in bands (N > WIDE_MAX_N) also in
`<wrapper>.band_launches`, and its launches by (B, M, N) in
`<wrapper>.shapes`.

Both kernels are bound by the integer instructions they execute, and both
run an anti-diagonal wavefront: a group of 8, 16 or 32 lanes per
alignment with as many columns a lane as make the group as wide as the
window (K1: always 32 lanes, so that align's small batches on the main
path fill the card), lane l on query row t - l
at step t, the recurrence in the Gotoh form on Hopper's DPX
instructions, the substitution score by one byte permute out of a table
word a column; above NARROW_MAX_N columns one block
per alignment, a warp a stripe, the stripes joined through a ring in
shared memory without a block barrier; above WIDE_MAX_N columns one such
block a band, the bands of an alignment in a thread-block cluster of up
to 8 blocks, running together, the edge between two bands through a ring
in the right block's shared memory (distributed shared memory). Past 8
bands the blocks take bands round-robin and the edge from the cluster's
last block to its first goes through a buffer of M rows an alignment
that the wrapper allocates. A band launch that the card refuses (no
cluster of that size fits) raises, as any launch error does.
K1 also carries the origin of H, E
and F (the packed index of the cell that started the alignment): each
maximum with its winner is one `__vibmax_s32` and a select, with the
operands in the order that reproduces the Pallas tie rules, so its start
coordinates are exact. The header of csrc/sw.cu has the recurrence, the
tie rules and the cell's instruction count.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from localhgt_tpu_torch import _build

NEG = -(1 << 28)
# csrc/sw.cu runs N <= NARROW_MAX_N on one warp (K2: one group of lanes)
# per alignment, NARROW_MAX_N < N <= WIDE_MAX_N on one block of N/512 (K2:
# N/256) warps, and a wider N in ceil(N / WIDE_MAX_N) bands, a block each,
# in a cluster of at most 8 blocks (the portable cluster size)
NARROW_MAX_N = 512
WIDE_MAX_N = 4096
MAX_CELLS = 1 << 31  # the origin register packs i*(N+1)+j into int32
# int32 words of the edge from a cluster's last block to its first, a
# query row: K1 carries H, E and their origins, K2 H and E (csrc/sw.cu
# reads and writes it only past 8 bands)
EDGE_WORDS = {"lht_sw_align_bands": 4, "lht_sw_score_bands": 2}

_P = ctypes.c_void_p
# lht_sw_align and lht_sw_score: q, r, out, B, M, N, match, mismatch, open,
# ext, stream; the _bands entry points take the wrap buffer before stream
SIGNATURE = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
BANDS_SIGNATURE = SIGNATURE[:-1] + [_P, _P]


def _lib():
    return _build.load("sw", {"lht_sw_align": SIGNATURE,
                              "lht_sw_score": SIGNATURE,
                              "lht_sw_align_bands": BANDS_SIGNATURE,
                              "lht_sw_score_bands": BANDS_SIGNATURE})


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


def _check_inputs(q: torch.Tensor, r: torch.Tensor) -> None:
    if q.dtype != torch.uint8 or r.dtype != torch.uint8:
        raise TypeError(f"sw: want uint8 codes, got {q.dtype} and {r.dtype}")
    if q.dim() != 2 or r.dim() != 2 or q.shape[0] != r.shape[0]:
        raise ValueError(f"sw: want [B, M] and [B, N], got {tuple(q.shape)} "
                         f"and {tuple(r.shape)}")
    if q.device != r.device:
        raise ValueError(f"sw: query on {q.device}, reference on {r.device}")
    M, N = q.shape[1], r.shape[1]
    if M * (N + 1) >= MAX_CELLS:
        raise ValueError(f"sw: {M} query rows x {N + 1} reference columns "
                         "overflow the int32 origin register")


def launch(lib, fn: str, q, r, out, match, mismatch, gap_open, gap_ext):
    """Launch entry point `fn` of a loaded build of csrc/sw.cu (the
    package's own, or a variant that `tune_sw` built); raises on any error
    the entry point returns. A `_bands` entry point gets its wrap buffer,
    allocated here: M rows of EDGE_WORDS[fn] int32 an alignment."""
    q = q.contiguous()
    r = r.contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = [q.data_ptr(), r.data_ptr(), out.data_ptr(), q.shape[0],
            q.shape[1], r.shape[1], match, mismatch, gap_open, gap_ext]
    if fn in EDGE_WORDS:
        wrap = torch.empty((q.shape[0], q.shape[1], EDGE_WORDS[fn]),
                           dtype=torch.int32, device=q.device)
        args.append(wrap.data_ptr())
    with torch.cuda.device(q.device):  # a launch goes to the current device
        err = getattr(lib, fn)(*args, stream)
    _build.check(err, fn)


def sw_align_plain(q: torch.Tensor, r: torch.Tensor, match=1, mismatch=-4,
                   gap_open=-6, gap_ext=-1) -> torch.Tensor:
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
                   gap_open=-3, gap_ext=-1) -> torch.Tensor:
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
        Mf = torch.maximum(Mf, H - i * e)
        best = torch.maximum(best, H.amax(dim=1))
    return best.to(i32)


def sw_align(q: torch.Tensor, r: torch.Tensor, match=1, mismatch=-4,
             gap_open=-6, gap_ext=-1) -> torch.Tensor:
    """K1. q uint8 [B, M], r uint8 [B, N] (code 4 never matches) on one
    device -> int32 [B, 5] on that device."""
    _check_inputs(q, r)
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_ext=gap_ext)
    if q.device.type == "cpu":
        return sw_align_plain(q, r, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"sw_align: unsupported device {q.device}")
    N = r.shape[1]
    out = torch.empty((q.shape[0], 5), dtype=torch.int32, device=q.device)
    launch(_lib(), "lht_sw_align_bands" if N > WIDE_MAX_N else "lht_sw_align",
           q, r, out, *kw.values())
    sw_align.launches += 1
    sw_align.wide_launches += int(N > NARROW_MAX_N)
    sw_align.band_launches += int(N > WIDE_MAX_N)
    sw_align.shapes[(q.shape[0], q.shape[1], N)] += 1
    return out


def sw_score(q: torch.Tensor, r: torch.Tensor, match=1, mismatch=-2,
             gap_open=-3, gap_ext=-1) -> torch.Tensor:
    """K2. q uint8 [B, M], r uint8 [B, N] on one device -> int32 [B]."""
    _check_inputs(q, r)
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_ext=gap_ext)
    if q.device.type == "cpu":
        return sw_score_plain(q, r, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"sw_score: unsupported device {q.device}")
    N = r.shape[1]
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    launch(_lib(), "lht_sw_score_bands" if N > WIDE_MAX_N else "lht_sw_score",
           q, r, out, *kw.values())
    sw_score.launches += 1
    sw_score.wide_launches += int(N > NARROW_MAX_N)
    sw_score.band_launches += int(N > WIDE_MAX_N)
    sw_score.shapes[(q.shape[0], q.shape[1], N)] += 1
    return out


sw_align.launches = sw_align.wide_launches = sw_align.band_launches = 0
sw_score.launches = sw_score.wide_launches = sw_score.band_launches = 0
sw_align.shapes = collections.Counter()
sw_score.shapes = collections.Counter()
