"""Reference divergence scan on torch tensors.

Port of localhgt_tpu/ops/scan.py::scan_hits, reproduced bug for bug (the
stencil and its telescoped left sum are documented there). The host
helpers (`good_intervals`, `peaks_in_intervals`, `final_intervals`,
`truncated_min`) are copied from the JAX package line for line, but for
`good_intervals`' merge loop, which is `merge_good_runs`.

`finalize_contig` gives what `good_intervals` and `peaks_in_intervals`
give, from a contig's masks where they are (on the card in stage B), as a
member code: a byte a contig position, whose bits say which positions are
peak members (MEMBER), which member starts its peak (START) and which
members the map build takes (TAKEN: a k-mer starts there). Only the good
runs' edges and the peak positions reach the host, and the merge loop
runs there on the edges; `members_of` expands a code on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from localhgt_tpu_torch.config import ScanConfig

# bits of a member code byte (finalize_contig)
MEMBER = 1  # a peak position inside a good interval
START = 2   # the first member of its merge bin: a peak's position
TAKEN = 4   # a member with a k-mer (position <= len - k): the map takes it


def truncated_min(window: int, ratio: float) -> int:
    """int(window * float32(ratio)) — the C++ float truncation (cpp:559-560)."""
    return int(np.float32(window) * np.float32(ratio))


def scan_hits(hc: torch.Tensor, k: int, cfg: ScanConfig,
              least_depth: int = 3, true_len=None):
    """Good-window and peak masks.

    hc: int [..., coder_num, L] per-position table counts; true_len: None,
    an int, or an int tensor [...] bounding the peak conditions per row.
    Returns good, peak: bool [..., L]."""
    L = hc.shape[-1]
    w = cfg.peak_w
    window = cfg.window
    dev = hc.device
    hit = hc == least_depth
    single = hit.any(dim=-2)
    trio = hit.all(dim=-2)

    s1 = torch.cumsum(single, dim=-1, dtype=torch.int32)
    s3 = torch.cumsum(trio, dim=-1, dtype=torch.int32)
    pad = window + 2 * k + 4 * w + 8  # covers every negative S offset used
    s1p = torch.nn.functional.pad(s1, (pad, 0))
    s3p = torch.nn.functional.pad(s3, (pad, 0))

    def shifted(sp, off):
        return sp[..., pad + off : pad + off + L]

    one_cnt = s1 - shifted(s1p, -window)
    three_cnt = s3 - shifted(s3p, -window)
    good = ((one_cnt >= truncated_min(window, cfg.hit_ratio))
            & (three_cnt >= truncated_min(window, cfg.match_ratio)))

    j = torch.arange(L, device=dev)
    in_range = j > (2 * k + 2 * w)  # strict, cpp:644
    if true_len is not None:
        tl = torch.as_tensor(true_len, device=dev)
        if tl.dim():
            tl = tl[..., None]
        in_range = in_range & (j < tl)
    right = s1 - shifted(s1p, -w)
    base_left = (shifted(s1p, -w) - shifted(s1p, -2 * w)
                 - shifted(s1p, -k - w) + shifted(s1p, -k - 2 * w))
    peak = torch.zeros(good.shape, dtype=torch.bool, device=dev)
    for m in range(k, 2 * k, cfg.skip_a):
        diff = (base_left + shifted(s1p, -m - w) - shifted(s1p, -m - 2 * w)
                - right)
        neg = in_range & (diff <= -cfg.peak_diff)      # marks position j
        pos = in_range & (diff >= cfg.peak_diff)       # marks position j-m-w
        sh = m + w
        peak |= neg | torch.nn.functional.pad(pos[..., sh:], (0, sh))
    return good, peak


def good_intervals(good: np.ndarray, window: int, pad: int | None = None):
    """Reproduce the conti_flag state machine (cpp:617-686) on a host mask.

    Returns list of (start, end) 0/1-clamped intervals (C++ convention:
    start = rise - 2*window clamped to >= 1, end = fall + 2*window clamped to
    <= L; a run still open at the end closes with end = L; a new interval
    whose start is < window past the previous end merely extends it).
    """
    good = np.asarray(good, dtype=bool)
    pad = 2 * window if pad is None else pad
    g = good.astype(np.int8)
    rising = np.flatnonzero(np.diff(np.concatenate([[0], g])) == 1)
    falling = np.flatnonzero(np.diff(np.concatenate([g, [0]])) == -1)
    return merge_good_runs(rising, falling, len(good), window, pad)


def merge_good_runs(rising, falling, L: int, window: int, pad: int):
    """The merge loop of `good_intervals` over a mask's runs: `rising[i]`
    and `falling[i]` are the first and last position of run i, in order,
    of a contig of length L. Returns the same (start, end) list.

    For window >= 0 and pad >= 0 the intervals are disjoint, ascending
    and never reversed: a new one starts at least `window` past the
    previous end."""
    out: list[list[int]] = []
    for r, f in zip(rising, falling):
        start = max(r - pad, 1)
        if f == L - 1:  # run touches contig end
            end = L
        else:
            end = min(f + 1 + pad, L)
        if out and start - out[-1][1] < window:
            out[-1][1] = end
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def peaks_in_intervals(peak: np.ndarray, intervals, merge_bin: int):
    """Peak positions inside good intervals, dedup-merged by 50-bp bin.

    Mirrors the add_peak/merge_peak bookkeeping (cpp:239-301): scanning
    positions in order, a peak falling in the same `merge_bin` bin as the
    previously added peak merges into it (keeping the first position); the
    merged positions still contribute their k-mers to that peak id.

    Fully vectorized (a UHGG-scale sample emits millions of peaks, so no
    per-peak Python). Merging compares `p // merge_bin` against the current
    representative's bin; since every member of a group shares the
    representative's bin, group boundaries are exactly where consecutive
    member bins differ — including across interval boundaries, as in the
    C++ (merge_peak does not reset between good windows).

    Returns (positions, members, group_ids):
        positions int32 [P]: representative (first) position of each peak
            (contig-relative; callers widen to int64 global coords);
        members   int32 [M]: all member positions, ascending (contig-
            relative; a contig is < 2^31 bp, and int32 halves the
            dominant host allocation at reference scale — scale1g held
            ~500M members);
        group_ids int32 [M]: 0-based peak index of each member.
    """
    peak = np.asarray(peak, dtype=bool)
    # int32 positions as in the JAX package (a contig of 2^31 bp or more
    # would wrap): kept as it is, the outputs must stay equal
    mems = [np.flatnonzero(peak[a:b]).astype(np.int32) + np.int32(a)
            for a, b in intervals]
    mem = (np.concatenate(mems) if mems else np.zeros(0, np.int32))
    if len(mem) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    bins = mem // merge_bin
    first = np.ones(len(mem), bool)
    first[1:] = bins[1:] != bins[:-1]
    gid = np.cumsum(first, dtype=np.int32) - np.int32(1)
    return mem[first], mem, gid


def final_intervals(contig_peaks, ref_near: int, ref_gap: int, contig_lens=None):
    """count_filtered_peak (cpp:515-548): kept peaks -> merged +-ref_near
    intervals per contig. `contig_peaks` is an iterable of (ref_index, pos)
    sorted by (ref_index, pos)."""
    out: list[tuple[int, int, int]] = []
    for ref_index, pos in contig_peaks:
        start = pos - ref_near
        end = pos + ref_near
        if out and out[-1][0] == ref_index and start - out[-1][2] < ref_gap:
            out[-1] = (ref_index, out[-1][1], end)
        else:
            out.append((ref_index, max(start, 1), end))
    if contig_lens is not None:
        out = [
            (r, s, min(e, contig_lens[r])) for r, s, e in out
        ]
    return out


def good_edges(good: torch.Tensor) -> torch.Tensor:
    """int32 [2 n] of a bool [L] mask with n runs: the first position of
    each run and one past its last, in order."""
    z = good.new_zeros(1)
    g = torch.cat([z, good, z])
    return torch.nonzero(g[1:] != g[:-1]).flatten().to(torch.int32)


def member_code(peak: torch.Tensor, intervals, merge_bin: int,
                k: int) -> torch.Tensor:
    """`peaks_in_intervals` where the mask is, as a uint8 [L] member code
    on peak's device (MEMBER, START, TAKEN bits). `intervals` must be
    disjoint, ascending and never reversed (merge_good_runs' output):
    membership is the prefix sum of +1 at each start and -1 at each end,
    which counts every position once. A member starts its peak when no
    member lies before it in its merge bin, where the previous member's
    bin would differ in `peaks_in_intervals`."""
    L = peak.numel()
    dev = peak.device
    code = torch.zeros(L, dtype=torch.uint8, device=dev)
    if not intervals:
        return code
    iv = torch.tensor(intervals, dtype=torch.int64).to(dev)
    marks = torch.zeros(L + 1, dtype=torch.int32, device=dev)
    one = torch.ones(len(intervals), dtype=torch.int32, device=dev)
    marks.index_add_(0, iv[:, 0], one)
    marks.index_add_(0, iv[:, 1], -one)
    member = peak & (torch.cumsum(marks[:L], 0, dtype=torch.int32) > 0)
    # members before each position; bins are contig-relative, so the rows
    # of a [-1, merge_bin] view are the bins and column 0 their starts
    before = torch.cumsum(member, 0, dtype=torch.int32) - member.int()
    rows = torch.nn.functional.pad(before, (0, -L % merge_bin))
    rows = rows.view(-1, merge_bin)
    start = member & (rows == rows[:, :1]).view(-1)[:L]
    code |= member.to(torch.uint8) * MEMBER
    code |= start.to(torch.uint8) * START
    code[: max(L - k + 1, 0)] |= member[: max(L - k + 1, 0)].to(
        torch.uint8) * TAKEN
    return code


def finalize_contig(good: torch.Tensor, peak: torch.Tensor, window: int,
                    pad: int, merge_bin: int, k: int, out: torch.Tensor,
                    fetch) -> np.ndarray:
    """`peaks_in_intervals(peak, good_intervals(good, window, pad),
    merge_bin)` of one contig's bool [L] masks, computed where the masks
    are: the member code goes to `out` (uint8 [L] on the same device,
    see `member_code`), and the peak positions, int32 [P] ascending, come
    back. `fetch(*tensors)` hands int32 tensors to the host as numpy
    arrays (utils/device.HostStaging): the runs' edges, then the
    positions."""
    L = good.numel()
    (edges,) = fetch(good_edges(good))
    edges = edges.astype(np.int64)
    ivs = merge_good_runs(edges[0::2], edges[1::2] - 1, L, window, pad)
    code = member_code(peak, ivs, merge_bin, k)
    out.copy_(code)
    (pos,) = fetch(torch.nonzero(code & START).flatten().to(torch.int32))
    return pos


def members_of(code: np.ndarray):
    """Host expansion of a contig's member code: (positions, members,
    group_ids) equal in dtype and value to what `peaks_in_intervals`
    gives for the masks the code came from."""
    code = np.asarray(code, np.uint8)
    mem = np.flatnonzero(code & MEMBER).astype(np.int32)
    if len(mem) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    first = (code[mem] & START) != 0
    gid = np.cumsum(first, dtype=np.int32) - np.int32(1)
    return mem[first], mem, gid
