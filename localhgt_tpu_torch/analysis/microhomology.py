"""Junction microhomology analysis on one device.

Port of localhgt_tpu/analysis/microhomology.py (the method is described
there): every breakpoint's two +-cutoff reference flanks are coded on the
host and aligned in batches on `device` by ops.nw.nw_max_ungapped. The JAX
module imports jax when it loads, so its host helpers (`flank_codes`,
`find_mh`, `average_homology`, `length_freq`) are copied here and held
equal to it by tests/test_torch_analysis.py.
"""

from __future__ import annotations

import numpy as np
import torch

from localhgt_tpu_torch.ops import nw

CUTOFF = 100  # flank half-width (microhomology.py:156)
SHORTEST_LEN = 5  # exact-seed length (microhomology.py:157 `shortest_len`)
TOLE_DIFF = 10  # max offset difference (microhomology.py:158 `tole_diff`)
BATCH = 4096  # flank pairs per device call


def _revcomp(codes: np.ndarray) -> np.ndarray:
    out = codes[::-1].copy()
    m = out < 4
    out[m] = 3 - out[m]
    return out


def flank_codes(contigs, ref_name: str, pos: int, strand: str,
                cutoff: int = CUTOFF) -> np.ndarray | None:
    """+-cutoff flank around `pos` (1-based, shifted -1 as in
    microhomology.py:262), reverse-complemented for '-' strand; None when
    the window is truncated or contains N."""
    try:
        cid = contigs.contig_id(ref_name)
    except KeyError:
        return None
    p = pos - 1
    lo, hi = p - cutoff, p + cutoff
    if lo < 0 or hi > contigs.length_of(cid):
        return None
    seq = contigs.slice_codes(cid, lo, hi)
    if (seq >= 4).any():
        return None
    if strand == "-":
        seq = _revcomp(seq)
    return seq


def homology_lengths(from_codes: np.ndarray, to_codes: np.ndarray, device,
                     batch: int = BATCH) -> np.ndarray:
    """Longest-ungapped-block length for each coded flank pair
    [B, 2*cutoff], aligned on `device` `batch` pairs at a time."""
    outs = []
    for s in range(0, len(from_codes), batch):
        q = torch.from_numpy(np.ascontiguousarray(from_codes[s:s + batch]))
        r = torch.from_numpy(np.ascontiguousarray(to_codes[s:s + batch]))
        _, runs = nw.nw_max_ungapped(q.to(device), r.to(device))
        outs.append(runs.cpu().numpy())
    return np.concatenate(outs) if outs else np.zeros(0, np.int32)


def bkp_homology(bkps, contigs, device, cutoff: int = CUTOFF,
                 batch: int = BATCH) -> np.ndarray:
    """Microhomology length per breakpoint (-1 = not scorable)
    (microhomology.py:241-278 `for_each_bkp`)."""
    pairs, idx = [], []
    for i, b in enumerate(bkps):
        f = flank_codes(contigs, b.from_ref, b.from_bkp, b.from_strand, cutoff)
        t = flank_codes(contigs, b.to_ref, b.to_bkp, b.to_strand, cutoff)
        if f is None or t is None:
            continue
        pairs.append((f, t))
        idx.append(i)
    out = np.full(len(bkps), -1, np.int32)
    if pairs:
        out[idx] = homology_lengths(
            np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]), device, batch=batch)
    return out


def random_homology(contigs, n: int, device, cutoff: int = CUTOFF,
                    seed: int = 0, batch: int = BATCH) -> np.ndarray:
    """Null distribution: homology lengths of `n` random flank pairs drawn
    uniformly from the reference (microhomology.py:299-329 `random_seq`),
    the same draws as the JAX package for the same seed."""
    rng = np.random.default_rng(seed)
    got_f, got_t = [], []
    while len(got_f) < n:
        want = n - len(got_f)
        for side in (got_f, got_t):
            made = 0
            while made < want:
                cid = int(rng.integers(1, contigs.n + 1))
                ln = contigs.length_of(cid)
                if ln < 2 * cutoff + 2:
                    continue
                p = int(rng.integers(cutoff, ln - cutoff))
                seq = contigs.slice_codes(cid, p - cutoff, p + cutoff)
                if (seq >= 4).any():
                    continue
                side.append(seq)
                made += 1
    return homology_lengths(np.stack(got_f[:n]), np.stack(got_t[:n]), device,
                            batch=batch)


def find_mh(seq1: np.ndarray, seq2: np.ndarray,
            shortest_len: int = SHORTEST_LEN,
            tole_diff: int = TOLE_DIFF) -> bool:
    """Exact-seed microhomology near the junction: some `shortest_len`-mer of
    seq1 occurs in seq2 at an offset within `tole_diff`
    (microhomology.py:353-379; the first occurrence of each window in seq2,
    as the reference checks)."""
    L1, L2 = len(seq1), len(seq2)
    if L1 < shortest_len or L2 < shortest_len:
        return False
    w1 = np.lib.stride_tricks.sliding_window_view(seq1, shortest_len)
    w2 = np.lib.stride_tricks.sliding_window_view(seq2, shortest_len)
    eq = (w1[:, None, :] == w2[None, :, :]).all(-1)  # [n1, n2]
    any_hit = eq.any(1)
    first = np.where(any_hit, eq.argmax(1), np.iinfo(np.int64).max)
    i = np.arange(len(w1))
    return bool((any_hit & (np.abs(first - i) <= tole_diff)).any())


def average_homology(lengths) -> float:
    """Mean homology length over scorable junctions
    (microhomology.py:391-396 `cal_ave_homo_len`)."""
    ls = np.asarray([x for x in lengths if x >= 0])
    return float(ls.mean()) if len(ls) else 0.0


def length_freq(lengths) -> dict:
    """length -> frequency dict over scorable junctions."""
    out = {}
    for x in lengths:
        if x < 0:
            continue
        out[int(x)] = out.get(int(x), 0) + 1
    return out


def compare_vs_random(bkps, contigs, device, n_random: int = 10000,
                      cutoff: int = CUTOFF, seed: int = 0) -> dict:
    """HGT-junction vs random-pair microhomology summary
    (microhomology.py:398-417 `microhomology_freq_compare`): frequency
    tables, means, and a Mann-Whitney U test."""
    from scipy.stats import mannwhitneyu

    obs = bkp_homology(bkps, contigs, device, cutoff)
    ran = random_homology(contigs, n_random, device, cutoff, seed)
    obs_ok = obs[obs >= 0]
    res = {
        "hgt_freq": length_freq(obs), "random_freq": length_freq(ran),
        "hgt_mean": average_homology(obs),
        "random_mean": average_homology(ran),
        "n_hgt": int(len(obs_ok)), "n_random": int(len(ran)),
    }
    if len(obs_ok) and len(ran):
        u = mannwhitneyu(obs_ok, ran, alternative="two-sided")
        res["u_stat"], res["p_value"] = float(u.statistic), float(u.pvalue)
    return res
