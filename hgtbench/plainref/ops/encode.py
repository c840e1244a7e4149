"""Bit-sliced canonical k-mer hashing on torch tensors.

Port of localhgt_tpu/ops/encode.py::canonical_hashes (the formulation is
described there). Hashes are carried as **int64** holding 32-bit unsigned
values: torch's uint32 has no shifts, `~`, `minimum` or `<` on the CPU, and
int64 keeps the unsigned order that the canonical min and the 0xFFFFFFFF
count sentinel rely on. Every shift left and every `~` is masked back to
32 bits. `hasher_for` is copied from the JAX package.

In this frozen copy `canonical_hashes` runs `canonical_hashes_plain`, the
torch formulation below (the port's kernel K4's plain version), on any
device.
"""

from __future__ import annotations

import numpy as np
import torch

from hgtbench.plainref.ops import coder

U32 = 0xFFFFFFFF


def _shift_left(x: torch.Tensor, m: int) -> torch.Tensor:
    """y[..., j] = x[..., j+m], zero-filled at the tail."""
    if m == 0:
        return x
    return torch.nn.functional.pad(x[..., m:], (0, m))


def packed_windows(bits: torch.Tensor, k: int) -> torch.Tensor:
    """W[j] = sum_{z<k} bits[j+z] << (k-1-z), log-doubling build (int64)."""
    pows = {1: bits}
    m = 1
    while 2 * m <= k:
        w = pows[m]
        pows[2 * m] = (w << m) | _shift_left(w, m)
        m *= 2
    acc = None
    done = 0
    for p in sorted(pows, reverse=True):
        if k & p:
            piece = _shift_left(pows[p], done)
            acc = piece if acc is None else ((acc << p) | piece)
            done += p
    return acc


def bitrev_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse the low k bits of 32-bit values held in int64."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x << 16) & U32) | (x >> 16)
    if k < 32:
        x = x >> (32 - k)
    return x


def canonical_hashes(codes: torch.Tensor, masks, k: int):
    """Canonical (min of strand) k-mer hashes for every window start.

    Args:
        codes: uint8 base codes [..., L] on any device.
        masks: uint32 [coder_num, 3] numpy masks (encode.hasher_for).
        k: k-mer length, 1..32.

    Returns:
        hashes: int64 [coder_num, ..., L] of 32-bit values; at j > L-k
            the window is read with zeros past L (a non-base), so those
            positions hold defined values that no caller uses.
        valid: bool [..., L]; True iff window j is all A/C/G/T and j <= L-k.
    """
    return canonical_hashes_plain(codes, masks, k)


def canonical_hashes_plain(codes: torch.Tensor, masks, k: int):
    """Plain torch version of K4 on any device: the bit-sliced
    formulation of the JAX package, log-doubling windows over the three
    partition streams, bit reversals for the reverse complement."""
    kmask = (1 << k) - 1
    c = codes.to(torch.int64)
    validbit = c < 4
    p0 = ((c == 0) | (c == 3)).to(torch.int64)          # A,T
    p1 = (c < 2).to(torch.int64)                        # A,C
    p2 = (((c & 1) ^ 1) & validbit).to(torch.int64)     # A,G
    w0 = packed_windows(p0, k)
    w1 = packed_windows(p1, k)
    w2 = packed_windows(p2, k)
    # complement stream windows: p0 invariant, p1/p2 flipped
    r0 = bitrev_k(w0, k)
    r1 = bitrev_k((~w1) & kmask, k)
    r2 = bitrev_k((~w2) & kmask, k)
    del p0, p1, p2

    vwin = packed_windows(validbit.to(torch.int64), k)
    L = codes.shape[-1]
    inside = torch.arange(L, device=codes.device) <= (L - k)
    valid = (vwin == kmask) & inside
    del vwin

    outs = []
    for i in range(masks.shape[0]):
        m0, m1, m2 = (int(masks[i, j]) for j in range(3))
        fwd = (w0 & m0) | (w1 & m1) | (w2 & m2)
        rev = (r0 & m0) | (r1 & m1) | (r2 & m2)
        outs.append(torch.minimum(fwd, rev))
    return torch.stack(outs, dim=0), valid


def hasher_for(k: int, coder_num: int, seed: int):
    """Convenience: returns (masks uint32 [coder_num,3], choose_coder)."""
    cc = coder.choose_coder(k, coder_num, seed)
    masks = coder.hash_masks(cc, k).astype(np.uint32)
    return masks, cc
