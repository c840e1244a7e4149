"""The 3-partition k-mer coder family and its seeded per-position permutation.

The hash family (reference src/extract_ref_normal_peak.cpp:1109-1242) encodes a
k-mer as a k-bit integer. Each position z of the k-mer contributes one bit:
the base at that position is mapped through one of three binary partitions of
{A,C,G,T} ("coders"), and which partition is used at position z is drawn from a
seeded PRNG once per reference index ("choose_coder"). The bit is weighted
2^(k-1-z) (generate_base, cpp:1156-1163). The canonical index of a k-mer is
min(forward, reverse-complement) (cpp:447-452).

Partitions (generate_coder, cpp:1109-1154):
    p0: A,T -> 1   C,G -> 0
    p1: A,C -> 1   T,G -> 0
    p2: A,G -> 1   T,C -> 0

Complement behavior (used for the bit-sliced reverse-complement fast path):
    p0(comp(b)) == p0(b);  p1(comp(b)) == 1 - p1(b);  p2(comp(b)) == 1 - p2(b)

This module is pure numpy/python host code; the device-side vectorized hashing
lives in hgtbench.plainref.ops.encode.
"""

from __future__ import annotations

import numpy as np

# Base codes used throughout the framework: A=0, C=1, G=2, T=3, invalid=4.
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4

# partition value per base code (index [partition][base_code]); invalid -> 0
# (invalid positions are masked separately via the validity bitmask).
PARTITIONS = np.array(
    [
        [1, 0, 0, 1, 0],  # p0: A,T -> 1
        [1, 1, 0, 0, 0],  # p1: A,C -> 1
        [1, 0, 1, 0, 0],  # p2: A,G -> 1
    ],
    dtype=np.uint8,
)

# complement of a base code (A<->T, C<->G); invalid stays invalid.
COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)

# The 6 permutations of (0,1,2) in the order the reference's `permu` table
# lists them (random_coder, cpp:1184).
_PERMU = np.array(
    [[0, 1, 2], [0, 2, 1], [1, 2, 0], [1, 0, 2], [2, 0, 1], [2, 1, 0]],
    dtype=np.int8,
)

_ASCII_TO_CODE = np.full(256, BASE_N, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _ASCII_TO_CODE[ord(_ch)] = _code
    _ASCII_TO_CODE[ord(_ch.lower())] = _code


def seq_to_codes(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (A=0,C=1,G=2,T=3, other=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    return _ASCII_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> str:
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    return lut[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[np.asarray(codes, dtype=np.uint8)][::-1]


class GlibcRand:
    """Bit-exact reimplementation of glibc's rand() (TYPE_3 additive generator).

    The reference seeds libc with `srand(seed)` and draws the coder permutation
    with `rand() % 6` (random_coder, cpp:1182-1222) and the down-sampling array
    with `(rand() % 100000)/1000.0` (get_random, cpp:1332-1340). Reproducing
    the glibc stream lets a fresh run of this framework pick the identical
    coder permutation for a given --seed, so hash values are comparable with a
    reference-binary run. The algorithm is public (glibc stdlib/random_r.c):
    degree-31, separation-3 additive feedback over a LCG-seeded state.
    """

    def __init__(self, seed: int):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = np.zeros(344, dtype=np.int64)
        r[0] = seed if seed < (1 << 31) else seed - (1 << 32)
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2147483647 via Schrage, C trunc division
            w = int(r[i - 1])
            hi = abs(w) // 127773 * (1 if w >= 0 else -1)
            lo = w - 127773 * hi
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._state = [int(x) & 0xFFFFFFFF for x in r[:34]]
        self._i = 34
        for _ in range(34, 344):
            self._next_word()

    def _next_word(self) -> int:
        s = self._state
        word = (s[-31] + s[-3]) & 0xFFFFFFFF
        s.append(word)
        if len(s) > 64:
            del s[:-34]
        return word

    def rand(self) -> int:
        return self._next_word() >> 1


def choose_coder(k: int, coder_num: int, seed: int) -> np.ndarray:
    """Seeded per-position partition selection, shape (k, coder_num) int8.

    Mirrors random_coder (cpp:1182-1222): for each k-mer position, draw enough
    random permutations of (0,1,2) to cover `coder_num` hash functions, then
    take the first `coder_num` entries of their concatenation. With the
    default coder_num=3 each position's three hash functions use the three
    distinct partitions in a seeded random order.
    """
    rng = GlibcRand(seed)
    out = np.zeros((k, coder_num), dtype=np.int8)
    t = coder_num // 3 + 1
    for z in range(k):
        pool = np.concatenate([_PERMU[rng.rand() % 6] for _ in range(t)])
        out[z] = pool[:coder_num]
    return out


def hash_masks(cc: np.ndarray, k: int) -> np.ndarray:
    """Per-hash bit-selection masks for the bit-sliced hasher.

    For hash function i, mask[i, p] has bit (k-1-z) set iff position z of the
    k-mer uses partition p. Given the three packed partition windows W_p[j]
    (bit (k-1-z) of W_p[j] = partition-p value of base j+z), the forward hash is
        fwd_i[j] = (W_0 & mask[i,0]) | (W_1 & mask[i,1]) | (W_2 & mask[i,2])
    which reproduces sum_z partition_{cc[z,i]}(b[j+z]) * 2^(k-1-z)
    (read_fastq inner loop, cpp:1052-1086) in O(1) vector ops per position.
    """
    coder_num = cc.shape[1]
    masks = np.zeros((coder_num, 3), dtype=np.uint64)
    for i in range(coder_num):
        for z in range(k):
            masks[i, cc[z, i]] |= np.uint64(1) << np.uint64(k - 1 - z)
    return masks


def reference_kmer_hashes(
    codes: np.ndarray, cc: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Slow direct-port semantics of the reference hash, for tests only.

    Computes, for every k-mer start j, the canonical index for each hash
    function plus a validity flag, with the same arithmetic as the reference's
    scalar loop (cpp:1052-1086). Returns (hashes[n-k+1, coder_num] uint64,
    valid[n-k+1] bool).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    coder_num = cc.shape[1]
    nk = n - k + 1
    if nk <= 0:
        return (np.zeros((0, coder_num), np.uint64), np.zeros(0, bool))
    hashes = np.zeros((nk, coder_num), dtype=np.uint64)
    valid = np.zeros(nk, dtype=bool)
    comp = COMPLEMENT[codes]
    for j in range(nk):
        window = codes[j : j + k]
        ok = bool(np.all(window != BASE_N))
        valid[j] = ok
        if not ok:
            continue
        cwin = comp[j : j + k]
        for i in range(coder_num):
            fwd = 0
            rev = 0
            for z in range(k):
                fwd += int(PARTITIONS[cc[z, i], window[z]]) << (k - 1 - z)
                rev += int(PARTITIONS[cc[k - 1 - z, i], cwin[z]]) << z
            hashes[j, i] = min(fwd, rev)
    return hashes, valid
