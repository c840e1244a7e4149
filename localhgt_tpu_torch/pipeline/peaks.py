"""Candidate peaks, the two hash -> peak-id maps, and the split-read vote.

Port of the direct-map and RankMap paths of localhgt_tpu/pipeline/peaks.py
(the machinery is described there). On one device the map is an int32
[2^k] tensor for every k; at k=32 that is 16 GiB, which an 80 GB card
holds. It is built from stage B's member code, a byte a reference
position that stays on the device (PeakMembers). The multi-device
extraction (parallel/extract_sharded.py) uses the RankMap instead, from
member arrays flattened on the host (`_flatten_members`): a presence
bitmap with prefix popcounts plus the peak ids in hash order, small
enough for a copy on every device. Both maps
store the max peak id per hash, so lookups give the same ids.
`rankmap_from_jax` / `rankmap_to_jax` carry the RankMap's two arrays to
and from the JAX package, whose layout they share element for element.
The sequential greedy register scan of the vote runs in kernel K3
(ops.cuda_vote).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from localhgt_tpu_torch.ops import count as count_mod
from localhgt_tpu_torch.ops import cuda_vote, encode
from localhgt_tpu_torch.ops import scan as scan_mod
from localhgt_tpu_torch.utils import metrics

MAP_BUILD_CHUNK = 1 << 22  # reference positions hashed per map-build step
PAIR_CACHE_LIMIT = 2 << 30  # bytes of (hash, pid) stream kept between passes
POPCOUNT_CHUNK = 1 << 24    # bit-words per popcount step of the build


@dataclass
class RankMap:
    """Succinct hash -> peak-id map (localhgt_tpu/pipeline/peaks.py
    ::RankMap, same arrays):

      wp:   int32 [2 * 2^(k-5)] interleaved (bit-word, exclusive-prefix
            popcount) pairs. Word i covers hashes [32i, 32i+32): bit
            (h & 31) of wp[2i] is set iff hash h is stored (bit 31 is the
            int32 sign); wp[2i+1] counts the stored hashes < 32i.
      pids: int32 [>= Ku] peak id of each stored hash in ascending hash
            order, zero-padded to `_pids_cap(Ku)`.

    Duplicate (hash, pid) pairs of the build stream resolve to the MAX
    pid, as the direct map's scatter-max does."""

    wp: torch.Tensor
    pids: torch.Tensor
    k: int = 0


@dataclass
class PeakSet:
    """Peak ids are 1-based; index 0 of every array is a sentinel."""

    contig: np.ndarray           # int32 [P+1] contig id of each peak
    pos: np.ndarray              # int64 [P+1] representative position
    # exactly one of the two maps is set (rmap may be None with it when no
    # k-mer was stored)
    direct_map: torch.Tensor | None = None  # int32 [2^k] hash -> peak id
    rmap: RankMap | None = None             # the multi-device path's map

    @property
    def n(self) -> int:
        return len(self.contig) - 1


@dataclass
class PeakMembers:
    """Stage B's peaks as the one-device map build reads them: `code`,
    uint8 [len(contigs.codes)] on the device, the member code of every
    reference position (ops/scan.py: MEMBER, START, TAKEN bits; zero in a
    contig never finalized); `peaks`, the (contig id, int32 contig-relative
    peak positions) of each finalized contig, in order, on the host."""

    code: torch.Tensor
    peaks: list

    @property
    def n(self) -> int:
        return sum(len(p) for _, p in self.peaks)

    def per_contig(self, contigs) -> list:
        """(cid, positions, members, group_ids) of each finalized contig as
        `scan.peaks_in_intervals` gives them, expanded on the host."""
        out = []
        for cid, _ in self.peaks:
            off = int(contigs.offsets[cid - 1])
            code = self.code[off : off + contigs.length_of(cid)]
            out.append((cid, *scan_mod.members_of(code.cpu().numpy())))
        return out


def _flatten_members(per_contig, contigs, k):
    """Host, for the multi-device map build: peak table (contig, pos) +
    flat member positions in global coordinates of the concatenated code
    array, with their peak ids. Consumes `per_contig` (the per-contig arrays are freed as they are
    copied). Same stream as the reference's _flatten_members."""
    pcontig = [np.zeros(1, np.int32)]
    ppos = [np.zeros(1, np.int64)]
    gpos_all, pid_all = [], []
    pid_base = 0
    for i in range(len(per_contig)):
        cid, pos, mem, gid = per_contig[i]
        per_contig[i] = None
        ln = contigs.length_of(cid)
        off = np.int64(contigs.offsets[cid - 1])
        pcontig.append(np.full(len(pos), cid, np.int32))
        ppos.append(np.asarray(pos, np.int64))
        # k-mers only exist for positions <= len-k (add_peak, cpp:247,262)
        sel = mem <= ln - k
        gpos_all.append(mem[sel].astype(np.int64) + off)
        pid_all.append(gid[sel].astype(np.int32) + np.int32(pid_base + 1))
        pid_base += len(pos)
    per_contig.clear()
    gpos = np.concatenate(gpos_all) if gpos_all else np.zeros(0, np.int64)
    pids = np.concatenate(pid_all) if pid_all else np.zeros(0, np.int32)
    return np.concatenate(pcontig), np.concatenate(ppos), gpos, pids


def _member_keys(h, v, tables, gpos, pids):
    """The (hash, peak id) pairs one hashed reference chunk (h [C, Lc], v
    [Lc]) adds to the map, coder-major: members whose window is valid and
    whose count in table i is > 0 (build_kmer_table cpp:246-270). Hash 0
    and the all-ones hash, the count sentinel, are dropped, as the JAX
    package's member stream drops them (peaks.py::_member_batch)."""
    hm = h[:, gpos]                                   # [C, n]
    ok = v[gpos][None, :] & (hm != 0) & (hm != count_mod.SENTINEL)
    for i, t in enumerate(tables):
        ok[i] &= count_mod.table_lookup(t, hm[i]) > 0
    return hm[ok], pids[None, :].expand_as(hm)[ok]


def _build_map_chunk(direct_map, tables, codes_chunk, code, pid0: int,
                     masks, k: int) -> torch.Tensor:
    """Hash one reference chunk (codes_chunk uint8 [n]) and scatter-MAX its
    members' peak ids into `direct_map` in place (== the reference's
    last-writer overwrite; max composes across chunks). `code` is the
    chunk's member code, uint8 [n], and `pid0` the number of peaks that
    start before the chunk: a member's peak id counts the peak starts at
    or before it. Every position scatters at its own hash: its peak id
    where the map takes it, past `_member_keys`' filters, and 0 elsewhere,
    a no-op on a map of ids >= 0; so nothing waits on the device. Returns
    the number of members the map takes, on the device."""
    h, v = encode.canonical_hashes(codes_chunk[None, :], masks, k)
    pid = torch.cumsum((code & scan_mod.START) != 0, 0,
                       dtype=torch.int32) + pid0
    taken = (code & scan_mod.TAKEN) != 0
    for i, t in enumerate(tables):  # a coder at a time: [n] temporaries
        hi = h[i, 0]
        ok = (taken & v[0] & (hi != 0) & (hi != count_mod.SENTINEL)
              & (count_mod.table_lookup(t, hi) > 0))
        direct_map.scatter_reduce_(0, hi, torch.where(ok, pid, 0),
                                   reduce="amax")
    return taken.sum()


def build_direct_map(members: PeakMembers, contigs, tables, masks, k: int,
                     merge_bin: int, device) -> PeakSet:
    """Device build of the hash -> peak-id map from stage B's member code,
    which never leaves the device; the loop over chunks waits on nothing.
    A reference chunk is skipped when no peak lies in it or less than
    `merge_bin` bp before it (a peak's members share its merge bin).
    Counter `peakset_members`: the members the map takes, read once at
    the end."""
    CH = MAP_BUILD_CHUNK
    with metrics.span("peakset.flatten"):
        pcontig, ppos, before = _peak_table(members.peaks, contigs)
        chunks = [(base, before(base))
                  for base in range(0, len(contigs.codes), CH)
                  if before(base - merge_bin + 1) < before(base + CH)]
    direct_map = torch.zeros(1 << k, dtype=torch.int32, device=device)
    taken = torch.zeros((), dtype=torch.int64, device=device)
    pinned = torch.device(device).type == "cuda"
    with metrics.span("peakset.build"):
        for base, pid0 in chunks:
            n = min(CH, len(contigs.codes) - base)
            # pinned, so the upload waits on nothing (the host allocator
            # reuses a block only once its copy is done)
            codes = torch.full((n + k,), 4, dtype=torch.uint8,
                               pin_memory=pinned)
            avail = contigs.codes[base : base + n + k]
            codes.numpy()[: len(avail)] = avail
            code = torch.zeros(n + k, dtype=torch.uint8, device=device)
            code[:n] = members.code[base : base + n]
            taken += _build_map_chunk(
                direct_map, tables, codes.to(device, non_blocking=True),
                code, pid0, masks, k)
    metrics.add("peakset_members", int(taken))
    return PeakSet(contig=pcontig, pos=ppos, direct_map=direct_map)


def _peak_table(peaks, contigs):
    """(contig int32 [P+1], pos int64 [P+1], before) of stage B's
    per-contig peaks, 1-based with a sentinel at 0; `before(x)` counts the
    peaks whose global position (in `contigs.codes`) is below x."""
    counts = np.array([len(p) for _, p in peaks], np.int64)
    cum = np.concatenate([[0], np.cumsum(counts)])
    pcontig = np.zeros(int(cum[-1]) + 1, np.int32)
    ppos = np.zeros(len(pcontig), np.int64)
    for (cid, pos), a, b in zip(peaks, cum[:-1], cum[1:]):
        pcontig[a + 1 : b + 1] = cid
        ppos[a + 1 : b + 1] = pos
    offs = np.array([contigs.offsets[cid - 1] for cid, _ in peaks], np.int64)

    def before(x: int) -> int:
        i = int(np.searchsorted(offs, x, side="right")) - 1
        if i < 0:
            return 0
        return int(cum[i] + np.searchsorted(peaks[i][1], x - offs[i]))

    return pcontig, ppos, before


# --------------------------------------------------------------------------
# RankMap build and lookup
# --------------------------------------------------------------------------


def _popcount(w: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit values held in int64 (torch has no
    population count; exact: byte sums <= 32 < 256)."""
    x = w - ((w >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & encode.U32) >> 24


def _pids_cap(n: int) -> int:
    return max(128, -(-n // 128) * 128)


def _bit32(bit: torch.Tensor) -> torch.Tensor:
    """1 << bit as an int32 (bit 31 is the sign: -2^31)."""
    val = 1 << bit
    return torch.where(val >= 1 << 31, val - (1 << 32), val).to(torch.int32)


def _word_add(w: torch.Tensor, keys: torch.Tensor) -> None:
    """OR the keys' presence bits into the int32 bit-words `w` in place.
    torch has no scatter-OR; a scatter-ADD is an exact OR when every added
    bit is distinct and not yet set: the batch's keys are made unique (key
    <-> (word, bit) is a bijection) and bits that an earlier batch set are
    filtered against the current words. Distinct bits of one word add
    without a carry."""
    kk = torch.unique(keys)
    wi = kk >> 5
    bit = kk & 31
    absent = ((w[wi].long() >> bit) & 1) == 0
    w.index_add_(0, wi[absent], _bit32(bit[absent]))


def _words_to_wp(w: torch.Tensor):
    """Bit-words int32 [W] -> (wp int32 [2W], stored k-mers). The prefix
    is summed in int64 and refused at 2^31, where the int32 interleave
    would wrap."""
    W = w.shape[0]
    pc = torch.empty(W, dtype=torch.int64, device=w.device)
    for lo in range(0, W, POPCOUNT_CHUNK):
        part = w[lo : lo + POPCOUNT_CHUNK].long() & encode.U32
        pc[lo : lo + POPCOUNT_CHUNK] = _popcount(part)
    pref = torch.cumsum(pc, 0)
    ku = int(pref[-1])
    if ku >= 1 << 31:
        raise ValueError("rank map exceeds 2^31 stored k-mers; raise "
                         "--max_peak filtering or use k <= 30")
    pref -= pc
    wp = torch.empty(2 * W, dtype=torch.int32, device=w.device)
    wp[0::2] = w
    wp[1::2] = pref.to(torch.int32)
    return wp, ku


def _rank(wp: torch.Tensor, h: torch.Tensor):
    """(present bool, rank int64) of int64 hashes h in the bitmap: the
    word and its prefix are neighbours, so one gather of a pair reads
    both."""
    pair = wp.view(-1, 2)[h >> 5].long()
    word = pair[..., 0] & encode.U32
    bit = h & 31
    present = ((word >> bit) & 1) != 0
    below = _popcount(word & ((1 << bit) - 1))
    return present, pair[..., 1] + below


def rank_lookup(wp: torch.Tensor, pids: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    """Peak id int32 per int64 hash (0 where absent); see RankMap. A miss
    gathers row 0 of `pids` and is masked to 0 afterwards."""
    present, rank = _rank(wp, h)
    rank = torch.where(present, rank, 0).clamp_(max=pids.shape[0] - 1)
    return torch.where(present, pids[rank], 0)


def build_rankmap(pair_batches, k: int, device,
                  cache_limit: int = PAIR_CACHE_LIMIT) -> RankMap | None:
    """RankMap on `device` from a (hash, pid) pair stream; None when the
    stream stores nothing.

    pair_batches: zero-argument callable returning an iterator of (keys
    int64 [T], pids int32 [T]) tensors on `device`; keys need not be
    unique and never hold 0 or 0xFFFFFFFF (`_member_keys` drops both).
    The stream is read twice: pass 1 sets the presence bits, one
    popcount and cumulative sum turn the words into (word, prefix) pairs,
    pass 2 scatter-maxes each pid at its key's rank. The batches are kept
    between the passes while they fit `cache_limit` bytes; a longer
    stream is asked for again."""
    cached: list | None = []
    cache_bytes = 0
    w = torch.zeros(1 << max(k - 5, 0), dtype=torch.int32, device=device)
    for keys, vals in pair_batches():
        _word_add(w, keys)
        if cached is not None:
            cached.append((keys, vals))
            cache_bytes += keys.numel() * 12
            if cache_bytes > cache_limit:
                cached = None
    wp, ku = _words_to_wp(w)
    del w
    if ku == 0:
        return None
    pids = torch.zeros(_pids_cap(ku), dtype=torch.int32, device=device)
    for keys, vals in (cached if cached is not None else pair_batches()):
        pids.scatter_reduce_(0, _rank(wp, keys)[1], vals, reduce="amax")
    return RankMap(wp=wp, pids=pids, k=k)


def rankmap_from_jax(wp, pids, k: int, device) -> RankMap:
    """The JAX package's RankMap arrays (host int32 arrays, e.g. of
    `build_rankmap_host`) as a RankMap on `device`; the layouts are equal."""
    wp = np.ascontiguousarray(wp)
    pids = np.ascontiguousarray(pids)
    if wp.dtype != np.int32 or pids.dtype != np.int32:
        raise ValueError(f"rank map: want int32 arrays, got {wp.dtype} and "
                         f"{pids.dtype}")
    if wp.shape != (2 << max(k - 5, 0),):
        raise ValueError(f"rank map: k={k} needs {2 << max(k - 5, 0)} "
                         f"interleaved words, got {wp.shape}")
    return RankMap(wp=torch.from_numpy(wp).to(device),
                   pids=torch.from_numpy(pids).to(device), k=k)


def rankmap_to_jax(rmap: RankMap):
    """(wp, pids) int32 numpy arrays in the JAX package's layout."""
    return rmap.wp.cpu().numpy(), rmap.pids.cpu().numpy()


def _candidates(codes, lengths, masks, lookup, k: int, kw: int):
    """Peak-id candidates int32 [C, B, kw] of one mate batch: hash, crop
    the start axis to kw (0 = no crop), and look the hashes up (`lookup`:
    int64 hashes -> int32 peak ids). Hash 0 is excluded, as on every
    lookup path of the reference."""
    h, v = encode.canonical_hashes(codes, masks, k)    # [C, B, L]
    L = codes.shape[-1]
    if kw and kw < L:
        h = h[:, :, :kw]
        v = v[:, :kw]
        L = kw
    inwin = (torch.arange(L, device=codes.device)[None, :]
             <= (lengths[:, None].long() - k))
    ok = (v & inwin)[None] & (h != 0)
    return torch.where(ok, lookup(h), 0)


def vote_candidates(codes, lengths, masks, direct_map, k: int, kw: int):
    """`_candidates` through the direct map."""
    return _candidates(codes, lengths, masks, direct_map.__getitem__, k, kw)


def rank_vote_candidates(codes, lengths, masks, rmap: RankMap, k: int,
                         kw: int = 0):
    """`_candidates` through a RankMap on the codes' device."""
    return _candidates(codes, lengths, masks,
                       lambda h: rank_lookup(rmap.wp, rmap.pids, h), k, kw)


def vote_core(peak_filter, pk1, pk2, peak_contig, accept,
              min_base_num: int, n_slots: int) -> None:
    pk = torch.cat([pk1, pk2], dim=2)                  # [C, B, P]
    genome = peak_contig[pk.long()]                     # 0 where no peak
    slots_g, slots_c, slots_p, hits = cuda_vote.vote_state(
        genome, pk, n_slots=n_slots)
    vote_tail(peak_filter, slots_g, slots_c, slots_p, hits, accept,
              min_base_num)


def vote_tail(peak_filter, slots_g, slots_c, slots_p, hits, accept,
              min_base_num: int) -> None:
    """check_split's top-2-genome gate + the peak_filter bump
    (cpp:161-202,498-505), from the final register state [B, G]. Updates
    `peak_filter` in place; rows that do not vote add to index 0, the
    sentinel, as in the reference."""
    qual = (slots_c >= min_base_num) & (slots_g != 0)
    nq = qual.sum(dim=1)
    gate = accept & (hits >= min_base_num) & (nq >= 2)
    counts = torch.where(qual, slots_c, 0)
    largest = counts.amax(dim=1, keepdim=True)
    n_largest = (counts == largest).sum(dim=1)
    second_cand = torch.where(counts == largest, 0, counts).amax(dim=1)
    second = torch.where(n_largest > 1, largest[:, 0], second_cand)
    vote = (qual & ((counts == largest) | (counts == second[:, None]))
            & gate[:, None])
    ids = torch.where(vote, slots_p, 0).reshape(-1).long()
    peak_filter.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))


def split_vote_batch(peak_filter, codes1, len1, codes2, len2, accept, masks,
                     direct_map, peak_contig, k: int, min_base_num: int = 6,
                     n_slots: int = 8, kw: int = 0) -> None:
    """One step of the split-read vote (slide_reads, cpp:313-506) on one
    pair batch; adds this batch's votes to `peak_filter` in place.

    codes1/codes2 uint8 [B, L], len1/len2 int32 [B], accept bool [B],
    peak_contig int32 [P+1]; all on the map's device."""
    pk1 = vote_candidates(codes1, len1, masks, direct_map, k, kw)
    pk2 = vote_candidates(codes2, len2, masks, direct_map, k, kw)
    vote_core(peak_filter, pk1, pk2, peak_contig, accept, min_base_num,
              n_slots)
