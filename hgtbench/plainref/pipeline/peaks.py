"""Candidate peaks, the hash -> peak-id direct map, and the split-read
vote: the port's pipeline/peaks.py on one device, frozen, with the plain
version of K3 (ops/vote_plain.py) and without the multi-device RankMap.
On one device the map is an int32 [2^k] tensor; at k=32, 16 GiB.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hgtbench.plainref.ops import count as count_mod
from hgtbench.plainref.ops import encode, vote_plain

MAP_BUILD_CHUNK = 1 << 22  # reference positions hashed per map-build step


@dataclass
class PeakSet:
    """Peak ids are 1-based; index 0 of every array is a sentinel."""

    contig: np.ndarray           # int32 [P+1] contig id of each peak
    pos: np.ndarray              # int64 [P+1] representative position
    direct_map: torch.Tensor | None = None  # int32 [2^k] hash -> peak id

    @property
    def n(self) -> int:
        return len(self.contig) - 1


def _flatten_members(per_contig, contigs, k):
    """Host: peak table (contig, pos) + flat member positions in global
    coordinates of the concatenated code array, with their peak ids.
    Consumes `per_contig` (the per-contig arrays are freed as they are
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


def _build_map_chunk(direct_map, tables, codes_chunk, gpos, pids, masks,
                     k: int) -> None:
    """Hash one reference chunk and scatter-MAX its members' peak ids into
    `direct_map` in place (== the reference's last-writer overwrite; max
    composes across chunks)."""
    h, v = encode.canonical_hashes(codes_chunk[None, :], masks, k)
    keys, vals = _member_keys(h[:, 0, :], v[0, :], tables, gpos, pids)
    direct_map.scatter_reduce_(0, keys, vals, reduce="amax")


def build_direct_map(per_contig, contigs, tables, masks, k: int,
                     device) -> PeakSet:
    """Device build of the hash -> peak-id map. Reference chunks with no
    peak member are skipped. Consumes `per_contig`."""
    pcontig, ppos, gpos, pids = _flatten_members(per_contig, contigs, k)
    direct_map = torch.zeros(1 << k, dtype=torch.int32, device=device)
    total = len(contigs.codes)
    for base in range(0, max(total, 1), MAP_BUILD_CHUNK):
        lo = int(np.searchsorted(gpos, base))
        hi = int(np.searchsorted(gpos, base + MAP_BUILD_CHUNK))
        if hi == lo:
            continue
        codes = np.full(MAP_BUILD_CHUNK + k, 4, np.uint8)
        avail = contigs.codes[base : base + MAP_BUILD_CHUNK + k]
        codes[: len(avail)] = avail
        _build_map_chunk(
            direct_map, tables, torch.from_numpy(codes).to(device),
            torch.from_numpy(gpos[lo:hi] - base).to(device),
            torch.from_numpy(pids[lo:hi]).to(device), masks, k)
    return PeakSet(contig=pcontig, pos=ppos, direct_map=direct_map)


# --------------------------------------------------------------------------
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


def vote_core(peak_filter, pk1, pk2, peak_contig, accept,
              min_base_num: int, n_slots: int) -> None:
    pk = torch.cat([pk1, pk2], dim=2)                  # [C, B, P]
    genome = peak_contig[pk.long()]                     # 0 where no peak
    slots_g, slots_c, slots_p, hits = vote_plain.vote_state_plain(
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
