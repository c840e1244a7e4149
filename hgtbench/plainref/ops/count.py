"""Saturating k-mer count tables as torch tensors.

Port of localhgt_tpu/ops/count.py. Every table is the **plain int8
[2^k]** layout, for every k: at k=32 that is 4 GiB a table, 12 GiB for
three, which an 80 GB card holds (the reference's 4-bit packed k > 30
layout exists to fit 16 GB). Hash indices are int64.

Semantics are the reference's: per batch, each hash's contribution is
capped at `cap` by ranking duplicates in the sorted batch, a scatter-add
accumulates, and a (deferrable) clip gives min(total, cap). On a CUDA
device the port's step is kernel K4's count epilogue (the flat keys), a
sort of those 32-bit keys and kernel K5; this frozen copy runs their plain
versions, `count_keys_plain` and `run_capped_update_plain` (the
rank-capped contributions and the scatter-add), on any device. The hash
value
0xFFFFFFFF is the invalid sentinel and is never counted, so at k=32 the
real all-ones k-mer keeps count 0, exactly as in the reference.
"""

from __future__ import annotations

import torch

from hgtbench.plainref.ops import encode

# the count step's 32-bit keys, held as their int32 bit patterns, as the
# port holds them (torch sorts no uint32 on a CUDA device)
KEY_DTYPE = torch.int32

SENTINEL = 0xFFFFFFFF
JAX_TABLE_BITS = 30        # the JAX package packs tables for k above this
JAX_PACKED_FIELDS = 8      # 4-bit fields per int32 word in that layout
JAX_PACKED_FIELD_MAX = 15  # the largest count a 4-bit field holds


def make_table(k: int, device) -> torch.Tensor:
    return torch.zeros(1 << k, dtype=torch.int8, device=device)


def table_lookup(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Gather int8 counts for int64 hashes."""
    return table[h]


def rank_capped_contrib(s: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-entry int8 contribution from SORTED int64 hashes s [C, N]: the
    first `cap` entries of each run contribute 1, the rest 0, so the
    scatter-add total per hash is exactly min(run_length, cap)."""
    C, N = s.shape
    pos = torch.arange(N, device=s.device).expand(C, N)
    is_start = torch.ones_like(s, dtype=torch.bool)
    is_start[:, 1:] = s[:, 1:] != s[:, :-1]
    run_start = torch.cummax(torch.where(is_start, pos, 0), dim=1).values
    return (((pos - run_start) < cap) & (s != SENTINEL)).to(torch.int8)


def scatter_delta(table: torch.Tensor, s: torch.Tensor,
                  contrib: torch.Tensor) -> None:
    """Add the contributions of one sorted hash row into `table` in place;
    sentinel and zero-contribution entries are dropped first."""
    live = contrib != 0
    table.index_add_(0, s[live], contrib[live])


def _flat_keys(hashes, valid, lengths, accept, k: int, kw: int):
    """The count step's flat int64 keys [C, B * W] from one batch's
    hashes [C, B, L] and valid [B, L]: the start axis cropped to kw
    (0 = no crop), every window that is not valid, starts past
    lengths - k or lies in a read that is not accepted as SENTINEL."""
    L = hashes.shape[-1]
    if kw and kw < L:
        hashes = hashes[:, :, :kw]
        valid = valid[:, :kw]
        L = kw
    j = torch.arange(L, device=hashes.device)
    valid = (valid & (j[None, :] <= (lengths[:, None].long() - k))
             & accept[:, None])
    C = hashes.shape[0]
    return torch.where(valid.reshape(1, -1), hashes.reshape(C, -1), SENTINEL)


def count_keys_plain(codes, lengths, accept, masks, k: int, kw: int = 0):
    """Plain torch version of K4's count epilogue on any device: the keys
    [C, B * W] that count_reads_step sorts, as the int32 bit patterns of
    their 32-bit values (KEY_DTYPE)."""
    hashes, valid = encode.canonical_hashes_plain(codes, masks, k)
    return _flat_keys(hashes, valid, lengths, accept, k, kw).to(
        KEY_DTYPE)


def count_keys(codes, lengths, accept, masks, k: int, kw: int = 0):
    """One read batch's flat keys, on any device (the plain version)."""
    return count_keys_plain(codes, lengths, accept, masks, k, kw)


def run_capped_update_plain(tables, s: torch.Tensor, cap: int) -> None:
    """Plain torch version of K5 on any device: the rank-capped
    contributions of each sorted key row s[c] of s [C, N] scattered into
    tables[c]."""
    s64 = s.to(torch.int64) & SENTINEL  # the unsigned value of any 32 bits
    for t, row, contrib in zip(tables, s64, rank_capped_contrib(s64, cap)):
        scatter_delta(t, row, contrib)


def run_capped_update(tables, s: torch.Tensor, cap: int) -> None:
    """Add min(run length, cap) of every run of the sorted key row s[c]
    to tables[c] in place, on any device (the plain version)."""
    return run_capped_update_plain(tables, s, cap)


def count_reads_step(tables, codes, lengths, accept, masks, k: int,
                     cap: int = 3, clip: bool = True, kw: int = 0) -> None:
    """Hash one read batch and update every table in place.

    codes uint8 [B, L], lengths int32 [B], accept bool [B], all on the
    tables' device. kw crops the k-mer start axis to the batch's real
    window before the sort (0 = no crop), as in the reference; clip=False
    defers the saturating sweep to clip_tables. The plain versions of the
    port's K4 count epilogue and K5, and one sort of the 32-bit keys (as
    int32)."""
    s = torch.sort(count_keys(codes, lengths, accept, masks, k, kw),
                   dim=1).values
    run_capped_update(tables, s, cap)
    if clip:
        clip_tables(tables, cap)


def clip_tables(tables, cap: int = 3) -> None:
    for t in tables:
        t.clamp_(max=cap)


def check_least_depth(k: int, cap: int) -> None:
    """The JAX package's rule, raised where its count stage starts
    (localhgt_tpu/ops/count.py::clip_every_batches): for k > 30 its tables
    are 4-bit fields, and a cap above 7 lets a clipped field plus one
    batch pass 15. The port's int8 tables would hold such counts, but its
    checkpoints are that layout, and its answer must be the JAX package's,
    so it refuses the same configurations with the same message."""
    if k > JAX_TABLE_BITS and cap > (JAX_PACKED_FIELD_MAX - 1) // 2:
        raise ValueError(
            f"least_depth={cap} > 7 overflows the 4-bit packed count "
            f"fields used for k={k} > {JAX_TABLE_BITS}; use k <= "
            f"{JAX_TABLE_BITS} or a smaller least_depth")


def clip_every_batches(cap: int = 3, streams: int = 1) -> int:
    """Unclipped batches an int8 table absorbs: a batch adds at most `cap`
    per rank-capped stream (`streams`: one, or one per shard of the
    multi-device count, whose int8 headroom shrinks that many times)."""
    return max(1, 120 // max(streams * cap, 1) - 2)
