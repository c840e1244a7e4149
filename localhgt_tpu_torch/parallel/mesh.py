"""An explicit list of devices, and the two dp x tp steps over it.

Port of localhgt_tpu/parallel/mesh.py. JAX's `Mesh` + `shard_map` become
`DeviceMesh`, a value object that names one torch device per shard, and
plain Python loops over the shards in one process. A collective is an
explicit copy: an all-gather is `.to(device)` of every shard's part and a
`torch.cat`, a psum is copies to one device and a sum. Work queued on
different cards overlaps by itself, since CUDA launches are asynchronous.

A shard is a list entry, not a physical card: the same device may appear
more than once (`["cpu"] * 8`, `["cuda:0"] * 4`), and every entry still
owns its own table slice and its own share of every batch, so slice
bounds, stream merging and the reductions run as they would on as many
cards.

* **dp axis**: read batches are data-parallel; each dp shard counts its
  own reads, and shards merge with min(sum(local_counts), cap), the
  single-device semantics min(total_occurrences, cap).
* **tp axis**: the 2^k count table is cut by leading hash bits; every
  shard filters the hash stream down to its own slice before scattering.
* the scan reuses dp: position blocks with halo overlap go to the dp
  shards and each block scans on its own.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from localhgt_tpu_torch.ops import encode, scan


@dataclass(frozen=True)
class DeviceMesh:
    """devices: one torch.device per shard, in shard order; shape: (dp, tp)
    with dp * tp == len(devices) (a flat mesh is (n, 1))."""

    devices: tuple
    shape: tuple

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> list:
        """The devices that hold at least one shard, in first-use order."""
        return list(dict.fromkeys(self.devices))

    def describe(self) -> str:
        return f"{self.n} shards on {len(self.distinct)} distinct devices"


def _devices(devices) -> tuple:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a device mesh over every visible CUDA device was asked for "
                "but CUDA is not available (pass the list of devices)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a device mesh needs at least one device")
    return devices


def make_flat_mesh(devices=None) -> DeviceMesh:
    """One axis over `devices` as given (repeats allowed); None = every
    visible CUDA device once, and an error when CUDA is absent."""
    devices = _devices(devices)
    return DeviceMesh(devices, (len(devices), 1))


def make_mesh(devices=None, dp: int | None = None,
              tp: int | None = None) -> DeviceMesh:
    """dp x tp over `devices` (shard (i, j) is entry i * tp + j). Without
    dp and tp: favor dp; tp gets the largest power-of-two factor <= 4."""
    devices = _devices(devices)
    n = len(devices)
    if dp is None or tp is None:
        tp = next((t for t in (4, 2) if n % t == 0), 1)
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"mesh {dp} x {tp} does not cover {n} devices")
    return DeviceMesh(devices, (dp, tp))


def row_bounds(n_rows: int, n: int) -> list:
    """[(lo, hi)] of n contiguous shares of n_rows rows; the shares differ
    by at most one row and may be empty."""
    return [(i * n_rows // n, (i + 1) * n_rows // n) for i in range(n)]


def replicate(mesh: DeviceMesh, x: torch.Tensor) -> list:
    """x on every shard's device: one copy per distinct device, shared by
    the shards that sit on it."""
    copies = {d: x.to(d) for d in mesh.distinct}
    return [copies[d] for d in mesh.devices]


def shard_rows(mesh: DeviceMesh, x: torch.Tensor) -> list:
    """x cut along dim 0 into one contiguous share per shard, each on its
    shard's device."""
    return [x[lo:hi].to(d) for (lo, hi), d in
            zip(row_bounds(x.shape[0], mesh.n), mesh.devices)]


def sharded_count_step(mesh: DeviceMesh, k: int, cap: int = 3):
    """Returns step(table_slices, hashes, valid) -> table_slices.

    table_slices: tp int32 tensors [2^k / tp], slice j on the device of
    shard (0, j); hashes int64 [B] and valid bool [B] on any device, cut
    over dp by the step. Shard (i, j) scatters the hashes of dp share i
    that fall into slice j; the partial deltas of a slice are summed over
    dp before the saturating clip, so the result does not depend on the
    mesh."""
    dp, tp = mesh.shape
    T = 1 << k
    if T % tp:
        raise ValueError(f"2^{k} hashes do not cut into {tp} equal slices")
    size = T // tp

    def step(table_slices, hashes, valid):
        out = []
        for j, table in enumerate(table_slices):
            lo = j * size
            delta = torch.zeros_like(table)
            for i, (a, b) in enumerate(row_bounds(hashes.shape[0], dp)):
                dev = mesh.devices[i * tp + j]
                h = hashes[a:b].to(dev)
                mine = valid[a:b].to(dev) & (h >= lo) & (h < lo + size)
                part = torch.zeros(size, dtype=table.dtype, device=dev)
                part.index_add_(0, h[mine] - lo, torch.ones(
                    int(mine.sum()), dtype=table.dtype, device=dev))
                delta += part.to(table.device)
            out.append(torch.clamp(table + delta, max=cap))
        return out

    return step


def sharded_scan_step(mesh: DeviceMesh, k: int, scan_cfg, coder_num: int,
                      block: int, halo: int):
    """Returns step(codes_blocks, table_slices, masks) -> (good, peak).

    codes_blocks uint8 [n_blocks, block + 2 * halo] (the caller prepares
    the halo overlap), cut over dp by the step; table_slices: tp tensors
    [coder_num, 2^k / tp] that every dp shard gathers whole; masks: the
    hash masks. Returns bool [n_blocks, block] masks of each block's core
    on the first shard's device."""
    dp, tp = mesh.shape

    def step(codes_blocks, table_slices, masks):
        goods, peaks = [], []
        for i, (a, b) in enumerate(row_bounds(codes_blocks.shape[0], dp)):
            dev = mesh.devices[i * tp]
            table = torch.cat([t.to(dev) for t in table_slices], dim=1)
            h, v = encode.canonical_hashes(codes_blocks[a:b].to(dev), masks,
                                           k)
            rows = [torch.where(v & (h[c] != 0), table[c][h[c]], 0)
                    for c in range(coder_num)]
            g, p = scan.scan_hits(torch.stack(rows, dim=-2), k, scan_cfg)
            goods.append(g[:, halo : halo + block].to(mesh.devices[0]))
            peaks.append(p[:, halo : halo + block].to(mesh.devices[0]))
        return torch.cat(goods), torch.cat(peaks)

    return step
