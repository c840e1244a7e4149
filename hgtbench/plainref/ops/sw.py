"""Host-tiled Smith-Waterman, as the port's ops/sw.py tiles it, over the
plain versions of its kernels (ops/sw_plain.py) on any device. No mesh."""

from __future__ import annotations

import numpy as np
import torch

from hgtbench.plainref.ops import sw_plain

SW_TILE = 8192  # rows per call on the card, as the port's SW_TILE
# rows per call on the CPU, as the port's PLAIN_TILE
PLAIN_TILE = 512
FIELDS = ("score", "qstart", "qend", "rstart", "rend")


def _tiles(query: np.ndarray, ref: np.ndarray, tile: int | None, device):
    B = query.shape[0]
    if tile is None:
        tile = SW_TILE if torch.device(device).type == "cuda" else PLAIN_TILE
    for lo in range(0, B, tile):
        hi = min(B, lo + tile)
        q = torch.from_numpy(np.ascontiguousarray(query[lo:hi])).to(device)
        r = torch.from_numpy(np.ascontiguousarray(ref[lo:hi])).to(device)
        yield q, r


def sw_align_tiled(query: np.ndarray, ref: np.ndarray, device,
                   tile: int | None = None, **kw) -> dict:
    """K1's plain version over host-tiled sub-batches; returns a numpy
    dict of int32 [B] keyed by FIELDS."""
    parts = [sw_plain.sw_align_plain(q, r, **kw).cpu().numpy()
             for q, r in _tiles(query, ref, tile, device)]
    if not parts:
        return {f: np.zeros(0, np.int32) for f in FIELDS}
    packed = np.concatenate(parts, axis=0)
    return {f: packed[:, i].copy() for i, f in enumerate(FIELDS)}


def sw_score_tiled(query: np.ndarray, ref: np.ndarray, device,
                   tile: int | None = None, **kw) -> np.ndarray:
    """K2's plain version over host-tiled sub-batches; numpy int32 [B]."""
    outs = [sw_plain.sw_score_plain(q, r, **kw).cpu().numpy()
            for q, r in _tiles(query, ref, tile, device)]
    if not outs:
        return np.zeros(0, np.int32)
    return np.concatenate(outs)


def sw_score(query: np.ndarray, ref: np.ndarray, device, **kw) -> np.ndarray:
    """Score-only SW of one small batch (K2's plain version); int32 [B]."""
    q = torch.from_numpy(np.ascontiguousarray(query)).to(device)
    r = torch.from_numpy(np.ascontiguousarray(ref)).to(device)
    return sw_plain.sw_score_plain(q, r, **kw).cpu().numpy()
