"""Kernels K4 and K5: the count step's hashing and table update.

`canonical_hashes` (K4) computes what ops/encode.py::canonical_hashes_plain
computes, `count_keys` (K4 with the count epilogue) what
ops/count.py::count_keys_plain computes, and `run_capped_update` (K5) what
ops/count.py::run_capped_update_plain does to the tables, in one launch
for all of them. Each launches the
CUDA kernel of `csrc/kmer.cu` on CUDA tensors and raises on anything else:
`encode.canonical_hashes`, `count.count_keys` and `count.run_capped_update`
dispatch on the device and give CPU tensors the plain versions. Each
counts its launches in `<wrapper>.launches`; `canonical_hashes` also in
`canonical_hashes.stages`, by the pipeline stage (`metrics.stage`) that
was open at the launch.

They replace no Pallas kernel: their counterpart is the XLA program of
localhgt_tpu/ops/count.py::count_reads_step (and the hashing that XLA
fuses into the JAX package's scan, peak-set and vote programs). What
bounds them on an H100 is in the header of csrc/kmer.cu.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from localhgt_tpu_torch import _build
from localhgt_tpu_torch.utils import metrics

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
SIGNATURES = {
    "lht_kmer_hashes": [_P, _LL, _I, _I, _I, _P, _P, _P, _P],
    "lht_kmer_count_keys": [_P, _LL, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "lht_kmer_run_capped_update": [_P, _I, _LL, _P, _I, _P],
}
KERNEL_MAX_HASHES = 9  # C the kernel holds masks for (config: 1-9)
# the count step's 32-bit keys, held as their int32 bit patterns: torch's
# sort takes no uint32 on a CUDA device, and the count needs only the
# grouping of equal keys into runs, so the invalid sentinel 0xFFFFFFFF (-1)
# sorts among the keys and K5 finds it by value
KEY_DTYPE = torch.int32


def _lib():
    return _build.load("kmer", SIGNATURES)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _masks(masks) -> np.ndarray:
    """masks [C, 3] as a contiguous uint32 host array the entry point
    copies into the kernel's parameters."""
    m = np.ascontiguousarray(np.asarray(masks).astype(np.uint32))
    if m.ndim != 2 or m.shape[1] != 3 or not 1 <= m.shape[0] <= \
            KERNEL_MAX_HASHES:
        raise ValueError(f"kmer kernel: want masks [C, 3] with 1 <= C <= "
                         f"{KERNEL_MAX_HASHES}, got {m.shape}")
    return m


def _check_codes(what: str, codes: torch.Tensor, k: int) -> None:
    if codes.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got "
                         f"{codes.device}")
    if codes.dtype != torch.uint8 or codes.dim() < 1:
        raise TypeError(f"{what}: want uint8 codes [..., L], got "
                        f"{codes.dtype} {tuple(codes.shape)}")
    if not 1 <= k <= 32:
        raise ValueError(f"{what}: k={k} is outside 1..32")


def canonical_hashes(codes: torch.Tensor, masks, k: int):
    """K4. codes uint8 [..., L] on a CUDA device -> (hashes int64
    [C, ..., L], valid bool [..., L]), bit-equal to
    encode.canonical_hashes_plain at every position."""
    _check_codes("canonical_hashes", codes, k)
    m = _masks(masks)
    dev = codes.device
    c = codes.contiguous()
    L = c.shape[-1]
    h = torch.empty((m.shape[0], *c.shape), dtype=torch.int64, device=dev)
    v = torch.empty(c.shape, dtype=torch.bool, device=dev)
    if c.numel() == 0:
        return h, v
    with torch.cuda.device(dev):  # a launch goes to the current device
        err = _lib().lht_kmer_hashes(
            c.data_ptr(), c.numel() // L, L, k, m.shape[0], m.ctypes.data,
            h.data_ptr(), v.data_ptr(), _stream(dev))
    _build.check(err, "lht_kmer_hashes")
    canonical_hashes.launches += 1
    canonical_hashes.stages[metrics.current_stage()] += 1
    return h, v


def count_keys(codes: torch.Tensor, lengths: torch.Tensor,
               accept: torch.Tensor, masks, k: int, kw: int = 0):
    """K4 with the count epilogue. codes uint8 [B, L], lengths int32 [B],
    accept bool [B] on one CUDA device -> keys KEY_DTYPE [C, B * W]
    (W = kw if 0 < kw < L, else L), equal to count.count_keys_plain."""
    _check_codes("count_keys", codes, k)
    if codes.dim() != 2:
        raise ValueError(f"count_keys: want codes [B, L], got "
                         f"{tuple(codes.shape)}")
    B, L = codes.shape
    if lengths.shape != (B,) or accept.shape != (B,):
        raise ValueError(f"count_keys: want lengths and accept [{B}], got "
                         f"{tuple(lengths.shape)} and {tuple(accept.shape)}")
    if lengths.dtype != torch.int32 or accept.dtype != torch.bool:
        raise TypeError(f"count_keys: want int32 lengths and bool accept, "
                        f"got {lengths.dtype} and {accept.dtype}")
    if lengths.device != codes.device or accept.device != codes.device:
        raise ValueError("count_keys: codes, lengths and accept on "
                         "different devices")
    m = _masks(masks)
    dev = codes.device
    W = kw if 0 < kw < L else L
    keys = torch.empty((m.shape[0], B * W), dtype=KEY_DTYPE, device=dev)
    if keys.numel() == 0:
        return keys
    c, ln, acc = codes.contiguous(), lengths.contiguous(), accept.contiguous()
    with torch.cuda.device(dev):
        err = _lib().lht_kmer_count_keys(
            c.data_ptr(), B, L, W, k, m.shape[0], m.ctypes.data,
            ln.data_ptr(), acc.data_ptr(), keys.data_ptr(), _stream(dev))
    _build.check(err, "lht_kmer_count_keys")
    count_keys.launches += 1
    return keys


def run_capped_update(tables, s: torch.Tensor, cap: int) -> None:
    """K5, one launch for every table. Add min(run length, cap) of every
    run of equal keys in row c of the sorted keys s [C, N] (KEY_DTYPE,
    sorted as int32) to the int8 table tables[c] in place; the sentinel
    0xFFFFFFFF is never counted. Equal to count.run_capped_update_plain."""
    tables = list(tables)
    if not 1 <= len(tables) <= KERNEL_MAX_HASHES:
        raise ValueError(f"run_capped_update: want 1 to {KERNEL_MAX_HASHES} "
                         f"tables, got {len(tables)}")
    dev = tables[0].device
    if dev.type != "cuda" or s.device != dev or any(
            t.device != dev for t in tables):
        raise ValueError(f"run_capped_update: the kernel takes tables and "
                         f"keys on one CUDA device, got "
                         f"{[str(t.device) for t in tables]} and {s.device}")
    for t in tables:
        if t.dtype != torch.int8 or t.dim() != 1:
            raise TypeError(f"run_capped_update: want int8 tables [2^k], got "
                            f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("run_capped_update: the tables must be "
                             "contiguous: they are updated in place")
        if t.numel() % 4 or t.data_ptr() % 4:
            raise ValueError("run_capped_update: the kernel updates a "
                             "table's bytes a 32-bit word at a time: want "
                             "2^k entries, k >= 2, from a 4-byte boundary")
    if s.dtype != KEY_DTYPE or s.shape[:1] != (len(tables),) or s.dim() != 2:
        raise TypeError(f"run_capped_update: want {KEY_DTYPE} key rows "
                        f"[{len(tables)}, N], got {s.dtype} "
                        f"{tuple(s.shape)}")
    if not 0 <= cap <= 127:
        raise ValueError(f"run_capped_update: cap={cap} is outside 0..127")
    if s.numel() == 0:
        return
    rows = s.contiguous()
    ptrs = np.array([t.data_ptr() for t in tables], dtype=np.uint64)
    with torch.cuda.device(dev):
        err = _lib().lht_kmer_run_capped_update(
            rows.data_ptr(), len(tables), rows.shape[1], ptrs.ctypes.data,
            cap, _stream(dev))
    _build.check(err, "lht_kmer_run_capped_update")
    run_capped_update.launches += 1


canonical_hashes.launches = 0
canonical_hashes.stages = collections.Counter()
count_keys.launches = 0
run_capped_update.launches = 0
