"""Kernel K6: the align stage's seed prefilter.

`seed_prefilter` computes what pipeline/align.py::seed_prefilter_plain
computes, bool [B] from codes, lengths and the prefix bitmap, in one launch
of the CUDA kernel of `csrc/seed.cu`, and raises on anything else:
`align.seed_prefilter_device` dispatches on the device and gives CPU
tensors the plain version. It counts its launches in
`seed_prefilter.launches` and in `seed_prefilter.stages`, by the pipeline
stage (`metrics.stage`) that was open at the launch.

It replaces no Pallas kernel: its counterpart is the XLA program `pf` of
localhgt_tpu/pipeline/align.py::_ensure_pf_jit. What bounds it on an H100
is in the header of csrc/seed.cu.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from localhgt_tpu_torch import _build
from localhgt_tpu_torch.utils import metrics

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {"lht_seed_prefilter": [_P, _I, _I, _P, _P, _P, _P]}
# the kernel's window is 16 bases, so its hash is 32 bits and the bitmap
# 2^32 bits (pipeline/align.py: PREFILTER_LEN, BITMAP_WORDS)
BITMAP_WORDS = 1 << 27


def _lib():
    return _build.load("seed", SIGNATURES)


def seed_prefilter(codes: torch.Tensor, lengths: torch.Tensor,
                   bitmap: torch.Tensor) -> torch.Tensor:
    """K6. codes uint8 [B, L], lengths int32 [B] and the prefix bitmap
    int32 [2^27], all on one CUDA device -> bool [B], equal to
    align.seed_prefilter_plain."""
    dev = codes.device
    if dev.type != "cuda" or lengths.device != dev or bitmap.device != dev:
        raise ValueError(f"seed_prefilter: the kernel takes codes, lengths "
                         f"and bitmap on one CUDA device, got {dev}, "
                         f"{lengths.device} and {bitmap.device}")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError(f"seed_prefilter: want uint8 codes [B, L], got "
                        f"{codes.dtype} {tuple(codes.shape)}")
    B, L = codes.shape
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise TypeError(f"seed_prefilter: want int32 lengths [{B}], got "
                        f"{lengths.dtype} {tuple(lengths.shape)}")
    if bitmap.dtype != torch.int32 or bitmap.shape != (BITMAP_WORDS,):
        raise TypeError(f"seed_prefilter: want an int32 bitmap "
                        f"[{BITMAP_WORDS}], got {bitmap.dtype} "
                        f"{tuple(bitmap.shape)}")
    out = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return out
    c, ln, bm = codes.contiguous(), lengths.contiguous(), bitmap.contiguous()
    with torch.cuda.device(dev):  # a launch goes to the current device
        err = _lib().lht_seed_prefilter(
            c.data_ptr(), B, L, ln.data_ptr(), bm.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lht_seed_prefilter")
    seed_prefilter.launches += 1
    seed_prefilter.stages[metrics.current_stage()] += 1
    return out


seed_prefilter.launches = 0
seed_prefilter.stages = collections.Counter()
