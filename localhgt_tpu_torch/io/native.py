"""ctypes bindings for the native host IO library (io_native.cpp).

Copy of localhgt_tpu/io/native.py. Builds the shared library on first use
with g++ from the port's own io/csrc/io_native.cpp into
build/localhgt_tpu_torch/ beside the package, keyed by the source's content
(plain C ABI + ctypes; never into the source tree). All entry
points fall back to the numpy implementations in localhgt_tpu_torch.io.fastq if the
toolchain is unavailable, so the package never hard-depends on a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from localhgt_tpu_torch._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "csrc" / "io_native.cpp"
_GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
              "-pthread"]
_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    key = hashlib.sha1(_SRC.read_bytes()
                       + " ".join(_GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"io_native-{key}.so"


def _build(so: Path) -> bool:
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", *_GXX_FLAGS, str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = library_path()
        if not so.is_file() and not _build(so):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(so))
        lib.lht_fastq_open.restype = ctypes.c_void_p
        lib.lht_fastq_open.argtypes = [ctypes.c_char_p]
        lib.lht_fastq_close.argtypes = [ctypes.c_void_p]
        lib.lht_fastq_next_block.restype = ctypes.c_int64
        lib.lht_fastq_next_block.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ]
        lib.lht_fastq_count_bases.restype = ctypes.c_int64
        lib.lht_fastq_count_bases.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)
        ]
        lib.lht_glibc_random_array.argtypes = [
            ctypes.c_uint32, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        ]
        lib.lht_seed_hits.restype = ctypes.c_int64
        lib.lht_seed_hits.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int8),
            ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def count_bases(path: str):
    lib = get_lib()
    if lib is None:
        from localhgt_tpu_torch.io import fastq

        return fastq.count_bases(path)[:2]
    n_reads = ctypes.c_int64(0)
    total = lib.lht_fastq_count_bases(path.encode(), ctypes.byref(n_reads))
    return int(total), int(n_reads.value)


def iter_fastq_blocks(path: str, max_reads: int = 1 << 16, width: int = 192,
                      chunk_bytes: int = 1 << 26, threads: int = 4):
    """Yield (codes [n, width] uint8, lengths [n] int32, start_ordinal)."""
    lib = get_lib()
    if lib is None:
        from localhgt_tpu_torch.io import fastq

        for b in fastq.iter_fastq_batches(path, batch_reads=max_reads,
                                          max_len=width):
            yield b.codes, b.lengths, b.start_ordinal
        return
    h = lib.lht_fastq_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        while True:
            codes = np.empty((max_reads, width), np.uint8)
            lengths = np.empty(max_reads, np.int32)
            start = ctypes.c_int64(0)
            n = lib.lht_fastq_next_block(
                h,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                max_reads, width, chunk_bytes, ctypes.byref(start), threads,
            )
            if n <= 0:
                break
            yield codes[:n], lengths[:n], int(start.value)
    finally:
        lib.lht_fastq_close(h)


def seed_hits(codes: np.ndarray, lengths: np.ndarray,
              sorted_hash: np.ndarray, sorted_pos: np.ndarray,
              seed_len: int, stride: int, max_occ: int,
              threads: int = 8):
    """Both-strand seed index hits: (read int32, qoff int32, pos int64,
    strand int8) arrays, or None when the native library is unavailable.
    qoff for strand 1 is in the reverse-complemented read frame (matching
    the numpy seeding path in pipeline/align.py)."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    sh = np.ascontiguousarray(sorted_hash, np.uint64)
    sp = np.ascontiguousarray(sorted_pos, np.int64)
    B, W = codes.shape
    cap = max(1 << 16, B * 8)
    while True:
        hr = np.empty(cap, np.int32)
        ho = np.empty(cap, np.int32)
        hp = np.empty(cap, np.int64)
        hs = np.empty(cap, np.int8)
        n = lib.lht_seed_hits(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            B, W,
            sh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            sp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(sh), seed_len, stride, max_occ, threads,
            hr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ho.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            hp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            hs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            cap,
        )
        if n >= 0:
            return hr[:n], ho[:n], hp[:n], hs[:n]
        cap = int(-n) + 1024


def glibc_random_array(seed: int, n: int) -> np.ndarray:
    """The reference's 50M-entry down-sampling array (strict parity mode)."""
    lib = get_lib()
    if lib is None:
        from localhgt_tpu_torch.ops.coder import GlibcRand

        g = GlibcRand(seed)
        return np.array([(g.rand() % 100000) / 1000.0 for _ in range(n)],
                        np.float32)
    out = np.empty(n, np.float32)
    lib.lht_glibc_random_array(
        seed, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    )
    return out
