"""Host allocator hygiene for the long pipeline runs.

glibc malloc dynamically RAISES its mmap threshold (up to 32 MB) once it
sees large frees, after which multi-MB numpy buffers are carved from the
brk/arena heap and freed pages are RETAINED by the process. The scan and
peakset stages churn millions of per-interval arrays, so at the 1 Gbp
scale the retained-but-free arena alone pushed max RSS to ~43 GB while
live data was <14 GB (measured via /proc/PID/maps) — blowing the
reference's <25 GB envelope (README.md:6) with memory nobody was using.

`cap_mmap_threshold` pins M_MMAP_THRESHOLD so every allocation >= the
threshold is mmap'd and RETURNS to the OS on free; `trim` releases any
remaining free arena pages at stage boundaries. Both are no-ops on
non-glibc platforms.
"""

from __future__ import annotations

_libc = None
_capped = False


def _get_libc():
    global _libc
    if _libc is None:
        try:
            import ctypes

            _libc = ctypes.CDLL("libc.so.6", use_errno=True)
        except Exception:
            _libc = False
    return _libc or None


def cap_mmap_threshold(threshold: int = 1 << 20) -> bool:
    """Pin glibc's mmap threshold (disables the dynamic raise). Call once
    at pipeline start, BEFORE the allocation churn begins."""
    global _capped
    libc = _get_libc()
    if libc is None:
        return False
    try:
        M_MMAP_THRESHOLD = -3
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, int(threshold)))
        _capped = _capped or ok
        return ok
    except Exception:
        return False


def trim() -> None:
    """Release free heap pages back to the OS (glibc malloc_trim)."""
    libc = _get_libc()
    if libc is None:
        return
    try:
        libc.malloc_trim(0)
    except Exception:
        pass
