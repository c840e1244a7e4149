"""The least time kernels K1 (`sw_align`) and K2 (`sw_score`) of the
port's csrc/sw.cu could take for a launch of shape (B, M, N) on one
NVIDIA H100 SXM at its 700 W power limit: the larger of the bytes term
(each input read once, each output written once, at HBM3's 3.35 TB/s)
and the operations term (the integer-pipe operations a DP cell needs,
over 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.73 T/s). A card set below
700 W runs slower than this bound, so the benchmark prints the card's
power limit beside every share of it.

The counts are the port's (its chip_smoke.py, re-counted on K1's SASS):
K1 carries each maximum's origin, so a cell is 20 compares, selects,
maxima and byte permutes; K2 needs no origin and uses Hopper's
three-input maxima, 5.5 a cell. Adds are not counted: they also issue on
the FMA pipe. K1 writes 5 int32 a row (score, qstart, qend, rstart,
rend), K2 one.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_CELL = {"sw_align": 20.0, "sw_score": 5.5}
OUT_BYTES_PER_ROW = {"sw_align": 20, "sw_score": 4}
# the kernel names of each wrapper in a device trace (K2's scan variant
# is a tuning build's, listed so that it is never counted as something
# else)
KERNEL_NAMES = {"sw_align": ("sw_align_kernel",),
                "sw_score": ("sw_score_kernel", "sw_score_scan_kernel")}


def bound_s(kernel: str, B: int, M: int, N: int) -> float:
    """Seconds one launch of `kernel` at (B, M, N) takes at least."""
    nbytes = B * (M + N) + B * OUT_BYTES_PER_ROW[kernel]
    ops = float(B) * M * N * OPS_PER_CELL[kernel]
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)


def shapes_bound_s(kernel: str, shapes: dict) -> float:
    """The bound of every launch in `shapes` ({(B, M, N): launches})."""
    return sum(n * bound_s(kernel, *shape) for shape, n in shapes.items())


def device_s(kernel: str, by_name: dict) -> float:
    """The device seconds of `kernel` in a trace's time by kernel name."""
    keys = KERNEL_NAMES[kernel]
    return sum(s for name, s in by_name.items()
               if any(k in name for k in keys))


def share_pct(kernel: str, shapes: dict, by_name: dict) -> float | None:
    """The kernel's bound over its device time, in %; None where it did
    not run in the window (no launch or no device time)."""
    dev = device_s(kernel, by_name)
    if not shapes or dev <= 0:
        return None
    return 100.0 * shapes_bound_s(kernel, shapes) / dev
