"""Device selection, device-memory reporting and copies to the host for
the port.

Replaces localhgt_tpu/utils/metrics.py::device_memory_stats (which asks
jax) with torch's allocator counters. Stage timing and counters are in
localhgt_tpu_torch/utils/metrics.py.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# int32 slots of a HostStaging buffer: 8 MiB, which holds the peak arrays
# of a 1.2 Mbp contig (~6.3 MB), so one wait brings them back
STAGING_INTS = 1 << 21
# threads that copy out of the buffer: the copy writes fresh host pages,
# and on an H100 host four threads faulted them in faster than one
# (stage B's finalize 0.44 s a sample against 0.52 s with one thread)
COPY_THREADS = 4
COPY_SPLIT = 1 << 16  # ints: a copy shorter than this stays on one thread


def resolve(name: str) -> torch.device:
    """The device a run was asked for; raises when it is a CUDA device and
    CUDA is absent. Nothing falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available (pass --device cpu to run the plain "
                           "torch versions of the kernels)")
    return dev


def memory_stats(device) -> dict:
    """Peak and current allocated device memory (GiB) of a CUDA device;
    empty for the CPU, which has no such counters."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    return {
        "device_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "device_in_use_gib": torch.cuda.memory_allocated(dev) / 2**30,
    }


class HostStaging:
    """Fresh numpy copies of int32 tensors through one staging buffer,
    pinned for a CUDA device: non-blocking copies fill the buffer, one
    wait, then COPY_THREADS threads copy out of it into one fresh array a
    fetch, of which the returned arrays are views. A transfer needs no
    pageable copy and waits once for every buffer's worth. The CPU takes
    the same path through an unpinned buffer. `nbytes` counts the bytes
    handed to the host. Use it in a `with` block: `close` ends the
    threads."""

    def __init__(self, device, ints: int = STAGING_INTS):
        self.device = torch.device(device)
        self.buf = torch.empty(ints, dtype=torch.int32,
                               pin_memory=self.device.type == "cuda")
        self.nbytes = 0
        self._pool = ThreadPoolExecutor(COPY_THREADS)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._pool.shutdown()

    def fetch(self, *tensors) -> list:
        for t in tensors:
            if t.dtype != torch.int32 or t.dim() != 1:
                raise TypeError(f"HostStaging takes int32 vectors, not "
                                f"{t.dtype} of {t.dim()} dimensions")
        block = np.empty(sum(t.numel() for t in tensors), np.int32)
        self.nbytes += block.nbytes
        out = []
        pending = []  # (slice of block, its offset in the buffer)
        at = fill = 0
        cap = self.buf.numel()
        for t in tensors:
            arr = block[at:at + t.numel()]
            out.append(arr)
            at += len(arr)
            off = 0
            while off < len(arr):
                if fill == cap:
                    self._drain(pending)
                    fill = 0
                n = min(len(arr) - off, cap - fill)
                self.buf[fill:fill + n].copy_(t[off:off + n],
                                              non_blocking=True)
                pending.append((arr[off:off + n], fill))
                fill += n
                off += n
        self._drain(pending)
        return out

    def _drain(self, pending) -> None:
        if not pending:
            return
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        host = self.buf.numpy()
        parts = []
        for dst, at in pending:
            cuts = np.linspace(0, len(dst), COPY_THREADS + 1).astype(int)
            if len(dst) < COPY_SPLIT:
                cuts = [0, len(dst)]
            parts += [(dst[a:b], host[at + a:at + b])
                      for a, b in zip(cuts[:-1], cuts[1:])]
        for f in [self._pool.submit(np.copyto, d, h) for d, h in parts]:
            f.result()
        pending.clear()
