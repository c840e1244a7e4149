"""Device selection and device-memory reporting for the port.

Replaces localhgt_tpu/utils/metrics.py::device_memory_stats (which asks
jax) with torch's allocator counters. Stage timing and counters are in
localhgt_tpu_torch/utils/metrics.py.
"""

from __future__ import annotations

import torch


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
