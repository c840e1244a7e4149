"""Lightweight run metrics: per-stage walls, device-memory highwater, and
derived throughput numbers.

The reference's only observability is `date +%s` deltas in pipeline.sh and
`/usr/bin/time -v` parsing in the paper harness (SURVEY.md section 5). Here
every pipeline stage records into a process-global registry that bench.py
and the grid runner surface next to accuracy. Copy of
localhgt_tpu/utils/metrics.py without what asks JAX for a profiler trace or
for device memory: device memory is in localhgt_tpu_torch/utils/device.py.
"""

from __future__ import annotations

import contextlib
import time

from localhgt_tpu_torch.utils import hostmem

_STAGES: dict[str, float] = {}
_COUNTERS: dict[str, float] = {}
_SERIES: dict[str, list] = {}
_STAGE_RSS: dict[str, float] = {}


def reset() -> None:
    _STAGES.clear()
    _COUNTERS.clear()
    _SERIES.clear()
    _STAGE_RSS.clear()


def add_time(stage: str, seconds: float) -> None:
    _STAGES[stage] = _STAGES.get(stage, 0.0) + seconds


def add(counter: str, value: float) -> None:
    _COUNTERS[counter] = _COUNTERS.get(counter, 0.0) + value


def record(series: str, value: float) -> None:
    """Append one sample to a named series (e.g. per-batch dispatch walls),
    so a single anomalous batch is diagnosable from the bench artifact alone
    (the round-3 contended capture showed 21.7 s/batch vs 0.8 s clean, with
    nothing in the JSON to tell them apart)."""
    _SERIES.setdefault(series, []).append(float(value))


def series_stats() -> dict:
    """{name: {n, mean, max, p90}} for every recorded series."""
    out = {}
    for name, vals in _SERIES.items():
        if not vals:
            continue
        sv = sorted(vals)
        out[name] = {
            "n": len(vals),
            "mean": round(sum(vals) / len(vals), 3),
            "max": round(sv[-1], 3),
            "p90": round(sv[int(0.9 * (len(sv) - 1))], 3),
        }
    return out


def host_rss_gb() -> float:
    """Current resident set size of this process, GB (from /proc)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 2**20, 3)
    except OSError:
        pass
    return 0.0


def stage_rss() -> dict[str, float]:
    """Host RSS (GB) sampled at the end of each stage."""
    return dict(_STAGE_RSS)


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage and sample the host RSS at its end."""
    t0 = time.perf_counter()
    yield
    add_time(name, time.perf_counter() - t0)
    hostmem.trim()  # return freed arena pages before sampling RSS
    _STAGE_RSS[name] = host_rss_gb()


def stage_walls() -> dict[str, float]:
    return {k: round(v, 3) for k, v in _STAGES.items()}


def counters() -> dict[str, float]:
    return dict(_COUNTERS)
