"""Lightweight run metrics: per-stage walls, device-memory highwater, and
derived throughput numbers.

The reference's only observability is `date +%s` deltas in pipeline.sh and
`/usr/bin/time -v` parsing in the paper harness (SURVEY.md section 5). Here
every pipeline stage records into a process-global registry that the bench
(localhgt_tpu_torch/bench.py) and the grid runner surface next to accuracy.
Copy of localhgt_tpu/utils/metrics.py without what asks JAX for a profiler
trace or for device memory: each stage is a `torch.profiler` span instead
(read when a profiler is active), and device memory is in
localhgt_tpu_torch/utils/device.py.

Below the stages, `span(name)` names a part of a stage's host work, or of
the orchestration between stages: a `torch.profiler.record_function` on
the trace's clock, and its seconds added to the counter `<name>_s`, so
`counters()` carries them and `reset()` clears them with the rest. Spans
never touch the stage walls. The benchmark reads each `<name>_s` from
`counters()` after a sample (hgtbench/layers/span_s.*.py).
"""

from __future__ import annotations

import contextlib
import time

import torch

from localhgt_tpu_torch.utils import hostmem

_STAGES: dict[str, float] = {}
_COUNTERS: dict[str, float] = {}
_SERIES: dict[str, list] = {}
_STAGE_RSS: dict[str, float] = {}
_OPEN: list[str] = []  # the stages open now, innermost last


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
    """Time a pipeline stage and sample the host RSS at its end; under an
    active torch.profiler the stage is also a span of its trace."""
    t0 = time.perf_counter()
    _OPEN.append(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _OPEN.pop()
    add_time(name, time.perf_counter() - t0)
    hostmem.trim()  # return freed arena pages before sampling RSS
    _STAGE_RSS[name] = host_rss_gb()


@contextlib.contextmanager
def span(name: str):
    """Add the wall of the body, even one that raises, to the counter
    `name + "_s"`; under an active torch.profiler the body is also a span
    of its trace. Unlike `stage` it takes no RSS sample, trims no heap and
    waits for no device: it records only where the host is."""
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        add(name + "_s", time.perf_counter() - t0)


_END = object()


def spanned(name: str, iterable):
    """The items of `iterable`, each advance of it inside `span(name)`."""
    it = iter(iterable)
    while True:
        with span(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item


def current_stage() -> str:
    """The innermost stage open now; "" outside every stage."""
    return _OPEN[-1] if _OPEN else ""


def stage_walls() -> dict[str, float]:
    return {k: round(v, 3) for k, v in _STAGES.items()}


def counters() -> dict[str, float]:
    return dict(_COUNTERS)


def derived(n_pairs: int, read_len: int, coder_num: int) -> dict:
    """Throughput numbers, kernel-window and stage-wall kept apart.

    The round-4 artifact divided ideal work by whole STAGE walls (seeding,
    host IO, dispatch latency included), which made the wired Pallas SW
    kernel look worse than the dead-code era it replaced (VERDICT r4 weak
    #6). Now:

    - sw_gcups_kernel: SW cells over the summed synchronous kernel windows
      (`sw_kernel_s` series recorded by ops.sw around each sub-batch —
      H2D + DP + D2H, nothing else).
    - sw_gcups_stage: the old stage-wall proxy, renamed so nobody triages
      kernel perf from it.
    - count_step_gbps_device: count-stage bytes (~9 per k-mer per coder:
      sorted-stream reads + table writes) a batch over the mean synced
      device step (`count_step_device_s`: the JAX package's count step
      samples it on every 16th batch; the port's records no such series,
      since sampling it synchronizes the device inside the timed path).
    - count_scatter_gbps_stage: the old stage-wall proxy, renamed (the
      same bytes over the `count` stage wall)."""
    out = {}
    w = stage_walls()
    kmers = n_pairs * 2 * max(read_len - 20, 1) * coder_num
    if w.get("count"):
        out["count_scatter_gbps_stage"] = round(kmers * 9 / w["count"] / 1e9, 2)
    step = _SERIES.get("count_step_device_s")
    nb = _COUNTERS.get("count_batches")
    if step and nb:
        bytes_per_batch = kmers * 9 / nb
        out["count_step_gbps_device"] = round(
            bytes_per_batch / (sum(step) / len(step)) / 1e9, 2)
    if w.get("align") and _COUNTERS.get("sw_cells"):
        out["sw_gcups_stage"] = round(
            _COUNTERS["sw_cells"] / w["align"] / 1e9, 2)
    kern = _SERIES.get("sw_kernel_s")
    if kern and _COUNTERS.get("sw_cells"):
        out["sw_gcups_kernel"] = round(
            _COUNTERS["sw_cells"] / sum(kern) / 1e9, 2)
    return out
