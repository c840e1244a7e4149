"""Reduction of a torch.profiler Chrome trace to the benchmark's device
numbers: the union of the device's busy intervals inside the window, the
device time of each kernel name, the device operations that took most
time, and the device's idle gaps labelled by the pipeline stage span (a
`record_function` of `utils/metrics.stage` in the port) that was open on
the host at the time.

The interval arithmetic (`union_us`, `_outermost`) is a frozen
copy of the port's profile_trace.py. The window is the span named
WINDOW_SPAN that the harness opens around the measured loop; spans whose
name starts with SPAN_PREFIX are the harness's own and label nothing.
"""

from __future__ import annotations

import bisect
import collections

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "hgtbench.window"
SPAN_PREFIX = "hgtbench."
OUTSIDE = "(outside every stage)"


def _outermost(spans):
    """The spans (start, end, name) that no other span holds, in order."""
    out = []
    for s in sorted(spans, key=lambda x: (x[0], -x[1])):
        if not out or s[0] >= out[-1][1]:
            out.append(s)
    return out


def union_us(intervals) -> float:
    """Length of the union of [start, end) intervals (us)."""
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The gaps (start, end) of [lo, hi) that no interval covers."""
    gaps, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def summarize(events, top: int = 10) -> dict | None:
    """The window's device numbers from a trace's `traceEvents`; None when
    the trace holds no WINDOW_SPAN. Times in seconds:
    {"window_s", "busy_s", "device_events", "by_name": {name: s},
     "device_ops": [[name, s]] (top), "idle_by_stage": [[stage, s]] (top)}.
    Only device events that overlap the window count, clipped to it."""
    window = None
    stages = []
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e["name"]))
        elif cat == "user_annotation":
            if e["name"] == WINDOW_SPAN:
                window = (ts, ts + dur)
            elif not e["name"].startswith(SPAN_PREFIX):
                stages.append((ts, ts + dur, e["name"]))
    if window is None:
        return None
    lo, hi = window
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in device
              if b > lo and a < hi]
    by_name = collections.Counter()
    for a, b, n in inside:
        by_name[n] += (b - a) / 1e6
    busy = union_us((a, b) for a, b, _ in inside) / 1e6
    spans = _outermost(stages)
    starts = [s[0] for s in spans]
    idle = collections.Counter()
    for a, b in idle_gaps([(a, b) for a, b, _ in inside], lo, hi):
        # a gap is charged to the stages open over it, piece by piece
        t = a
        while t < b:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t < spans[i][1]:
                end, name = min(b, spans[i][1]), spans[i][2]
            else:
                nxt = starts[i + 1] if i + 1 < len(starts) else b
                end, name = min(b, nxt), OUTSIDE
            idle[name] += (end - t) / 1e6
            t = end
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy,
            "device_events": len(inside), "by_name": dict(by_name),
            "device_ops": [[n, s] for n, s in by_name.most_common(top)],
            "idle_by_stage": [[n, s] for n, s in idle.most_common(top)]}
