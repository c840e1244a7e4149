"""Device time of a torch.profiler trace by kernel name and by caller.

    python -m localhgt_tpu_torch.profile_trace TRACE.json [--top 30]
        [--json out.json]

Reads a Chrome trace written by `torch.profiler` (`bench --profile`
writes one to run_<scale>/trace/trace.json) and attributes every device
event (kernel, memcpy, memset) to its caller: the pipeline stage span
(`utils/metrics.stage`, a `record_function`) and the outermost aten
operator that were open on the launching thread when the host launched
it, found through the launch's correlation id. A kernel launched outside
every aten operator (the port's own kernels, through ctypes) is listed
under its kernel name. Prints, and writes with --json: the device time
summed and as the union of the events' intervals, the time by stage, by
(stage, caller) and by kernel name. Imports nothing of JAX; needs no
card.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_OP = "(no aten op)"


def _outermost(spans):
    """The spans (start, end, name) that no other span holds, in order."""
    out = []
    for s in sorted(spans, key=lambda x: (x[0], -x[1])):
        if not out or s[0] >= out[-1][1]:
            out.append(s)
    return out


def _holder(spans, starts, t):
    """Name of the span of the sorted, disjoint `spans` holding time t."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][0] <= t <= spans[i][1]:
        return spans[i][2]
    return None


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


def summarize(events, top: int = 30) -> dict:
    """The summary of a trace's `traceEvents` list; every user annotation
    (`record_function` span) counts as a stage."""
    ops = collections.defaultdict(list)       # (pid, tid) -> cpu op spans
    spans = collections.defaultdict(list)     # (pid, tid) -> stage spans
    launch = {}                               # correlation -> (key, ts)
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        key = (e.get("pid"), e.get("tid"))
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (key, ts)
        elif cat == "cpu_op":
            ops[key].append((ts, ts + dur, e["name"]))
        elif cat == "user_annotation":
            spans[key].append((ts, ts + dur, e["name"]))
    ops = {k: _outermost(v) for k, v in ops.items()}
    op_starts = {k: [s[0] for s in v] for k, v in ops.items()}
    spans = {k: _outermost(v) for k, v in spans.items()}
    span_starts = {k: [s[0] for s in v] for k, v in spans.items()}

    by_stage = collections.Counter()
    by_caller = collections.Counter()
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in device:
        ms = float(e.get("dur", 0.0)) / 1e3
        name = e["name"]
        stage, op = "(no stage)", NO_OP
        hit = launch.get(e.get("args", {}).get("correlation"))
        if hit is not None:
            key, t = hit
            if key in spans:
                stage = _holder(spans[key], span_starts[key], t) or stage
            if key in ops:
                op = _holder(ops[key], op_starts[key], t) or op
        caller = op if op != NO_OP else name
        by_stage[stage] += ms
        by_caller[(stage, caller)] += ms
        by_name[name] += ms
        calls[name] += 1
        calls[(stage, caller)] += 1
    busy_ms = union_us((float(e["ts"]), float(e["ts"]) + float(
        e.get("dur", 0.0))) for e in device) / 1e3

    def rows(counter, n):
        return [{"key": k if isinstance(k, str) else list(k), "ms": v,
                 "calls": calls[k]} for k, v in counter.most_common(n)]

    return {"device_events": len(device),
            "device_ms": sum(by_stage.values()), "busy_ms": busy_ms,
            "by_stage": dict(by_stage.most_common()),
            "by_caller": rows(by_caller, top), "by_name": rows(by_name, top)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="a torch.profiler Chrome trace (JSON)")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--json", default="", help="also write the summary here")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        events = json.load(f)["traceEvents"]
    rec = summarize(events, top=args.top)
    print(f"{rec['device_events']} device events, {rec['device_ms']:.1f} ms "
          f"summed, {rec['busy_ms']:.1f} ms busy (union)")
    print("by stage (ms): " + json.dumps(
        {k: round(v, 1) for k, v in rec["by_stage"].items()}))
    for title, part in (("stage / caller", "by_caller"),
                        ("kernel", "by_name")):
        print(f"device ms  calls  {title}")
        for r in rec[part]:
            key = r["key"] if isinstance(r["key"], str) else " / ".join(
                r["key"])
            print(f"{r['ms']:9.1f} {r['calls']:6d}  {key[:110]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
