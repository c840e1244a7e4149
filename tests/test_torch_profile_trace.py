"""profile_trace: device time of a torch.profiler trace by caller.

The host side of the trace is a real CPU trace of torch.profiler (stage
spans from utils/metrics.stage, aten operators); device kernels and their
launches are added the way a CUDA trace holds them (a `cuda_runtime`
launch and a `kernel` event sharing a correlation id), since there is no
card here.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from localhgt_tpu_torch import profile_trace
from localhgt_tpu_torch.utils import metrics


def _host_trace(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.stage("count"):
            x = torch.arange(4096)
            torch.sort(x)
        with metrics.stage("scan"):
            x.cumsum(0)
    metrics.reset()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _op(events, name):
    return next(e for e in events
                if e.get("cat") == "cpu_op" and e["name"] == name)


def _device(events, corr, host, t, name, start, dur):
    """A launch on `host`'s thread at time t and its kernel event."""
    events.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "pid": host["pid"],
                   "tid": host["tid"], "ts": t, "dur": 1.0,
                   "args": {"correlation": corr}})
    events.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                   "tid": 7, "ts": start, "dur": dur,
                   "args": {"correlation": corr}})


def test_device_time_goes_to_the_stage_and_outermost_op_of_its_launch(
        tmp_path):
    events = _host_trace(tmp_path)
    sort_op, cumsum_op = _op(events, "aten::sort"), _op(events, "aten::cumsum")
    count_span = next(e for e in events if e.get("cat") == "user_annotation"
                      and e["name"] == "count")
    t0 = 1e12
    # a sort kernel launched inside aten::sort (and so inside its inner
    # operators), a cumsum kernel in scan overlapping it on the device, the
    # port's kernel launched in count outside every aten op, and a copy
    # launched before any stage
    _device(events, 1, sort_op, sort_op["ts"] + sort_op["dur"] / 2,
            "radix_sort", t0, 2000.0)
    _device(events, 2, cumsum_op, cumsum_op["ts"] + cumsum_op["dur"] / 2,
            "scan_kernel", t0 + 1000.0, 2000.0)
    _device(events, 3, count_span, count_span["ts"] + 0.001,
            "kmer_kernel<true>", t0 + 5000.0, 500.0)
    _device(events, 4, count_span, count_span["ts"] - 50.0,
            "Memcpy HtoD", t0 + 6000.0, 100.0)
    events[-1]["cat"] = "gpu_memcpy"
    rec = profile_trace.summarize(events)
    assert rec["device_events"] == 4
    assert rec["device_ms"] == pytest.approx(4.6)
    assert rec["busy_ms"] == pytest.approx(3.6)   # the overlap counted once
    assert rec["by_stage"] == pytest.approx(
        {"count": 2.5, "scan": 2.0, "(no stage)": 0.1})
    callers = {tuple(r["key"]): (r["ms"], r["calls"])
               for r in rec["by_caller"]}
    assert callers == pytest.approx({
        ("count", "aten::sort"): (2.0, 1),
        ("scan", "aten::cumsum"): (2.0, 1),
        ("count", "kmer_kernel<true>"): (0.5, 1),
        ("(no stage)", "Memcpy HtoD"): (0.1, 1)})
    assert [r["key"] for r in rec["by_name"]][:2] == ["radix_sort",
                                                      "scan_kernel"]


def test_main_prints_and_writes_the_summary(tmp_path, capsys):
    events = _host_trace(tmp_path)
    sort_op = _op(events, "aten::sort")
    _device(events, 9, sort_op, sort_op["ts"] + 0.5, "radix_sort", 10.0,
            300.0)
    trace = tmp_path / "with_device.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    out = tmp_path / "summary.json"
    assert profile_trace.main([str(trace), "--json", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "1 device events, 0.3 ms summed" in printed
    assert "count / aten::sort" in printed
    assert json.loads(out.read_text())["by_stage"] == {"count": 0.3}
