"""The trace reduction: union, window clipping, idle gaps by stage, and
the interval arithmetic against the port's profile_trace.py."""

import numpy as np
import pytest

from hgtbench import trace
from localhgt_tpu_torch import profile_trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_union_equals_the_port():
    rng = np.random.default_rng(0)
    iv = [(float(a), float(a + d)) for a, d in
          zip(rng.integers(0, 1000, 200), rng.integers(0, 30, 200))]
    assert trace.union_us(iv) == profile_trace.union_us(iv)


def test_summarize_clips_to_the_window_and_labels_gaps():
    events = [
        _ev("user_annotation", trace.WINDOW_SPAN, 100, 1000),
        _ev("user_annotation", "hgtbench.sample", 100, 1000),
        _ev("user_annotation", "count", 100, 400),
        _ev("user_annotation", "align", 600, 300),
        _ev("kernel", "k_a", 50, 100),      # clipped to [100, 150)
        _ev("kernel", "k_a", 200, 100),
        _ev("kernel", "k_b", 250, 100),     # overlaps k_a: union 200-350
        _ev("gpu_memcpy", "copy", 700, 50),
        _ev("kernel", "late", 1200, 10),    # after the window
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((50 + 150 + 50) * 1e-6)
    assert s["by_name"] == pytest.approx({"k_a": 150e-6, "k_b": 100e-6,
                                          "copy": 50e-6})
    idle = dict(s["idle_by_stage"])
    # count [100, 500): idle 150-200 and 350-500; 500-600 outside; align
    # [600, 900): idle 600-700 and 750-900; 900-1100 outside
    assert idle["count"] == pytest.approx(200e-6)
    assert idle["align"] == pytest.approx(250e-6)
    assert idle[trace.OUTSIDE] == pytest.approx(300e-6)
    assert sum(idle.values()) + s["busy_s"] == pytest.approx(s["window_s"])


def test_summarize_without_a_window_reads_nothing():
    assert trace.summarize([_ev("kernel", "k", 0, 5)]) is None
