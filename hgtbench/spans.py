"""The reading the span metrics (layers/span_s.*.py) share: the seconds
of one of the port's spans (`utils/metrics.span`), which the port adds to
its counter registry as `<span>_s` and run.py copies into each sample's
"counters"."""

from __future__ import annotations


def span_mean(ctx: dict, span: str) -> float | None:
    """Mean over the window's samples of the seconds a sample spent in
    `span` (summed over the sample's spans of that name); None where no
    sample recorded it, as a program without the span records nothing."""
    key = span + "_s"
    vals = [r["counters"][key] for r in ctx["runs"]
            if r["ok"] and key in r.get("counters", {})]
    return sum(vals) / len(vals) if vals else None
