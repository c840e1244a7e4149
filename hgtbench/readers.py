"""Arithmetic the metric readers (end_to_end/*.py, layers/*.py) share.
Each reader is `read(ctx) -> float | None` over the context run.py hands
it: "runs" (one dict a sample of the window: "pairs", "wall_s", "ok",
"stages" {stage: s}, "counters"), "window_s", "setup_s",
"host_rss_peak_bytes", "device_mem_peak_bytes", "sw_shapes"
{"sw_align"|"sw_score": {(B, M, N): launches}} and, in a traced run,
"trace" (trace.summarize's dict). None means nothing to read: the metric
is left out of the result."""

from __future__ import annotations


def stage_mean(ctx: dict, stage: str) -> float | None:
    """Mean wall of `stage` over the window's samples; None where no
    sample ran it."""
    walls = [r["stages"][stage] for r in ctx["runs"]
             if r["ok"] and stage in r["stages"]]
    return sum(walls) / len(walls) if walls else None
