"""Mean over the window's samples of the seconds in the port's `write` span
(utils/metrics.span): pipeline/bkp.py's file writes: the interval and
bed files and `<sample>.acc.csv`. In the direct-mode cell it moves
`setup_s` (PERF.md section 3)."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "write")
