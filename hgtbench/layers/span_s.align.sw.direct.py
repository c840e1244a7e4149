"""Mean over the window's samples of the seconds in the port's `align.sw`
span (utils/metrics.span): the SW extension in `align.align_batch`:
window gather, reverse complement and `sw_align_tiled` (K1 with its
copies). In the direct-mode cell it moves `setup_s` (PERF.md section 3)."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "align.sw")
