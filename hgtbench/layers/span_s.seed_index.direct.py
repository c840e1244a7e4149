"""Mean over the window's samples of the seconds in the port's `seed_index`
span (utils/metrics.span): `align.SeedIndex.build` in pipeline/bkp.py:
the host seed index of the sub-reference. In the direct-mode cell it
moves `setup_s` (PERF.md section 3)."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "seed_index")
