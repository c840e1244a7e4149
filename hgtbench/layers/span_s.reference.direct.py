"""Mean over the window's samples of the seconds in the port's `reference`
span (utils/metrics.span): `reference.build` in pipeline/bkp.py: the
reference's index, parsed again for every sample. In the direct-mode
cell it moves `setup_s` (PERF.md section 3)."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "reference")
