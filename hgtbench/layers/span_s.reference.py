"""Mean over the window's samples of the seconds in the port's `reference`
span (utils/metrics.span): `reference.build` in pipeline/bkp.py: the
reference's index, parsed again for every sample."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "reference")
