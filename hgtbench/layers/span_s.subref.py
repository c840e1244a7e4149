"""Mean over the window's samples of the seconds in the port's `subref`
span (utils/metrics.span): `align.build_subref` in pipeline/bkp.py: the
sub-reference cut from the intervals (the whole reference in direct
mode)."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "subref")
