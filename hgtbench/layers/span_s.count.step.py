"""Mean over the window's samples of the seconds in the port's `count.step`
span (utils/metrics.span): `count.count_reads_step` of each count batch:
the host's dispatch of the count step, with any wait inside it."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "count.step")
