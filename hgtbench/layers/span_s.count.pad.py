"""Mean over the window's samples of the seconds in the port's `count.pad`
span (utils/metrics.span): `accept_mask` and `_pad_read_batch` of each
count batch in `extract.count_kmers`."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "count.pad")
