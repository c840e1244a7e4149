"""Mean over the window's samples of the seconds in the port's
`count.upload` span (utils/metrics.span): the three uploads of each
count batch in `extract.count_kmers` (pageable copies, so the host
waits)."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "count.upload")
