"""Mean over the window's samples of the seconds in the port's
`count.parse` span (utils/metrics.span): each advance of
`fastq.iter_fastq_batches` in `extract.count_kmers`: the host waiting on
the C++ FASTQ parser."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "count.parse")
