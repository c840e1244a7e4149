"""Mean over the window's samples of the seconds in the port's
`qc.parse` span (utils/metrics.span) in `io/qc.py::refine_fastq`:
each advance of `_read_batches`, the blob reads, the newline
search and the joining of records across blobs."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "qc.parse")
