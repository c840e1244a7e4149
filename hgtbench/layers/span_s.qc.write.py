"""Mean over the window's samples of the seconds in the port's
`qc.write` span (utils/metrics.span) in `io/qc.py::refine_fastq`:
`_write_records` of both mates' kept records."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "qc.write")
