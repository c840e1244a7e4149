"""Mean over the window's samples of the seconds in the port's
`qc.encode` span (utils/metrics.span) in `io/qc.py::refine_fastq`:
both mates' sequence bytes gathered at the batch's width and turned
into base codes, N past each read's end."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "qc.encode")
