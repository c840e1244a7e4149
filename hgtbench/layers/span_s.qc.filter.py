"""Mean over the window's samples of the seconds in the port's
`qc.filter` span (utils/metrics.span) in `io/qc.py::refine_fastq`:
the trims to each pair's insert, the quality bytes gathered,
fastp's filter (`_passes`) and the counts."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "qc.filter")
