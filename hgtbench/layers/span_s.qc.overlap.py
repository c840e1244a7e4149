"""Mean over the window's samples of the seconds in the port's
`qc.overlap` span (utils/metrics.span) in `io/qc.py::refine_fastq`:
the four uploads, the read 1 x revcomp(read 2) scan
(`_overlap_insert`, plain torch on the card) and the copy back of the
inserts, with its wait on the card."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "qc.overlap")
