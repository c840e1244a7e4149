"""Mean over the window's samples of the seconds in the port's
`align.parse` span (utils/metrics.span): each advance of `raw_batches()`
in `bkp.align_reads`: the code cache on the k-mer path, the FASTQ parse
in direct mode. In the direct-mode cell it moves `setup_s` (PERF.md
section 3)."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "align.parse")
