"""Mean over the window's samples of the seconds in the port's
`scan.finalize` span (utils/metrics.span): `finalize` of each contig in
`extract.scan_reference`: good intervals, peaks in them, the max_peak
cut."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "scan.finalize")
