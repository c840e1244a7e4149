"""Mean over the window's samples of the seconds in the port's
`scan.stitch` span (utils/metrics.span): copying each scanned row into
its contig's good and peak masks in `extract.scan_reference`."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "scan.stitch")
