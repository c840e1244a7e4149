"""Mean over the window's samples of the seconds in the port's
`scan.device` span (utils/metrics.span): `scan_rows` and the copies of
its masks back in `extract.scan_reference`: the host waiting on the
scan's device work."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "scan.device")
