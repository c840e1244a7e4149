"""Mean over the window's samples of the seconds in the port's
`scan.assemble` span (utils/metrics.span): filling each scan group's
codes and lengths on the host in `extract.scan_reference`."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "scan.assemble")
