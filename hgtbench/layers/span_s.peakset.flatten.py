"""Mean over the window's samples of the seconds in the port's
`peakset.flatten` span (utils/metrics.span): `_flatten_members` in
`peaks.build_direct_map`."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "peakset.flatten")
