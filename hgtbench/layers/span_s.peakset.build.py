"""Mean over the window's samples of the seconds in the port's
`peakset.build` span (utils/metrics.span): the chunk loop of
`peaks.build_direct_map`: host fill, uploads and `_build_map_chunk`."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "peakset.build")
