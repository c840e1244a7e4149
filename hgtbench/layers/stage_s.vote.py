"""Mean wall of the port's `vote` stage span (utils/metrics.stage) over
the window's samples, in seconds."""

from hgtbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, "vote")
