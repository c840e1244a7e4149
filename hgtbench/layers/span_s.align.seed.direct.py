"""Mean over the window's samples of the seconds in the port's `align.seed`
span (utils/metrics.span): host seeding in `align.align_batch`:
`native.seed_hits`, `_group_candidates` and the candidates' order. In
the direct-mode cell it moves `setup_s` (PERF.md section 3)."""

from hgtbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "align.seed")
