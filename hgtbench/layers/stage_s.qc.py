"""Mean wall of the port's `qc` stage span (utils/metrics.stage, around
`io/qc.py::refine_fastq`, `bkp --refine_fq 1`) over the window's
samples, in seconds."""

from hgtbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, "qc")
