"""Seconds from process start to the window's start: the CUDA context,
the inputs made from the seed, and the warm-up `bkp` of the first pool
sample, which loads (in a fresh checkout builds) the kernel libraries."""


def read(ctx):
    return ctx["setup_s"]
