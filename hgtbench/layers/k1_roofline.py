"""K1 (`sw_align`, csrc/sw.cu) over the window: the bound of every launch
(hgtbench/roofline.py, from the shapes `cuda_sw.sw_align.shapes` counted)
over the kernel's device time in the trace, in %."""

from hgtbench import roofline


def read(ctx):
    if ctx["trace"] is None:
        return None
    return roofline.share_pct("sw_align", ctx["sw_shapes"]["sw_align"],
                              ctx["trace"]["by_name"])
