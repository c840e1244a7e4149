"""The process's resident high-water mark over the window (VmHWM after
a reset at the window's start), in GiB."""


def read(ctx):
    return ctx["host_rss_peak_bytes"] / float(1 << 30)
