"""torch.cuda.max_memory_allocated over the window, in GiB."""


def read(ctx):
    b = ctx["device_mem_peak_bytes"]
    return b / float(1 << 30) if b else None
