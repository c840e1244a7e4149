"""Read pairs of every sample completed in the window over the window's
wall, from the first sample's start to the last one's end."""


def read(ctx):
    pairs = sum(r["pairs"] for r in ctx["runs"] if r["ok"])
    return pairs / ctx["window_s"] if pairs else None
