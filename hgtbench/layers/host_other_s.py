"""Mean over the window's samples of the sample's wall minus the sum of
its stage walls, in seconds: the orchestration of pipeline/bkp.py outside
every stage span (reference index load, sub-reference, seed index build,
file writes)."""


def read(ctx):
    rows = [r["wall_s"] - sum(r["stages"].values())
            for r in ctx["runs"] if r["ok"]]
    return sum(rows) / len(rows) if rows else None
