"""The reading of end_to_end/pairs_per_s.py
in the QC cell. A window there holds two or three samples, too few for
the window's rate to be an end-to-end metric, so this reading moves
`setup_s`, whose warm-up `bkp` runs QC and the same stages on a pool
sample at its full size (PERF.md section 3)."""

from pathlib import Path

from hgtbench.registry import load_reader

read = load_reader(Path(__file__).parent.parent / "end_to_end"
                   / "pairs_per_s.py")
