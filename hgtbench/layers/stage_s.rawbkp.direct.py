"""The reading of layers/stage_s.rawbkp.py
in the direct-mode cell. There the window's rate is not an end-to-end
metric, so this reading moves `setup_s`, whose warm-up `bkp` runs the
same stages on a pool sample (PERF.md section 3)."""

from pathlib import Path

from hgtbench.registry import load_reader

read = load_reader(Path(__file__).with_name("stage_s.rawbkp.py"))
