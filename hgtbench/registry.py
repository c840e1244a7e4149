"""Everything of one cell, found by name: the cell's entry in
BENCHMARK.json, its configuration (configs/<name>.json), its traffic mix
(traffic/<name>.json) and a reader for each of its metrics
(end_to_end/<name>.py, layers/<name>.py). A later cell or metric is added
as files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
SPEC_PATH = BENCH_DIR.parent / "BENCHMARK.json"


def load_spec(path: Path = SPEC_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(path: Path):
    """The `read(ctx)` function of a metric's reader file."""
    spec = importlib.util.spec_from_file_location(
        "hgtbench_reader_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """One `workloads` entry with its configuration, traffic and metrics.
    `end_to_end` and `per_layer` are [(metric entry, read function)] of
    the metrics this cell reports."""

    def __init__(self, spec: dict, name: str, bench_dir: Path = BENCH_DIR):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in the benchmark "
                           f"(have: {', '.join(sorted(cells))})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config = _load_json(
            bench_dir / "configs" / f"{self.entry['config']}.json")
        self.traffic = _load_json(
            bench_dir / "traffic" / f"{self.entry['traffic']}.json")
        self.end_to_end = self._readers(spec["end_to_end"],
                                        bench_dir / "end_to_end")
        self.per_layer = self._readers(spec["per_layer"],
                                       bench_dir / "layers")

    def _readers(self, metrics: list, folder: Path) -> list:
        return [(m, load_reader(folder / f"{m['name']}.py")) for m in metrics
                if self.name in m.get("workloads", [self.name])]
