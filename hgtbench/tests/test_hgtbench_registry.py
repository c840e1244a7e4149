"""A cell, its configuration, its traffic and its metrics are found by
name: adding them takes files and entries only."""

import json

from hgtbench import registry


def test_the_benchmark_files_load():
    spec = registry.load_spec()
    for w in spec["workloads"]:
        cell = registry.Cell(spec, w["name"])
        assert cell.end_to_end and cell.per_layer
        assert {m["name"] for m, _ in cell.end_to_end} >= {"setup_s"}
        for m in spec["per_layer"]:
            assert (w["name"] in m["workloads"]) == any(
                m["name"] == n["name"] for n, _ in cell.per_layer)


def test_a_new_config_traffic_and_metric_are_found_by_name(tiny_bench):
    spec, d = tiny_bench
    (d / "configs" / "extra.json").write_text(json.dumps({"k": 21}))
    (d / "traffic" / "burst.json").write_text(json.dumps({"depth": 9}))
    (d / "layers" / "new.metric.py").write_text(
        "def read(ctx):\n    return ctx['window_s'] * 2\n")
    spec["workloads"].append({"name": "extra.burst", "config": "extra",
                              "traffic": "burst", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "new.metric", "unit": "s",
                              "better": "lower", "source": "host_clock",
                              "layer": "x", "moves": "pairs_per_s",
                              "workloads": ["extra.burst"]})
    cell = registry.Cell(spec, "extra.burst", d)
    assert cell.config == {"k": 21} and cell.traffic == {"depth": 9}
    readers = dict((m["name"], r) for m, r in cell.per_layer)
    assert readers["new.metric"]({"window_s": 1.5}) == 3.0
    other = registry.Cell(spec, "tiny.kmer", d)
    assert "new.metric" not in {m["name"] for m, _ in other.per_layer}


def test_each_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    spec = registry.load_spec()
    for w in spec["workloads"]:
        cell = registry.Cell(spec, w["name"])
        reported = {m["name"] for m, _ in cell.end_to_end}
        for m, _ in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
