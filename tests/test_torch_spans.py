"""utils/metrics.span, the benchmark's readers of the spans
(hgtbench/layers/span_s.*.py) and their entries in BENCHMARK.json.

A span adds its wall to the counter `<name>_s` and is a record_function
under the profiler; it never reaches the stage walls. Each reader is the
mean of one span's counter over the window's ok samples, None where no
sample recorded it (a program without the span)."""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hgtbench import registry
from localhgt_tpu_torch.utils import metrics

# the spans each cell's metrics read, by cell
CELL_SPANS = {
    "sim100_k32.cohort_d5": (
        "reference", "subref", "seed_index", "write", "count.parse",
        "count.pad", "count.upload", "count.step", "scan.assemble",
        "scan.device", "scan.stitch", "scan.finalize", "peakset.flatten",
        "peakset.build", "align.seed", "align.sw"),
    "species20_direct.cohort_d5": (
        "reference", "seed_index", "write", "align.parse", "align.seed",
        "align.sw"),
    "sim100_k32_qc.raw_d5": (
        "qc.parse", "qc.encode", "qc.overlap", "qc.filter", "qc.write"),
}
# the end-to-end metric each cell's span metrics move: the window's rate
# where it is one, else `setup_s`, whose warm-up `bkp` runs the same spans
CELL_MOVES = {
    "sim100_k32.cohort_d5": "pairs_per_s",
    "species20_direct.cohort_d5": "setup_s",
    "sim100_k32_qc.raw_d5": "setup_s",
}
# metric name -> (its cell, the span it reads)
METRICS = {
    f"span_s.{span}" + (".direct" if "direct" in cell else ""): (cell, span)
    for cell, spans in CELL_SPANS.items() for span in spans}
ALL_SPANS = sorted({s for spans in CELL_SPANS.values() for s in spans})


@pytest.fixture(autouse=True)
def _clean_registry():
    metrics.reset()
    yield
    metrics.reset()


def test_span_adds_its_wall_to_a_counter_and_no_stage_wall():
    with metrics.span("a"):
        time.sleep(0.01)
    assert metrics.counters()["a_s"] >= 0.01
    assert metrics.stage_walls() == {} and metrics.stage_rss() == {}


def test_nested_spans_each_add_their_own_wall():
    with metrics.span("outer"):
        time.sleep(0.005)
        with metrics.span("inner"):
            time.sleep(0.01)
    c = metrics.counters()
    assert c["inner_s"] >= 0.01
    assert c["outer_s"] >= c["inner_s"] + 0.005


def test_spans_of_one_name_add_up_until_reset():
    for _ in range(3):
        with metrics.span("rep"):
            time.sleep(0.004)
    assert metrics.counters()["rep_s"] >= 0.012
    metrics.reset()
    assert "rep_s" not in metrics.counters()


def test_span_keeps_its_time_when_the_body_raises():
    with pytest.raises(ValueError):
        with metrics.span("bad"):
            time.sleep(0.005)
            raise ValueError("x")
    assert metrics.counters()["bad_s"] >= 0.005


def test_spans_inside_a_stage_leave_its_wall_and_rss_alone():
    with metrics.stage("count"):
        with metrics.span("count.parse"):
            time.sleep(0.005)
        with metrics.span("count.step"):
            pass
    assert set(metrics.stage_walls()) == {"count"}
    assert set(metrics.stage_rss()) == {"count"}
    assert set(metrics.counters()) == {"count.parse_s", "count.step_s"}
    assert metrics.current_stage() == ""


def test_spanned_times_each_advance_and_keeps_the_items():
    def slow():
        for i in range(3):
            time.sleep(0.004)
            yield i

    got = []
    for i in metrics.spanned("gen", slow()):
        time.sleep(0.02)  # the loop body is not the span's
        got.append(i)
    assert got == [0, 1, 2]
    assert 0.012 <= metrics.counters()["gen_s"] < 0.06
    assert list(metrics.spanned("empty", [])) == []
    assert "empty_s" in metrics.counters()


def test_span_is_a_user_annotation_on_the_profiler_trace(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.stage("scan"):
            with metrics.span("scan.device"):
                torch.arange(1024).cumsum(0)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    ev = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("cat") == "user_annotation"}
    st, sp = ev["scan"], ev["scan.device"]
    assert st["ts"] <= sp["ts"] and sp["ts"] + sp["dur"] <= st["ts"] + st[
        "dur"]


def _ctx(runs):
    return {"runs": runs, "window_s": 1.0}


def _reader(name):
    return registry.load_reader(registry.BENCH_DIR / "layers" / f"{name}.py")


def test_every_span_metric_has_its_reader_and_entry():
    spec = registry.load_spec()
    names = {m["name"] for m in spec["per_layer"]
             if m["name"].startswith("span_s.")}
    files = {p.stem for p in (registry.BENCH_DIR / "layers").glob(
        "span_s.*.py")}
    assert names == files == set(METRICS)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reader_is_the_mean_of_its_span_over_ok_samples(name):
    _, span = METRICS[name]
    # every span a distinct value, so a reader of the wrong span misreads
    base = {f"{s}_s": 10.0 * (i + 1) for i, s in enumerate(ALL_SPANS)}
    want = base[f"{span}_s"]
    runs = [
        {"ok": True, "counters": {**base, f"{span}_s": want - 1.0}},
        {"ok": True, "counters": {**base, f"{span}_s": want + 3.0}},
        {"ok": False, "counters": {**base, f"{span}_s": 1e6}},
        {"ok": True, "counters": {k: v for k, v in base.items()
                                  if k != f"{span}_s"}},
    ]
    assert _reader(name)(_ctx(runs)) == pytest.approx(want + 1.0)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reader_reads_nothing_where_no_sample_has_its_span(name):
    _, span = METRICS[name]
    read = _reader(name)
    # the parent's program records stage walls and counters, no span
    parent = {"n_pairs": 5.0, "subref_bp": 1e5, "count_batches": 52.0}
    assert read(_ctx([{"ok": True, "counters": parent}] * 2)) is None
    assert read(_ctx([{"ok": False, "counters": {f"{span}_s": 2.0}}])) is None
    assert read(_ctx([])) is None


@pytest.mark.parametrize("name", sorted(METRICS))
def test_registry_loads_each_span_metric_for_its_cell_only(name):
    spec = registry.load_spec()
    cell, span = METRICS[name]
    entry = next(m for m in spec["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [cell]
    assert (entry["source"], entry["unit"], entry["better"]) == (
        "program_span", "s", "lower")
    assert entry["moves"] == CELL_MOVES[cell]
    # the layer text of the stage the span sits in; orchestration's
    # outside every stage
    family = span.split(".")[0] if "." in span else None
    stage = "host_other_s" if family is None else f"stage_s.{family}"
    layer_of = {m["name"]: m["layer"] for m in spec["per_layer"]}
    assert entry["layer"] == layer_of[stage]
    for w in spec["workloads"]:
        loaded = {m["name"]: r
                  for m, r in registry.Cell(spec, w["name"]).per_layer}
        assert (name in loaded) == (w["name"] == cell)
        if name in loaded:
            ctx = _ctx([{"ok": True, "counters": {f"{span}_s": 0.25}}])
            assert loaded[name](ctx) == 0.25
