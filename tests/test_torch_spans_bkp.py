"""The spans of the port's `bkp` (utils/metrics.span) on the CPU, on the
bench's small fixture (4 x 20 kb, k=18), in the k-mer path, in the k-mer
path after QC (`refine_fq`) and in direct mode, each run once under a
CPU-only torch.profiler: the run records every span its mode reaches;
each family of spans sums to no more than its stage's wall, and the
orchestration's spans to no more than the sample's wall outside every
stage; on the trace each span is a user_annotation inside its stage's,
or outside every stage for the orchestration's, and its summed duration
agrees with its counter."""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from localhgt_tpu_torch.config import Config, KmerConfig
from localhgt_tpu_torch.pipeline.bkp import detect_breakpoint
from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample
from localhgt_tpu_torch.utils import metrics

ORCHESTRATION = ("reference", "subref", "seed_index", "write")
ALIGN = ("align.parse", "align.seed", "align.sw")
MODE_SPANS = {
    "kmer": ORCHESTRATION + (
        "count.parse", "count.pad", "count.upload", "count.step",
        "scan.assemble", "scan.device", "scan.stitch", "scan.finalize",
        "peakset.flatten", "peakset.build") + ALIGN,
    "direct": ORCHESTRATION + ALIGN,
}
MODE_SPANS["qc"] = MODE_SPANS["kmer"] + (
    "qc.parse", "qc.encode", "qc.overlap", "qc.filter", "qc.write")
ALL_SPANS = {s for spans in MODE_SPANS.values() for s in spans}
CASES = [(mode, span) for mode, spans in MODE_SPANS.items()
         for span in spans]
FAMILIES = {"kmer": ("count", "scan", "peakset", "align"),
            "direct": ("align",),
            "qc": ("qc", "count", "scan", "peakset", "align")}


def _stage_of(span):
    """The stage a span sits in; None for the orchestration's."""
    return span.split(".")[0] if "." in span else None


@pytest.fixture(scope="module")
def bkp_run(tmp_path_factory):
    """mode -> {"counters", "stages", "wall_s", "events"} of one profiled
    `bkp` of the fixture, each mode run once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("spans")
    ref, fq1, fq2, _ = simulate_sample(str(d), "tiny", SimParams(
        n_genomes=4, genome_len=20_000, hgt_num=2, depth=5, snp_rate=0.01,
        seed=5))
    runs = {}

    def get(mode):
        if mode not in runs:
            metrics.reset()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                t0 = time.perf_counter()
                detect_breakpoint(
                    ref, fq1, fq2, mode, str(d), "cpu",
                    cfg=Config().replace(kmer=KmerConfig(k=18)),
                    use_kmer=mode != "direct", refine_fq=mode == "qc")
                wall = time.perf_counter() - t0
            path = d / f"{mode}.json"
            prof.export_chrome_trace(str(path))
            events = [e for e in json.loads(path.read_text())["traceEvents"]
                      if e.get("cat") == "user_annotation"]
            path.unlink()
            runs[mode] = {"counters": metrics.counters(),
                          "stages": dict(metrics._STAGES), "wall_s": wall,
                          "events": events}
            metrics.reset()
        return runs[mode]

    yield get
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", sorted(MODE_SPANS))
def test_bkp_records_every_span_its_mode_reaches(bkp_run, mode):
    run = bkp_run(mode)
    spans = {k[:-2] for k in run["counters"]
             if k.endswith("_s") and k[:-2] in ALL_SPANS}
    assert spans == set(MODE_SPANS[mode])
    assert all(run["counters"][f"{s}_s"] > 0 for s in spans)
    # a span is no stage
    assert not set(run["stages"]) & spans


@pytest.mark.parametrize("mode", sorted(MODE_SPANS))
def test_each_span_family_sums_to_no_more_than_its_stage(bkp_run, mode):
    run = bkp_run(mode)
    c = run["counters"]
    for stage in FAMILIES[mode]:
        parts = [c[f"{s}_s"] for s in MODE_SPANS[mode]
                 if _stage_of(s) == stage]
        assert parts and sum(parts) <= run["stages"][stage], stage
    outside = run["wall_s"] - sum(run["stages"].values())
    assert sum(c[f"{s}_s"] for s in ORCHESTRATION) <= outside


def _within(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("mode,span", CASES)
def test_span_is_a_user_annotation_inside_its_stage(bkp_run, mode, span):
    events = bkp_run(mode)["events"]
    mine = [e for e in events if e["name"] == span]
    assert mine
    stage = _stage_of(span)
    if stage is None:  # the orchestration's spans are outermost
        assert not any(_within(e, o) for e in mine for o in events
                       if o is not e and o["name"] != span)
    else:
        stages = [e for e in events if e["name"] == stage]
        assert all(any(_within(e, s) for s in stages) for e in mine)


@pytest.mark.parametrize("mode,span", CASES)
def test_span_trace_time_agrees_with_its_counter(bkp_run, mode, span):
    run = bkp_run(mode)
    traced = sum(e["dur"] for e in run["events"] if e["name"] == span) / 1e6
    counted = run["counters"][f"{span}_s"]
    assert abs(traced - counted) <= 0.05 * counted + 1e-3
