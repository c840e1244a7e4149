"""The port's QC (`io/qc.py::refine_fastq`, `bkp --refine_fq 1`) against
the benchmark's plain reference (hgtbench/plainref/io/qc.py, fastp's
rules written plainly) on the CPU, on raw samples from the benchmark's
generator (4 x 20 kb at depth 5, with adapter read-through and
low-quality mates planted by `sim.Planting`): the refined files are
byte-equal and the counts equal, and the overlap scan's counters are what
the batch sizes give. Then the QC cell's entries in BENCHMARK.json."""

from pathlib import Path

import pytest
import torch

from hgtbench import cohort, registry
from hgtbench.plainref.io import qc as plain_qc
from localhgt_tpu_torch.io import qc

CONFIG = {"n_genomes": 4, "genome_len": 20_000}
RAW = {"depth": 5, "hgt_num": 2, "pool": 1, "adapter_frac": 0.05,
       "adapter_insert": "60-140", "lowq_frac": 0.02}
SEEDS = (2**31 + 41, 5_000_000_007)
CELL = "sim100_k32_qc.raw_d5"
QC_SPANS = ("qc.parse", "qc.encode", "qc.overlap", "qc.filter", "qc.write")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The overlap scans are many small torch ops: one intra-op thread
    keeps them from spinning against the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """seed -> (fq1, fq2, the plain reference's QCStats and refined
    bytes), each seed made and refined once."""
    d = tmp_path_factory.mktemp("qc_plainref")
    made = {}

    def get(seed):
        if seed not in made:
            s = cohort.make(str(d / str(seed)), CONFIG, RAW, seed).pool[0]
            out = [str(d / f"{seed}_plain_{m}.fq") for m in (1, 2)]
            st = plain_qc.refine_fastq(s.fq1, s.fq2, *out,
                                       torch.device("cpu"))
            made[seed] = (s.fq1, s.fq2, st,
                          [Path(p).read_bytes() for p in out])
        return made[seed]

    return get


def _port(tmp_path, fq1, fq2, **kw):
    out = [str(tmp_path / f"port_{m}.fq") for m in (1, 2)]
    st = qc.refine_fastq(fq1, fq2, *out, torch.device("cpu"), **kw)
    return st, [Path(p).read_bytes() for p in out]


@pytest.mark.parametrize("batch", [qc.BATCH_PAIRS, 257])
@pytest.mark.parametrize("seed", SEEDS)
def test_refined_files_equal_the_plain_reference(sample, tmp_path, seed,
                                                  batch):
    fq1, fq2, want, want_bytes = sample(seed)
    got, got_bytes = _port(tmp_path, fq1, fq2, batch=batch)
    # the planting reaches both of QC's rules
    assert want.adapter_trimmed > 0 and want.pairs_out < want.pairs_in
    for k in ("pairs_in", "pairs_out", "adapter_trimmed", "bases_in",
              "bases_out"):
        assert getattr(got, k) == getattr(want, k), k
    assert got_bytes == want_bytes


def _expected_counters(fq1, fq2, batch):
    """(batches, overlap_blocks, overlap_cells) from the batch sizes: per
    batch of B pairs at width L (the longest read of either mate, to a
    multiple of 32), ceil((2(L - 30) + 1) / step) blocks, step =
    max(1, SCAN_ELEMENTS // (B L)), and B (2(L - 30) + 1) L cells."""
    r1, r2 = plain_qc.read_records(fq1), plain_qc.read_records(fq2)
    n = min(len(r1), len(r2))
    batches = blocks = cells = 0
    for lo in range(0, n, batch):
        B = min(batch, n - lo)
        L = max(len(r[1]) for r in r1[lo:lo + B] + r2[lo:lo + B])
        L = -(-L // 32) * 32
        offsets = 2 * (L - qc.OVERLAP_REQUIRE) + 1
        step = max(1, qc.SCAN_ELEMENTS // (B * L))
        batches += 1
        blocks += -(-offsets // step)
        cells += B * offsets * L
    return batches, blocks, cells


def test_a_full_batch_of_150_bp_pairs_scans_22_blocks():
    assert len(qc._offset_blocks(qc.BATCH_PAIRS, 160)) == 22
    assert len(qc._offset_blocks(1, 160)) == 1


@pytest.mark.parametrize("batch,scan_elements", [
    (qc.BATCH_PAIRS, qc.SCAN_ELEMENTS), (257, 1 << 20), (500, 1 << 21)])
@pytest.mark.parametrize("seed", SEEDS)
def test_overlap_counters_follow_the_batch_sizes(sample, tmp_path,
                                                 monkeypatch, seed, batch,
                                                 scan_elements):
    fq1, fq2, _, want_bytes = sample(seed)
    monkeypatch.setattr(qc, "SCAN_ELEMENTS", scan_elements)
    got, got_bytes = _port(tmp_path, fq1, fq2, batch=batch)
    want = _expected_counters(fq1, fq2, batch)
    assert (got.batches, got.overlap_blocks, got.overlap_cells) == want
    if scan_elements != qc.SCAN_ELEMENTS or batch != qc.BATCH_PAIRS:
        assert got.overlap_blocks > got.batches  # offsets in several blocks
    # the blocks do not move the files
    assert got_bytes == want_bytes


def test_the_qc_cell_loads_with_its_end_to_end_and_layer_metrics():
    spec = registry.load_spec()
    cell = registry.Cell(spec, CELL)
    assert cell.chips == 1
    assert cell.config["refine_fq"] == 1 and cell.traffic["adapter_frac"] > 0
    # sim100_k32 with QC: every other number as it is there
    base = registry.Cell(spec, "sim100_k32.cohort_d5").config
    assert {k: v for k, v in cell.config.items()
            if isinstance(v, (int, float)) and k != "refine_fq"} == {
        k: v for k, v in base.items()
        if isinstance(v, (int, float)) and k != "refine_fq"}
    assert cell.config["reduced"] == base["reduced"] == ["n_genomes"]
    reported = {m["name"] for m, _ in cell.end_to_end}
    assert reported == {"host_rss_peak_gib", "device_mem_peak_gib",
                        "setup_s"}
    layers = {m["name"]: m for m, _ in cell.per_layer}
    assert set(layers) == {"pairs_per_s.qc", "stage_s.qc",
                           *(f"span_s.{s}" for s in QC_SPANS)}
    for m in layers.values():
        assert m["moves"] in reported and m["workloads"] == [CELL]
    readers = dict((m["name"], r) for m, r in cell.per_layer)
    ctx = {"window_s": 4.0, "runs": [
        {"ok": True, "pairs": 10, "stages": {"qc": 1.0, "count": 9.0}},
        {"ok": True, "pairs": 6, "stages": {"qc": 2.0}},
        {"ok": False, "pairs": 99, "stages": {"qc": 90.0}}]}
    assert readers["stage_s.qc"](ctx) == 1.5
    assert readers["pairs_per_s.qc"](ctx) == 4.0
