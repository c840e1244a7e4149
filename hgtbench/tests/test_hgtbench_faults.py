"""A run of the harness on the CPU at a tiny size (the look for a card is
the CLI's, and is skipped), with the timed path broken underneath: each
fault must turn `correct` false, and the sound program must not. The
faults a cell of this benchmark can have: a step that leaves its state
unchanged (the count step adds nothing to the tables), half of the batch
left out (every other read pair dropped as the FASTQ is read), and an
answer altered where it is produced (K1's reference end moved by one).
One card runs no exchange between cards, so that fault does not apply."""

import numpy as np
import pytest
import torch

from hgtbench import registry, run


def _correct(spec, d, cell_name, seed=2**31 + 5):
    cell = registry.Cell(spec, cell_name, d)
    workdir = d / "run"
    workdir.mkdir()
    res, nums = run.run_cell(cell, seed, 0.1, False, torch.device("cpu"),
                             str(workdir))
    return run.finish(res, nums)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sound_program_is_correct(tiny_bench):
    res = _correct(*tiny_bench, "tiny.kmer")
    assert res["correct"], res["checks"]
    assert res["checks"]["checked_runs"]["value"] == 1
    assert set(res["metrics"]) == {"pairs_per_s", "host_rss_peak_gib",
                                   "setup_s"}  # no device memory on a CPU


def test_count_step_that_leaves_the_tables_unchanged(tiny_bench,
                                                     monkeypatch):
    from localhgt_tpu_torch.ops import count
    monkeypatch.setattr(count, "run_capped_update",
                        lambda tables, s, cap: None)
    res = _correct(*tiny_bench, "tiny.kmer")
    assert not res["correct"]
    assert res["checks"]["intervals"]["value"] > 0


def test_half_of_the_pairs_left_out(tiny_bench, monkeypatch):
    from localhgt_tpu_torch.io import fastq
    orig = fastq.paired_batches

    def half(fq1, fq2, **kw):
        for b1, b2 in orig(fq1, fq2, **kw):
            keep = np.arange(0, b1.n, 2)
            yield (fastq.ReadBatch(b1.codes[keep], b1.lengths[keep],
                                   b1.start_ordinal),
                   fastq.ReadBatch(b2.codes[keep], b2.lengths[keep],
                                   b2.start_ordinal))

    monkeypatch.setattr(fastq, "paired_batches", half)
    res = _correct(*tiny_bench, "tiny.direct")
    assert not res["correct"]
    assert res["checks"]["alignments"]["value"] > 0


def test_k1_answer_altered_where_it_is_produced(tiny_bench, monkeypatch):
    from localhgt_tpu_torch.ops import cuda_sw
    orig = cuda_sw.sw_align

    def moved(q, r, **kw):
        out = orig(q, r, **kw).clone()
        out[:, 4] += 1  # rend
        return out

    moved.shapes = orig.shapes  # the counter the harness reads
    monkeypatch.setattr(cuda_sw, "sw_align", moved)
    res = _correct(*tiny_bench, "tiny.direct")
    assert not res["correct"]
    assert res["checks"]["alignments"]["value"] > 0
