"""Port parity end to end at k=24: the fixture of tests/test_pipeline_e2e.py
(20 genomes x 60 kbp, 8 HGTs, depth 8) through the JAX package's `bkp` and
`event` and through the port's on the CPU. The port's acc.csv, bed and
event CSV must be byte-equal to the JAX package's, and its output must
pass that file's gates: breakpoint recall >= 0.95 and FDR <= 0.1,
extraction recall >= 0.95, event recall >= 0.85 and FDR <= 0.15."""

import os

import pytest
import torch

from localhgt_tpu import config as jax_config
from localhgt_tpu.pipeline.bkp import detect_breakpoint as jax_bkp
from localhgt_tpu.pipeline.event import detect_event as jax_event
from localhgt_tpu_torch.config import Config, KmerConfig
from localhgt_tpu_torch.pipeline.bkp import detect_breakpoint
from localhgt_tpu_torch.pipeline.event import detect_event
from localhgt_tpu_torch.sim import evaluate
from localhgt_tpu_torch.sim.simulate import SimParams, read_truth, \
    simulate_sample
from localhgt_tpu_torch.utils import formats


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread beside the other test
    processes (tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{package: output folder} after `bkp` (k=24) and `event` of each."""
    root = tmp_path_factory.mktemp("torch_e2e")
    pa = SimParams(n_genomes=20, genome_len=60_000, hgt_num=8, depth=8,
                   snp_rate=0.01, seed=11)
    ref, fq1, fq2, truth = simulate_sample(str(root), "t1", pa)
    # each package with its own Config, so that a drift between their
    # defaults shows in the files
    jax_cfg = jax_config.Config().replace(kmer=jax_config.KmerConfig(k=24))
    cfg = Config().replace(kmer=KmerConfig(k=24))
    out = {}
    for name, bkp, event in (
            ("jax", lambda o: jax_bkp(ref, fq1, fq2, "t1", o, cfg=jax_cfg),
             jax_event),
            ("torch", lambda o: detect_breakpoint(ref, fq1, fq2, "t1", o,
                                                  "cpu", cfg=cfg),
             detect_event)):
        o = str(root / name)
        os.makedirs(o)
        bkp(o)
        event(ref, o, os.path.join(o, "events.csv"))
        out[name] = o
    out["truth"] = read_truth(truth)
    return out


@pytest.mark.parametrize("name", ["t1.acc.csv", "t1.interval.txt.bed",
                                  "events.csv"])
def test_port_writes_the_jax_packages_files(runs, name):
    with open(os.path.join(runs["jax"], name), "rb") as f:
        want = f.read()
    with open(os.path.join(runs["torch"], name), "rb") as f:
        assert f.read() == want
    assert want.count(b"\n") > 1


def test_port_passes_the_e2e_gates(runs):
    """tests/test_pipeline_e2e.py's three gates on the port's output."""
    out, truth = runs["torch"], runs["truth"]
    rows, reads_num, insert = formats.read_acc_csv(
        os.path.join(out, "t1.acc.csv"))
    assert reads_num > 0 and insert > 0
    called = [(r["from_ref"], int(r["from_pos"]), r["to_ref"],
               int(r["to_pos"])) for r in rows]
    score = evaluate.score_bkps(evaluate.truth_to_bkps(truth), called)
    assert score.recall >= 0.95 and score.fdr <= 0.1, (score, called)

    ivs = {}
    with open(os.path.join(out, "t1.interval.txt.bed")) as f:
        for line in f:
            contig, span = line.strip().split(":")
            s, e = span.split("-")
            ivs.setdefault(contig, []).append((int(s), int(e)))
    assert evaluate.extraction_recall(truth, ivs) >= 0.95

    with open(os.path.join(out, "events.csv")) as f:
        rows = [line.rstrip("\n").split(",") for line in f][1:]
    called = [(r[1], int(r[2]), r[3], int(r[4]), int(r[5])) for r in rows]
    true_events = [(t.receptor, t.insert_locus, t.donor, t.seg_start,
                    t.seg_end) for t in truth]
    recall, fdr, _ = evaluate.score_events(true_events, called)
    assert recall >= 0.85 and fdr <= 0.15, (recall, fdr, called)
