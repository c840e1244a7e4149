"""The frozen scorer against the port's sim/evaluate.py."""

import numpy as np

from hgtbench import score, sim
from localhgt_tpu_torch.sim import evaluate


def test_score_bkps_equals_the_port():
    rng = np.random.default_rng(3)
    names = ["G000_1", "G001_1", "G002_1"]
    truth = [sim.TruthEvent(names[rng.integers(3)], int(rng.integers(1000)),
                            names[rng.integers(3)], int(rng.integers(1000)),
                            int(rng.integers(1000)), False) for _ in range(20)]
    true_bkps = score.truth_to_bkps(truth)
    assert true_bkps == evaluate.truth_to_bkps(truth)
    called = [(t[0], t[1] + int(rng.integers(-80, 80)), t[2],
               t[3] + int(rng.integers(-80, 80))) for t in true_bkps[::2]]
    called += [(t[2], t[3], t[0], t[1]) for t in true_bkps[1::5]]
    mine = score.score_bkps(true_bkps, called)
    theirs = evaluate.score_bkps(true_bkps, called)
    assert round(mine["recall"], 4) == theirs.recall
    assert round(mine["fdr"], 4) == theirs.fdr
    assert (mine["n_true"], mine["n_called"]) == (theirs.n_true,
                                                  theirs.n_called)


def test_called_bkps_reads_acc_rows():
    lines = ["# reads_num: 10; insert size 350.",
             "from_ref,from_pos,from_side,from_strand,to_ref,to_pos",
             "G1_1,100,left,+,G2_1,200,right,-,False,A,A,1,1,1,1,0"]
    assert score.called_bkps(lines) == [("G1_1", 100, "G2_1", 200)]
