"""`event` on the port is run-to-run deterministic when the cohort exceeds
pop_sample, on the fixture of tests/test_event_determinism.py: the
reference's ambiguity check subsamples the cohort with an unseeded shuffle
(infer_HGT_event.py:258); the JAX package seeds it, and the port keeps its
seed. Two runs of the port write the same bytes, and those are the JAX
package's bytes."""

import os

from localhgt_tpu.config import EventConfig as JaxEventConfig
from localhgt_tpu.pipeline.event import detect_event as jax_detect_event
from localhgt_tpu_torch.config import EventConfig
from localhgt_tpu_torch.pipeline.event import detect_event

from test_event_determinism import _write_fixture


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_event_output_identical_across_runs_and_to_jax(tmp_path):
    d = str(tmp_path)
    ref = _write_fixture(d)
    kw = dict(min_split_reads=2, min_hgt_len=100, pop_sample=4)
    outs = [os.path.join(d, f"e{i}.csv") for i in range(3)]
    detect_event(ref, d, outs[0], EventConfig(**kw))
    detect_event(ref, d, outs[1], EventConfig(**kw))
    jax_detect_event(ref, d, outs[2], JaxEventConfig(**kw))
    got = _bytes(outs[0])
    assert got.startswith(b"sample,receptor,insert_locus,")
    assert _bytes(outs[1]) == got
    assert _bytes(outs[2]) == got
