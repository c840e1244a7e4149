"""Port parity of tools/validate_events.py. The port aligns every read of
a junction, both orientations, in one K1 call with the queries
right-padded by code 4; the JAX tool makes one call per read and
orientation. Results are compared exactly.

The JAX tool on the CPU runs the lax.scan K1, which breaks start
coordinate ties differently from the Pallas kernel and the port (ROADMAP
F1); where a per-read row of the two differs, the port's row is held to
the O(MN) oracle sw.sw_align_np instead. A small flank (64) and min_span
(40) keep the JAX tool's per-read calls small on the CPU."""

import csv

import numpy as np
import pytest
import torch

from localhgt_tpu.io import fasta
from localhgt_tpu.ops import coder
from localhgt_tpu.ops import sw as jax_sw
from localhgt_tpu.sim.simulate import SimParams, read_truth, simulate_sample
from localhgt_tpu.tools import validate_events as jax_validate
from localhgt_tpu_torch.ops import cuda_sw
from localhgt_tpu_torch.tools import validate_events

FLANK, MIN_SPAN, READ_LEN = 64, 40, 120


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions are many small torch ops: one intra-op thread
    keeps them from spinning against the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_long_reads(path, contigs, truth, flank, read_len, seed):
    """Reads cut across both junctions of every truth event (1%
    substitutions, half reverse-complemented), plus as many reads from
    random reference windows."""
    rng = np.random.default_rng(seed)
    reads = []
    for t in truth:
        for j in jax_validate.reconstruct_junctions(
                contigs, t.receptor, t.insert_locus, t.donor, t.seg_start,
                t.seg_end, t.reverse, flank):
            lo = (len(j) - read_len) // 2 + int(rng.integers(-4, 5))
            rd = j[lo:lo + read_len].copy()
            sub = rng.random(len(rd)) < 0.01
            rd[sub] = (rd[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
            reads.append(coder.COMPLEMENT[rd][::-1] if rng.random() < 0.5
                         else rd)
    for _ in range(len(reads)):
        cid = int(rng.integers(1, contigs.n + 1))
        p = int(rng.integers(0, contigs.length_of(cid) - read_len))
        reads.append(contigs.slice_codes(cid, p, p + read_len))
    with open(path, "w") as f:
        for i, rd in enumerate(reads):
            seq = "".join("ACGTN"[c] for c in rd)
            f.write(f"@lr{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    return reads


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    out = tmp_path_factory.mktemp("validate")
    pa = SimParams(n_genomes=4, genome_len=20_000, hgt_num=3, depth=1,
                   seed=21)
    ref, _, _, truth_path = simulate_sample(str(out), "v", pa)
    truth = read_truth(truth_path)
    contigs = fasta.read_fasta(ref)
    events = out / "events.csv"
    with open(events, "w") as f:
        f.write("sample,receptor,insert_locus,donor,delete_start,"
                "delete_end,reverse_flag\n")
        for t in truth:
            f.write(f"v,{t.receptor},{t.insert_locus},{t.donor},"
                    f"{t.seg_start},{t.seg_end},{t.reverse}\n")
        # an event no read supports: the first truth event moved
        t = truth[0]
        f.write(f"v,{t.receptor},{t.insert_locus + 3000},{t.donor},"
                f"{t.seg_start + 2000},{t.seg_end + 2000},{t.reverse}\n")
    lr = out / "lr.fq"
    reads = _write_long_reads(lr, contigs, truth, FLANK, READ_LEN, 22)
    return ref, str(events), str(lr), contigs, truth, reads


def test_validate_matches_jax(fixture):
    ref, events, lr, _, truth, _ = fixture
    got = validate_events.validate(ref, events, lr, "cpu", min_span=MIN_SPAN,
                                   flank=FLANK)
    want = jax_validate.validate(ref, events, lr, min_span=MIN_SPAN,
                                 flank=FLANK)
    assert [r["validated"] for r in got] == [True] * len(truth) + [False]
    assert got == want


def test_batched_k1_rows_match_jax_per_read_calls(fixture):
    """The port's one padded call per junction against the JAX tool's
    per-read calls, row by row; a row that differs (an F1 tie) must equal
    the oracle."""
    _, _, _, contigs, truth, reads = fixture
    t = truth[0]
    for j in jax_validate.reconstruct_junctions(
            contigs, t.receptor, t.insert_locus, t.donor, t.seg_start,
            t.seg_end, t.reverse, FLANK):
        qs = [q[: len(j)] for rd in reads
              for q in (rd, coder.COMPLEMENT[rd][::-1])]
        Q = np.full((len(qs), max(map(len, qs))), 4, np.uint8)
        for i, q in enumerate(qs):
            Q[i, : len(q)] = q
        got = cuda_sw.sw_align(
            torch.from_numpy(Q),
            torch.from_numpy(np.ascontiguousarray(
                np.broadcast_to(j, (len(qs), len(j)))))).numpy()
        for q, row in zip(qs, got):
            want = jax_sw.sw_align_tiled(q[None], j[None])
            want = tuple(int(want[f][0]) for f in jax_sw._FIELDS)
            if tuple(row) != want:
                assert tuple(row) == jax_sw.sw_align_np(q, j)


def test_junction_support_counts_each_read_once(fixture):
    """A read counts once even when both of its orientations pass, and a
    read shorter than 2 x min_span is skipped."""
    _, _, _, contigs, truth, reads = fixture
    t = truth[0]
    j1, _ = jax_validate.reconstruct_junctions(
        contigs, t.receptor, t.insert_locus, t.donor, t.seg_start, t.seg_end,
        t.reverse, FLANK)
    mid = len(j1) // 2
    fwd = j1[mid - 50:mid + 50].copy()
    palin = np.concatenate([fwd, coder.COMPLEMENT[fwd][::-1]])
    n = validate_events.junction_support(
        [fwd, palin, fwd[:70]], j1, "cpu", min_span=MIN_SPAN)
    assert n == 2


@pytest.mark.parametrize("pad", [(0, 9), (13, 0), (7, 40)])
def test_right_padding_with_code_4_leaves_k1_unchanged(pad):
    """The batched tool pads queries to one width with code 4: every K1
    field stays as it is (plain version; planted and tie-heavy rows)."""
    rng = np.random.default_rng(sum(pad))
    B, M, N = 96, 40, 72
    alpha = np.where(np.arange(B) % 2 == 0, 2, 4)[:, None]
    q = (rng.integers(0, 4, (B, M)) % alpha).astype(np.uint8)
    r = (rng.integers(0, 4, (B, N)) % alpha).astype(np.uint8)
    for b in range(0, B, 3):
        off = int(rng.integers(0, N - M))
        r[b, off:off + M] = q[b]
    q[rng.random(q.shape) < 0.02] = 4
    qp = np.pad(q, ((0, 0), (0, pad[0])), constant_values=4)
    rp = np.pad(r, ((0, 0), (0, pad[1])), constant_values=4)
    want = cuda_sw.sw_align(torch.from_numpy(q), torch.from_numpy(r))
    got = cuda_sw.sw_align(torch.from_numpy(qp), torch.from_numpy(rp))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (want[:, 0] > 0).all()


def test_main_at_the_default_flank(fixture, tmp_path, capsys):
    """The CLI at flank 500: junctions of up to 1,000 columns, the width of
    K1's wide-reference variant on the card (plain version here)."""
    ref, events, _, contigs, truth, _ = fixture
    lr = tmp_path / "lr.fq"
    _write_long_reads(lr, contigs, truth[:1], 500, 600, 23)
    out = tmp_path / "validated.csv"
    validate_events.main(["-r", ref, "-e", events, "--long-reads", str(lr),
                          "-o", str(out), "--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith(
        "events validated")
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert rows[0]["validated"] == "True"
    assert all(r["validated"] == "False" for r in rows[1:])
