"""A cell's inputs, made from the run's seed: the shared reference and
the pool of samples that the warm-up and the window cycle through,
written under a temporary directory.

Each sample's HGTs and mutations come from one rng stream of the seed, as
in the port's simulator; its reads are drawn CHUNK_CONTIGS contigs at a
time, each chunk from a stream of its own, in child processes, so that
set-up takes a fraction of one core's time for a sample. The read model
and the FASTQ bytes of a chunk are the port simulator's
(tests/test_hgtbench_sim.py).

Every seed draws the same sizes: the genome lengths and the HGT lengths
come from a stream that no seed changes (`fixed_sizes`), and the seed
only decides which genome gets which length and in which order a
sample's HGTs take theirs. So the reference has the same length and a
sample the same number of pairs and of transferred bases for every
seed, and seeds differ in the bases, the loci and the reads alone.

A traffic with `adapter_frac` or `lowq_frac` plants what QC is there to
find (`sim.Planting`) into a fixed share of each chunk's pairs, from a
stream of its own, [seed, ADAPT, sample index, chunk]: a traffic without
those keys writes the same bytes as one before them, and every seed plants
the same share of each chunk."""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import sys
import time

import numpy as np

from hgtbench import sim

# what each rng stream draws from: [seed, STREAM, sample index(, chunk)]
REF, POOL = 0, 1
# the stream of the sizes, [SIZES] alone: the same for every seed
SIZES = 4
# the stream of a chunk's planting, [seed, ADAPT, sample index, chunk]
ADAPT = 5
CHUNK_CONTIGS = 8


@dataclasses.dataclass
class Sample:
    name: str
    fq1: str
    fq2: str
    truth: str
    n_pairs: int


@dataclasses.dataclass
class Cohort:
    ref: str
    pool: list


def sim_params(config: dict, traffic: dict, depth: float) -> sim.SimParams:
    fields = {f.name for f in dataclasses.fields(sim.SimParams)}
    kw = {k: v for k, v in {**config, **traffic}.items() if k in fields}
    kw["depth"] = depth
    return sim.SimParams(**kw)


def _rng(seed: int, *stream: int):
    return np.random.default_rng([seed % (1 << 64), *stream])


def fixed_sizes(pa: sim.SimParams) -> tuple[np.ndarray, np.ndarray]:
    """(pa.n_genomes genome lengths of 0.8-1.2 x pa.genome_len, pa.hgt_num
    HGT length fractions in [0, 1)), the same whatever the seed."""
    rng = np.random.default_rng([SIZES])
    lengths = (pa.genome_len * (0.8 + 0.4 * rng.random(pa.n_genomes))
               ).astype(np.int64)
    return lengths, rng.random(pa.hgt_num)


def _reads(args) -> tuple[bytes, bytes, int]:
    """FASTQ bytes of both mates of one chunk of contigs (child process)."""
    contigs, pa, seed, stream, planting = args
    parts = list(sim.synthesize_reads(contigs, pa, _rng(seed, *stream)))
    if planting is not None:
        planting.apply(parts, _rng(seed, ADAPT, *stream[1:]))
    b1, b2, n = [], [], 0
    for chrom, starts, m1, m2, q1, q2 in parts:
        b1.append(sim.fastq_records(chrom, starts, m1, q1))
        b2.append(sim.fastq_records(chrom, starts, m2, q2))
        n += len(starts)
    return b"".join(b1), b"".join(b2), n


def make(outdir: str, config: dict, traffic: dict, seed: int) -> Cohort:
    """The reference and traffic["pool"] samples at traffic["depth"], all
    from `seed`, with the traffic's planting (`sim.Planting.of`)."""
    os.makedirs(outdir, exist_ok=True)
    t0 = time.perf_counter()
    pa = sim_params(config, traffic, traffic["depth"])
    planting = sim.Planting.of(traffic)
    lengths, fracs = fixed_sizes(pa)
    rng = _rng(seed, REF)
    genomes, ref = sim.make_reference(outdir, "ref", pa, rng,
                                      rng.permutation(lengths))
    plans = [(f"s{i}", pa, POOL, i) for i in range(traffic["pool"])]
    samples, tasks = [], []
    for name, p, stream, index in plans:
        rng = _rng(seed, stream, index)
        edited, truth = sim.implant_hgts(genomes, p, rng,
                                         rng.permutation(fracs))
        edited = {c: sim.mutate(s, p, rng) for c, s in edited.items()}
        truth_path = os.path.join(outdir, f"{name}.true.sv.txt")
        sim.write_truth(truth_path, truth)
        names = list(edited)
        chunks = [names[j:j + CHUNK_CONTIGS]
                  for j in range(0, len(names), CHUNK_CONTIGS)]
        samples.append((name, truth_path, len(chunks)))
        tasks += [({c: edited[c] for c in chunk}, p, seed,
                   (stream, index, j), planting)
                  for j, chunk in enumerate(chunks)]
    t1 = time.perf_counter()
    made = []
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(len(tasks), len(os.sched_getaffinity(0)))) as workers:
        parts = workers.imap(_reads, tasks)
        for name, truth_path, n_chunks in samples:
            fq1 = os.path.join(outdir, f"{name}.1.fq")
            fq2 = os.path.join(outdir, f"{name}.2.fq")
            n = 0
            with open(fq1, "wb") as f1, open(fq2, "wb") as f2:
                for _ in range(n_chunks):
                    r1, r2, k = next(parts)
                    f1.write(r1)
                    f2.write(r2)
                    n += k
            made.append(Sample(name, fq1, fq2, truth_path, n))
            print(f"hgtbench inputs: {name} written at "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(f"hgtbench inputs: reference, HGTs and mutations {t1 - t0:.1f} s, "
          f"reads {time.perf_counter() - t1:.1f} s on {len(tasks)} tasks",
          file=sys.stderr)
    return Cohort(ref, made)
