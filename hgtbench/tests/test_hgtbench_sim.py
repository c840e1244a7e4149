"""The benchmark's generator against the port's simulator: the same files,
byte for byte, for two seeds (one past 2**31)."""

import filecmp

import pytest

from hgtbench import sim
from localhgt_tpu_torch.sim import simulate as port_sim


@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_simulate_sample_is_byte_equal_to_the_port(tmp_path, seed):
    kw = dict(n_genomes=5, genome_len=30_000, hgt_num=2, depth=4, seed=seed)
    theirs = port_sim.simulate_sample(str(tmp_path / "port"), "s",
                                      port_sim.SimParams(**kw))
    mine = sim.simulate_sample(str(tmp_path / "mine"), "s", sim.SimParams(**kw))
    for a, b in zip(theirs, mine):
        assert filecmp.cmp(a, b, shallow=False), (a, b)


def test_fasta_writer_handles_a_partial_last_line(tmp_path):
    recs = [("a", "ACGT" * 41), ("b", "ACGTACGTAC" * 16)]  # 164 and 160 bp
    sim.write_fasta(str(tmp_path / "m.fa"), recs)
    port_sim.fasta.write_fasta(str(tmp_path / "p.fa"), recs)
    assert (tmp_path / "m.fa").read_bytes() == (tmp_path / "p.fa").read_bytes()


def _contig_lengths(path):
    lengths, n = [], None
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if n is not None:
                    lengths.append(n)
                n = 0
            else:
                n += len(line.strip())
    return sorted(lengths + [n])


def test_every_seed_draws_the_same_sizes(tmp_path):
    """Two seeds: the same reference contig lengths in another order, the
    same HGT lengths in each sample, pairs within the indels' play. The
    genomes are long enough that no donor shortens an HGT's range."""
    from hgtbench import cohort

    config = {"n_genomes": 6, "genome_len": 80_000}
    traffic = {"depth": 2, "hgt_num": 2, "pool": 2,
               "read_len": 150, "mean_frag": 350, "frag_sd": 10}
    made = [cohort.make(str(tmp_path / str(seed)), config, traffic, seed)
            for seed in (5, 2**31 + 3)]
    refs = [_contig_lengths(c.ref) for c in made]
    assert refs[0] == refs[1]
    segs = [[sorted(t.seg_end - t.seg_start for t in sim.read_truth(s.truth))
             for s in c.pool] for c in made]
    assert segs[0][0] == segs[0][1] == segs[1][0] == segs[1][1]
    pairs = [s.n_pairs for c in made for s in c.pool]
    assert max(pairs) - min(pairs) <= 0.01 * max(pairs)
