"""Port parity of the multi-device path on the CPU: the RankMap, the two
dp x tp steps, sharded count / scan / peak set / vote, `bkp` with a mesh
through the library and the CLI, and data-parallel K1.

The same seeded numpy inputs go through the JAX function (on its 8
virtual CPU devices, tests/conftest.py) and its counterpart in the port
(a mesh of 1 to 8 entries that all name the CPU). Every result is an
integer array or a file: tolerance 0 everywhere."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localhgt_tpu.config import Config as JaxConfig
from localhgt_tpu.config import KmerConfig as JaxKmerConfig
from localhgt_tpu.config import ScanConfig as JaxScanConfig
from localhgt_tpu.index import reference as jax_reference
from localhgt_tpu.ops import encode as jax_encode
from localhgt_tpu.ops import sw as jax_sw
from localhgt_tpu.parallel import extract_sharded as jax_shx
from localhgt_tpu.parallel import mesh as jax_pmesh
from localhgt_tpu.pipeline import extract as jax_extract
from localhgt_tpu.pipeline import peaks as jax_peaks
from localhgt_tpu.pipeline.bkp import detect_breakpoint as jax_bkp
from localhgt_tpu.sim.simulate import SimParams, simulate_sample
from localhgt_tpu_torch import cli
from localhgt_tpu_torch.config import Config, KmerConfig, ScanConfig
from localhgt_tpu_torch.index import reference
from localhgt_tpu_torch.ops import count, encode, sw
from localhgt_tpu_torch.parallel import extract_sharded as shx
from localhgt_tpu_torch.parallel import mesh as pmesh
from localhgt_tpu_torch.pipeline import extract, peaks
from localhgt_tpu_torch.pipeline.bkp import detect_breakpoint

K = 18
U32 = 0xFFFFFFFF


def cpu_mesh(n):
    return pmesh.make_flat_mesh(["cpu"] * n)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread beside the other test
    processes (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def need8():
    if len(jax.devices()) < 8:
        pytest.skip("the JAX side needs its 8-virtual-device mesh")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------- RankMap


def _pairs(rng, k, n):
    """(hashes, pids) with duplicates under different pids, a word whose
    bit 31 is set, and both sides of word boundaries."""
    hs = rng.integers(1, 1 << k, n).astype(np.uint32)
    hs[:50] = hs[50:100]
    hs[100:106] = [31, 32, 63, 64, (1 << k) - 1, (1 << k) - 32]
    ps = rng.integers(1, 900, n).astype(np.int32)
    return hs, ps


def _build(hs, ps, k, cuts):
    """The port's RankMap from the stream cut into batches at `cuts`."""
    H = torch.from_numpy(hs.astype(np.int64))
    P = torch.from_numpy(ps)
    edges = [0, *cuts, len(hs)]
    return peaks.build_rankmap(
        lambda: [(H[a:b], P[a:b]) for a, b in zip(edges, edges[1:])], k,
        "cpu")


@pytest.mark.parametrize("k", [12, 18])
def test_rankmap_arrays_equal_jax_host_build(k):
    hs, ps = _pairs(np.random.default_rng(k), k, 5000)
    want = jax_peaks.build_rankmap_host(hs, ps, k)
    # bits of one word arrive in different batches, and so do duplicates
    got = _build(hs, ps, k, (70, 2000))
    assert got.wp.dtype == got.pids.dtype == torch.int32
    np.testing.assert_array_equal(got.wp.numpy(), want.wp)
    np.testing.assert_array_equal(got.pids.numpy(), want.pids)
    assert (got.wp[0::2] < 0).any()     # some word has its bit 31 set
    assert peaks.build_rankmap(lambda: [], k, "cpu") is None
    # the stream is asked for again when it outgrows the cache
    H = torch.from_numpy(hs.astype(np.int64))
    again = peaks.build_rankmap(lambda: [(H, torch.from_numpy(ps))], k,
                                "cpu", cache_limit=0)
    np.testing.assert_array_equal(again.pids.numpy(), want.pids)


@pytest.mark.parametrize("k", [12, 18])
def test_rank_lookup_equals_jax(k):
    rng = np.random.default_rng(100 + k)
    hs, ps = _pairs(rng, k, 3000)
    want = jax_peaks.build_rankmap_host(hs, ps, k)
    rmap = peaks.rankmap_from_jax(want.wp, want.pids, k, "cpu")
    q = np.concatenate([hs, hs ^ 1, hs + 32,    # hits, neighbours, next word
                        rng.integers(0, 1 << k, 4000),
                        [0, 30, 31, 32, 33, (1 << k) - 1]]) & ((1 << k) - 1)
    exp = np.asarray(jax_peaks.rank_lookup(
        jnp.asarray(want.wp), jnp.asarray(want.pids),
        jnp.asarray(q.astype(np.uint32))))
    got = peaks.rank_lookup(rmap.wp, rmap.pids,
                            torch.from_numpy(q.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, exp)
    assert 0 < (exp == 0).sum() < len(q)
    # a miss is 0, not pids[0]
    assert rmap.pids[0] != 0
    stored = set(hs.tolist())
    miss = np.array([h for h in range(200) if h not in stored], np.int64)
    assert not peaks.rank_lookup(rmap.wp, rmap.pids,
                                 torch.from_numpy(miss)).any()
    # duplicates resolved to the max pid
    dup = int(hs[0])
    assert int(peaks.rank_lookup(rmap.wp, rmap.pids, torch.tensor([dup]))
               ) == int(ps[hs == dup].max())


def test_rankmap_round_trip_and_layout_checks():
    k = 12
    hs, ps = _pairs(np.random.default_rng(5), k, 800)
    want = jax_peaks.build_rankmap_host(hs, ps, k)
    wp, pids = peaks.rankmap_to_jax(
        peaks.rankmap_from_jax(want.wp, want.pids, k, "cpu"))
    np.testing.assert_array_equal(wp, want.wp)
    np.testing.assert_array_equal(pids, want.pids)
    # the port's own build goes into the JAX lookup as it is
    wp, pids = peaks.rankmap_to_jax(_build(hs, ps, k, (400,)))
    got = np.asarray(jax_peaks.rank_lookup(
        jnp.asarray(wp), jnp.asarray(pids), jnp.asarray(hs)))
    exp = np.array([ps[hs == h].max() for h in hs])
    np.testing.assert_array_equal(got, exp)
    with pytest.raises(ValueError, match="interleaved words"):
        peaks.rankmap_from_jax(want.wp[:-2], want.pids, k, "cpu")
    with pytest.raises(ValueError, match="int32"):
        peaks.rankmap_from_jax(want.wp.astype(np.int64), want.pids, k, "cpu")


def test_rankmap_32_bit_hashes_on_a_shrunken_word_array():
    """k = 32 with every stored hash >= 2^31: the full arrays are 2^28
    int32 of which only the pages of the top 2^17 hashes are ever touched
    (the JAX host build runs at k = 17 on the hashes less their base, and
    its words and prefixes ARE the tail of the k = 32 arrays, nothing
    being stored below)."""
    k, kw = 32, 17
    base = (1 << k) - (1 << kw)
    rng = np.random.default_rng(32)
    low, ps = _pairs(rng, kw, 2000)
    low = low[low != (1 << kw) - 1]           # 0xFFFFFFFF is never stored
    ps = ps[: len(low)]
    small = jax_peaks.build_rankmap_host(low, ps, kw)
    hs = low.astype(np.int64) + base
    assert hs.min() >= 1 << 31

    # presence bits land in the words of the top hashes, sign bit included
    w = torch.zeros(1 << (k - 5), dtype=torch.int32)
    H = torch.from_numpy(hs)
    peaks._word_add(w, H[:900])
    peaks._word_add(w, H[700:])
    np.testing.assert_array_equal(w[base >> 5 :].numpy(), small.wp[0::2])
    assert not w[(base >> 5) - 4096 : base >> 5].any()

    wp = np.zeros(2 << (k - 5), np.int32)
    wp[2 * (base >> 5) :] = small.wp
    rmap = peaks.rankmap_from_jax(wp, small.pids, k, "cpu")
    q = np.concatenate([hs, hs ^ 1, hs - base,
                        rng.integers(0, 1 << 32, 3000), [0, U32, base]])
    got = peaks.rank_lookup(rmap.wp, rmap.pids, torch.from_numpy(q)).numpy()
    in_window = q >= base
    exp = np.zeros(len(q), np.int32)
    exp[in_window] = np.asarray(jax_peaks.rank_lookup(
        jnp.asarray(small.wp), jnp.asarray(small.pids),
        jnp.asarray((q[in_window] - base).astype(np.uint32))))
    np.testing.assert_array_equal(got, exp)
    assert (got[: len(hs)] != 0).all()


def test_rank_prefix_is_summed_in_int64_and_refused_at_2_31(monkeypatch):
    """2^31 stored hashes would wrap the int32 prefix. 2^26 full words
    are too slow here, so every non-zero word is made to count 2^20."""
    monkeypatch.setattr(peaks, "_popcount", lambda w: (w != 0) * (1 << 20))
    w = torch.full((1 << 11,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31 stored k-mers"):
        peaks._words_to_wp(w)
    w[-1] = 0
    wp, ku = peaks._words_to_wp(w)
    assert ku == (1 << 31) - (1 << 20)
    assert int(wp[-1]) == ku and wp.dtype == torch.int32  # exact, no wrap


# ------------------------------------------------------- the dp x tp steps


def test_mesh_shapes_and_shares():
    m = pmesh.make_mesh(["cpu"] * 8)
    assert m.shape == (2, 4) and m.n == 8 and len(m.distinct) == 1
    assert pmesh.make_mesh(["cpu"] * 6).shape == (3, 2)
    assert pmesh.make_mesh(["cpu"] * 3).shape == (3, 1)
    assert pmesh.make_mesh(["cpu"] * 6, dp=1, tp=6).shape == (1, 6)
    with pytest.raises(ValueError, match="does not cover"):
        pmesh.make_mesh(["cpu"] * 6, dp=4, tp=2)
    flat = cpu_mesh(3)
    assert flat.shape == (3, 1)
    assert flat.describe() == "3 shards on 1 distinct devices"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.make_flat_mesh(None)
    x = torch.arange(10)
    parts = pmesh.shard_rows(flat, x)
    assert [len(p) for p in parts] == [3, 3, 4]
    assert torch.equal(torch.cat(parts), x)
    assert [len(p) for p in pmesh.shard_rows(cpu_mesh(8), x[:3])] == [
        0, 0, 1, 0, 0, 1, 0, 1]
    reps = pmesh.replicate(flat, x)
    assert len(reps) == 3 and all(r is reps[0] for r in reps)
    assert shx.slice_bounds(10, 3) == [(0, 4), (4, 8), (8, 10)]
    assert shx.slice_bounds(1 << 32, 4)[-1] == (3 << 30, 1 << 32)


def test_sharded_count_step_matches_jax(need8):
    """The inputs of tests/test_sharding.py."""
    k, cap, B = 10, 3, 4096
    rng = np.random.default_rng(0)
    hashes = rng.integers(0, 1 << k, B).astype(np.uint32)
    hashes[:1000] = 7  # heavy duplication across dp shards
    valid = rng.random(B) < 0.9

    jm = jax_pmesh.make_mesh(8)
    jt = jax_pmesh.shard_tp(jm, jnp.zeros(1 << k, jnp.int32))
    jt = jax_pmesh.sharded_count_step(jm, k, cap)(
        jt, jax_pmesh.shard_dp(jm, jnp.asarray(hashes)),
        jax_pmesh.shard_dp(jm, jnp.asarray(valid)))

    m = pmesh.make_mesh(["cpu"] * 8)
    assert m.shape == tuple(jm.devices.shape)
    step = pmesh.sharded_count_step(m, k, cap)
    slices = [torch.zeros((1 << k) // 4, dtype=torch.int32)
              for _ in range(4)]
    H = torch.from_numpy(hashes.astype(np.int64))
    V = torch.from_numpy(valid)
    got = torch.cat(step(slices, H, V)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jt))
    exp = np.zeros(1 << k, np.int64)
    np.add.at(exp, hashes[valid].astype(np.int64), 1)
    np.testing.assert_array_equal(got, np.minimum(exp, cap))
    # a second step accumulates onto clipped tables, on any mesh shape
    twice = torch.cat(pmesh.sharded_count_step(
        pmesh.make_mesh(["cpu"] * 6, dp=3, tp=2), k, cap)(
        list(torch.from_numpy(got).chunk(2)), H, V)).numpy()
    np.testing.assert_array_equal(twice, np.minimum(2 * exp, cap))


def test_sharded_scan_step_matches_jax(need8):
    """The inputs of tests/test_sharding.py."""
    k, coder_num = 12, 3
    block, halo = 512, 256
    jm = jax_pmesh.make_mesh(8)
    dp = jm.shape["dp"]
    rng = np.random.default_rng(1)
    n_blocks = 2 * dp
    ref = rng.integers(0, 4, n_blocks * block + 2 * halo).astype(np.uint8)
    masks, _ = jax_encode.hasher_for(k, coder_num, seed=1)
    table = np.zeros((coder_num, 1 << k), np.int32)
    h, v = jax_encode.canonical_hashes(np, ref, masks, k)
    for i in range(coder_num):
        table[i][h[i][v][::2].astype(np.int64)] = 3
    blocks = np.stack([ref[i * block : i * block + block + 2 * halo]
                       for i in range(n_blocks)])

    from jax.sharding import NamedSharding, PartitionSpec as P

    jstep = jax_pmesh.sharded_scan_step(jm, k, JaxScanConfig(window=64),
                                        coder_num, block, halo)
    jgood, jpeak = jstep(
        jax_pmesh.shard_dp(jm, jnp.asarray(blocks)),
        jax.device_put(jnp.asarray(table), NamedSharding(jm, P(None, "tp"))),
        jnp.asarray(masks))

    m = pmesh.make_mesh(["cpu"] * 8)
    step = pmesh.sharded_scan_step(m, k, ScanConfig(window=64), coder_num,
                                   block, halo)
    good, peak = step(torch.from_numpy(blocks),
                      list(torch.from_numpy(table).chunk(4, dim=1)), masks)
    assert good.shape == (n_blocks, block)
    np.testing.assert_array_equal(good.numpy(), np.asarray(jgood))
    np.testing.assert_array_equal(peak.numpy(), np.asarray(jpeak))
    assert good.any() and peak.any()


# ------------------------------------------------------ sharded extraction


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """The fixture of tests/test_sharded_extract.py."""
    out = str(tmp_path_factory.mktemp("torch_shx"))
    pa = SimParams(n_genomes=6, genome_len=30_000, hgt_num=3, depth=8,
                   snp_rate=0.01, seed=21)
    ref, fq1, fq2, _ = simulate_sample(out, "sx", pa)
    return ref, fq1, fq2


def _capturing(mp, module, name, seen, **more):
    """Replace module.name by a wrapper that keeps each call's result in
    `seen[name]` (and passes `more` on)."""
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        seen[name] = orig(*args, **kw, **more)
        return seen[name]

    mp.setattr(module, name, wrapper)


@pytest.fixture(scope="module")
def single(sample):
    """The port's single-device `bkp` through the CLI with `--multi_chip
    auto` (no CUDA here, so one device), keeping its stage-A tables and
    its extraction result."""
    ref, fq1, fq2 = sample
    out = os.path.dirname(ref)
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        _capturing(mp, extract, "count_kmers", seen)
        _capturing(mp, extract, "extract", seen)
        assert cli.main(["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2,
                         "-o", out, "-k", str(K), "--device", "cpu",
                         "-s", "auto", "--multi_chip", "auto"]) == 0
    tables, _, n_pairs, _ = seen["count_kmers"]
    return [t.numpy() for t in tables], n_pairs, seen["extract"]


@pytest.fixture(scope="module")
def mesh_runs(sample, need8):
    """`bkp` over 8 shards in both packages (samples `mesh` and `jax`),
    each keeping its extraction result; extraction scans in blocks of
    2^13 as tests/test_sharded_extract.py does."""
    ref, fq1, fq2 = sample
    out = os.path.dirname(ref)
    seen, jseen = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        _capturing(mp, shx, "extract_sharded", seen, scan_block=1 << 13)
        _capturing(mp, jax_shx, "extract_sharded", jseen,
                   scan_block=1 << 13)
        detect_breakpoint(ref, fq1, fq2, "mesh", out, "cpu",
                          cfg=Config().replace(kmer=KmerConfig(k=K)),
                          mesh=cpu_mesh(8))
        jax_bkp(ref, fq1, fq2, "jax", out,
                cfg=JaxConfig().replace(kmer=JaxKmerConfig(k=K)),
                mesh=jax_shx.make_flat_mesh(8))
    return seen["extract_sharded"], jseen["extract_sharded"]


@pytest.mark.parametrize("n", [1, 3, 8])
def test_count_kmers_sharded_tables(n, sample, single, need8):
    ref, fq1, fq2 = sample
    want, n_pairs, _ = single
    cfg = Config().replace(kmer=KmerConfig(k=K))
    masks, _ = encode.hasher_for(K, 3, cfg.kmer.seed)
    # small batches: 12 steps, several deferred clips, a ragged last batch
    tables, _, got_pairs = shx.count_kmers_sharded(
        cpu_mesh(n), fq1, fq2, masks, cfg, batch_reads=1000)
    assert got_pairs == n_pairs
    assert [len(s) for s in tables] == [n] * 3
    for slices, w in zip(tables, want):
        np.testing.assert_array_equal(torch.cat(slices).numpy(), w)
    assert max(int(w.max()) for w in want) == cfg.kmer.least_depth
    if n == 8:
        jcfg = JaxConfig().replace(kmer=JaxKmerConfig(k=K))
        jt, _, jp = jax_shx.count_kmers_sharded(
            jax_shx.make_flat_mesh(8), fq1, fq2, masks, jcfg)
        assert jp == n_pairs
        for t, w in zip(jt, want):
            np.testing.assert_array_equal(np.asarray(t), w)


def test_sharded_count_needs_its_own_clip_cadence(tmp_path, monkeypatch):
    """8 shards x cap 3 add up to 24 to a hash per batch, so an int8 slice
    wraps after 5 unclipped batches. One read repeated through 16 batches
    keeps its k-mers at the cap; with the single-device cadence (38
    batches) the same run wraps, which is the mutation this test kills."""
    k, cap, n = 12, 3, 8
    rng = np.random.default_rng(9)
    read = "".join("ACGT"[c] for c in rng.integers(0, 4, 60))
    fq = tmp_path / "same.fq"
    fq.write_text("".join(f"@r{i}\n{read}\n+\n{'I' * 60}\n"
                          for i in range(8 * 64)))
    cfg = Config().replace(kmer=KmerConfig(k=k))
    masks, _ = encode.hasher_for(k, 3, cfg.kmer.seed)
    assert count.clip_every_batches(cap, streams=n) == 3
    assert count.clip_every_batches(cap) == 38

    def run():
        tables, _, _ = shx.count_kmers_sharded(
            cpu_mesh(n), str(fq), str(fq), masks, cfg, batch_reads=64)
        return [torch.cat(s) for s in tables]

    good = run()
    single, _, _, _ = extract.count_kmers(str(fq), str(fq), masks, cfg,
                                          "cpu")
    for g, s in zip(good, single):
        assert int(g.min()) == 0 and int(g.max()) == cap
        assert torch.equal(g, s)
    one_stream = count.clip_every_batches
    monkeypatch.setattr(count, "clip_every_batches",
                        lambda cap, streams=1: one_stream(cap))
    assert any(int(t.min()) < 0 for t in run())


def test_extract_sharded_equals_single_and_jax_mesh(single, mesh_runs):
    _, n_pairs, one = single
    got, want = mesh_runs
    assert got.cache is None and got.peakset.direct_map is None
    assert len(one.intervals) > 0
    for other in (one, want):
        assert got.n_pairs_counted == other.n_pairs_counted == n_pairs
        assert got.intervals == other.intervals
        assert got.bed == other.bed
        # slot 0 takes the rows that do not vote: it follows the batch
        # geometry, so only real peaks are compared
        np.testing.assert_array_equal(got.peak_votes[1:],
                                      other.peak_votes[1:])
    np.testing.assert_array_equal(got.peakset.contig, want.peakset.contig)
    np.testing.assert_array_equal(got.peakset.pos, want.peakset.pos)
    wp, pids = peaks.rankmap_to_jax(got.peakset.rmap)
    np.testing.assert_array_equal(wp, np.asarray(want.peakset.rmap.wp))
    np.testing.assert_array_equal(pids, np.asarray(want.peakset.rmap.pids))


def _odd_contigs_fasta(ref):
    """A FASTA beside `ref` of a whole contig of it, one shorter than a
    scan block, one shorter than k and a middling one."""
    contigs = reference.build(ref)
    codes = [contigs.contig_codes(c) for c in (1, 2)]
    extra = os.path.join(os.path.dirname(ref), "odd_contigs.fa")
    with open(extra, "w") as f:
        for name, c in (("long", codes[0]), ("short", codes[1][:700]),
                        ("tiny", codes[1][:10]), ("mid", codes[1][:9000])):
            f.write(f">{name}\n{''.join('ACGT'[x] for x in c)}\n")
    return extra


def test_scan_reference_sharded_at_contig_ends_and_max_peak(sample, single):
    """Blocks far shorter than a contig, a contig shorter than one block,
    one shorter than k, and the --max_peak cut: per-contig peaks equal the
    single path's."""
    ref, fq1, fq2 = sample
    tables = [torch.from_numpy(t) for t in single[0]]
    odd = reference.build(_odd_contigs_fasta(ref))
    cfg = Config().replace(kmer=KmerConfig(k=K))
    masks, _ = encode.hasher_for(K, 3, cfg.kmer.seed)
    for max_peak in (cfg.scan.max_peak, 7):
        c = cfg.replace(scan=ScanConfig(max_peak=max_peak))
        want = extract.scan_reference(tables, odd, masks, c,
                                      "cpu").per_contig(odd)
        for n in (3, 8):
            mesh = cpu_mesh(n)
            slices = [[t[lo:hi] for lo, hi in
                       shx.slice_bounds(1 << K, n)] for t in tables]
            got = shx.scan_reference_sharded(mesh, slices, odd, masks, c,
                                             block=1 << 12)
            assert [g[0] for g in got] == [w[0] for w in want]
            for g, w in zip(got, want):
                for a, b in zip(g[1:], w[1:]):
                    np.testing.assert_array_equal(a, b)
        assert sum(len(w[1]) for w in want) > 0
    assert sum(len(w[1]) for w in want) == 7


def test_scan_reference_equals_jax(sample, single):
    """extract.scan_reference (masks stitched and finalized on the device,
    here the CPU, into a member code) against the JAX package's on the
    fixture's reference and on the odd contigs, with and without a
    --max_peak cut: every (cid, positions, members, group_ids) of the
    code's host expansion equal in dtype and value."""
    ref, _, _ = sample
    tables = [torch.from_numpy(t) for t in single[0]]
    jtables = [jnp.asarray(a) for a in count.tables_to_jax(tables, K)]
    masks, _ = encode.hasher_for(K, 3, Config().kmer.seed)
    jmasks, _ = jax_encode.hasher_for(K, 3, JaxConfig().kmer.seed)
    np.testing.assert_array_equal(masks, jmasks)
    for path in (ref, _odd_contigs_fasta(ref)):
        contigs, jcontigs = reference.build(path), jax_reference.build(path)
        for max_peak in (Config().scan.max_peak, 7):
            cfg = Config().replace(kmer=KmerConfig(k=K),
                                   scan=ScanConfig(max_peak=max_peak))
            jcfg = JaxConfig().replace(kmer=JaxKmerConfig(k=K),
                                       scan=JaxScanConfig(max_peak=max_peak))
            got = extract.scan_reference(tables, contigs, masks, cfg,
                                         "cpu").per_contig(contigs)
            want = jax_extract.scan_reference(jtables, jcontigs, jmasks,
                                              jcfg)
            assert [g[0] for g in got] == [w[0] for w in want]
            assert sum(len(g[2]) for g in got) > 0
            for g, w in zip(got, want):
                for a, b in zip(g[1:], w[1:]):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
            if max_peak == 7:
                assert sum(len(g[1]) for g in got) == 7


def test_bkp_with_a_mesh_writes_the_single_device_files(sample, single,
                                                        mesh_runs):
    """detect_breakpoint(mesh=...) over 8 shards and the CLI's
    `--multi_chip on` (one CPU shard): acc.csv, interval.txt and the bed
    byte-equal to the port's single-device run (`--multi_chip auto`
    without CUDA) and to the JAX mesh run."""
    ref, fq1, fq2 = sample
    out = os.path.dirname(ref)
    assert cli.main(["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2, "-o", out,
                     "-k", str(K), "--device", "cpu", "-s", "on",
                     "--multi_chip", "on"]) == 0
    for suffix in ("acc.csv", "interval.txt", "interval.txt.bed"):
        want = _bytes(os.path.join(out, f"auto.{suffix}"))
        assert want.count(b"\n") > 1
        for name in ("mesh", "jax", "on"):
            assert _bytes(os.path.join(out, f"{name}.{suffix}")) == want, (
                name, suffix)


def test_multi_chip_modes_choose_the_mesh(monkeypatch, sample, tmp_path):
    """force = a mesh even on one device, auto = none without a second
    CUDA device; a mesh reaches both extraction and the K1 extension."""
    from localhgt_tpu_torch.pipeline import bkp as bkp_mod

    ref, fq1, fq2 = sample
    seen = []

    def fake_extract(fq1, fq2, contigs, cfg, mesh):
        seen.append(mesh)
        raise KeyboardInterrupt  # the choice is made; stop the run here

    monkeypatch.setattr(bkp_mod.extract_sharded, "extract_sharded",
                        fake_extract)
    with pytest.raises(KeyboardInterrupt):
        detect_breakpoint(ref, fq1, fq2, "f", str(tmp_path), "cpu",
                          mesh="force")
    assert seen[0].devices == (torch.device("cpu"),)
    monkeypatch.setattr(bkp_mod.extract, "extract", fake_extract)
    with pytest.raises(KeyboardInterrupt):
        detect_breakpoint(ref, fq1, fq2, "a", str(tmp_path), "cpu",
                          mesh="auto")
    assert seen[1] == torch.device("cpu")   # extract's device argument


# ------------------------------------------------------ data-parallel K1


def test_sw_align_sharded_matches_tiled_and_jax(need8):
    """The inputs of tests/test_sharding.py: B = 700 is no multiple of the
    shard count. All five fields against the port's single path; score,
    qend and rend against the JAX mesh (its start coordinates follow the
    lax.scan tie rule, ROADMAP F1)."""
    rng = np.random.default_rng(3)
    B, M, N = 700, 48, 96
    q = rng.integers(0, 4, (B, M)).astype(np.uint8)
    r = rng.integers(0, 4, (B, N)).astype(np.uint8)
    for b in range(0, B, 3):
        r[b, 11:11 + 32] = q[b][5:37]
    want = sw.sw_align_tiled(q, r, "cpu")
    jgot = jax_sw.sw_align_sharded(jax_shx.make_flat_mesh(8), q, r)
    for n in (8, 3):
        mesh = cpu_mesh(n)
        got = sw.sw_align_sharded(mesh, q, r)
        routed = sw.sw_align_tiled(q, r, "cpu", mesh=mesh)
        for f in sw.FIELDS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
            np.testing.assert_array_equal(routed[f], want[f], err_msg=f)
        for f in ("score", "qend", "rend"):
            np.testing.assert_array_equal(got[f], jgot[f], err_msg=f)
    assert (want["score"] >= 32).sum() >= B // 3
    empty = sw.sw_align_sharded(cpu_mesh(3), q[:0], r[:0])
    assert all(len(empty[f]) == 0 for f in sw.FIELDS)
    two = sw.sw_align_sharded(cpu_mesh(8), q[:2], r[:2])  # empty shares
    np.testing.assert_array_equal(two["score"], want["score"][:2])
