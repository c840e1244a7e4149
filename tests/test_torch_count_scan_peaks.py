"""Port parity: count tables, the JAX table layout round trip, the
reference scan stencil and the direct hash -> peak-id map build."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localhgt_tpu.config import ScanConfig
from localhgt_tpu.io import fasta
from localhgt_tpu.ops import count as jax_count
from localhgt_tpu.ops import encode as jax_encode
from localhgt_tpu.ops import scan as jax_scan
from localhgt_tpu.pipeline import peaks as jax_peaks
from localhgt_tpu_torch.ops import count, scan
from localhgt_tpu_torch.pipeline import peaks


def _read_batch(rng, B, L, k):
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[:, :40] = codes[0, :40]          # duplicated k-mers beyond the cap
    codes[rng.random(codes.shape) < 0.01] = 4
    lengths = rng.integers(k - 2, L + 1, B).astype(np.int32)
    accept = rng.random(B) < 0.8
    return codes, lengths, accept


@pytest.mark.parametrize("kw", [0, 64])
def test_count_tables_match_jax_by_value(kw):
    k = 18
    rng = np.random.default_rng(3)
    masks, _ = jax_encode.hasher_for(k, 3, seed=1)
    jt = tuple(jax_count.make_table(k) for _ in range(3))
    pt = [count.make_table(k, "cpu") for _ in range(3)]
    for _ in range(3):
        codes, lengths, accept = _read_batch(rng, 48, 96, k)
        jt = jax_count.count_reads_step(
            jt, jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(accept),
            jnp.asarray(masks), k, 3, clip=False, kw=kw)
        count.count_reads_step(
            pt, torch.from_numpy(codes), torch.from_numpy(lengths),
            torch.from_numpy(accept), masks, k, 3, clip=False, kw=kw)
    jt = jax_count.clip_tables(jt, 3)
    count.clip_tables(pt, 3)
    for j, p in zip(jt, pt):
        assert int(p.max()) == 3
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


ALL_ONES = 0xFFFFFFFF
# (hash seed, coder) whose masks let a 32-mer hash to 0xFFFFFFFF
ALL_ONES_SEED, ALL_ONES_CODER = 25, 1
# base codes (A, C, G, T = 0..3) with a set bit in each forward hash
# stream (encode.canonical_hashes: A|T, A|C, A|G) and in each
# reverse-complement stream (A|T, G|T, C|T)
_FWD = ((0, 3), (0, 1), (0, 2))
_REV = ((0, 3), (2, 3), (1, 3))


def _all_ones_kmer(mask_row, k=32):
    """A k-mer whose canonical hash under `mask_row` (uint32 [3]) is all
    ones: base z sets forward bit k-1-z and reverse bit z, so each base is
    chosen alone from the streams that cover those two bits."""
    streams = [[s for s in range(3) if int(mask_row[s]) >> b & 1]
               for b in range(k)]
    kmer = []
    for z in range(k):
        ok = [c for c in range(4)
              if any(c in _FWD[s] for s in streams[k - 1 - z])
              and any(c in _REV[s] for s in streams[z])]
        kmer.append(ok[0])
    return np.array(kmer, np.uint8)


def _plant_all_ones_kmer(rng, masks, shape, spots):
    """Random codes with the all-ones k-mer of ALL_ONES_CODER written at
    each (row, start) of `spots`."""
    codes = rng.integers(0, 4, shape).astype(np.uint8)
    kmer = _all_ones_kmer(masks[ALL_ONES_CODER])
    for b, z in spots:
        codes[b, z : z + 32] = kmer
    h, v = jax_encode.canonical_hashes(np, codes, masks, 32)
    assert int(((h[ALL_ONES_CODER] == ALL_ONES) & v).sum()) == len(spots)
    return codes


def test_all_ones_kmer_is_never_counted_at_k32():
    """0xFFFFFFFF is both a real k=32 hash and the count sentinel. Reads
    holding such a k-mer go through both packages' hash, sort and
    rank-capped contribution; the two agree and the k-mer contributes
    nothing, so its count stays 0 in both."""
    s = np.array([[5, 5, ALL_ONES, ALL_ONES], [ALL_ONES] * 4], np.uint32)
    np.testing.assert_array_equal(
        count.rank_capped_contrib(torch.from_numpy(s.astype(np.int64)),
                                  3).numpy(),
        np.asarray(jax_count.rank_capped_contrib(jnp.asarray(s), 3)))

    k, cap = 32, 3
    rng = np.random.default_rng(6)
    masks, _ = jax_encode.hasher_for(k, 3, seed=ALL_ONES_SEED)
    # more copies than the cap of 3
    codes = _plant_all_ones_kmer(
        rng, masks, (8, 96),
        [(0, 0), (0, 50), (1, 10), (3, 64), (5, 30), (6, 30)])
    lengths = rng.integers(80, 97, len(codes)).astype(np.int32)
    lengths[[0, 1, 3, 5, 6]] = 96  # every planted copy lies in its read
    accept = np.ones(len(codes), bool)
    jh, jv = jax_encode.canonical_hashes(np, codes, masks, k)
    inwin = np.arange(codes.shape[1])[None, :] <= lengths[:, None] - k
    js, jc = jax_count.capped_batch_delta_multi(
        jnp.asarray(jh), jnp.asarray(jv & inwin & accept[:, None]), cap)
    ps, pc = count.sorted_contrib(
        torch.from_numpy(codes), torch.from_numpy(lengths),
        torch.from_numpy(accept), masks, k, cap)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    row = ps[ALL_ONES_CODER]
    assert int((row == ALL_ONES).sum()) > 6  # planted copies + invalid
    assert int(pc[ALL_ONES_CODER][row == ALL_ONES].sum()) == 0


def test_direct_map_drops_all_ones_hash_at_k32():
    """The k=32 map build keeps the same (hash, peak id) members as the JAX
    package's member stream, which feeds its RankMap and cuckoo map, and
    neither keeps the all-ones hash even when every hash is counted."""
    k = 32
    rng = np.random.default_rng(7)
    masks, _ = jax_encode.hasher_for(k, 3, seed=ALL_ONES_SEED)
    codes = _plant_all_ones_kmer(
        rng, masks, (4, 400), [(0, 0), (0, 50), (1, 10), (3, 64)]
    ).reshape(-1)
    # members over all four copies (at 0, 50, 410 and 1264), one twice
    gpos = np.concatenate([np.arange(0, 80), [50, 410, 830],
                           np.arange(1190, 1300)]).astype(np.int32)
    pids = (np.arange(len(gpos)) // 7 + 1).astype(np.int32)
    h, v = jax_peaks._hash_ref_chunk(jnp.asarray(codes), jnp.asarray(masks),
                                     k=k)
    # every hash counted 3: JAX clamps its gathers, so one packed word
    # (eight 4-bit fields of 3) serves every index; the port's table is a
    # stride-0 view of 2^32 counts
    jt = tuple(jnp.full(1, 0x33333333, jnp.int32) for _ in range(3))
    keys, vals = jax_peaks._member_batch(h, v, jt, jnp.asarray(gpos),
                                         jnp.asarray(pids))
    keys, vals = np.asarray(keys), np.asarray(vals)
    live = keys != ALL_ONES
    pt = [torch.full((1,), 3, dtype=torch.int8).expand(1 << k)] * 3
    pkeys, pvals = peaks._member_keys(
        torch.from_numpy(np.asarray(h).astype(np.int64)),
        torch.from_numpy(np.array(v)), pt,
        torch.from_numpy(gpos.astype(np.int64)), torch.from_numpy(pids))
    hm = np.asarray(h)[ALL_ONES_CODER, gpos]
    assert int((hm == ALL_ONES).sum()) == 5   # members holding the k-mer
    np.testing.assert_array_equal(pkeys.numpy(), keys[live])
    np.testing.assert_array_equal(pvals.numpy(), vals[live])
    assert not (pkeys == ALL_ONES).any()


def test_jax_layout_round_trip_packed_and_plain():
    rng = np.random.default_rng(4)
    words = rng.integers(-(1 << 31), 1 << 31, 64, dtype=np.int64)
    words = words.astype(np.int32)
    (plain,) = count.tables_from_jax([words], 32, "cpu")
    assert plain.dtype == torch.int8 and plain.numel() == 64 * 8
    h = np.arange(64 * 8)
    np.testing.assert_array_equal(plain.numpy(),
                                  jax_count.table_lookup_np(words, h))
    (back,) = count.tables_to_jax([plain], 32)
    np.testing.assert_array_equal(back, words)
    small = rng.integers(0, 4, 1 << 10).astype(np.int8)
    (p18,) = count.tables_from_jax([small], 10, "cpu")
    np.testing.assert_array_equal(count.tables_to_jax([p18], 10)[0], small)
    with pytest.raises(ValueError):
        count.tables_from_jax([small], 32, "cpu")


def _make_hits(rng, L, coder_num=3):
    """Synthetic count profile with a coverage edge (tests/test_scan.py)."""
    hc = np.zeros((coder_num, L), dtype=np.int8)
    cov = rng.random(L) < 0.9
    cov[L // 2:] = rng.random(L - L // 2) < 0.15
    for c in range(coder_num):
        noise = rng.random(L) < 0.05
        hc[c] = np.where(cov ^ noise, 3, rng.integers(0, 3, L))
    return hc


@pytest.mark.parametrize("k", [16, 32])
def test_scan_hits_matches_reference(k):
    rng = np.random.default_rng(3)
    cfg = ScanConfig()
    hc = _make_hits(rng, 3000)
    want_g, want_p = jax_scan.scan_hits(np, hc, k, cfg)
    got_g, got_p = scan.scan_hits(torch.from_numpy(hc), k, cfg)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    # batched rows with per-row true lengths, as stage B calls it
    rows = np.stack([hc, _make_hits(rng, 3000)])
    tl = np.array([3000, 2100])
    want_g, want_p = jax_scan.scan_hits(np, rows, k, cfg, true_len=tl)
    got_g, got_p = scan.scan_hits(torch.from_numpy(rows), k, cfg,
                                  true_len=torch.from_numpy(tl))
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(got_p.numpy(), want_p)


def _members(per_contig, contigs, k):
    """peaks.PeakMembers of host per-contig arrays (cid, positions,
    members, group_ids): the member code stage B's finalize writes."""
    code = np.zeros(len(contigs.codes), np.uint8)
    for cid, _, mem, gid in per_contig:
        first = np.ones(len(gid), bool)
        first[1:] = gid[1:] != gid[:-1]
        code[contigs.offsets[cid - 1] + mem] = (
            scan.MEMBER | np.where(first, scan.START, 0)
            | np.where(mem <= contigs.length_of(cid) - k, scan.TAKEN, 0))
    return peaks.PeakMembers(
        code=torch.from_numpy(code),
        peaks=[(cid, pos.astype(np.int32)) for cid, pos, _, _ in per_contig])


def test_build_direct_map_matches_jax():
    """Count tables made by the JAX package, fed to both map builds: the
    JAX package's from host member arrays, the port's from their member
    code."""
    k = 18
    rng = np.random.default_rng(5)
    lens = [7000, 5000]
    codes = rng.integers(0, 4, sum(lens)).astype(np.uint8)
    codes[7000:7400] = codes[1000:1400]  # a repeat: duplicate hashes
    contigs = fasta.Contigs(
        names=["c1", "c2"], lengths=np.array(lens),
        offsets=np.array([0, lens[0]]), codes=codes).finalize()
    masks, _ = jax_encode.hasher_for(k, 3, seed=1)
    tables = []
    for i in range(3):
        arr = np.zeros(1 << k, np.int8)
        h, v = jax_encode.canonical_hashes(np, codes[None, :], masks, k)
        hv = h[i, 0][v[0]].astype(np.int64)
        arr[hv[rng.random(len(hv)) < 0.7]] = 3
        tables.append(arr)

    def per_contig():
        out = []
        for cid, (lo, hi) in ((1, (900, 1500)), (2, (100, 600))):
            mem = np.arange(lo, hi, dtype=np.int32)
            gid = (mem - lo) // 50
            out.append((cid, mem[::50].astype(np.int64), mem,
                        gid.astype(np.int32)))
        return out

    want = jax_peaks.build_direct_map(
        per_contig(), contigs, tuple(jnp.asarray(t) for t in tables),
        masks, k)
    got = peaks.build_direct_map(
        _members(per_contig(), contigs, k), contigs,
        count.tables_from_jax(tables, k, "cpu"), masks, k, 50, "cpu")
    dm = got.direct_map.numpy()
    assert (dm > 0).sum() > 100
    np.testing.assert_array_equal(dm, np.asarray(want.direct_map))
    np.testing.assert_array_equal(got.contig, want.contig)
    np.testing.assert_array_equal(got.pos, want.pos)


def test_count_checkpoint_is_shared_with_jax(tmp_path):
    """`--count_ckpt` files carry the JAX layout under the JAX file name:
    the port resumes from a checkpoint the JAX package wrote, and the JAX
    package resumes from one the port wrote."""
    import dataclasses

    from localhgt_tpu.config import Config, KmerConfig
    from localhgt_tpu.pipeline import extract as jax_extract
    from localhgt_tpu.sim.simulate import SimParams, simulate_sample
    from localhgt_tpu_torch.pipeline import extract

    pa = SimParams(n_genomes=2, genome_len=6000, hgt_num=1, depth=3, seed=3)
    _, fq1, fq2, _ = simulate_sample(str(tmp_path), "c", pa)
    cfg = Config().replace(kmer=KmerConfig(k=14),
                           count_ckpt=str(tmp_path / "ck"))
    masks, _ = jax_encode.hasher_for(14, 3, seed=1)
    assert (extract.count_ckpt_path(fq1, fq2, cfg)
            == jax_extract._count_ckpt_path(fq1, fq2, cfg))

    tables, ratio, n_pairs, cache = extract.count_kmers(
        fq1, fq2, masks, cfg, "cpu")
    assert cache is not None  # a fresh count keeps the read-code cache
    jt, jratio, jn, jcache = jax_extract.count_kmers(fq1, fq2, masks, cfg)
    assert jcache is None  # resumed from the port's checkpoint
    assert (jratio, jn) == (ratio, n_pairs)
    for j, p in zip(jt, tables):
        np.testing.assert_array_equal(np.asarray(j), p.numpy())

    fresh = dataclasses.replace(cfg, count_ckpt=str(tmp_path / "ck2"))
    jt, _, _, _ = jax_extract.count_kmers(fq1, fq2, masks, fresh)
    pt, _, _, pcache = extract.count_kmers(fq1, fq2, masks, fresh, "cpu")
    assert pcache is None  # resumed from the JAX package's checkpoint
    for j, p in zip(jt, pt):
        np.testing.assert_array_equal(np.asarray(j), p.numpy())


def test_count_kmers_records_the_dispatch_series_and_no_device_step(
        tmp_path, monkeypatch):
    """One `count_batch_dispatch_s` sample a batch; on the CPU no
    `count_step_device_s`, the series a device metric is derived from."""
    from test_torch_cuda import count_series

    _, nb, series, _ = count_series(tmp_path, monkeypatch, "cpu")
    assert nb > 17  # batches 1 and 17 would be sampled on a card
    assert set(series) == {"count_batch_dispatch_s"}
    assert len(series["count_batch_dispatch_s"]) == nb
    assert all(v >= 0 for v in series["count_batch_dispatch_s"])
