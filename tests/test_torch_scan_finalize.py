"""Stage B's per-contig finalize where the masks are.

`scan.finalize_contig` (the good runs' edges to the host, the merge loop
there, members and group ids compacted beside the masks) against the JAX
package's `good_intervals` + `peaks_in_intervals`, element for element in
dtype, order and value; `extract.scan_reference`, which stitches a
contig's rows into device masks and finalizes them, against the same
helpers over whole-contig masks, across chunks and steps and through the
--max_peak cut; `utils/device.HostStaging`, which brings the results back;
the map build from the member code (`peaks.build_direct_map`) against the
route before it, which flattened host member arrays (`_flatten_members`)
and compacted them a chunk at a time (`_member_keys`), on planted masks.

The card's case carries the `cuda` marker and skips without a card; it
compares with the CPU run of the same code and the port's numpy helpers,
so the file runs there with

    python -m pytest tests/test_torch_scan_finalize.py -m cuda --noconftest

The JAX package's helpers are imported inside the CPU tests only.
"""

import numpy as np
import pytest
import torch

from localhgt_tpu_torch.config import Config, KmerConfig, ScanConfig
from localhgt_tpu_torch.io import fasta
from localhgt_tpu_torch.ops import encode, scan
from localhgt_tpu_torch.pipeline import extract, peaks
from localhgt_tpu_torch.utils import metrics
from localhgt_tpu_torch.utils.device import STAGING_INTS, HostStaging

K = 18
CAP = 3  # least_depth: a table entry at the cap is a hit


def _jax_scan():
    from localhgt_tpu.ops import scan as jax_scan
    return jax_scan


def _want(helpers, good, peak, window, pad, merge_bin=50):
    """(intervals, (positions, members, group_ids)) of the host helpers."""
    ivs = helpers.good_intervals(good, window, pad=pad)
    return ivs, helpers.peaks_in_intervals(peak, ivs, merge_bin)


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _realistic(rng, L=1_200_000):
    """This cell's density on a 1.2 Mbp contig: good covers ~99% of it in
    ~90 runs, 65% of positions are peaks."""
    good = np.ones(L, bool)
    for a in rng.integers(0, L, 90):
        good[a : a + int(rng.integers(1, 2_000))] = False
    return good, rng.random(L) < 0.65


def _case(name):
    """(good, peak, window, pad) of each named case."""
    rng = np.random.default_rng(len(name))
    if name == "empty":
        return np.zeros(5_000, bool), rng.random(5_000) < 0.5, 500, 1000
    if name == "all_good":
        return np.ones(5_000, bool), rng.random(5_000) < 0.5, 500, 1000
    if name == "run_at_end":  # end = L, not fall + 1 + pad
        good = np.zeros(8_000, bool)
        good[3_000:6_000] = good[7_500:] = True
        return good, rng.random(8_000) < 0.3, 100, 50
    if name == "gap_under_window":  # two runs, one interval
        good = np.zeros(8_000, bool)
        good[1_000:2_000] = good[2_150:3_000] = True
        return good, rng.random(8_000) < 0.3, 200, 50
    if name == "bin_across_boundary":
        # intervals [100, 120) and [135, 160) share the 50-bp bin
        # [100, 150): 110 and 140 form one peak (merge_peak does not
        # reset between intervals); 125 lies outside both
        good = np.zeros(400, bool)
        good[100:120] = good[135:160] = True
        peak = np.zeros(400, bool)
        peak[[20, 110, 125, 140, 155, 170]] = True
        return good, peak, 10, 0
    if name == "adjacent_intervals":  # one ends where the next starts
        good = np.zeros(200, bool)
        good[10:20] = good[22:30] = True
        return good, rng.random(200) < 0.5, 0, 1
    if name == "empty_interval":  # a run at 0 with no pad gives [1, 1)
        good = np.zeros(200, bool)
        good[0] = good[5:9] = True
        return good, np.ones(200, bool), 0, 0
    if name == "random_1p2mbp":
        return (*_realistic(rng), 500, 1000)
    if name == "many_runs":  # thousands of intervals
        return (rng.random(60_000) < 0.5, rng.random(60_000) < 0.65, 0, 0)
    raise KeyError(name)


CASES = ["empty", "all_good", "run_at_end", "gap_under_window",
         "bin_across_boundary", "adjacent_intervals", "empty_interval",
         "random_1p2mbp", "many_runs"]


@pytest.mark.parametrize("name", CASES)
def test_finalize_contig_equals_the_host_helpers(name):
    good, peak, window, pad = _case(name)
    ivs, want = _want(_jax_scan(), good, peak, window, pad)
    edges = scan.good_edges(torch.from_numpy(good)).numpy().astype(np.int64)
    assert scan.merge_good_runs(edges[0::2], edges[1::2] - 1, len(good),
                                window, pad) == ivs
    code = torch.zeros(len(good), dtype=torch.uint8)
    with HostStaging("cpu") as staging:
        pos = scan.finalize_contig(torch.from_numpy(good),
                                   torch.from_numpy(peak), window, pad, 50, K,
                                   code, staging.fetch)
    got = scan.members_of(code.numpy())
    _same(got, want)
    _same([pos], [got[0].astype(np.int32)])
    _takes_the_members_with_a_kmer(code.numpy(), got[1])
    assert staging.nbytes == 4 * (len(edges) + len(pos))
    if name == "bin_across_boundary":
        assert ivs == [(100, 120), (135, 160)]
        assert got[1].tolist() == [110, 140, 155]
        assert got[2].tolist() == [0, 0, 1]
    if name == "run_at_end":
        assert ivs[-1][1] == len(good)
    if name == "gap_under_window":
        assert ivs == [(950, 3050)]
    if name == "adjacent_intervals":
        assert ivs == [(9, 21), (21, 31)]
    if name == "empty_interval":
        assert ivs == [(1, 1), (5, 9)] and got[1].tolist() == [5, 6, 7, 8]
    if name == "random_1p2mbp":
        assert 600_000 < len(got[1]) < 800_000 and len(got[0]) > 10_000


def _takes_the_members_with_a_kmer(code, mem):
    """TAKEN is set on exactly the members at or before len - K."""
    want = np.zeros(len(code), bool)
    want[mem[mem <= len(code) - K]] = True
    np.testing.assert_array_equal((code & scan.TAKEN) != 0, want)


@pytest.mark.parametrize("ints", [7, 70_000])
def test_host_staging_copies_through_a_small_buffer(ints):
    """Vectors longer than the buffer, and several a buffer, come back
    whole; the buffer is drained between fills, and a long copy out of it
    is split between the threads."""
    rng = np.random.default_rng(5)
    parts = [rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
             for n in (0, 3, 10, 7, 1, 100_000)]
    with HostStaging("cpu", ints=ints) as staging:
        got = staging.fetch(*(torch.from_numpy(p) for p in parts))
        _same(got, parts)
        assert staging.nbytes == 4 * 100_021
        with pytest.raises(TypeError):
            staging.fetch(torch.zeros(3, dtype=torch.int64))


def _contigs(rng, lengths, n_runs=()):
    """Random codes, each (contig, start, length) of `n_runs` set to N."""
    codes = [rng.integers(0, 4, n).astype(np.uint8) for n in lengths]
    for c, a, n in n_runs:
        codes[c][a : a + n] = 4
    off = np.cumsum([0] + list(lengths[:-1])).astype(np.int64)
    return fasta.Contigs(names=[f"c{i}" for i in range(len(lengths))],
                         lengths=np.array(lengths, np.int64), offsets=off,
                         codes=np.concatenate(codes)).finalize()


@pytest.fixture(scope="module")
def scan_inputs():
    """k=18 tables with every entry at the cap at random (half of them),
    and contigs of 9,000 (N runs of 3,000 and 800 bp cut its good
    windows), 700, 10 (<= k: never scanned) and 3,000 bp."""
    rng = np.random.default_rng(11)
    tables = [torch.from_numpy(np.where(rng.random(1 << K) < 0.5, CAP, 0)
                               .astype(np.int8)) for _ in range(3)]
    contigs = _contigs(rng, [9_000, 700, 10, 3_000],
                       n_runs=[(0, 2_000, 3_000), (0, 6_500, 800)])
    masks, _ = encode.hasher_for(K, 3, Config().kmer.seed)
    return tables, contigs, masks


def _whole_contig_masks(tables, contigs, masks, cfg, cid):
    """One contig's masks from one scan row that holds all of it."""
    codes = contigs.contig_codes(cid)
    L = len(codes)
    halo = cfg.scan.window + 4 * K + 64
    row = np.full((1, L + 2 * halo), 4, np.uint8)
    row[0, :L] = codes
    g, p = extract.scan_rows(tables, torch.from_numpy(row), torch.tensor([L]),
                             masks, K, cfg.scan, cfg.kmer.least_depth)
    return g[0, :L].numpy(), p[0, :L].numpy()


def _expected(helpers, tables, contigs, masks, cfg):
    out = []
    for cid in range(1, contigs.n + 1):
        if contigs.length_of(cid) <= K:
            continue
        good, peak = _whole_contig_masks(tables, contigs, masks, cfg, cid)
        ivs, got = _want(helpers, good, peak, cfg.scan.window,
                         cfg.scan.good_pad, cfg.scan.merge_close_peak)
        runs = int(np.count_nonzero(good[1:] & ~good[:-1]) + good[0])
        out.append((cid, *got, runs))
    return out


def _scan(monkeypatch, tables, contigs, masks, cfg, chunk, rows,
          device="cpu"):
    monkeypatch.setattr(extract, "SCAN_CHUNK", chunk)
    monkeypatch.setattr(extract, "SCAN_ROWS", rows)
    metrics.reset()
    got = extract.scan_reference([t.to(device) for t in tables], contigs,
                                 masks, cfg, device)
    return got.per_contig(contigs), metrics.counters()


@pytest.mark.parametrize("chunk,rows", [(1 << 22, 8), (1 << 12, 2),
                                        (1 << 12, 3)])
def test_scan_reference_stitches_and_finalizes_each_contig(
        monkeypatch, scan_inputs, chunk, rows):
    """Whole contigs in one row each, and the 9,000-bp contig over four
    chunks of 4,096 (halo 636) stitched across rows and steps: equal to
    the host helpers over whole-contig masks, through the host expansion
    of the member code; one finalize a scanned contig, the bytes of its
    edges and peak positions counted."""
    tables, contigs, masks = scan_inputs
    cfg = Config().replace(kmer=KmerConfig(k=K))
    want = _expected(_jax_scan(), tables, contigs, masks, cfg)
    got, counters = _scan(monkeypatch, tables, contigs, masks, cfg, chunk,
                          rows)
    assert [g[0] for g in got] == [w[0] for w in want] == [1, 2, 4]
    for g, w in zip(got, want):
        _same(g[1:], w[1:4])
    assert len(want[0][1]) > 50 and want[0][4] > 1
    assert counters["scan_finalize_contigs"] == 3
    assert counters["scan_finalize_d2h_bytes"] == sum(
        4 * (2 * w[4] + len(w[1])) for w in want)


@pytest.mark.parametrize("into", [0, 1])
def test_scan_reference_cuts_at_max_peak_inside_a_contig(
        monkeypatch, scan_inputs, into):
    """--max_peak falls inside the first or the second contig: that
    contig's peaks are cut to the cap, the scan stops after it."""
    tables, contigs, masks = scan_inputs
    cfg = Config().replace(kmer=KmerConfig(k=K))
    want = _expected(_jax_scan(), tables, contigs, masks, cfg)
    before = sum(len(w[1]) for w in want[:into])
    keep = len(want[into][1]) // 2
    cfg = cfg.replace(scan=ScanConfig(max_peak=before + keep))
    got, counters = _scan(monkeypatch, tables, contigs, masks, cfg, 1 << 12,
                          2)
    assert [g[0] for g in got] == [w[0] for w in want[: into + 1]]
    for g, w in zip(got[:into], want):
        _same(g[1:], w[1:4])
    _, pos, mem, gid, _ = want[into]
    sel = gid < keep
    _same(got[into][1:], (pos[:keep], mem[sel], gid[sel]))
    assert counters["scan_finalize_contigs"] == into + 1


def _old_scan(contigs, planted, cfg):
    """Stage B before the member code: host peak arrays of each scanned
    contig's masks (`planted`: length -> (good, peak)) through the numpy
    helpers, cut at --max_peak."""
    out, total = [], 0
    for cid in range(1, contigs.n + 1):
        if contigs.length_of(cid) <= K:
            continue
        good, peak = planted[contigs.length_of(cid)]
        ivs = scan.good_intervals(good, cfg.scan.window, pad=cfg.scan.good_pad)
        pos, mem, gid = scan.peaks_in_intervals(peak, ivs,
                                                cfg.scan.merge_close_peak)
        if total + len(pos) > cfg.scan.max_peak:
            keep = max(0, cfg.scan.max_peak - total)
            sel = gid < keep
            pos, mem, gid = pos[:keep], mem[sel], gid[sel]
        total += len(pos)
        out.append((cid, pos, mem, gid))
        if total >= cfg.scan.max_peak:
            break
    return out


def _old_map(per_contig, contigs, tables, masks):
    """The map build before the member code stayed on the device: members
    flattened on the host, uploaded a chunk at a time and compacted by
    `_member_keys`. Returns (contig, pos, map, members taken)."""
    pcontig, ppos, gpos, pids = peaks._flatten_members(list(per_contig),
                                                       contigs, K)
    dm = torch.zeros(1 << K, dtype=torch.int32)
    CH = peaks.MAP_BUILD_CHUNK
    for base in range(0, len(contigs.codes), CH):
        lo, hi = np.searchsorted(gpos, [base, base + CH])
        if hi == lo:
            continue
        codes = np.full(CH + K, 4, np.uint8)
        avail = contigs.codes[base : base + CH + K]
        codes[: len(avail)] = avail
        h, v = encode.canonical_hashes(torch.from_numpy(codes)[None], masks, K)
        keys, vals = peaks._member_keys(
            h[:, 0], v[0], tables, torch.from_numpy(gpos[lo:hi] - base),
            torch.from_numpy(pids[lo:hi]))
        dm.scatter_reduce_(0, keys, vals, reduce="amax")
    return pcontig, ppos, dm, len(gpos)


def _plant(rng, name):
    """(contig lengths, {length: (good, peak)}, max_peak) of each planted
    fixture; every scanned contig is all good, its peaks ~30% of it."""
    lengths = [3010, 1500, 2600]
    if name == "short_contig":  # never scanned: a contig of k and one less
        lengths = [3010, K, 1500, 5, 2600]
    planted = {L: (np.ones(L, bool), rng.random(L) < 0.3) for L in lengths}
    p1, p2, p3 = (planted[L][1] for L in (3010, 1500, 2600))
    max_peak = ScanConfig().max_peak
    if name == "peak_past_end":
        # the bin [3000, 3050) of the first contig holds members only
        # past len - k = 2992: a peak with no k-mer, whose id still counts
        p1[2950:] = False
        p1[3001:3009] = True
    elif name == "bin_across_chunk":
        # at a 1,024-bp map chunk, the bins [1000, 1050) of the first
        # contig and [50, 100) of the second (global [3060, 3110)) start
        # in one chunk and end in the next; the first contig's second
        # chunk holds no peak start, its third starts with one
        p1[:] = False
        p1[[1010, 2048, 2049]] = True
        p1[1024:1050] = True
        p2[50:100] = False
        p2[[55, 70, 90]] = True
    elif name == "repeat":  # the third contig repeats the first's members
        p1[500:900] = p3[1000:1400] = True
    elif name == "no_peak":
        for _, peak in planted.values():
            peak[:] = False
    elif name in ("cut_first", "cut_second"):
        n1 = len(np.unique((np.flatnonzero(p1[1:]) + 1) // 50))  # c1's
        max_peak = n1 // 2 if name == "cut_first" else n1 + 7
    return lengths, planted, max_peak


PLANTED = ["peak_past_end", "cut_first", "cut_second", "bin_across_chunk",
           "repeat", "short_contig", "no_peak"]


@pytest.mark.parametrize("chunk", [1 << 10, 1 << 14])
@pytest.mark.parametrize("name", PLANTED)
def test_map_from_the_member_code_equals_the_host_route(monkeypatch, name,
                                                        chunk):
    """Stage B on planted masks (each contig one scan row, its masks put in
    place of the stencils'), then the map build from the member code, at a
    map chunk of 1,024 bp (the reference spans several) and 16,384 (one):
    the code's host expansion equal to the host helpers' arrays, the map,
    the peak table and `peakset_members` equal to the host route's."""
    rng = np.random.default_rng(len(name))
    lengths, planted, max_peak = _plant(rng, name)
    contigs = _contigs(rng, lengths)
    if name == "repeat":
        o1, o3 = contigs.offsets[0], contigs.offsets[2]
        contigs.codes[o3 + 1000 : o3 + 1400] = contigs.codes[o1 + 500 : o1 + 900]
    tables = [torch.from_numpy(np.where(rng.random(1 << K) < 0.7, CAP, 0)
                               .astype(np.int8)) for _ in range(3)]
    masks, _ = encode.hasher_for(K, 3, Config().kmer.seed)
    cfg = Config().replace(kmer=KmerConfig(k=K),
                           scan=ScanConfig(max_peak=max_peak))

    def scan_rows(tables, codes, true_len, masks, k, scan_cfg, least_depth):
        g = torch.zeros(codes.shape, dtype=torch.bool)
        p = torch.zeros_like(g)
        for r, n in enumerate(true_len.tolist()):
            if n:
                g[r, :n] = torch.from_numpy(planted[n][0])
                p[r, :n] = torch.from_numpy(planted[n][1])
        return g, p

    monkeypatch.setattr(extract, "scan_rows", scan_rows)
    monkeypatch.setattr(peaks, "MAP_BUILD_CHUNK", chunk)
    want = _old_scan(contigs, planted, cfg)
    metrics.reset()
    found = extract.scan_reference(tables, contigs, masks, cfg, "cpu")
    got = found.per_contig(contigs)
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        _same(g[1:], w[1:])
    pset = peaks.build_direct_map(found, contigs, tables, masks, K,
                                  cfg.scan.merge_close_peak, "cpu")
    counted = metrics.counters()["peakset_members"]
    pcontig, ppos, dm, n_members = _old_map(want, contigs, tables, masks)
    _same([pset.contig, pset.pos], [pcontig, ppos])
    np.testing.assert_array_equal(pset.direct_map.numpy(), dm.numpy())
    assert counted == n_members
    n_peaks = sum(len(w[1]) for w in want)
    assert (n_peaks == 0) == (name == "no_peak") == (n_members == 0)
    if name != "no_peak":
        assert (dm.numpy() > 0).sum() > 100
    if name.startswith("cut"):
        assert n_peaks == max_peak and len(want) == 1 + (name == "cut_second")
    if name == "peak_past_end":
        assert 3001 in ppos and not (dm.numpy() == np.flatnonzero(
            ppos == 3001)[0]).any()
    if name == "short_contig":
        assert [w[0] for w in want] == [1, 3, 5]


@pytest.mark.parametrize("chunk", [1 << 10, 1 << 14])
def test_map_from_the_scanned_member_code_equals_the_host_route(
        monkeypatch, scan_inputs, chunk):
    """The same through stage B's real stencils, the 9,000-bp contig over
    chunks of 4,096: the map, peak table and member count equal the host
    route's from the helpers' arrays of whole-contig masks."""
    tables, contigs, masks = scan_inputs
    cfg = Config().replace(kmer=KmerConfig(k=K))
    want = [w[:4] for w in _expected(scan, tables, contigs, masks, cfg)]
    monkeypatch.setattr(extract, "SCAN_CHUNK", 1 << 12)
    monkeypatch.setattr(peaks, "MAP_BUILD_CHUNK", chunk)
    metrics.reset()
    found = extract.scan_reference(tables, contigs, masks, cfg, "cpu")
    pset = peaks.build_direct_map(found, contigs, tables, masks, K,
                                  cfg.scan.merge_close_peak, "cpu")
    pcontig, ppos, dm, n_members = _old_map(want, contigs, tables, masks)
    _same([pset.contig, pset.pos], [pcontig, ppos])
    np.testing.assert_array_equal(pset.direct_map.numpy(), dm.numpy())
    assert metrics.counters()["peakset_members"] == n_members > 0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's finalize and its "
                    "pinned staging run only there")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_finalize_on_the_card_equals_the_cpu(monkeypatch, dev, scan_inputs):
    """Every case above and a 1.2 Mbp contig at this cell's density on the
    card, through the default pinned buffer and one of 1,000 slots: equal
    to the CPU run and to the port's numpy helpers; scan_reference on the
    card equal to the CPU's, stitched across chunks and steps."""
    for name in CASES:
        good, peak, window, pad = _case(name)
        _, want = _want(scan, good, peak, window, pad)
        for ints in (STAGING_INTS, 1_000):
            code = torch.zeros(len(good), dtype=torch.uint8, device=dev)
            with HostStaging(dev, ints=ints) as staging:
                pos = scan.finalize_contig(
                    torch.from_numpy(good).to(dev),
                    torch.from_numpy(peak).to(dev), window, pad, 50, K,
                    code, staging.fetch)
            got = scan.members_of(code.cpu().numpy())
            _same(got, want)
            _same([pos], [got[0].astype(np.int32)])
    tables, contigs, masks = scan_inputs
    cfg = Config().replace(kmer=KmerConfig(k=K))
    for chunk, rows in ((1 << 22, 8), (1 << 12, 2)):
        on_cpu, c_cpu = _scan(monkeypatch, tables, contigs, masks, cfg, chunk,
                              rows)
        on_card, c_card = _scan(monkeypatch, tables, contigs, masks, cfg,
                                chunk, rows, device=dev)
        assert [g[0] for g in on_card] == [g[0] for g in on_cpu]
        for a, b in zip(on_card, on_cpu):
            _same(a[1:], b[1:])
        for key in ("scan_finalize_contigs", "scan_finalize_d2h_bytes"):
            assert c_card[key] == c_cpu[key]


@pytest.mark.cuda
def test_map_build_on_the_card_equals_the_cpu(monkeypatch, dev):
    """The 1.2 Mbp contig at this cell's density and a 3,000-bp one behind
    it, finalized into the member code and built into the map on the card
    (K4's hashes, the pinned buffer) and on the CPU, at the map chunk of
    the main path and at 2^18 bp: the map, the peak table and
    `peakset_members` equal."""
    rng = np.random.default_rng(12)
    planted = [_realistic(rng), (np.ones(3_000, bool),
                                 rng.random(3_000) < 0.3)]
    contigs = _contigs(rng, [len(g) for g, _ in planted])
    tables = [np.where(rng.random(1 << K) < 0.7, CAP, 0).astype(np.int8)
              for _ in range(3)]
    masks, _ = encode.hasher_for(K, 3, Config().kmer.seed)

    def build(device):
        found = peaks.PeakMembers(
            code=torch.zeros(len(contigs.codes), dtype=torch.uint8,
                             device=device), peaks=[])
        with HostStaging(device) as staging:
            for cid, (good, peak) in enumerate(planted, 1):
                off = int(contigs.offsets[cid - 1])
                pos = scan.finalize_contig(
                    torch.from_numpy(good).to(device),
                    torch.from_numpy(peak).to(device), 500, 1000, 50, K,
                    found.code[off : off + len(good)], staging.fetch)
                found.peaks.append((cid, pos))
        metrics.reset()
        pset = peaks.build_direct_map(
            found, contigs, [torch.from_numpy(t).to(device) for t in tables],
            masks, K, 50, device)
        return pset, metrics.counters()["peakset_members"]

    for chunk in (peaks.MAP_BUILD_CHUNK, 1 << 18):
        monkeypatch.setattr(peaks, "MAP_BUILD_CHUNK", chunk)
        on_cpu, n_cpu = build("cpu")
        on_card, n_card = build(dev)
        _same([on_card.contig, on_card.pos], [on_cpu.contig, on_cpu.pos])
        np.testing.assert_array_equal(on_card.direct_map.cpu().numpy(),
                                      on_cpu.direct_map.numpy())
        assert n_card == n_cpu > 600_000 and on_cpu.n > 10_000
