"""The port's own copies of the host modules against their originals in
the JAX package, on seeded numpy inputs, exact equality throughout: the
port imports nothing of `localhgt_tpu`, so these tests are what keeps the
two sides of every parity test from drifting apart."""

import dataclasses
import os

import numpy as np
import pytest

import localhgt_tpu.cli as jax_cli
import localhgt_tpu.config as jax_config
import localhgt_tpu.index.reference as jax_reference
import localhgt_tpu.io.fasta as jax_fasta
import localhgt_tpu.io.fastq as jax_fastq
import localhgt_tpu.io.native as jax_native
import localhgt_tpu.ops.coder as jax_coder
import localhgt_tpu.ops.encode as jax_encode
import localhgt_tpu.ops.scan as jax_scan
import localhgt_tpu.pipeline.accbkp as jax_accbkp
import localhgt_tpu.pipeline.align as jax_align
import localhgt_tpu.pipeline.event as jax_event
import localhgt_tpu.pipeline.rawbkp as jax_rawbkp
import localhgt_tpu.sim.evaluate as jax_evaluate
import localhgt_tpu.sim.simulate as jax_simulate
import localhgt_tpu.tools.validate_events as jax_validate_events
import localhgt_tpu.utils.formats as jax_formats
import localhgt_tpu.utils.metrics as jax_metrics
import localhgt_tpu.utils.validate as jax_validate
import localhgt_tpu_torch.cli as cli
import localhgt_tpu_torch.config as config
import localhgt_tpu_torch.index.reference as reference
import localhgt_tpu_torch.io.fasta as fasta
import localhgt_tpu_torch.io.fastq as fastq
import localhgt_tpu_torch.io.native as native
import localhgt_tpu_torch.ops.coder as coder
import localhgt_tpu_torch.ops.encode as encode
import localhgt_tpu_torch.ops.scan as scan
import localhgt_tpu_torch.pipeline.accbkp as accbkp
import localhgt_tpu_torch.pipeline.align as align
import localhgt_tpu_torch.pipeline.event as event
import localhgt_tpu_torch.pipeline.rawbkp as rawbkp
import localhgt_tpu_torch.sim.evaluate as evaluate
import localhgt_tpu_torch.sim.simulate as simulate
import localhgt_tpu_torch.tools.validate_events as validate_events
import localhgt_tpu_torch.utils.formats as formats
import localhgt_tpu_torch.utils.metrics as metrics
import localhgt_tpu_torch.utils.validate as validate

GOLD = os.path.join(os.path.dirname(__file__), "golden")
SIM = dict(n_genomes=6, genome_len=30_000, hgt_num=3, depth=8,
           snp_rate=0.01, seed=33)  # the golden fixture of test_golden.py


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same(a, b):
    """Exact equality of nested tuples/lists/dicts/dataclasses/arrays."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """One simulated sample per package, from the same seed."""
    out = {}
    for name, mod in (("jax", jax_simulate), ("torch", simulate)):
        d = str(tmp_path_factory.mktemp(f"host_{name}"))
        out[name] = mod.simulate_sample(d, "gold", mod.SimParams(**SIM))
    return out


def _aln_tables(mod, rng, n=400):
    """Two mates' AlnTable of module `mod` from one seeded draw: pairs
    cluster around a few junctions between contigs 1..4."""
    def table(mate, contig, pos):
        z = np.zeros(n, np.int32)
        return mod.AlnTable(
            read_id=np.arange(n, dtype=np.int64),
            mate=np.full(n, mate, np.int8), contig=contig.astype(np.int32),
            pos=pos.astype(np.int64), rend=(pos + 149).astype(np.int64),
            strand=strand[mate], qstart=z.copy(),
            qend=np.full(n, 149, np.int32), score=np.full(n, 150, np.int32),
            mapq=mapq[mate], rlen=np.full(n, 150, np.int32),
            contig2=np.full(n, -1, np.int32), pos2=np.zeros(n, np.int64),
            rend2=np.zeros(n, np.int64), strand2=np.zeros(n, np.int8),
            qstart2=z.copy(), qend2=z.copy(), score2=z.copy(),
            has_alt=alt[mate])

    junction = rng.integers(0, 6, n)
    c1 = 1 + junction % 4
    cross = rng.random(n) < 0.4
    c2 = np.where(cross, 1 + (junction + 1) % 4, c1)
    base = 2_000 + 3_000 * junction
    p1 = base + rng.integers(0, 200, n)
    p2 = np.where(cross, base + 9_000 + rng.integers(0, 200, n),
                  p1 + rng.integers(100, 300, n))
    strand = [(rng.random(n) < 0.2).astype(np.int8),
              (rng.random(n) < 0.8).astype(np.int8)]
    mapq = [rng.integers(0, 61, n).astype(np.int16) for _ in range(2)]
    alt = [rng.random(n) < 0.1 for _ in range(2)]
    return table(0, c1, p1), table(1, c2, p2)


def _check_config():
    _same(dataclasses.asdict(config.Config()),
          dataclasses.asdict(jax_config.Config()))
    for name in ("KmerConfig", "ScanConfig", "AlignConfig", "BkpConfig",
                 "EventConfig"):
        a, b = getattr(config, name)(), getattr(jax_config, name)()
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)]
        _same(a, b)


def _check_coder():
    rng = np.random.default_rng(1)
    seq = "".join("ACGTNacgtn"[i] for i in rng.integers(0, 10, 500))
    codes = coder.seq_to_codes(seq)
    _same(codes, jax_coder.seq_to_codes(seq))
    assert coder.codes_to_seq(codes) == jax_coder.codes_to_seq(codes)
    _same(coder.revcomp_codes(codes), jax_coder.revcomp_codes(codes))
    _same(coder.COMPLEMENT, jax_coder.COMPLEMENT)
    a, b = coder.GlibcRand(7), jax_coder.GlibcRand(7)
    assert [a.rand() for _ in range(50)] == [b.rand() for _ in range(50)]
    for k, n, seed in ((18, 3, 1), (32, 3, 1), (24, 5, 9)):
        cc = coder.choose_coder(k, n, seed)
        _same(cc, jax_coder.choose_coder(k, n, seed))
        _same(coder.hash_masks(cc, k), jax_coder.hash_masks(cc, k))
        _same(encode.hasher_for(k, n, seed), jax_encode.hasher_for(k, n, seed))
        _same(coder.reference_kmer_hashes(codes, cc, k),
              jax_coder.reference_kmer_hashes(codes, cc, k))


def _check_simulate(sample):
    assert len(sample["jax"]) == len(sample["torch"]) == 4
    for pj, pt in zip(sample["jax"], sample["torch"]):
        assert os.path.basename(pj) == os.path.basename(pt)
        assert _bytes(pj) == _bytes(pt) and len(_bytes(pt)) > 100
    _same(simulate.read_truth(sample["torch"][3]),
          jax_simulate.read_truth(sample["jax"][3]))


def _check_readers(sample):
    ref, fq1, fq2, _ = sample["torch"]
    a, b = fasta.read_fasta(ref), jax_fasta.read_fasta(ref)
    assert a.names == b.names
    _same(a.codes, b.codes)
    _same(a.offsets, b.offsets)
    _same(a.slice_codes(2, 100, 400), b.slice_codes(2, 100, 400))
    assert native.available() and jax_native.available()
    assert "localhgt_tpu_torch" in str(native.library_path())
    for use_native in (False, True):
        kw = dict(batch_reads=1000, max_len=192, use_native=use_native)
        got = list(fastq.iter_fastq_batches(fq1, **kw))
        want = list(jax_fastq.iter_fastq_batches(fq1, **kw))
        assert len(got) == len(want) > 1
        for x, y in zip(got, want):
            _same(x.codes, y.codes)
            _same(x.lengths, y.lengths)
            assert x.start_ordinal == y.start_ordinal
    _same(fastq.count_bases(fq1), jax_fastq.count_bases(fq1))
    _same(native.count_bases(fq2), jax_native.count_bases(fq2))
    assert fastq.downsample_ratio(1e5, fq1) == \
        jax_fastq.downsample_ratio(1e5, fq1)
    for strict in (False, True):
        _same(fastq.accept_mask(500, 3000, 37.5, 1, strict),
              jax_fastq.accept_mask(500, 3000, 37.5, 1, strict))
    pairs = zip(fastq.paired_batches(fq1, fq2, batch_reads=4096),
                jax_fastq.paired_batches(fq1, fq2, batch_reads=4096))
    for (x1, x2), (y1, y2) in pairs:
        _same(x1.codes, y1.codes)
        _same(x2.codes, y2.codes)
    _same(native.glibc_random_array(3, 1000),
          jax_native.glibc_random_array(3, 1000))


def _check_reference(sample):
    outs = []
    for key, mod in (("torch", reference), ("jax", jax_reference)):
        ref = sample[key][0]
        c = mod.build(ref, force=True)
        again = mod.load(ref)
        _same(c.codes, again.codes)
        outs.append((c.names, c.codes, c.offsets, _bytes(mod.index_path(ref)),
                     os.path.basename(mod.index_path(ref))))
    assert outs[0][0] == outs[1][0]
    _same(outs[0][1:], outs[1][1:])


def _check_scan():
    rng = np.random.default_rng(2)
    good = np.zeros(20_000, bool)
    for a in rng.integers(0, 19_000, 6):
        good[a : a + int(rng.integers(50, 400))] = True
    peak = rng.random(20_000) < 0.01
    for window in (50, 200):
        iv = scan.good_intervals(good, window)
        _same(iv, jax_scan.good_intervals(good, window))
        assert len(iv) > 1
        _same(scan.peaks_in_intervals(peak, iv, 50),
              jax_scan.peaks_in_intervals(peak, iv, 50))
    peaks = sorted((int(r), int(p)) for r, p in
                   zip(rng.integers(0, 3, 200), rng.integers(1, 50_000, 200)))
    lens = {0: 40_000, 1: 50_000, 2: 45_000}
    _same(scan.final_intervals(peaks, 500, 300, lens),
          jax_scan.final_intervals(peaks, 500, 300, lens))
    for w, r in ((500, 0.1), (500, 0.08), (333, 0.7)):
        assert scan.truncated_min(w, r) == jax_scan.truncated_min(w, r)


def _check_align_host(sample):
    c = fasta.read_fasta(sample["torch"][0])
    iv = [(1, 1_000, 4_000), (2, 500, 2_500), (3, 10, 900)]
    rng = np.random.default_rng(3)
    subs = [m.build_subref(c, iv) for m in (align, jax_align)]
    _same(subs[0], subs[1])
    idx = [m.SeedIndex.build(s, 19) for m, s in zip((align, jax_align), subs)]
    _same(idx[0].sorted_hash, idx[1].sorted_hash)
    _same(idx[0].sorted_pos, idx[1].sorted_pos)
    _same(idx[0].prefix32, idx[1].prefix32)
    flat = rng.integers(0, len(subs[0].codes), 300)
    _same(subs[0].lift(flat), subs[1].lift(flat))
    q = np.sort(rng.integers(0, 50, 2_000))
    diag = rng.integers(0, 5_000, 2_000) // 40 * 40
    off = rng.integers(0, 130, 2_000)
    args = (q, diag, off, 50)
    kw = dict(gap=32, max_candidates=4, min_votes=2)
    _same(align._group_candidates(*args, **kw),
          jax_align._group_candidates(*args, **kw))
    sc = rng.integers(19, 151, 500).astype(np.int32)
    comp = rng.integers(0, 151, 500).astype(np.int32)
    args = (sc, comp, rng.integers(0, 4, 500), rng.integers(30, 200, 500))
    _same(align._bwa_mapq(*args, config.AlignConfig()),
          jax_align._bwa_mapq(*args, jax_config.AlignConfig()))
    codes = rng.integers(0, 5, (40, 160)).astype(np.uint8)
    lens = rng.integers(20, 161, 40).astype(np.int32)
    _same(align._revcomp_batch(codes, lens),
          jax_align._revcomp_batch(codes, lens))
    assert (align.SEP, align.PREFILTER_LEN) == \
        (jax_align.SEP, jax_align.PREFILTER_LEN)


def _check_rawbkp():
    outs = []
    for mod, tab, cfgm in ((rawbkp, align, config),
                           (jax_rawbkp, jax_align, jax_config)):
        a1, a2 = _aln_tables(tab, np.random.default_rng(4))
        cfg = cfgm.BkpConfig()
        ins = mod.estimate_insert(a1, a2, cfg)
        raw = mod.call_raw_bkps(a1, a2, ins, cfg)
        strict = dataclasses.replace(cfg, keep_xa=0)
        outs.append((mod.pair_tlen(a1, a2), ins, raw,
                     mod.call_raw_bkps(a1, a2, ins, strict)))
    assert len(outs[0][2]) > 2
    _same(outs[0], outs[1])


def _check_accbkp_host():
    outs = []
    for mod, raw_mod, tab, cfgm in (
            (accbkp, rawbkp, align, config),
            (jax_accbkp, jax_rawbkp, jax_align, jax_config)):
        a1, a2 = _aln_tables(tab, np.random.default_rng(5))
        cfg = cfgm.BkpConfig()
        ins = raw_mod.estimate_insert(a1, a2, cfg)
        raw = raw_mod.call_raw_bkps(a1, a2, ins, cfg)
        clusters = mod.cluster_raw_bkps(raw, cfg)
        outs.append(([dataclasses.asdict(c) for c in clusters],
                     mod._enumerate_tasks(clusters, 150, cfg)))
    assert len(outs[0][0]) > 1
    _same(outs[0], outs[1])


def _check_event(sample, tmp_path):
    outs = []
    for key, mod, cfgm in (("torch", event, config),
                           ("jax", jax_event, jax_config)):
        d = tmp_path / key
        d.mkdir()
        (d / "gold.acc.csv").write_bytes(
            _bytes(os.path.join(GOLD, "gold.acc.csv")))
        out = str(d / "events.csv")
        cfg = dataclasses.replace(cfgm.EventConfig(), min_hgt_len=200)
        mod.detect_event(sample[key][0], str(d), out, cfg)
        outs.append(_bytes(out))
    assert outs[0] == outs[1] == _bytes(os.path.join(GOLD, "gold.events.csv"))


def _check_formats(sample, tmp_path):
    gold = os.path.join(GOLD, "gold.acc.csv")
    got, want = formats.read_acc_csv(gold), jax_formats.read_acc_csv(gold)
    _same(got, want)
    assert formats.HEADER == jax_formats.HEADER and len(got[0]) > 1
    contigs = fasta.read_fasta(sample["torch"][0])
    rng = np.random.default_rng(7)
    spots = [(int(rng.integers(1, 5)), int(rng.integers(0, 8)) * 40 + 1_000,
              int(rng.integers(1, 5)), int(rng.integers(0, 8)) * 40 + 5_000,
              bool(rng.integers(0, 2))) for _ in range(60)]
    outs = []
    for mod, acc_mod, name in ((formats, accbkp, "t.csv"),
                               (jax_formats, jax_accbkp, "j.csv")):
        accs = [acc_mod.AccBkp(a, p, "right", "+", b, q, "left", "-", rev,
                               "ACGT", "ACGA", 0.75, 3, 4, 5, 6)
                for a, p, b, q, rev in spots]
        for a in accs[::3]:
            a.refine()
        kept = mod.dedup_rows(accs)
        mod.write_acc_csv(str(tmp_path / name), kept, contigs, 123, 456)
        outs.append([dataclasses.asdict(a) for a in kept])
    assert 1 < len(outs[0]) < len(spots)
    _same(outs[0], outs[1])
    assert _bytes(tmp_path / "t.csv") == _bytes(tmp_path / "j.csv")
    _same(formats.read_acc_csv(str(tmp_path / "t.csv")),
          jax_formats.read_acc_csv(str(tmp_path / "j.csv")))


def _check_evaluate(sample):
    truth = simulate.read_truth(sample["torch"][3])
    jtruth = jax_simulate.read_truth(sample["jax"][3])
    tb = evaluate.truth_to_bkps(truth)
    _same(tb, jax_evaluate.truth_to_bkps(jtruth))
    rng = np.random.default_rng(6)
    called = [(a, p + int(rng.integers(-80, 80)), b, q)
              for a, p, b, q in tb[::2]] + [("G0_1", 5, "G1_1", 9)]
    _same(evaluate.score_bkps(tb, called),
          jax_evaluate.score_bkps(tb, called))
    ev = [(t.receptor, t.insert_locus, t.donor, t.seg_start, t.seg_end)
          for t in truth]
    shifted = [(r, i + 30, d, s, e - 60) for r, i, d, s, e in ev]
    _same(evaluate.score_events(ev, shifted),
          jax_evaluate.score_events(ev, shifted))
    rows, _, _ = formats.read_acc_csv(os.path.join(GOLD, "gold.acc.csv"))
    beds = {}
    for r in rows:
        beds.setdefault(r["from_ref"], []).append(
            (max(1, int(r["from_pos"]) - 400), int(r["from_pos"]) + 400))
    _same(evaluate.extraction_recall(truth, beds),
          jax_evaluate.extraction_recall(jtruth, beds))
    assert evaluate.TOLERATE_DIST == jax_evaluate.TOLERATE_DIST


def _check_validate_and_metrics(sample, tmp_path):
    ref, fq1, fq2, _ = sample["torch"]
    bad = tmp_path / "bad.fq"
    bad.write_bytes(b"\x1f\x8b\x08rest")
    missing = str(tmp_path / "none.fq")
    for args in ((ref, fq1, fq2, str(tmp_path)),
                 (ref, str(bad), fq2, str(tmp_path)),
                 (ref, fq1, missing, str(tmp_path)),
                 (fq1, fq1, fq2, str(tmp_path))):
        msgs = []
        for mod in (validate, jax_validate):
            try:
                mod.check_bkp_inputs(*args)
                msgs.append(None)
            except mod.InputError as e:
                msgs.append(str(e))
        assert msgs[0] == msgs[1]
    for mod in (metrics, jax_metrics):
        mod.reset()
        with mod.stage("a"):
            mod.add("n", 2)
            mod.add("n", 3)
        for v in (3.0, 1.0, 2.0):
            mod.record("s", v)
    assert metrics.counters() == jax_metrics.counters() == {"n": 5.0}
    assert metrics.series_stats() == jax_metrics.series_stats()
    assert list(metrics.stage_walls()) == list(jax_metrics.stage_walls())
    assert list(metrics.stage_rss()) == ["a"]
    c = fasta.read_fasta(ref)
    jc = jax_fasta.read_fasta(ref)
    args = ("G001_1", 5_000, "G002_1", 1_000, 3_000, True, 300)
    _same(validate_events.reconstruct_junctions(c, *args),
          jax_validate_events.reconstruct_junctions(jc, *args))


def _check_grid_and_derived():
    """The sweep's grids are the original's, and `metrics.derived` gives
    the original's numbers from the same registry contents, the device
    count step's `count_step_gbps_device` included."""
    import localhgt_tpu.sim.grid as jax_grid
    import localhgt_tpu_torch.sim.grid as grid

    assert grid.SCENARIOS == jax_grid.SCENARIOS
    assert grid.AMOUNT_FRACTIONS == jax_grid.AMOUNT_FRACTIONS
    for mod in (metrics, jax_metrics):
        mod.reset()
        mod.add_time("count", 2.5)
        mod.add_time("align", 1.25)
        mod.add("sw_cells", 3e9)
        mod.add("count_batches", 7)
        for v in (0.01, 0.02):
            mod.record("sw_kernel_s", v)
            mod.record("count_step_device_s", v)
    want = jax_metrics.derived(1000, 150, 3)
    assert metrics.derived(1000, 150, 3) == want
    assert set(want) == {"count_scatter_gbps_stage", "count_step_gbps_device",
                         "sw_gcups_stage", "sw_gcups_kernel"}
    for mod in (metrics, jax_metrics):
        mod.reset()
    assert metrics.derived(1000, 150, 3) == jax_metrics.derived(1000, 150, 3)


def _options(parser):
    """{subcommand: {option strings: (dest, default, type, choices,
    required, nargs, help)}} of an argparse parser."""
    sub = parser._subparsers._group_actions[0]
    out = {}
    for name, p in sub.choices.items():
        out[name] = {
            tuple(a.option_strings) or (a.dest,): (
                a.dest, a.default, a.type, a.choices and tuple(a.choices),
                a.required, a.nargs, a.help)
            for a in p._actions if a.dest != "help"}
    return out, {n: a.help for n, a in zip(
        sub.choices, sub._choices_actions)}


def _check_parser():
    got, got_help = _options(cli.build_parser())
    want, want_help = _options(jax_cli.build_parser())
    assert got_help == want_help
    assert list(got) == list(want) == ["bkp", "event", "analyze"]
    for cmd in ("bkp", "analyze"):
        dev = got[cmd].pop(("--device",))
        assert dev[:2] == ("device", "cuda")
    assert ("--device",) not in got["event"]
    # --multi_chip keeps its choices and default; its help no longer
    # speaks of jax.sharding, which the port does not use
    mc, jmc = got["bkp"].pop(("--multi_chip",)), want["bkp"].pop(
        ("--multi_chip",))
    assert mc[:6] == jmc[:6]
    assert got == want
    argv = ["bkp", "-r", "r.fa", "--fq1", "a", "--fq2", "b", "-k", "24",
            "-e", "4", "-q", "30", "-a", "0", "--hit_ratio", "0.2",
            "--sample", "1e6", "-t", "3", "--count_ckpt", "ck"]
    a = cli.build_parser().parse_args(argv)
    b = jax_cli.build_parser().parse_args(argv)
    _same(dataclasses.asdict(cli.config_from_args(a)),
          dataclasses.asdict(jax_cli.config_from_args(b)))


GROUPS = {
    "config": lambda s, t: _check_config(),
    "coder": lambda s, t: _check_coder(),
    "simulate": lambda s, t: _check_simulate(s),
    "fasta_fastq_readers": lambda s, t: _check_readers(s),
    "reference": lambda s, t: _check_reference(s),
    "scan_host": lambda s, t: _check_scan(),
    "align_host": lambda s, t: _check_align_host(s),
    "rawbkp": lambda s, t: _check_rawbkp(),
    "accbkp_host": lambda s, t: _check_accbkp_host(),
    "event": _check_event,
    "formats": _check_formats,
    "evaluate": lambda s, t: _check_evaluate(s),
    "validate_metrics_junctions": _check_validate_and_metrics,
    "parser": lambda s, t: _check_parser(),
    "grid_derived": lambda s, t: _check_grid_and_derived(),
}


@pytest.mark.parametrize("group", list(GROUPS))
def test_host_copy_equals_original(group, sample, tmp_path):
    GROUPS[group](sample, tmp_path)
