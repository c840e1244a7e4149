"""Command-line interface of the port: the `localhgt` commands on torch.

    python -m localhgt_tpu_torch.cli bkp -r ref.fa --fq1 s.1.fq \
        --fq2 s.2.fq -s sample -o outdir [--device cuda]
    python -m localhgt_tpu_torch.cli event -r ref.fa -b outdir -f events.csv
    python -m localhgt_tpu_torch.cli analyze microhomology -b outdir \
        -r ref.fa [--device cuda]

Options, defaults and help text are those of localhgt_tpu/cli.py, plus
`--device` on `bkp` and `analyze` (default cuda; raises when CUDA is
absent), which `bkp` and the device analyses (`microhomology`,
`mechanism`, `classifier`, `lodo`) use. `event` and the other analyses are
host-only. `--multi_chip on` runs extraction over a mesh of every
visible CUDA device (one shard on the CPU with `--device cpu`).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from localhgt_tpu_torch.config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="localhgt_tpu_torch",
        description="LocalHGT on PyTorch and CUDA: ultrafast HGT detection "
        "from large microbial communities",
    )
    sub = p.add_subparsers(dest="command")

    b = sub.add_parser("bkp", help="Detect HGT breakpoints from metagenomic "
                       "sequencing data.")
    b.add_argument("-r", required=True, help="reference FASTA")
    b.add_argument("--fq1", required=True)
    b.add_argument("--fq2", required=True)
    b.add_argument("-s", default="sample", help="sample name")
    b.add_argument("-o", default="./", help="output folder")
    b.add_argument("-k", type=int, default=32, help="kmer length")
    b.add_argument("-t", type=int, default=10, help="host threads")
    b.add_argument("-e", type=int, default=3, help="number of hash functions")
    b.add_argument("-a", type=int, default=1, help="retain multi-hit reads")
    b.add_argument("-q", type=int, default=20, help="min mapping quality")
    b.add_argument("--seed", type=int, default=1)
    b.add_argument("--use_kmer", type=int, default=1)
    b.add_argument("--hit_ratio", type=float, default=0.1)
    b.add_argument("--match_ratio", type=float, default=0.08)
    b.add_argument("--max_peak", type=int, default=300000000)
    b.add_argument("--sample", dest="sample_bp", type=float, default=2e9)
    b.add_argument("--read_info", type=int, default=1)
    b.add_argument("--refine_fq", type=int, default=0,
                   help="run fastp-equivalent read QC before detection")
    b.add_argument("--multi_chip", choices=["auto", "on", "off"],
                   default="auto",
                   help="run extraction over all visible chips "
                        "(auto: when >1 device; intervals are identical to "
                        "single-device)")
    b.add_argument("--count_ckpt", default="",
                   help="directory for stage-A count-table checkpoints "
                   "(resume the k-mer counting pass across runs)")
    b.add_argument("--device", default="cuda",
                   help="torch device of every device step (default cuda; "
                   "raises when CUDA is absent)")

    e = sub.add_parser("event", help="Infer complete HGT events from "
                       "detected breakpoints.")
    e.add_argument("-r", required=True, help="reference FASTA")
    e.add_argument("-b", required=True, help="folder with *.acc.csv files")
    e.add_argument("-f", default="complete_HGT_event.csv", help="output CSV")
    e.add_argument("-n", type=int, default=2, help="min split reads")
    e.add_argument("-m", type=int, default=500, help="min transfer length")

    a = sub.add_parser(
        "analyze",
        help="Downstream cohort analyses (paper_results equivalents: "
        "stats, microhomology, mechanism, network, classifier).")
    a.add_argument("what", choices=[
        "stats", "microhomology", "mechanism", "network", "classifier",
        "lodo", "kegg", "timeline", "transfer_gene", "association",
        "phenotype_table"])
    a.add_argument("-b", help="folder with *.acc.csv files")
    a.add_argument("-r", help="reference FASTA (microhomology/mechanism)")
    a.add_argument("-e", help="event CSV (mechanism)")
    a.add_argument("-f", default="", help="output CSV/JSON path (default: stdout)")
    a.add_argument("--pheno", help="phenotype CSV: sample,cohort,disease[,full]")
    a.add_argument("--meta", help="UHGG genomes metadata TSV (taxonomy)")
    a.add_argument("--group1", default="CRC")
    a.add_argument("--group2", default="control")
    a.add_argument("--level", default="all",
                   help="taxonomy level for network edges (phylum..species, "
                   "or 'all' to sweep levels 1-6)")
    a.add_argument("--n-random", type=int, default=10000,
                   help="random junction pairs for the microhomology null")
    a.add_argument("--tandem", help="tandem-repeat interval file (mechanism)")
    a.add_argument("--tei", help="TE insertion interval file (mechanism)")
    a.add_argument("--model", choices=["logreg", "rf"], default="logreg")
    a.add_argument("--markers", type=int, default=20)
    a.add_argument("--kos", help="input KO id list, one per line (kegg)")
    a.add_argument("--background-kos",
                   help="background KO id list, one per line (kegg)")
    a.add_argument("--ko-pathway",
                   help="TSV mapping: KO id <tab> pathway id[,pathway...] "
                   "(kegg; replaces the reference's KEGG REST fetch)")
    a.add_argument("--individuals",
                   help="CSV mapping sample,individual (timeline)")
    a.add_argument("--gff",
                   help="gene-annotation GFF for product classification "
                   "(transfer_gene)")
    a.add_argument("--bin-size", type=int, default=5000,
                   help="breakpoint bin for association marker tags "
                   "(associtation_study.py bin_size)")
    a.add_argument("--cohort", default="all",
                   help="restrict the association study to one cohort")
    a.add_argument("--meta-csv",
                   help="flat cohort-metadata CSV (phenotype_table): "
                   "columns sample,cohort,disease[,full_disease,run,...]")
    a.add_argument("--device", default="cuda",
                   help="torch device of every device step (default cuda; "
                   "raises when CUDA is absent)")
    return p


def config_from_args(a) -> Config:
    cfg = Config()
    kmer = dataclasses.replace(
        cfg.kmer, k=a.k, coder_num=a.e, seed=a.seed, sample=a.sample_bp
    )
    scan = dataclasses.replace(
        cfg.scan, hit_ratio=a.hit_ratio, match_ratio=a.match_ratio,
        max_peak=a.max_peak,
    )
    align = dataclasses.replace(cfg.align, min_mapq=a.q)
    bkp = dataclasses.replace(cfg.bkp, mapq_min=a.q, keep_xa=a.a)
    return cfg.replace(kmer=kmer, scan=scan, align=align, bkp=bkp,
                       threads=a.t, count_ckpt=getattr(a, "count_ckpt", ""))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _dispatch(args)
    except Exception as e:
        from localhgt_tpu_torch.utils.validate import InputError

        if isinstance(e, InputError):
            print(f"error: {e}", file=sys.stderr)
            return 2
        raise


def _dispatch(args) -> int:
    if args.command == "bkp":
        from localhgt_tpu_torch.pipeline.bkp import detect_breakpoint
        from localhgt_tpu_torch.utils import device

        detect_breakpoint(
            args.r, args.fq1, args.fq2, args.s, args.o,
            device.resolve(args.device),
            cfg=config_from_args(args),
            use_kmer=bool(args.use_kmer),
            read_info=bool(args.read_info),
            refine_fq=bool(args.refine_fq),
            mesh={"auto": "auto", "on": "force",
                  "off": None}[args.multi_chip],
        )
        return 0
    if args.command == "event":
        from localhgt_tpu_torch.config import EventConfig
        from localhgt_tpu_torch.pipeline.event import detect_event

        cfg = dataclasses.replace(EventConfig(), min_split_reads=args.n,
                                  min_hgt_len=args.m)
        detect_event(args.r, args.b, args.f, cfg)
        return 0
    if args.command == "analyze":
        return run_analyze(args)
    build_parser().print_help()
    return 1


def run_analyze(a) -> int:
    """The downstream analyses of localhgt_tpu/cli.py::run_analyze with
    the same arguments and JSON. microhomology, mechanism, classifier and
    lodo run their device steps on --device; the others are host code."""
    import json

    from localhgt_tpu_torch.analysis import records
    from localhgt_tpu_torch.analysis.taxonomy import Taxonomy
    from localhgt_tpu_torch.utils import device

    def emit(obj):
        text = json.dumps(obj, indent=2, default=str)
        if a.f:
            with open(a.f, "w") as f:
                f.write(text + "\n")
        else:
            print(text)

    pheno = records.read_phenotype(a.pheno) if a.pheno else None
    tax = Taxonomy(a.meta)

    if a.what == "association":
        from localhgt_tpu_torch.analysis import association

        if not (a.b and a.pheno):
            print("association needs -b <acc.csv folder> and --pheno",
                  file=sys.stderr)
            return 2
        level = a.level if a.level != "all" else "genus"
        emit(association.association_study(
            a.b, a.pheno, tax, a.group1, a.group2, level=level,
            cohort=a.cohort, bin_size=a.bin_size))
        return 0

    if a.what == "phenotype_table":
        from localhgt_tpu_torch.analysis import association

        if not (a.meta_csv and a.f):
            print("phenotype_table needs --meta-csv and -f <output CSV>",
                  file=sys.stderr)
            return 2
        t = association.PhenotypeTable.from_metadata_csv(a.meta_csv)
        n = t.write_csv(a.f)
        print(f"{n} phenotype rows -> {a.f}")
        return 0

    if a.what == "kegg":
        from localhgt_tpu_torch.analysis import cohort

        if not (a.kos and a.background_kos and a.ko_pathway):
            print("kegg needs --kos, --background-kos and --ko-pathway",
                  file=sys.stderr)
            return 2
        ko_pathway = {}
        for line in open(a.ko_pathway):
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                ko_pathway[parts[0]] = parts[1].split(",")
        kos = [l.strip() for l in open(a.kos) if l.strip()]
        bg = [l.strip() for l in open(a.background_kos) if l.strip()]
        emit(cohort.kegg_enrichment(kos, bg, ko_pathway))
        return 0

    if a.what == "transfer_gene":
        from localhgt_tpu_torch.analysis import transfer_gene

        if not a.e:
            print("transfer_gene needs -e <event CSV> (and optionally "
                  "--gff for product classes)", file=sys.stderr)
            return 2
        emit(transfer_gene.analyze(a.e, a.gff))
        return 0

    if a.what == "mechanism":
        from localhgt_tpu_torch.analysis import mechanism
        from localhgt_tpu_torch.index import reference

        contigs = reference.build(a.r)
        events = mechanism.read_events(a.e)
        tandem = mechanism.read_interval_bed(a.tandem) if a.tandem else None
        tei = mechanism.read_interval_bed(a.tei) if a.tei else None
        out = mechanism.classify_events(
            events, contigs, device.resolve(a.device), tandem, tei)
        emit([{**{k: v for k, v in c.items() if k != "event"},
               "sample": c["event"].sample,
               "receptor": c["event"].receptor,
               "donor": c["event"].donor} for c in out])
        return 0

    samples = records.load_cohort(a.b, phenotypes=pheno)
    if a.what == "stats":
        from localhgt_tpu_torch.analysis import stats

        contigs = None
        if a.r:
            from localhgt_tpu_torch.index import reference

            contigs = reference.build(a.r)
        out = stats.summary(samples, contigs)
        if pheno:
            out["group_test"] = stats.group_count_test(
                samples, a.group1, a.group2)
        emit(out)
        return 0
    if a.what == "microhomology":
        from localhgt_tpu_torch.analysis import microhomology
        from localhgt_tpu_torch.index import reference

        contigs = reference.build(a.r)
        bkps = [b for s in samples for b in s.bkps]
        emit(microhomology.compare_vs_random(
            bkps, contigs, device.resolve(a.device), n_random=a.n_random))
        return 0
    if a.what == "network":
        from localhgt_tpu_torch.analysis import network
        from localhgt_tpu_torch.analysis.taxonomy import LEVELS

        if a.level == "all":
            levels = range(1, 7)
        else:
            if a.level not in LEVELS:
                print(f"unknown taxonomy level {a.level!r}; choose from "
                      f"{LEVELS[1:7]} or 'all'", file=sys.stderr)
                return 2
            levels = [LEVELS.index(a.level)]
        emit(network.compare_groups(samples, tax, a.group1, a.group2,
                                    levels=levels))
        return 0
    if a.what == "classifier":
        from localhgt_tpu_torch.analysis import classifier

        out = classifier.train_and_eval(
            samples, a.group1, a.group2, device.resolve(a.device),
            marker_num=a.markers, model=a.model)
        out.pop("markers", None)
        emit(out)
        return 0
    if a.what == "lodo":
        from localhgt_tpu_torch.analysis import cohort

        out = cohort.lodo(samples, a.group1, a.group2,
                          device.resolve(a.device),
                          marker_num=a.markers, model=a.model)
        emit(out)
        return 0
    if a.what == "timeline":
        from localhgt_tpu_torch.analysis import cohort

        if not a.individuals:
            print("timeline needs --individuals sample,individual CSV",
                  file=sys.stderr)
            return 2
        ind = {}
        for line in open(a.individuals):
            parts = line.strip().split(",")
            if len(parts) >= 2 and parts[0] != "sample":
                ind[parts[0]] = parts[1]
        vectors, _ = cohort.profile_vectors(samples)
        emit(cohort.timeline_fingerprint(vectors, ind))
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
