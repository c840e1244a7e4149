"""Command-line interface of the port: the `localhgt` commands on torch.

    python -m localhgt_tpu_torch.cli bkp -r ref.fa --fq1 s.1.fq \
        --fq2 s.2.fq -s sample -o outdir [--device cuda]
    python -m localhgt_tpu_torch.cli event -r ref.fa -b outdir -f events.csv
    python -m localhgt_tpu_torch.cli analyze microhomology -b outdir \
        -r ref.fa [--device cuda]

Flags and defaults are the JAX package's (its parser is reused), plus
`--device` (default cuda; raises when CUDA is absent), which `bkp` and the
device analyses (`microhomology`, `mechanism`, `classifier`, `lodo`) use.
`event` and the other analyses are host-only and run the JAX package's
host code. Not ported: `--multi_chip on` (see ROADMAP.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from localhgt_tpu.cli import build_parser as _reference_parser
from localhgt_tpu.cli import config_from_args
from localhgt_tpu.cli import run_analyze as _reference_run_analyze  # host-only


def _device_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda",
                   help="torch device of every device step of bkp and "
                   "analyze (default cuda)")
    return p


def build_parser() -> argparse.ArgumentParser:
    p = _reference_parser()
    p.prog = "localhgt_tpu_torch"
    p.epilog = ("bkp and analyze also take --device DEVICE: the torch "
                "device of every device step (default cuda).")
    return p


def main(argv=None) -> int:
    """`--device` is taken out of argv first, wherever it stands; the rest
    goes to the reused parser unchanged."""
    dev, rest = _device_parser().parse_known_args(argv)
    args = build_parser().parse_args(rest)
    args.device = dev.device
    try:
        return _dispatch(args)
    except Exception as e:
        from localhgt_tpu.utils.validate import InputError

        if isinstance(e, InputError):
            print(f"error: {e}", file=sys.stderr)
            return 2
        raise


def _dispatch(args) -> int:
    if args.command == "bkp":
        if args.multi_chip == "on":
            raise NotImplementedError(
                "--multi_chip on is not ported to localhgt_tpu_torch yet; "
                "see ROADMAP.md queue 1")
        from localhgt_tpu_torch.pipeline.bkp import detect_breakpoint
        from localhgt_tpu_torch.utils import device

        detect_breakpoint(
            args.r, args.fq1, args.fq2, args.s, args.o,
            device.resolve(args.device),
            cfg=config_from_args(args),
            use_kmer=bool(args.use_kmer),
            read_info=bool(args.read_info),
            refine_fq=bool(args.refine_fq),
        )
        return 0
    if args.command == "event":
        from localhgt_tpu.config import EventConfig
        from localhgt_tpu.pipeline.event import detect_event

        cfg = dataclasses.replace(EventConfig(), min_split_reads=args.n,
                                  min_hgt_len=args.m)
        detect_event(args.r, args.b, args.f, cfg)
        return 0
    if args.command == "analyze":
        return run_analyze(args)
    build_parser().print_help()
    return 1


# analyses with a device step, and transfer_gene, whose JAX `analyze`
# loads jax through mechanism.read_events; the JAX CLI runs the others,
# which are host-only and load no jax
PORTED_ANALYSES = ("microhomology", "mechanism", "classifier", "lodo",
                   "transfer_gene")


def run_analyze(a) -> int:
    """The downstream analyses of localhgt_tpu/cli.py::run_analyze with
    the same arguments and JSON. microhomology, mechanism, classifier and
    lodo run their device steps on --device."""
    if a.what not in PORTED_ANALYSES:
        return _reference_run_analyze(a)
    import json

    from localhgt_tpu.analysis import records
    from localhgt_tpu.index import reference
    from localhgt_tpu_torch.utils import device

    def emit(obj):
        text = json.dumps(obj, indent=2, default=str)
        if a.f:
            with open(a.f, "w") as f:
                f.write(text + "\n")
        else:
            print(text)

    if a.what == "transfer_gene":
        from localhgt_tpu.analysis import transfer_gene as tg
        from localhgt_tpu_torch.analysis.mechanism import read_events

        if not a.e:
            print("transfer_gene needs -e <event CSV> (and optionally "
                  "--gff for product classes)", file=sys.stderr)
            return 2
        # the report of transfer_gene.analyze
        events = read_events(a.e)
        report = {"n_events": len(events),
                  "transfer_times": tg.transfer_times(events),
                  "segment_lengths": tg.gene_length_stats(events)}
        if a.gff:
            report["product_classes"] = tg.product_class_counts(
                events, tg.GffAnnotation(a.gff))
        emit(report)
        return 0

    if a.what == "mechanism":
        from localhgt_tpu_torch.analysis import mechanism

        events = mechanism.read_events(a.e)
        tandem = mechanism.read_interval_bed(a.tandem) if a.tandem else None
        tei = mechanism.read_interval_bed(a.tei) if a.tei else None
        out = mechanism.classify_events(events, reference.build(a.r),
                                        device.resolve(a.device), tandem, tei)
        emit([{**{k: v for k, v in c.items() if k != "event"},
               "sample": c["event"].sample,
               "receptor": c["event"].receptor,
               "donor": c["event"].donor} for c in out])
        return 0

    pheno = records.read_phenotype(a.pheno) if a.pheno else None
    samples = records.load_cohort(a.b, phenotypes=pheno)
    if a.what == "microhomology":
        from localhgt_tpu_torch.analysis import microhomology

        bkps = [b for s in samples for b in s.bkps]
        emit(microhomology.compare_vs_random(
            bkps, reference.build(a.r), device.resolve(a.device),
            n_random=a.n_random))
        return 0
    if a.what == "classifier":
        from localhgt_tpu_torch.analysis import classifier

        out = classifier.train_and_eval(
            samples, a.group1, a.group2, device.resolve(a.device),
            marker_num=a.markers, model=a.model)
        out.pop("markers", None)
        emit(out)
        return 0
    from localhgt_tpu_torch.analysis import cohort

    emit(cohort.lodo(samples, a.group1, a.group2, device.resolve(a.device),
                     marker_num=a.markers, model=a.model))
    return 0


if __name__ == "__main__":
    sys.exit(main())
