"""Command-line interface of the port: the `localhgt` commands on torch.

    python -m localhgt_tpu_torch.cli bkp -r ref.fa --fq1 s.1.fq \
        --fq2 s.2.fq -s sample -o outdir [--device cuda]
    python -m localhgt_tpu_torch.cli event -r ref.fa -b outdir -f events.csv

Flags and defaults are the JAX package's (its parser is reused), plus
`--device` (default cuda; raises when CUDA is absent), which only `bkp`
uses. `event` is host-only and runs the JAX package's host module. Not
ported yet: `--refine_fq 1`, `--multi_chip on` and `analyze` (see
ROADMAP.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from localhgt_tpu.cli import build_parser as _reference_parser
from localhgt_tpu.cli import config_from_args


def _device_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda",
                   help="torch device of every device step of bkp "
                   "(default cuda)")
    return p


def build_parser() -> argparse.ArgumentParser:
    p = _reference_parser()
    p.prog = "localhgt_tpu_torch"
    p.epilog = ("bkp also takes --device DEVICE: the torch device of every "
                "device step (default cuda).")
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
        print("analyze is not ported to localhgt_tpu_torch yet; run "
              "`python -m localhgt_tpu.cli analyze` (see ROADMAP.md)",
              file=sys.stderr)
        return 2
    build_parser().print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
