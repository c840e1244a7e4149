"""Time kernels K1 and K2 (`lht_sw_align`, `lht_sw_score` of csrc/sw.cu)
in their mappings on one card.

    python -m localhgt_tpu_torch.tune_sw [--real] [--parent DIR]
                                         [--sass out.txt] [--json out.json]
    python -m localhgt_tpu_torch.tune_sw --count out.txt      # no card

Builds csrc/sw.cu once per variant with `-DLHT_SW_*` / `-DLHT_SWA_*` flags
(lanes a group and columns a lane, wavefront or row-by-row scan, the
substitution score by table or by compare and select, columns a lane of
K2's wide mapping), all nvcc runs started together, each with `-Xptxas
-v` (registers and spills of every kernel). Every variant is held exactly
against the plain version of the kernel it tunes (`sw_score_plain` for
K2, `sw_align_plain` for K1), on planted and on tie-heavy reads, and then
timed with CUDA events: K2 at B=8,192 for M=N in 96, 128, 160 and at
B=512, M=N=1,000; K1 at M=192, N=256 (align's windows) for B from the
main path's 152 to 8,192, and at B=512, M=N=1,000 (validate_events');
both past 4,096 columns, in bands, at B=64, M=800, N = 4,097, 6,000 and
8,192 (`lht_sw_*_bands`).
`--parent DIR` times the kernels of another checkout of the package (a
subprocess in DIR builds and loads its csrc/sw.cu) on the same inputs and
through its `cuda_sw.launch`, as the variants are timed, before and after
the variants. `--real` also simulates the `big` fixture, runs `bkp` at
k=32 and prints the (B, M, N) of every K1 and K2 launch. `--sass` writes
`cuobjdump -sass` of the package's variant to a file and prints, for K1's
kernels, the opcodes of every loop and the integer-pipe instructions a
cell (what the bound's count is read from), and the registers, stack and
local (spilled) bytes of every band kernel (`cuobjdump -res-usage`); with
`--parent` also whether each kernel's SASS is the same as that of the
parent's build. `--count` prints the loops from such a file and needs no
card. It prints the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from localhgt_tpu_torch.tune_vote import BIG, card_line, time_ms

# name -> (nvcc -D flags, kernels it tunes, the widest N the variant takes
# or None, serves narrow windows, serves wider ones: the wide block and the
# bands). "package" is what the package builds.
VARIANTS = {
    "package": ((), "K1 K2", None, True, True),
    "compare_select": (("-DLHT_SW_TABLE=0",), "K1 K2", None, True, True),
    "g32_npl5": (("-DLHT_SW_G=32", "-DLHT_SW_NPL=5"), "K2", 160, True, False),
    "g16_npl6": (("-DLHT_SW_G=16", "-DLHT_SW_NPL=6"), "K2", 96, True, False),
    "g16_npl8": (("-DLHT_SW_G=16", "-DLHT_SW_NPL=8"), "K2", 128, True, False),
    "g16_npl10": (("-DLHT_SW_G=16", "-DLHT_SW_NPL=10"), "K2", 160, True,
                  False),
    "g4_npl24": (("-DLHT_SW_G=4", "-DLHT_SW_NPL=24"), "K2", 96, True, False),
    "g4_npl32": (("-DLHT_SW_G=4", "-DLHT_SW_NPL=32"), "K2", 128, True, False),
    "g4_npl40": (("-DLHT_SW_G=4", "-DLHT_SW_NPL=40"), "K2", 160, True, False),
    "scan_g16_npl10": (("-DLHT_SW_SCAN=1", "-DLHT_SW_G=16",
                        "-DLHT_SW_NPL=10"), "K2", 160, True, False),
    "wide_npl16": (("-DLHT_SW_WIDE_NPL=16",), "K2", 4096, False, True),
    "align_g8_npl32": (("-DLHT_SWA_G=8", "-DLHT_SWA_NPL=32"), "K1", 256,
                       True, False),
    "align_g16_npl16": (("-DLHT_SWA_G=16", "-DLHT_SWA_NPL=16"), "K1", 256,
                        True, False),
}
# kernel -> (entry point, plain version, [(B, M, N)]): K2 at the accbkp
# window widths of 150-bp reads and the widest junction window of
# validate_events; K1 at align's windows (150-bp reads padded to 192, 32
# columns either side) in a full tile of 8,192, at the median batch of the
# main path (152; 61 to 242 on `big`) and at batches between, and at
# validate_events' windows; both past WIDE_MAX_N columns, in bands, at the
# shapes of chip_smoke.py's band rows
BAND_SHAPES = [(64, 800, 4097), (64, 800, 6000), (64, 800, 8192)]
KERNELS = {
    "K2": ("lht_sw_score", "sw_score_plain",
           [(8192, 96, 96), (8192, 128, 128), (8192, 160, 160),
            (512, 1000, 1000), *BAND_SHAPES]),
    "K1": ("lht_sw_align", "sw_align_plain",
           [(8192, 192, 256), (152, 192, 256), (1024, 192, 256),
            (2048, 192, 256), (4096, 192, 256), (512, 1000, 1000),
            *BAND_SHAPES]),
}
# the parent's build timed as the variants are: `run` through its
# `cuda_sw.launch`
PARENT_SNIPPET = """
import json, sys, torch
sys.path.insert(0, {here!r})
from localhgt_tpu_torch.tune_sw import KERNELS, device_inputs, run
from localhgt_tpu_torch.tune_vote import time_ms
sys.path.pop(0)
for m in [m for m in sys.modules if m.startswith("localhgt_tpu_torch")]:
    del sys.modules[m]
from localhgt_tpu_torch.ops import cuda_sw
lib = cuda_sw._lib()
dev = torch.device("cuda:0")
out = {{}}
for kernel in ("K2", "K1"):
    for shape in KERNELS[kernel][2]:
        q, r = device_inputs(dev, *shape)
        out[kernel + " " + str(shape)] = time_ms(
            lambda: run(lib, kernel, q, r), 20)
print(json.dumps({{"parent_ms": out}}))
"""


def sw_inputs(rng, B: int, M: int, N: int, tie_heavy: bool):
    """Reads planted in their reference windows with mutations; tie-heavy
    inputs use a 2-letter alphabet and 1-5 bp insertions (ROADMAP F1)."""
    alpha = 2 if tie_heavy else 4
    q = rng.integers(0, alpha, (B, M)).astype(np.uint8)
    r = rng.integers(0, alpha, (B, N)).astype(np.uint8)
    for b in range(0, B, 2):
        ins = int(rng.integers(1, 6))
        cut = int(rng.integers(4, M - 4))
        seg = np.concatenate([q[b, :cut],
                              rng.integers(0, alpha, ins).astype(np.uint8),
                              q[b, cut:]])
        off = int(rng.integers(0, max(1, N - len(seg))))
        seg = seg[: N - off]
        mut = rng.random(len(seg)) < 0.02
        seg[mut] = rng.integers(0, alpha, int(mut.sum()))
        r[b, off:off + len(seg)] = seg
    q[rng.random(q.shape) < 0.002] = 4
    return q, r


def device_inputs(dev, B: int, M: int, N: int, tie_heavy: bool = False):
    q, r = sw_inputs(np.random.default_rng(B + M + N), B, M, N, tie_heavy)
    return torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)


def build_variants() -> tuple:
    """({variant name: loaded library}, path of the package's variant); one
    nvcc per variant, started together."""
    from localhgt_tpu_torch import _build
    from localhgt_tpu_torch.ops import cuda_sw

    def one(name):
        # -v: ptxas prints every kernel's registers and spills
        path = _build.build("sw", VARIANTS[name][0] + ("-Xptxas", "-v"))
        lib = ctypes.CDLL(str(path))
        for fn, _, _ in KERNELS.values():
            for entry, sig in ((fn, cuda_sw.SIGNATURE),
                               (fn + "_bands", cuda_sw.BANDS_SIGNATURE)):
                getattr(lib, entry).argtypes = sig
                getattr(lib, entry).restype = ctypes.c_int
        return lib, path

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(one, VARIANTS)))
    return {n: lib for n, (lib, _) in built.items()}, built["package"][1]


def run(lib, kernel: str, q, r):
    """One launch of `kernel` (K1 or K2) of a loaded build at the
    parameters of its caller (align's, accbkp's), through the entry point
    the wrapper takes at this width."""
    from localhgt_tpu_torch.ops import cuda_sw

    sfx = "_bands" if r.shape[1] > cuda_sw.WIDE_MAX_N else ""
    if kernel == "K1":
        out = torch.empty((q.shape[0], 5), dtype=torch.int32,
                          device=q.device)
        cuda_sw.launch(lib, "lht_sw_align" + sfx, q, r, out, 1, -4, -6, -1)
    else:
        out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
        cuda_sw.launch(lib, "lht_sw_score" + sfx, q, r, out, 1, -2, -3, -1)
    return out


def takes(name: str, kernel: str, N: int) -> bool:
    from localhgt_tpu_torch.ops.cuda_sw import NARROW_MAX_N

    _, kernels, max_n, narrow, wider = VARIANTS[name]
    serves = wider if N > NARROW_MAX_N else narrow
    return kernel in kernels.split() and serves and (
        max_n is None or N <= max_n)


def real_shapes(dev) -> dict:
    """Run `bkp` on `big` at k=32; {kernel: {(B, M, N): launches}}."""
    from localhgt_tpu_torch import cli
    from localhgt_tpu_torch.ops import cuda_sw
    from localhgt_tpu_torch.sim.simulate import SimParams, simulate_sample

    work = tempfile.mkdtemp(prefix="lht_tune_")
    try:
        ref, fq1, fq2, _ = simulate_sample(work, "big", SimParams(**BIG))
        cuda_sw.sw_score.shapes.clear()
        cuda_sw.sw_align.shapes.clear()
        rc = cli.main(["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2, "-s",
                       "big", "-o", work, "-k", "32", "--device", str(dev)])
        if rc != 0:
            raise SystemExit(f"bkp exited {rc}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"K1": dict(cuda_sw.sw_align.shapes),
            "K2": dict(cuda_sw.sw_score.shapes)}


# SASS opcodes that only the SM's 64-lane integer pipe issues
INT_PIPE_ONLY = ("ISETP", "SEL", "VIMNMX", "VIMNMX3", "VIADDMNMX", "PLOP3",
                 "LOP3", "PRMT", "IMNMX", "SHF", "LEA")
# K1's kernels as the package builds them for align's windows, for
# validate_events' and past 4,096 columns (mangled template arguments: G,
# NPL, wide, guard, bands), with their columns a lane
K1_KERNELS = {"sw_align_kernelILi32ELi8ELb0ELb0ELb0EE": 8,
              "sw_align_kernelILi32ELi16ELb1ELb0ELb0EE": 16,
              "sw_align_kernelILi32ELi16ELb1ELb0ELb1EE": 16}


def loop_opcodes(sass: str, kernel: str) -> list:
    """[(start, end, {opcode: count})] of every loop (a backward branch
    and what lies between it and its target) of the first function of a
    `cuobjdump -sass` text whose mangled name holds `kernel`."""
    text = sass.split("Function : ")
    body = next((t for t in text[1:] if kernel in t.split("\n", 1)[0]), "")
    ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
        r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)[^;]*;", body)]
    targets = {int(m.group(1), 16): int(m.group(2), 16) for m in re.finditer(
        r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\d+\s+)?BRA[^;]*?0x([0-9a-f]+)",
        body)}
    loops = []
    for at, to in sorted(targets.items()):
        if to < at:
            ops = collections.Counter(
                op.split(".")[0] for a, op in ins if to <= a <= at)
            loops.append((to, at, dict(ops.most_common())))
    return loops


def print_k1_loops(sass: str) -> None:
    """Every loop of K1's kernels; a loop that steps a lane over its row
    (NPL cells) also with its integer-pipe-only instructions a cell."""
    for kernel, npl in K1_KERNELS.items():
        loops = loop_opcodes(sass, kernel)
        if not loops:
            print(f"[sass] {kernel}: no such function or no loop", flush=True)
        for to, at, ops in loops:
            only = sum(n for op, n in ops.items() if op in INT_PIPE_ONLY)
            print(f"[sass] {kernel} loop {to:#x}-{at:#x}: "
                  f"{sum(ops.values())} instructions, {only} of them on the "
                  f"integer pipe alone ({only / npl:.2f} a cell if the loop "
                  f"is one step of {npl} columns): {json.dumps(ops)}",
                  flush=True)


def print_band_resources(so: Path) -> None:
    """Registers, stack and local (spilled) bytes of every band kernel of
    a built library, as `cuobjdump -res-usage` reads them: the mangled
    name's last template argument (kBands) is true."""
    from localhgt_tpu_torch import _build

    dump = Path(_build.nvcc_path()).with_name("cuobjdump")
    res = subprocess.run([str(dump), "-res-usage", str(so)],
                         capture_output=True, text=True, check=True)
    lines = res.stdout.splitlines()
    band = re.compile(
        r"(sw_(?:align|score)_kernelILi32ELi\d+ELb1ELb[01]ELb1E)")
    for k, line in enumerate(lines):
        m = band.search(line)
        if m and k + 1 < len(lines):
            print(f"[sass] {m.group(1)}: {lines[k + 1].strip()}", flush=True)


def sass_functions(sass: str) -> dict:
    """{kernel name without its file's anonymous-namespace hash: its
    instructions} of a `cuobjdump -sass` text."""
    out = {}
    for body in sass.split("Function : ")[1:]:
        name, _, rest = body.partition("\n")
        name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", name.strip())
        out[name] = re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*;)", rest)
    return out


def compare_sass(sass: str, parent: str) -> None:
    """Print, for every kernel that both this build and the parent
    checkout's build of csrc/sw.cu have, whether their SASS is the same."""
    from localhgt_tpu_torch import _build

    built = sorted(Path(parent).glob("build/localhgt_tpu_torch/sw-*.so"),
                   key=lambda p: p.stat().st_mtime)
    if not built:
        print("[sass] the parent's build of sw.cu is not found", flush=True)
        return
    dump = Path(_build.nvcc_path()).with_name("cuobjdump")
    res = subprocess.run([str(dump), "-sass", str(built[-1])],
                         capture_output=True, text=True, check=True)
    mine, theirs = sass_functions(sass), sass_functions(res.stdout)
    for name in sorted(set(mine) & set(theirs)):
        a, b = mine[name], theirs[name]
        diff = [k for k, (x, y) in enumerate(zip(a, b)) if x != y]
        if a == b:
            what = "the same as the parent's"
        elif diff:
            k = diff[0]
            what = (f"{len(diff)} differ from the parent's ({len(b)}), the "
                    f"first at {k}: {a[k]!r} against {b[k]!r}")
        else:
            what = f"not the same as the parent's ({len(b)})"
        print(f"[sass] {name}: {len(a)} instructions, {what}", flush=True)
    for name in sorted(set(mine) - set(theirs)):
        print(f"[sass] {name}: not in the parent's build", flush=True)


def parent_ms(parent: str) -> dict:
    """{"K1 (B, M, N)": ms, ...} of the checkout in `parent`."""
    res = subprocess.run(
        [sys.executable, "-c", PARENT_SNIPPET.format(
            here=str(Path(__file__).resolve().parent.parent))],
        cwd=parent, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"parent timing failed:\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])["parent_ms"]


def main(argv=None) -> int:
    from localhgt_tpu_torch import _build
    from localhgt_tpu_torch.ops import cuda_sw

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--real", action="store_true",
                    help="also print the K1 and K2 launch shapes of bkp on "
                    "big")
    ap.add_argument("--parent", default="",
                    help="another checkout whose sw_score and sw_align are "
                    "timed too")
    ap.add_argument("--sass", default="",
                    help="write cuobjdump -sass of the package's build here")
    ap.add_argument("--count", default="",
                    help="print K1's loop opcodes from a --sass file and "
                    "stop (needs no card)")
    ap.add_argument("--json", default="", help="also write the times here")
    args = ap.parse_args(argv)
    if args.count:
        print_k1_loops(Path(args.count).read_text())
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("tune_sw: CUDA is not available")
    dev = torch.device("cuda:0")
    print(card_line(), flush=True)
    libs, package_so = build_variants()
    if args.sass:
        dump = Path(_build.nvcc_path()).with_name("cuobjdump")
        res = subprocess.run([str(dump), "-sass", str(package_so)],
                             capture_output=True, text=True, check=True)
        Path(args.sass).write_text(res.stdout)
        print_k1_loops(res.stdout)
        print_band_resources(package_so)

    out = {"card": card_line(), "times_ms": {}}
    if args.parent:  # parent, variants, parent: in turns on one card
        out["parent_ms"] = parent_ms(args.parent)
    for kernel, (_, plain, shapes) in KERNELS.items():
        for shape in shapes:
            key = f"{kernel} {shape}"
            for tie in (True, False):
                q, r = device_inputs(dev, *shape, tie_heavy=tie)
                want = getattr(cuda_sw, plain)(q, r)
                for name, lib in libs.items():
                    if not takes(name, kernel, shape[2]):
                        continue
                    got = run(lib, kernel, q, r)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise SystemExit(f"variant {name} disagrees with "
                                         f"{plain} at {shape}")
            for name, lib in libs.items():  # timed on the 4-letter input
                if takes(name, kernel, shape[2]):
                    ms = time_ms(lambda: run(lib, kernel, q, r), 20)
                    out["times_ms"].setdefault(key, {})[name] = ms
                    print(f"[tune] {key} {name}: {ms:.4f} ms", flush=True)
    if args.parent:
        out["parent_again_ms"] = parent_ms(args.parent)
        if args.sass:
            compare_sass(Path(args.sass).read_text(), args.parent)
        for key, ms in out["parent_ms"].items():
            print(f"[tune] {key} parent: {ms:.4f} ms before the variants, "
                  f"{out['parent_again_ms'][key]:.4f} ms after", flush=True)
    if args.real:
        shapes = real_shapes(dev)
        out["real_launch_shapes"] = {
            k: {str(s): n for s, n in v.items()} for k, v in shapes.items()}
        for kernel, by_shape in shapes.items():
            for shape, n in sorted(by_shape.items()):
                print(f"[real] {kernel} (B, M, N) = {shape}: {n} launches",
                      flush=True)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
