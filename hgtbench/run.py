"""Run one cell of the port's benchmark once and print its result.

    python3 -m hgtbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell is a cohort of simulated samples run through the port's `bkp`
(`localhgt_tpu_torch.pipeline.bkp.detect_breakpoint`, the call the CLI's
`bkp` makes) one after another against one reference, on one CUDA card;
`bkp` runs QC on the raw reads first where the cell's configuration sets
`refine_fq` (`--refine_fq 1`).

1. Set-up (`setup_s`, from process start): the CUDA context, the
   reference and a pool of samples made from --seed under $TMPDIR, and
   one warm-up `bkp` of the first pool sample at its full size, which
   loads (and in a fresh checkout builds) the port's kernel libraries
   under build/ in the checkout, reaches every stage and takes the host's
   and the card's memory to the sizes the window uses.
2. The window: the peak statistics are reset, then `bkp` runs on the pool
   samples in turn, from the second on, until --seconds have passed; the
   sample in flight finishes. With --trace 1 the window runs under
   torch.profiler.
3. After the window: the plain reference (hgtbench/plainref) works out
   the checked samples again, through its own QC where the configuration
   sets `refine_fq`, and check.py compares; recall and FDR
   against the simulator's truth go to standard error; then the result.

The last line of standard output is one JSON object: `correct`,
`attempted` (samples run in the window), `failed` (those that raised),
`metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), `device`, with --trace 1 `breakdown`, and last
`checks`, each compared number with its limit; the same numbers are the
last lines of standard error. The run fails, printing no result, when no
CUDA card is visible, when fewer cards than the cell asks for are, or
when a module of JAX or of the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

# modules a run must never load, by whole top-level name (the port's own
# name begins with the JAX package's, so no prefix test)
FORBIDDEN = ("jax", "jaxlib", "flax", "localhgt_tpu")


def process_age_s() -> float:
    """Seconds since this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def note(msg: str) -> None:
    """A progress line on standard error, with the process's age."""
    print(f"hgtbench [{process_age_s():.1f} s] {msg}", file=sys.stderr,
          flush=True)


def host_times() -> tuple:
    """(this process's CPU seconds, its threads' and children's included;
    the system part of them; the machine's steal and iowait seconds over
    all cores), for the progress lines: a sample that took longer with the
    same CPU time waited on the host, one that took more CPU time did more
    work or ran on a slower host (the system part: page faults and system
    calls)."""
    t = os.times()
    cpu = t.user + t.system + t.children_user + t.children_system
    sys_s = t.system + t.children_system
    try:
        with open("/proc/stat") as f:
            ticks = f.readline().split()[1:]
        hz = os.sysconf("SC_CLK_TCK")
        return cpu, sys_s, int(ticks[7]) / hz, int(ticks[4]) / hz
    except (OSError, IndexError, ValueError):
        return cpu, sys_s, 0.0, 0.0


def dirty_mib() -> str:
    """Dirty and Writeback pages from /proc/meminfo, for a progress line."""
    try:
        with open("/proc/meminfo") as f:
            got = {ln.split(":")[0]: int(ln.split()[1]) // 1024
                   for ln in f if ln.startswith(("Dirty:", "Writeback:"))}
        return (f"dirty {got.get('Dirty')} MiB, "
                f"writeback {got.get('Writeback')} MiB")
    except OSError:
        return "dirty: no /proc/meminfo"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_readings(device) -> dict:
    """Name, power limit and SM clock of the card, as nvidia-smi reads
    them; empty off a card or without nvidia-smi."""
    if device.type != "cuda":
        return {}
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, check=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return {}
    parts = [p.strip() for p in res.stdout.strip().split(",")]
    if len(parts) != 3:
        return {}
    try:
        return {"power_limit_w": float(parts[1]), "sm_clock_mhz": float(parts[2])}
    except ValueError:
        return {}


# the resident-size watcher: a child process that reads its parent's
# /proc/<pid>/statm every SAMPLE_S seconds until a line arrives on its
# standard input, then prints the largest size in bytes. Out of process,
# it takes no turn at the parent's interpreter lock.
_WATCH = """
import os, select, sys
path = f"/proc/{sys.argv[1]}/statm"
page = os.sysconf("SC_PAGE_SIZE")
peak = 0
while True:
    with open(path) as f:
        peak = max(peak, int(f.read().split()[1]) * page)
    if select.select([sys.stdin], [], [], float(sys.argv[2]))[0]:
        break
print(peak, flush=True)
"""


class HostPeak:
    """The process's resident high-water mark between `start` and `stop`:
    the kernel's VmHWM, reset through /proc/self/clear_refs (5), or where
    the kernel refuses that reset, the largest resident size the watcher
    process above reads."""

    SAMPLE_S = 0.005

    def __init__(self):
        self._watch = None

    def start(self) -> None:
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
        except OSError:
            self._watch = subprocess.Popen(
                [sys.executable, "-c", _WATCH, str(os.getpid()),
                 str(self.SAMPLE_S)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def stop(self) -> int:
        """The peak in bytes since `start`."""
        if self._watch is None:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmHWM:"):
                        return int(line.split()[1]) * 1024
            raise RuntimeError("no VmHWM in /proc/self/status")
        out, _ = self._watch.communicate("stop\n", timeout=60)
        self._watch = None
        return int(out)

    def close(self) -> None:
        """Stops the watcher, if one runs, without a reading."""
        if self._watch is not None:
            self._watch.kill()
            self._watch.wait()
            self._watch = None


def _trim_heap() -> None:
    gc.collect()
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL("libc.so.6").malloc_trim(0)


def pipeline_config(Config, KmerConfig, ScanConfig, config: dict):
    """The port's (or the reference's) Config for a configuration file."""
    return Config().replace(
        kmer=KmerConfig(k=config["k"], coder_num=config["coder_num"],
                        seed=config["hash_seed"],
                        least_depth=config["least_depth"],
                        sample=float(config["sample"])),
        scan=ScanConfig(hit_ratio=config["hit_ratio"],
                        match_ratio=config["match_ratio"],
                        max_peak=int(config["max_peak"])),
        threads=int(config["threads"]))


class Capture:
    """Keeps what the program's `bkp` produced on the way to its files:
    both mates' alignment tables (`align_reads`) and the raw junctions
    (`call_raw_bkps`). The wrappers call the program's functions unchanged
    and only hold their results until `take`."""

    def __init__(self, bkp_mod, rawbkp_mod):
        self.got: dict = {}
        self._mods = (bkp_mod, rawbkp_mod)
        self._orig = (bkp_mod.align_reads, rawbkp_mod.call_raw_bkps)

        def align_reads(*a, **kw):
            out = self._orig[0](*a, **kw)
            self.got["a1"], self.got["a2"] = out[0], out[1]
            return out

        def call_raw_bkps(*a, **kw):
            out = self._orig[1](*a, **kw)
            self.got["raw"] = out
            return out

        bkp_mod.align_reads = align_reads
        rawbkp_mod.call_raw_bkps = call_raw_bkps

    def take(self) -> dict:
        got, self.got = self.got, {}
        return got

    def close(self) -> None:
        self._mods[0].align_reads, self._mods[1].call_raw_bkps = self._orig


def _read_lines(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return f.read().splitlines()


def _read_bytes(path: str) -> bytes:
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as f:
        return f.read()


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             workdir: str) -> tuple[dict, dict]:
    """One run of `cell` (registry.Cell) on `device`, its files under
    `workdir`. Returns (result without `checks`, {number: reading})."""
    import numpy as np
    import torch

    from localhgt_tpu_torch.config import Config, KmerConfig, ScanConfig
    from localhgt_tpu_torch.ops import cuda_sw
    from localhgt_tpu_torch.pipeline import bkp as bkp_mod
    from localhgt_tpu_torch.pipeline import rawbkp as rawbkp_mod
    from localhgt_tpu_torch.utils import metrics

    from hgtbench import check, cohort, score, sim

    on_card = device.type == "cuda"
    config, traffic = cell.config, cell.traffic
    use_kmer = bool(config["use_kmer"])
    refine_fq = bool(config.get("refine_fq", 0))
    cfg = pipeline_config(Config, KmerConfig, ScanConfig, config)
    for name in ("localhgt_tpu_torch", "hgtbench"):
        logging.getLogger(name).setLevel(logging.WARNING)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    sync()  # creates the context
    co = cohort.make(os.path.join(workdir, "in"), config, traffic, seed)
    note(f"inputs made: pool of {len(co.pool)} "
         f"({', '.join(str(s.n_pairs) for s in co.pool)} pairs)")
    outdir = os.path.join(workdir, "out")
    os.makedirs(outdir, exist_ok=True)

    def bkp(s):
        return bkp_mod.detect_breakpoint(
            co.ref, s.fq1, s.fq2, s.name, outdir, device, cfg=cfg,
            use_kmer=use_kmer, refine_fq=refine_fq)

    pool = co.pool
    bkp(pool[0])  # the window starts at pool[1], never on the same sample
    sync()
    note(f"warm-up bkp done: {metrics.stage_walls()}")

    cap = Capture(bkp_mod, rawbkp_mod)
    host = HostPeak()
    prof = None
    runs: list = []
    failed = 0
    try:
        _trim_heap()
        card_before = card_readings(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        host.start()
        shapes0 = {k: dict(getattr(cuda_sw, k).shapes)
                   for k in ("sw_align", "sw_score")}
        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else []))
            prof.__enter__()
        setup_s = process_age_s()
        note(f"window opens: {dirty_mib()}")
        t_start = time.perf_counter()
        with torch.profiler.record_function("hgtbench.window"):
            while True:
                i = (len(runs) + 1) % len(pool)
                s = pool[i]
                cap.take()  # what an earlier run left behind
                metrics.reset()
                h0 = host_times()
                t0 = time.perf_counter()
                try:
                    bkp(s)
                    sync()
                    ok = True
                except Exception:  # a failed sample is counted, not fatal
                    traceback.print_exc()
                    failed += 1
                    ok = False
                t1 = time.perf_counter()
                h1 = host_times()
                run = {"pool": i, "pairs": s.n_pairs, "wall_s": t1 - t0,
                       "ok": ok, "stages": metrics.stage_walls(),
                       "counters": metrics.counters(),
                       "acc": _read_lines(os.path.join(
                           outdir, f"{s.name}.acc.csv"))}
                if ok:
                    got = cap.take()
                    iv = os.path.join(outdir, f"{s.name}.interval.txt")
                    got["intervals"] = _read_lines(iv)
                    got["bed"] = _read_lines(iv + ".bed")
                    got["subref_bp"] = run["counters"].get("subref_bp", 0)
                    got["qc"] = {k[len("qc_"):]: v
                                 for k, v in run["counters"].items()
                                 if k.startswith("qc_")}
                    got["acc"] = run["acc"]
                    run["got"] = got
                runs.append(run)
                note(f"sample {i}: {run['wall_s']:.3f} s, cpu "
                     f"{h1[0] - h0[0]:.2f} s (system {h1[1] - h0[1]:.2f} s), "
                     f"steal {h1[2] - h0[2]:.2f} s, "
                     f"iowait {h1[3] - h0[3]:.2f} s {run['stages']}")
                if t1 - t_start >= seconds:
                    break
        window_s = time.perf_counter() - t_start
        if prof is not None:
            prof.__exit__(None, None, None)
        card_after = card_readings(device)
        dev_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        host_peak = host.stop()
    finally:
        cap.close()
        host.close()
    shapes = {k: {sh: n - shapes0[k].get(sh, 0)
                  for sh, n in getattr(cuda_sw, k).shapes.items()
                  if n - shapes0[k].get(sh, 0) > 0}
              for k in ("sw_align", "sw_score")}

    summary = None
    if prof is not None:
        from hgtbench import trace as trace_mod

        path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        summary = trace_mod.summarize(events)
        del events
        note(f"trace read: {summary['device_events']} device events")

    # the reference, once the program's state is freed
    _trim_heap()
    if on_card:
        torch.cuda.empty_cache()
    from hgtbench.plainref import config as ref_config
    from hgtbench.plainref.pipeline import bkp as ref_bkp

    ref_cfg = pipeline_config(ref_config.Config, ref_config.KmerConfig,
                               ref_config.ScanConfig, config)
    # the reference's own progress lines say where its time goes
    logging.getLogger("hgtbench.plainref").setLevel(logging.INFO)
    # the samples checked: traffic["checked"] of the pool samples that
    # ran, drawn from the seed; every run of each is compared, and with QC
    # the refined files that the last run of each left
    ran = sorted({r["pool"] for r in runs if "got" in r})
    checked = np.random.default_rng([seed % (1 << 64), 3]).choice(
        ran, min(int(traffic["checked"]), len(ran)), replace=False) \
        if ran else []
    readings = []
    for i in sorted(int(i) for i in checked):
        mine = [r["got"] for r in runs if r["pool"] == i and "got" in r]
        if not mine:
            continue
        ref = ref_bkp.run(co.ref, pool[i].fq1, pool[i].fq2, device, ref_cfg,
                          use_kmer=use_kmer, refine_fq=refine_fq)
        readings += [check.compare(g, ref, use_kmer) for g in mine]
        if refine_fq:
            mine_fq = tuple(_read_bytes(os.path.join(
                outdir, f"{pool[i].name}_refined_{m}.fq")) for m in (1, 2))
            readings.append({"refined_records": check.refined_records(
                mine_fq, ref["refined"])})
            del mine_fq
        del ref
        note(f"reference of sample {i} compared")
    numbers = check.worst(readings)
    numbers["checked_runs"] = len(readings)

    for i, s in enumerate(pool):
        acc = [r["acc"] for r in runs if r["pool"] == i and r["ok"]]
        if acc:
            sc = score.score_bkps(
                score.truth_to_bkps(sim.read_truth(s.truth)),
                score.called_bkps(acc[-1]))
            print(json.dumps({"sample": i, "pairs": s.n_pairs, **sc}),
                  file=sys.stderr)

    ctx = {"runs": runs, "window_s": window_s, "setup_s": setup_s,
           "host_rss_peak_bytes": host_peak,
           "device_mem_peak_bytes": dev_peak, "sw_shapes": shapes,
           "trace": summary, "use_kmer": use_kmer}
    readers = cell.per_layer if trace else cell.end_to_end
    values = {}
    for m, read in readers:
        v = read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(dev_peak)}
    dev.update({f"{k}_before": v for k, v in card_before.items()})
    dev.update({f"{k}_after": v for k, v in card_after.items()})
    result = {"correct": None, "attempted": len(runs), "failed": failed,
              "metrics": values, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_by_stage"]}
    return result, numbers


def finish(result: dict, numbers: dict) -> dict:
    """`correct` from the numbers against their limits, and the `checks`
    key, last in the result."""
    from hgtbench import check

    checks = {k: {"value": v, "limit": check.LIMIT}
              for k, v in numbers.items() if k != "checked_runs"}
    checks["checked_runs"] = {"value": numbers.get("checked_runs", 0),
                              "min": 1}
    result["correct"] = bool(
        result["failed"] == 0 and numbers.get("checked_runs", 0) >= 1
        and all(c["value"] <= c["limit"] for k, c in checks.items()
                if k != "checked_runs"))
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from hgtbench import registry

    cell = registry.Cell(registry.load_spec(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"hgtbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    workdir = tempfile.mkdtemp(prefix="hgtbench-")
    try:
        result, numbers = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"hgtbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    result = finish(result, numbers)
    for k, c in result["checks"].items():
        lim = f"limit {c['limit']}" if "limit" in c else f"min {c['min']}"
        print(f"check {k} {c['value']} {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
