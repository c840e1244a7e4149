"""Accuracy scoring against simulator truth.

Re-implements the paper harness's scoring (paper_results/evaluation.py):

* A truth HGT event contributes two breakpoint pairs:
  (receptor, insert_locus, donor, seg_start) and
  (receptor, insert_locus, donor, seg_end)  (read_true, evaluation.py:87-95).
* A called pair matches a truth pair iff contigs agree (either orientation)
  and both positions are within `tolerate_dist` = 50 bp
  (compare, evaluation.py:138-187).
* recall = matched truth / truth; FDR = unmatched calls / calls;
  F1 = harmonic mean of precision (1-FDR) and recall.
* Extraction-stage recall: fraction of truth loci strictly inside emitted
  bed intervals shrunk by ref_gap = 50 (Read_bed.search, evaluation.py:52-60).
* Event scoring: all event fields within 50 bp (compare_event,
  evaluation.py:1296-1314).
"""

from __future__ import annotations

from dataclasses import dataclass

TOLERATE_DIST = 50
REF_GAP = 50


@dataclass
class BkpScore:
    recall: float
    fdr: float
    f1: float
    n_true: int
    n_called: int
    missed: list
    false_pos: list


def truth_to_bkps(truth) -> list[tuple[str, int, str, int]]:
    out = []
    for t in truth:
        out.append((t.receptor, t.insert_locus, t.donor, t.seg_start))
        out.append((t.receptor, t.insert_locus, t.donor, t.seg_end))
    return out


def _match(a, b, tol=TOLERATE_DIST) -> bool:
    if a[0] == b[0] and a[2] == b[2]:
        if abs(a[1] - b[1]) < tol and abs(a[3] - b[3]) < tol:
            return True
    if a[0] == b[2] and a[2] == b[0]:
        if abs(a[1] - b[3]) < tol and abs(a[3] - b[1]) < tol:
            return True
    return False


def score_bkps(true_bkps, called_bkps, tol=TOLERATE_DIST) -> BkpScore:
    missed = []
    right = 0
    for t in true_bkps:
        if any(_match(t, c, tol) for c in called_bkps):
            right += 1
        else:
            missed.append(t)
    recall = right / len(true_bkps) if true_bkps else 0.0
    false_pos = [c for c in called_bkps if not any(_match(c, t, tol) for t in true_bkps)]
    fdr = len(false_pos) / len(called_bkps) if called_bkps else 0.0
    precision = 1 - fdr
    f1 = (
        2 / (1 / precision + 1 / recall)
        if precision > 0 and recall > 0
        else 0.0
    )
    return BkpScore(
        round(recall, 4), round(fdr, 4), round(f1, 4),
        len(true_bkps), len(called_bkps), missed, false_pos,
    )


def extraction_recall(truth, bed_intervals, gap=REF_GAP):
    """bed_intervals: dict contig -> list[(start, end)] (1-based inclusive-ish,
    as emitted in the .bed name:start-end lines). Truth loci checked strictly
    inside shrunk intervals (evaluation.py:52-60,64-76)."""
    loci = []
    for t in truth:
        loci.append((t.receptor, t.insert_locus))
        loci.append((t.donor, t.seg_start))
        loci.append((t.donor, t.seg_end))
    hit = 0
    for contig, pos in loci:
        ivs = bed_intervals.get(contig, [])
        if any(pos > s + gap and pos < e - gap for s, e in ivs):
            hit += 1
    return round(hit / len(loci), 4) if loci else 0.0


def score_events(true_events, called_events, tol=TOLERATE_DIST):
    """Events: (receptor, insert_locus, donor, delete_start, delete_end).
    Match requires same receptor+donor and all three positions within tol
    (compare_event, evaluation.py:1296-1314)."""

    def ev_match(t, c):
        return (
            t[0] == c[0]
            and t[2] == c[2]
            and abs(t[1] - c[1]) < tol
            and abs(t[3] - c[3]) < tol
            and abs(t[4] - c[4]) < tol
        )

    right = sum(1 for t in true_events if any(ev_match(t, c) for c in called_events))
    recall = right / len(true_events) if true_events else 0.0
    fp = sum(1 for c in called_events if not any(ev_match(t, c) for t in true_events))
    fdr = fp / len(called_events) if called_events else 0.0
    precision = 1 - fdr
    f1 = 2 / (1 / precision + 1 / recall) if precision > 0 and recall > 0 else 0.0
    return round(recall, 4), round(fdr, 4), round(f1, 4)


def read_comparator_csv(path) -> list[tuple[str, int, str, int]]:
    """Read a comparator tool's breakpoint CSV (LEMON's format: first four
    columns = from_ref, from_pos, to_ref, to_pos; consecutive duplicates
    collapsed) for head-to-head scoring with score_bkps — the in-repo
    equivalent of the paper harness's LEMON comparator path
    (read_lemon, evaluation.py:97-108; run_lemon.sh)."""
    out = []
    past = None
    for line in open(path):
        a = line.strip().split(",")
        if not a or a[0] == "from_ref" or a[0].startswith("#"):
            continue
        key = tuple(a[:4])
        if key == past:
            continue
        out.append((a[0], int(a[1]), a[2], int(a[3])))
        past = key
    return out


def read_localhgt_csv(path, abun_cutoff: float = 1e-7,
                      deep_flag: bool = False):
    """Read an acc.csv with the paper harness's abundance filter:
    cross_split_reads / sample_read_count >= abun_cutoff, and (deep_flag)
    drop same-genome pairs (read_localHGT, evaluation.py:110-133; applied
    with cutoff 1e-7 at :1340)."""
    out = []
    reads_num = None
    for line in open(path):
        if line.startswith("#"):
            try:
                reads_num = int(line.split(";")[0].split(":")[1])
            except (IndexError, ValueError):
                pass
            continue
        a = line.strip().split(",")
        if not a or a[0] == "from_ref":
            continue
        from_ref, from_pos = a[0], int(a[1])
        to_ref, to_pos = a[4], int(a[5])
        cross = int(a[14])
        if reads_num and cross / reads_num < abun_cutoff:
            continue
        if deep_flag and ("_".join(from_ref.split("_")[:-1])
                          == "_".join(to_ref.split("_")[:-1])):
            continue
        out.append((from_ref, from_pos, to_ref, to_pos))
    return out


def compare_tools(truth, tool_csvs: dict, tol=TOLERATE_DIST) -> dict:
    """Score several tools' call files against one truth set — the LEMON
    head-to-head table (evaluation.py comparator flow). `tool_csvs` maps
    tool name -> (path, kind) with kind 'localhgt' (abundance-filtered
    acc.csv) or 'generic' (LEMON-style first-four-columns CSV)."""
    true_bkps = truth_to_bkps(truth)
    rows = {}
    for name, (path, kind) in tool_csvs.items():
        calls = (read_localhgt_csv(path) if kind == "localhgt"
                 else read_comparator_csv(path))
        s = score_bkps(true_bkps, calls, tol)
        rows[name] = {"recall": s.recall, "fdr": s.fdr, "f1": s.f1,
                      "n_called": s.n_called}
    return rows


def resource_usage() -> dict:
    """Host CPU time + peak RSS of this process — the in-process analogue of
    the paper harness's `/usr/bin/time -v` parsing (evaluation.py:205-240
    extract_time/extract_mem). ru_maxrss is KB on Linux."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {
        "cpu_user_s": round(ru.ru_utime, 1),
        "cpu_sys_s": round(ru.ru_stime, 1),
        "max_rss_gb": round(ru.ru_maxrss / 2**20, 3),
    }
