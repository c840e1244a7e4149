"""DSB-repair mechanism classification of HGT events on one device.

Port of localhgt_tpu/analysis/mechanism.py (the decision tree and its
signals are described there). The junction homology lengths are aligned
on `device` by analysis.microhomology. The JAX module imports jax when it
loads, so its host parts are copied here and held equal to it by
tests/test_torch_analysis.py.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass

import numpy as np

from localhgt_tpu_torch.analysis import microhomology as mh

FOSTES_INS = 10  # templated-insertion cutoff (mechanism.py:327-330)
NAHR_HOMO = 100  # long-homology cutoff (mechanism.py:333-336)
ALTEJ_HOMO = 2


@dataclass
class EventRow:
    """One `complete_HGT_event.csv` row (infer_HGT_event.py:395-396)."""

    sample: str
    receptor: str
    insert_locus: int
    donor: str
    delete_start: int
    delete_end: int
    reverse_flag: str

    @classmethod
    def from_row(cls, r) -> "EventRow":
        return cls(r[0], r[1], int(r[2]), r[3], int(r[4]), int(r[5]),
                   str(r[6]))


def read_events(path: str) -> list:
    out = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0] in ("sample", ""):
                continue
            out.append(EventRow.from_row(row))
    return out


def in_intervals(pos: int, intervals) -> bool:
    """mechanism.py:189-193."""
    return any(s <= pos <= e for s, e in intervals)


def classify(break_type: str, tandem: bool, tei: bool, ins_num: int,
             homo_num: int) -> str:
    """Verbatim decision tree (mechanism.py:313-339)."""
    if break_type == "ins":
        if tei:
            return "TEI"
        if tandem:
            return "VNTR"
        return "NA"
    if tei:
        return "TEI"
    if tandem:
        return "VNTR"
    if ins_num > 0:
        return "FoSTeS/MMBIR" if ins_num > FOSTES_INS else "NHEJ"
    if homo_num > NAHR_HOMO:
        return "NAHR"
    if homo_num >= ALTEJ_HOMO:
        return "alt-EJ"
    return "NHEJ"


def classify_events(events, contigs, device, tandem: dict | None = None,
                    tei: dict | None = None, ins_lens=None,
                    cutoff: int = mh.CUTOFF) -> list:
    """Classify every event; returns dicts with del/ins mechanisms and the
    junction homology length (mechanism.py:283-311 `Mechanism.main`).

    `tandem` / `tei`: contig -> [(start, end), ...] annotation intervals.
    `ins_lens`: optional per-event templated-insertion length; 0 when not
    provided, as in the JAX package."""
    tandem = tandem or {}
    tei = tei or {}
    # a reverse event attaches the donor segment on the '-' strand at both
    # junctions, so both flanks are reverse-complemented
    f_codes, t_codes, idx = [], [], []
    for i, ev in enumerate(events):
        strand = "-" if str(ev.reverse_flag).lower() in ("true", "1") else "+"
        s, e = sorted((ev.delete_start, ev.delete_end))
        f = mh.flank_codes(contigs, ev.donor, s, strand, cutoff)
        t = mh.flank_codes(contigs, ev.donor, e, strand, cutoff)
        if f is None or t is None:
            continue
        f_codes.append(f)
        t_codes.append(t)
        idx.append(i)
    homo = np.zeros(len(events), np.int32)
    if idx:
        homo[idx] = mh.homology_lengths(np.stack(f_codes), np.stack(t_codes),
                                        device)

    out = []
    for i, ev in enumerate(events):
        s, e = sorted((ev.delete_start, ev.delete_end))
        del_tandem = (in_intervals(s, tandem.get(ev.donor, ()))
                      or in_intervals(e, tandem.get(ev.donor, ())))
        del_tei = (in_intervals(s, tei.get(ev.donor, ()))
                   or in_intervals(e, tei.get(ev.donor, ())))
        ins_n = int(ins_lens[i]) if ins_lens is not None else 0
        del_mech = classify("del", del_tandem, del_tei, ins_n, int(homo[i]))
        ins_tandem = in_intervals(
            ev.insert_locus, tandem.get(ev.receptor, ()))
        ins_tei = in_intervals(ev.insert_locus, tei.get(ev.receptor, ()))
        ins_mech = classify("ins", ins_tandem, ins_tei, 0, 0)
        out.append({
            "event": ev, "del_mechanism": del_mech, "ins_mechanism": ins_mech,
            "homology": int(homo[i]),
        })
    return out


def mechanism_frequency(classified) -> dict:
    """mechanism -> relative frequency (mechanism_taxonomy.py:35-50)."""
    freq = {}
    for c in classified:
        freq[c["del_mechanism"]] = freq.get(c["del_mechanism"], 0) + 1
    n = max(1, len(classified))
    return {k: round(v / n, 2) for k, v in freq.items()}


def read_interval_bed(path: str) -> dict:
    """contig -> [(start, end)] from a 3-column BED-like annotation file
    (the shape `get_tandem_repeat`/`get_TEI` build, mechanism.py:152-188)."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            a = line.split()
            if len(a) >= 3:
                out.setdefault(a[0], []).append((int(a[1]), int(a[2])))
    return out
