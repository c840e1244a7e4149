"""HGT event inference: match breakpoint pairs into complete events.

Port of scripts/infer_HGT_event.py: load every sample's acc.csv, drop
same-genome pairs (genome = contig name minus its last '_' field, :38-39),
build a per-sample graph whose nodes are breakpoints with enough
cross-split-read support away from contig ends, whose edges join two
breakpoints sharing one endpoint within 20 bp while the other endpoints
differ (tail->head sides, same reverse flag, segment >= min length, and the
cohort ambiguity check), then take a max-weight matching per connected
component (:312-364) — each matched pair is one event row.
"""

from __future__ import annotations

import os
import random
import re
from dataclasses import dataclass

import numpy as np

from localhgt_tpu_torch.config import EventConfig
from localhgt_tpu_torch.io import fasta
from localhgt_tpu_torch.utils import formats


@dataclass
class Bkp:
    from_ref: str
    from_bkp: int
    from_side: str
    from_strand: str
    to_ref: str
    to_bkp: int
    to_side: str
    to_strand: str
    if_reverse: str
    cross_split_reads: int

    @property
    def from_genome(self):
        return "_".join(self.from_ref.split("_")[:-1])

    @property
    def to_genome(self):
        return "_".join(self.to_ref.split("_")[:-1])


def _load_sample(path: str) -> list[Bkp]:
    rows, _, _ = formats.read_acc_csv(path)
    out = []
    for r in rows:
        b = Bkp(
            r["from_ref"].strip(), int(r["from_pos"]), r["from_side"].strip(),
            r["from_strand"].strip(), r["to_ref"].strip(), int(r["to_pos"]),
            r["to_side"].strip(), r["to_strand"].strip(),
            r["if_reverse"].strip(), int(r["cross_split_reads"]),
        )
        if b.from_genome == b.to_genome:
            continue
        out.append(b)
    return out


class EventMatcher:
    def __init__(self, result_dir: str, ref_path: str, cfg: EventConfig):
        self.cfg = cfg
        # seeded: the reference shuffles the ambiguity-check cohort with the
        # global unseeded RNG (infer_HGT_event.py:258), so its event output
        # varies run to run on >pop_sample cohorts; this framework is
        # deterministic by design (SURVEY.md section 5)
        self._rng = random.Random(cfg.seed)
        self.ref = fasta.read_fasta(ref_path)
        self.cohort: dict[str, list[Bkp]] = {}
        for fn in sorted(os.listdir(result_dir)):
            if not re.search(r"\.acc\.csv$", fn) or re.search(r"\.repeat\.acc\.csv$", fn):
                continue
            sid = fn[: -len(".acc.csv")]
            self.cohort[sid] = _load_sample(os.path.join(result_dir, fn))

    def _at_contig_end(self, b: Bkp) -> bool:
        """check_if_bkp_at_ends (:298-310)."""
        w = self.cfg.window / 2
        for ref, pos in ((b.from_ref, b.from_bkp), (b.to_ref, b.to_bkp)):
            try:
                ln = self.ref.length_of(self.ref.contig_id(ref))
            except KeyError:
                return True
            if pos < w or ln - pos < w:
                return True
        return False

    @staticmethod
    def _delete_direction(pos_list):
        """delete_direction (:128-137): orders the donor endpoints and demands
        tail->head sides."""
        if pos_list[0] > pos_list[3]:
            pos_list = pos_list[3:] + pos_list[:3]
        ok = pos_list[1] == "tail" and pos_list[4] == "head"
        return pos_list[0], pos_list[3], ok

    def _pair_geometry(self, b1: Bkp, b2: Bkp):
        """The shared-endpoint cases of check_if_match/get_event (:139-235).
        Returns (receptor, insert_pos, donor, del_start, del_end, ok) or None."""
        md = self.cfg.max_diff
        cases = [
            (b1.from_ref == b2.from_ref and abs(b1.from_bkp - b2.from_bkp) < md,
             b1.to_ref == b2.to_ref and abs(b1.to_bkp - b2.to_bkp) > md,
             b1.from_ref, b1.from_bkp, b1.to_ref,
             [b1.to_bkp, b1.to_side, b1.to_strand, b2.to_bkp, b2.to_side, b2.to_strand]),
            (b1.to_ref == b2.from_ref and abs(b1.to_bkp - b2.from_bkp) < md,
             b1.from_ref == b2.to_ref and abs(b1.from_bkp - b2.to_bkp) > md,
             b1.to_ref, b1.to_bkp, b1.from_ref,
             [b1.from_bkp, b1.from_side, b1.from_strand, b2.to_bkp, b2.to_side, b2.to_strand]),
            (b1.from_ref == b2.to_ref and abs(b1.from_bkp - b2.to_bkp) < md,
             b1.to_ref == b2.from_ref and abs(b1.to_bkp - b2.from_bkp) > md,
             b1.from_ref, b1.from_bkp, b1.to_ref,
             [b1.to_bkp, b1.to_side, b1.to_strand, b2.from_bkp, b2.from_side, b2.from_strand]),
            (b1.to_ref == b2.to_ref and abs(b1.to_bkp - b2.to_bkp) < md,
             b1.from_ref == b2.from_ref and abs(b1.from_bkp - b2.from_bkp) > md,
             b1.to_ref, b1.to_bkp, b1.from_ref,
             [b1.from_bkp, b1.from_side, b1.from_strand, b2.from_bkp, b2.from_side, b2.from_strand]),
        ]
        for share, differ, receptor, ins_pos, donor, plist in cases:
            if share:
                if not differ:
                    return None
                ds, de, ok = self._delete_direction(plist)
                return receptor, ins_pos, donor, ds, de, ok
        return None

    def _ambiguity_clusters(self, sample_id, receptor, ins_pos, donor) -> int:
        """remove_ambiguity_pop (:254-285): donor-side positions matched at
        this insertion site across <=200 random cohort samples must form few
        1-D DBSCAN(eps=bin_size) clusters."""
        ids = list(self.cohort)
        self._rng.shuffle(ids)
        ids = sorted(set(ids[: self.cfg.pop_sample] + [sample_id]))
        pos = []
        md = self.cfg.max_diff
        for sid in ids:
            for b in self.cohort[sid]:
                if b.from_ref == receptor and abs(b.from_bkp - ins_pos) < md:
                    if b.to_ref == donor:
                        pos.append(b.to_bkp)
                elif b.to_ref == receptor and abs(b.to_bkp - ins_pos) < md:
                    if b.from_ref == donor:
                        pos.append(b.from_bkp)
        if not pos:
            return 0
        pos = np.sort(np.asarray(pos))
        # eps-chain clustering == DBSCAN(eps, min_samples=1) in 1-D
        return int(1 + np.sum(np.diff(pos) > self.cfg.bin_size))

    def _match(self, sample_id, b1: Bkp, b2: Bkp) -> bool:
        geo = self._pair_geometry(b1, b2)
        if geo is None:
            return False
        receptor, ins_pos, donor, ds, de, ok = geo
        ok = ok and b1.if_reverse == b2.if_reverse
        ok = ok and (de - ds >= self.cfg.min_hgt_len)
        if ok:
            n = self._ambiguity_clusters(sample_id, receptor, ins_pos, donor)
            ok = n <= self.cfg.max_ambiguity_clusters
        return ok

    def match_sample(self, sample_id: str) -> list[list]:
        import networkx as nx

        bkps = self.cohort[sample_id]
        usable = [
            i for i, b in enumerate(bkps)
            if b.cross_split_reads >= self.cfg.min_split_reads
            and not self._at_contig_end(b)
        ]
        G = nx.Graph()
        for ii, i in enumerate(usable):
            for j in usable[ii + 1:]:
                if self._match(sample_id, bkps[i], bkps[j]):
                    w = (bkps[i].cross_split_reads + bkps[j].cross_split_reads) / 2
                    G.add_edge(i, j, weight=w)
        rows = []
        for cc in nx.connected_components(G):
            matching = nx.algorithms.matching.max_weight_matching(
                G.subgraph(cc), weight="weight"
            )
            for i, j in matching:
                geo = self._pair_geometry(bkps[i], bkps[j])
                if geo is None:
                    continue
                receptor, ins_pos, donor, ds, de, _ = geo
                rows.append(
                    [sample_id, receptor, ins_pos, donor, ds, de,
                     bkps[i].if_reverse]
                )
        return rows


def detect_event(ref_path: str, result_dir: str, out_csv: str,
                 cfg: EventConfig | None = None):
    from localhgt_tpu_torch.utils import validate

    cfg = cfg or EventConfig()
    validate.check_event_inputs(ref_path, result_dir)
    m = EventMatcher(result_dir, ref_path, cfg)
    rows = []
    for sid in m.cohort:
        rows.extend(m.match_sample(sid))
    with open(out_csv, "w") as f:
        f.write("sample,receptor,insert_locus,donor,delete_start,delete_end,reverse_flag\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    return rows
