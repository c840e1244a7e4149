"""UHGG taxonomy lineages.

The reference loads `genomes-all_metadata.tsv` (UHGG) into a genome->lineage
dict (mechanism_taxonomy.py:10-33) and resolves a taxon at a level by
position in the GTDB-style `d__;p__;c__;o__;f__;g__;s__` string
(HGT_classifier.py:80-98: level index into lineage.split(";"), "s" when the
field is empty/unknown -> fall back to the genome id).

Here the table is a plain TSV parse (no pandas/pickle side files); when no
metadata is available the lookup degrades to genome-level tags so every
analysis still runs on simulated cohorts.
"""

from __future__ import annotations

LEVELS = ["domain", "phylum", "class", "order", "family", "genus", "species",
          "genome"]


class Taxonomy:
    def __init__(self, metadata_tsv: str | None = None):
        self.lineage = {}
        if metadata_tsv:
            self._read(metadata_tsv)

    def _read(self, path: str):
        with open(path) as f:
            header = f.readline().rstrip("\n").split("\t")
            try:
                gi = header.index("Genome")
                li = header.index("Lineage")
            except ValueError:
                gi, li = 0, 1
            for line in f:
                a = line.rstrip("\n").split("\t")
                if len(a) > max(gi, li):
                    self.lineage[a[gi]] = a[li]

    def taxon(self, genome: str, level: str | int) -> str:
        """Taxon of `genome` at `level` (name or 0-based lineage index);
        unknown genomes or empty fields return the genome id itself, so
        genome-level analyses work without any metadata."""
        if isinstance(level, str):
            if level == "genome":
                return genome
            level = LEVELS.index(level)
        lin = self.lineage.get(genome)
        if lin is None:
            return genome
        parts = lin.split(";")
        if level >= len(parts):
            return genome
        t = parts[level].strip()
        # "p__" with nothing after the prefix = unannotated
        if len(t) <= 3:
            return genome
        return t

    def edge_tag(self, bkp, level: str | int) -> str:
        """Unordered taxon-pair tag of a breakpoint at `level`
        (HGT_classifier.py:85-98 `get_tag`)."""
        a = self.taxon(bkp.from_ref_genome, level)
        b = self.taxon(bkp.to_ref_genome, level)
        return "&".join(sorted([a, b]))
