"""GFF3 gene-interval index for hit annotation.

Replaces the reference's GffAnnotationIndex (JanusX src/io/
gffanno.rs) used by postgwas: per-chromosome sorted gene intervals with
binary-search window queries.
"""

from __future__ import annotations

import gzip
from bisect import bisect_left, bisect_right
from dataclasses import dataclass


@dataclass
class Gene:
    chrom: str
    start: int
    end: int
    name: str
    strand: str


class GffIndex:
    def __init__(self, genes):
        self.by_chrom: dict = {}
        for g in genes:
            self.by_chrom.setdefault(g.chrom, []).append(g)
        self.starts: dict = {}
        # running max of gene end (and which gene holds it) over the
        # start-sorted list: lets overlap queries stop the back-scan exactly
        # when no earlier gene can still reach the window, and gives O(log n)
        # nearest-left lookups — no fixed-width scan windows that long or
        # densely nested genes could overflow
        self.cummax_end: dict = {}
        self.cummax_idx: dict = {}
        for c, lst in self.by_chrom.items():
            lst.sort(key=lambda g: g.start)
            self.starts[c] = [g.start for g in lst]
            ce, ci = [], []
            best_e, best_i = -1, -1
            for i, g in enumerate(lst):
                if g.end > best_e:
                    best_e, best_i = g.end, i
                ce.append(best_e)
                ci.append(best_i)
            self.cummax_end[c] = ce
            self.cummax_idx[c] = ci

    @classmethod
    def from_file(cls, path: str, feature_types=("gene",)) -> "GffIndex":
        opener = gzip.open if str(path).endswith(".gz") else open
        genes = []
        with opener(path, "rt") as fh:
            for line in fh:
                if line.startswith("#"):
                    continue
                f = line.rstrip("\n").split("\t")
                if len(f) < 9 or f[2] not in feature_types:
                    continue
                attrs = {}
                for kv in f[8].split(";"):
                    if "=" in kv:
                        k, v = kv.split("=", 1)
                        attrs[k.strip()] = v.strip()
                name = (
                    attrs.get("Name")
                    or attrs.get("gene_name")
                    or attrs.get("ID")
                    or f"{f[0]}:{f[3]}-{f[4]}"
                )
                genes.append(
                    Gene(chrom=f[0], start=int(f[3]), end=int(f[4]),
                         name=name, strand=f[6])
                )
        return cls(genes)

    @classmethod
    def from_bed(cls, path: str) -> "GffIndex":
        """BED-like interval text (chrom start end [name]; tab/comma/
        space delimited, header lines skipped) -> the same interval
        index the GFF path builds (reference postgwas -bed source)."""
        import re

        opener = gzip.open if str(path).endswith(".gz") else open
        genes = []
        with opener(path, "rt") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith(("#", "track", "browser")):
                    continue
                f = re.split(r"[\t, ]+", line)
                if len(f) < 3:
                    continue
                try:
                    start, end = int(f[1]), int(f[2])
                except ValueError:
                    continue  # header row
                name = f[3] if len(f) > 3 else f"{f[0]}:{start}-{end}"
                genes.append(Gene(chrom=f[0], start=start + 1, end=end,
                                  name=name, strand="."))
        return cls(genes)

    def query(self, chrom: str, pos: int, window: int = 0):
        """Genes overlapping [pos-window, pos+window] (exact; start order)."""
        lst = self.by_chrom.get(str(chrom))
        if not lst:
            return []
        c = str(chrom)
        starts = self.starts[c]
        cummax = self.cummax_end[c]
        lo = pos - window
        hi = pos + window
        j = bisect_right(starts, hi)  # genes starting at/before hi
        out = []
        for i in range(j - 1, -1, -1):
            if cummax[i] < lo:
                break  # nothing earlier can reach the window
            if lst[i].end >= lo:
                out.append(lst[i])
        out.reverse()
        return out

    def nearest(self, chrom: str, pos: int, max_dist: int = 1_000_000):
        hits = self.query(chrom, pos, 0)
        if hits:
            return hits[0], 0
        c = str(chrom)
        lst = self.by_chrom.get(c)
        if not lst:
            return None, None
        starts = self.starts[c]
        j = bisect_left(starts, pos)
        best, bd = None, max_dist + 1
        if j < len(lst):  # closest gene starting at/after pos
            d = lst[j].start - pos
            if d < bd:
                best, bd = lst[j], d
        if j > 0:  # closest gene ending before pos = running-max end holder
            i = self.cummax_idx[c][j - 1]
            d = pos - self.cummax_end[c][j - 1]
            if 0 < d < bd:
                best, bd = lst[i], d
        if best is None or bd > max_dist:
            return None, None
        return best, bd
