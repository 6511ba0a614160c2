"""Annotation readers + indexed region queries.

Reference: JanusX python/janusx/gtools/reader.py (gffreader
:202, bedreader :330, GFFQuery :444 — per-chromosome sorted numpy
arrays for repeated range lookups)."""

from __future__ import annotations

import gzip
import re
from typing import Iterable, Optional

import numpy as np
import pandas as pd

_CHR_PREFIX = re.compile(r"^(chr|chromosome|chrom)[_\-.]?", re.IGNORECASE)


def normalize_chr(chrom: object) -> str:
    """Strip chr/chromosome prefixes and leading zeros: Chr01 -> 1."""
    s = str(chrom).strip()
    s = _CHR_PREFIX.sub("", s)
    s2 = s.lstrip("0")
    return s2 if s2 else s


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def _attr_value(attr: str, key: str) -> str | None:
    for part in attr.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=", 1)
        elif " " in part:
            k, v = part.split(" ", 1)
        else:
            continue
        if k.strip() == key:
            return v.strip().strip('"')
    return None


def gffreader(
    gffpath: str, attr: Optional[Iterable[str]] = ("ID", "description")
) -> pd.DataFrame:
    """Parse GFF/GFF3(.gz) into a DataFrame with chrom/chrom_norm/source/
    feature/start/end/score/strand/frame/attribute (+ one column per
    requested attribute key)."""
    rows = []
    with _open(gffpath) as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 9:
                continue
            rows.append(f[:9])
    df = pd.DataFrame(
        rows,
        columns=["chrom", "source", "feature", "start", "end", "score",
                 "strand", "frame", "attribute"],
    )
    df["start"] = pd.to_numeric(df["start"], errors="coerce").astype("Int64")
    df["end"] = pd.to_numeric(df["end"], errors="coerce").astype("Int64")
    df = df.dropna(subset=["start", "end"]).reset_index(drop=True)
    df["start"] = df["start"].astype(np.int64)
    df["end"] = df["end"].astype(np.int64)
    df["chrom_norm"] = df["chrom"].map(normalize_chr)
    if attr:
        keys = [attr] if isinstance(attr, str) else list(attr)
        for key in keys:
            df[f"attr_{key}"] = df["attribute"].map(
                lambda a, k=key: _attr_value(a, k)
            )
    return df


def bedreader(annofile: str) -> pd.DataFrame:
    """Read BED-like rows (chrom start end [name ...]); 0-based half-open
    starts converted to 1-based inclusive (GFF convention) so both readers
    feed the same GFFQuery."""
    rows = []
    with _open(annofile) as fh:
        for line in fh:
            s = line.strip()
            if not s or s.startswith(("#", "track", "browser")):
                continue
            f = s.split("\t") if "\t" in s else s.split()
            if len(f) < 3:
                continue
            rows.append(f[:4] if len(f) >= 4 else f[:3] + [""])
    df = pd.DataFrame(rows, columns=["chrom", "start", "end", "name"])
    df["start"] = pd.to_numeric(df["start"], errors="coerce")
    df["end"] = pd.to_numeric(df["end"], errors="coerce")
    df = df.dropna(subset=["start", "end"]).reset_index(drop=True)
    df["start"] = df["start"].astype(np.int64) + 1  # BED -> 1-based
    df["end"] = df["end"].astype(np.int64)
    df["feature"] = "region"
    df["attribute"] = df["name"]
    df["chrom_norm"] = df["chrom"].map(normalize_chr)
    return df


class GFFQuery:
    """Indexed range queries over an annotation DataFrame.

    Per-chromosome start/end numpy arrays sorted by start; query_range
    narrows candidates with searchsorted on starts, then masks on ends
    (reference GFFQuery, reader.py:444)."""

    def __init__(self, gff: pd.DataFrame):
        need = {"chrom_norm", "start", "end", "feature"}
        missing = need - set(gff.columns)
        if missing:
            raise ValueError(f"missing columns: {sorted(missing)}")
        self.gff = gff.reset_index(drop=True)
        self._idx: dict[str, dict[str, np.ndarray]] = {}
        for ch, block in self.gff.groupby("chrom_norm", sort=False):
            block = block.sort_values(["start", "end"], kind="mergesort")
            self._idx[str(ch)] = {
                "rows": block.index.to_numpy(np.int64),
                "starts": block["start"].to_numpy(np.int64),
                "ends": block["end"].to_numpy(np.int64),
                "features": block["feature"].astype(str).str.lower().to_numpy(object),
            }

    @classmethod
    def from_file(cls, path: str, **kw) -> "GFFQuery":
        if str(path).rstrip(".gz").endswith((".bed", ".txt")):
            return cls(bedreader(path))
        return cls(gffreader(path, **kw))

    def query_range(
        self,
        chrom: object,
        start: int,
        end: int,
        features: Optional[Iterable[str]] = None,
        overlap: bool = True,
    ) -> pd.DataFrame:
        """Records on chrom overlapping (or fully inside) [start, end]."""
        if start > end:
            start, end = end, start
        idx = self._idx.get(normalize_chr(chrom))
        if idx is None:
            return self.gff.iloc[0:0]
        starts, ends = idx["starts"], idx["ends"]
        # candidates: start <= end_query; then filter end >= start_query
        hi = np.searchsorted(starts, end, side="right")
        if overlap:
            mask = ends[:hi] >= start
        else:
            mask = (starts[:hi] >= start) & (ends[:hi] <= end)
        rows = idx["rows"][:hi][mask]
        if features is not None:
            want = {features.lower()} if isinstance(features, str) else {
                str(f).lower() for f in features
            }
            fmask = np.isin(idx["features"][:hi][mask], list(want))
            rows = rows[fmask]
        return self.gff.loc[rows]

    def query_point(self, chrom: object, pos: int, window: int = 0) -> pd.DataFrame:
        return self.query_range(chrom, pos - window, pos + window)
