"""Phenotype / covariate file parsing.

Semantics follow the reference (gs/workflow.py:26-31 docstring,
doc/JanusXcli.md §2.4):

- whitespace/tab separated; first column = sample ID
- optional header row (auto-detected: non-numeric trait cells)
- NA / NaN / empty = missing
- duplicated sample IDs are averaged per trait
- trait selection by zero-based index (excluding the ID column) or by name
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_NA = {"na", "nan", "", ".", "-"}


def _to_float(tok: str) -> float:
    if tok.strip().lower() in _NA:
        return np.nan
    try:
        return float(tok)
    except ValueError:
        return np.nan


def _is_number(tok: str) -> bool:
    t = tok.strip().lower()
    if t in _NA:
        return True
    try:
        float(t)
        return True
    except ValueError:
        return False


@dataclass
class Phenotype:
    samples: np.ndarray  # (n,) object
    values: np.ndarray  # (n, t) float64, NaN missing
    traits: list[str]

    @property
    def n(self) -> int:
        return len(self.samples)

    def select(self, which: list | None):
        """Select traits by zero-based index or by name. None = all."""
        if which is None:
            return self
        idx = []
        for w in which:
            if isinstance(w, int) or (isinstance(w, str) and w.lstrip("-").isdigit()):
                idx.append(int(w))
            else:
                if w not in self.traits:
                    raise KeyError(f"trait {w!r} not in {self.traits}")
                idx.append(self.traits.index(w))
        return Phenotype(
            samples=self.samples,
            values=self.values[:, idx],
            traits=[self.traits[i] for i in idx],
        )

    def align(self, sample_ids: np.ndarray):
        """Reorder to a genotype sample list; unmatched IDs get NaN rows.

        Returns (values (len(sample_ids), t), matched_mask).
        """
        pos = {s: i for i, s in enumerate(self.samples)}
        out = np.full((len(sample_ids), self.values.shape[1]), np.nan)
        matched = np.zeros(len(sample_ids), dtype=bool)
        for j, s in enumerate(sample_ids):
            i = pos.get(s)
            if i is not None:
                out[j] = self.values[i]
                matched[j] = True
        return out, matched


def load_phenotype(path: str) -> Phenotype:
    with open(path, "rt") as fh:
        lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
    if not lines:
        raise ValueError(f"empty phenotype file: {path}")
    first = lines[0].split("\t") if "\t" in lines[0] else lines[0].split()
    has_header = not all(_is_number(t) for t in first[1:]) or first[0] == ""
    if has_header:
        traits = [t if t else f"trait{i}" for i, t in enumerate(first[1:])]
        body = lines[1:]
    else:
        traits = [f"trait{i}" for i in range(len(first) - 1)]
        body = lines
    ids: list[str] = []
    rows: list[list[float]] = []
    t = len(traits)
    for ln in body:
        f = ln.split("\t") if "\t" in ln else ln.split()
        if not f:
            continue
        ids.append(f[0])
        vals = [_to_float(x) for x in f[1 : 1 + t]]
        vals += [np.nan] * (t - len(vals))
        rows.append(vals)
    samples = np.array(ids, dtype=object)
    values = np.array(rows, dtype=np.float64)

    # average duplicated IDs per trait (NaN-aware) — reference behavior
    uniq, inv, counts = np.unique(samples, return_inverse=True, return_counts=True)
    if len(uniq) != len(samples):
        summed = np.zeros((len(uniq), t))
        cnt = np.zeros((len(uniq), t))
        ok = ~np.isnan(values)
        np.add.at(summed, inv, np.where(ok, values, 0.0))
        np.add.at(cnt, inv, ok.astype(np.float64))
        with np.errstate(invalid="ignore", divide="ignore"):
            avg = np.where(cnt > 0, summed / cnt, np.nan)
        # keep first-appearance order
        order = np.argsort([np.nonzero(inv == k)[0][0] for k in range(len(uniq))])
        samples, values = uniq[order], avg[order]
    return Phenotype(samples=samples, values=values, traits=list(traits))


def load_covariates(path: str, sample_ids: np.ndarray) -> np.ndarray:
    """Load a covariate file aligned to sample_ids; returns (n, c) float64.

    Rows for unmatched samples are NaN (caller drops them with the
    phenotype-missing mask). No intercept is added here.
    """
    ph = load_phenotype(path)
    vals, _ = ph.align(sample_ids)
    return vals
