"""The traffic: a stream of traits drawn from the seed.

Trait i of a run is drawn from its own stream (the run's seed, the
traffic key, i), so it is the same whichever batch it falls in. Each trait
has ``n_qtl`` QTLs at fresh positions with Gaussian effects, a polygenic
background mixed from the panel's ``background_scores`` scores with
Gaussian weights, and heritability h2 ~ U[h2]: the QTLs carry ``qtl_share``
of the genetic variance. Warm-up traits come from a stream of their own.
"""

from __future__ import annotations

import numpy as np

from portbench.panel import MISSING, Panel, sub_seed

TRAFFIC_KEY = 3
WARMUP_KEY = 4


def _standardize(x: np.ndarray) -> np.ndarray:
    sd = x.std()
    return (x - x.mean()) / (sd if sd > 0 else 1.0)


class TraitStream:
    """Traits on the phenotyped samples of ``panel`` (the set ``name``)."""

    def __init__(self, phenotype: dict, panel: Panel, name: str, seed: int):
        self.ph = phenotype
        self.set = panel.sets[name]
        self.scores = panel.scores
        self.seed = seed
        self.n = len(self.set.samples)

    def _genotypes(self, rows: np.ndarray) -> np.ndarray:
        """Standardized genotypes (len(rows), n) of the set's kept SNPs."""
        pk = self.set.packed[rows]
        codes = ((pk[:, :, None] >> np.arange(0, 8, 2, dtype=np.uint8)) & 3)
        codes = codes.reshape(len(rows), -1)[:, :self.n].astype(np.float64)
        p = self.set.af[rows][:, None]
        sd = np.sqrt(2.0 * p * (1.0 - p))
        z = (codes - 2.0 * p) / np.where(sd > 0, sd, 1.0)
        return np.where(codes == MISSING, 0.0, z)

    def trait(self, i: int, key: int = TRAFFIC_KEY) -> np.ndarray:
        ph = self.ph
        rng = np.random.default_rng(sub_seed(self.seed, key, i))
        m = self.set.packed.shape[0]
        pos = rng.choice(m, ph["n_qtl"], replace=False)
        eff = rng.normal(size=ph["n_qtl"])
        h2 = rng.uniform(*ph["h2"])
        c = rng.normal(size=self.scores.shape[1])
        eps = rng.normal(size=self.n)
        gq = _standardize(eff @ self._genotypes(pos))
        gb = _standardize(self.scores @ c)
        qs = ph["qtl_share"]
        g = _standardize(np.sqrt(qs) * gq + np.sqrt(1.0 - qs) * gb)
        return ph["mean"] + np.sqrt(h2) * g + np.sqrt(1.0 - h2) * _standardize(eps)

    def batch(self, start: int, T: int, key: int = TRAFFIC_KEY) -> np.ndarray:
        """Traits start .. start+T-1 as the columns of an (n, T) array."""
        return np.stack([self.trait(start + t, key) for t in range(T)], axis=1)

    def warmup(self, step: int, T: int) -> np.ndarray:
        return self.batch(step * T, T, WARMUP_KEY)
