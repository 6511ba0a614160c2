"""sklearn-style K-fold splitter (reference: python/janusx/pyBLUP/kfold.py)."""

from __future__ import annotations

import numpy as np


class KFold:
    def __init__(
        self, n_splits: int = 5, shuffle: bool = False, random_state: int | None = None
    ):
        if n_splits < 2:
            raise ValueError(f"n_splits must be >= 2, got {n_splits}")
        if not shuffle and random_state is not None:
            raise ValueError("random_state requires shuffle=True")
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def split(self, X, y=None, groups=None):
        """sklearn-compatible signature (y/groups accepted, unused)."""
        n = int(X) if isinstance(X, (int, np.integer)) else len(X)
        if self.n_splits > n:
            raise ValueError(f"n_splits={self.n_splits} > n_samples={n}")
        idx = np.arange(n, dtype=np.int64)
        if self.shuffle:
            rng = np.random.default_rng(self.random_state)
            idx = rng.permutation(idx)
        sizes = np.full(self.n_splits, n // self.n_splits, np.int64)
        sizes[: n % self.n_splits] += 1
        start = 0
        for sz in sizes:
            test = idx[start : start + sz]
            train = np.concatenate([idx[:start], idx[start + sz :]])
            yield np.sort(train), np.sort(test)
            start += sz
