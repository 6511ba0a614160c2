"""Bayesian marker models (BayesA/B/Cpi) — not ported yet.

The reference (janusx_tpu/gs/bayes.py) runs a Gibbs sampler whose inner
step is a ``fori_loop`` over each marker of a block (bayes.py:80-104),
inside a scan over blocks, inside 400 iterations: in eager PyTorch that
is 400 x m sequential scalar steps, so the port needs a kernel of its own
for it (ROADMAP queue 1, "BayesA/B/Cpi"). Until then the workflow copy
reaches this stub and fails loudly, and ``jx gs`` refuses the Bayes
methods before it reads any genotype.
"""

from __future__ import annotations

BAYES_NOT_PORTED = ("the Bayes methods are not ported to janusx_tpu_torch yet "
                    "(ROADMAP queue 1, item BayesA/B/Cpi)")


def bayes_fit_predict(cfg, method, X, y, train, test, folds):
    raise NotImplementedError(f"{method}: {BAYES_NOT_PORTED}")
