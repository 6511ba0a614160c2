"""sklearn-style in-memory Python API (port of janusx_tpu/api.py).

Mirrors the reference's ``janusx.assoc.api.ASSOC``
(JanusX python/janusx/assoc/api.py:518: .fit(y, X, K) /
.assoc(G) -> DataFrame[beta, se, pwald]; routes lm/lmm/fvlmm/splmm) and
the ``GenomicSelection`` wrapper (gs/runner.py).

Conventions: G passed to ``assoc`` is sample-major (n, m) and used as-is
(no re-centering — reference api.py docstring). K is a dense (n, n)
kinship; when omitted for mixed routes it is built from G at fit time.

Where the work runs: the mixed routes' eigenbasis and null fit are the
port's (host eigh, the batched Brent on the device); each chunk's rotation
Uᵀ G and its λ grid scan (the reference's 1,024-point grid, f32 grams)
and f64 beta/se run on the device, one copy back per chunk. The LM route
is host numpy in f64, as the reference's. ``assoc`` wraps the three
columns of ``_assoc_arrays`` in a pandas DataFrame, imported on use.
``GenomicSelection`` runs the port's GBLUP (host REML) and Bayes chains
(the G1/G2 sweeps on a card), with the kinship product on the device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.core import stats as jstats
from janusx_tpu_torch.core.reml import (
    beta_se_snp_batch,
    fit_null_reml,
    lmm_grid_scan,
    make_rotated,
)
from janusx_tpu_torch.core.spectral import eigh_grm

_MODELS = ("lm", "glm", "lmm", "fvlmm", "splmm")
f64 = torch.float64


class ASSOC:
    """In-memory association scans over dense matrices; the mixed routes
    run on ``device`` (default: ``config.resolve_device``)."""

    def __init__(self, model: str = "lmm", model_args: dict[str, Any] | None = None,
                 device=None):
        model = str(model).lower()
        if model == "glm":
            model = "lm"
        if model not in ("lm", "lmm", "fvlmm", "splmm"):
            raise ValueError(f"unsupported model {model!r}; use one of {_MODELS}")
        self.model = model
        self.model_args = dict(model_args or {})
        self.device = device
        self.fitted_ = False
        self.null_fit_: dict | None = None

    def fit(self, y, X=None, K=None):
        """y: (n,) phenotype; X: (n, c) covariates (no intercept column);
        K: (n, n) kinship for mixed routes (built later from G if None)."""
        y = np.asarray(y, np.float64).reshape(-1)
        n = len(y)
        keep = np.isfinite(y)
        if X is not None:
            X = np.asarray(X, np.float64)
            if X.ndim == 1:
                X = X[:, None]
            keep &= np.all(np.isfinite(X), axis=1)
        self._keep = np.nonzero(keep)[0]
        self.y_ = y[self._keep]
        self.X_ = None if X is None else X[self._keep]
        self.n_samples_ = len(self._keep)
        self._K = None if K is None else np.asarray(K, np.float64)
        self._basis = None
        self._rot = None
        if self.model in ("lmm", "fvlmm", "splmm") and self._K is not None:
            self._prepare_mixed(self._K[np.ix_(self._keep, self._keep)])
        self.fitted_ = True
        return self

    def _prepare_mixed(self, Ksub: np.ndarray):
        cutoff = float(self.model_args.get("sparse_cutoff", 0.05))
        if self.model == "splmm" and cutoff >= 0:
            from janusx_tpu_torch.models.splmm import sparsify_grm

            Ksub = np.asarray(sparsify_grm(Ksub, cutoff).todense())
        self._basis = eigh_grm(Ksub, diag_ridge=1e-6)
        self._rot = make_rotated(self._basis, self.y_, self.X_, device=self.device)
        null = fit_null_reml(self._rot)
        self.null_fit_ = {
            "lambda": null.lbd, "reml": null.reml, "ml": null.ml,
            "log10_lambda": null.log10_lbd,
        }
        self._null = null

    def assoc(self, G, chunk: int = 4096):
        """G: (n, m) sample-major marker matrix. Returns DataFrame."""
        import pandas as pd

        beta, se, pwald = self._assoc_arrays(G, chunk)
        self.result_ = pd.DataFrame({"beta": beta, "se": se, "pwald": pwald})
        return self.result_

    def _assoc_arrays(self, G, chunk: int = 4096):
        """The (beta, se, pwald) columns of ``assoc`` as numpy arrays."""
        if not self.fitted_:
            raise RuntimeError("call fit() first")
        G = np.asarray(G, np.float64)
        if G.ndim == 1:
            G = G[:, None]
        Gk = G[self._keep]  # (n_keep, m)
        if not np.isfinite(Gk).all():
            # missing dosages impute to the marker mean (standard GWAS
            # treatment; NaNs would silently poison every statistic)
            mu = np.nanmean(Gk, axis=0, keepdims=True)
            Gk = np.where(np.isfinite(Gk), Gk, np.where(np.isfinite(mu), mu, 0.0))
        n, m = Gk.shape

        if self.model in ("lmm", "fvlmm", "splmm") and self._basis is None:
            # kinship fallback from G itself: CENTER first — the raw
            # cross-product carries a rank-one allele-frequency component
            # that distorts the eigenbasis and lambda
            Gc = Gk - np.nanmean(Gk, axis=0, keepdims=True)
            Gc = np.where(np.isfinite(Gc), Gc, 0.0)  # missing -> mean
            K = Gc @ Gc.T / max(Gk.shape[1], 1)
            self._prepare_mixed(K)

        beta = np.empty(m)
        se = np.empty(m)
        if self.model == "lm":
            from janusx_tpu_torch.models.lm import design_matrix, student_t_p_two_sided

            X = design_matrix(n, self.X_)
            p = X.shape[1]
            df = n - p - 1
            C = np.linalg.inv(X.T @ X)
            My = self.y_ - X @ (C @ (X.T @ self.y_))
            yMy = float(self.y_ @ My)
            gMy = Gk.T @ My
            GX = Gk.T @ X
            gMg = np.einsum("mn,mn->m", Gk.T, Gk.T) - np.einsum(
                "mp,pq,mq->m", GX, C, GX
            )
            with np.errstate(divide="ignore", invalid="ignore"):
                beta = gMy / gMg
                rss = yMy - gMy**2 / gMg
                se = np.sqrt(rss / df / gMg)
                t = beta / se
            pwald = student_t_p_two_sided(np.where(np.isfinite(t), t, 0), df)
            ok = np.isfinite(beta) & np.isfinite(se) & (se > 0) & (gMg > 1e-12)
            pwald = np.where(ok, pwald, 1.0)
            beta = np.where(ok, beta, np.nan)
            se = np.where(ok, se, np.nan)
        else:
            rot = self._rot
            dev = rot.s.device
            grid = torch.as_tensor(
                np.linspace(config.LOG10_LAMBDA_LOW, config.LOG10_LAMBDA_HIGH, 1024),
                dtype=f64, device=dev)
            U = torch.as_tensor(self._basis.U, dtype=f64, device=dev)
            for s0 in range(0, m, chunk):
                e0 = min(s0 + chunk, m)
                Gr = torch.as_tensor(np.ascontiguousarray(Gk[:, s0:e0].T), dtype=f64,
                                     device=dev) @ U  # (B, n) = (Uᵀ G)ᵀ
                if self.model == "fvlmm":
                    lgs = torch.full((e0 - s0,), self._null.log10_lbd, dtype=f64, device=dev)
                else:
                    lgs = lmm_grid_scan(rot, Gr, grid)
                b, s = beta_se_snp_batch(lgs, rot, Gr)
                bs = torch.stack([b, s]).cpu().numpy()
                beta[s0:e0], se[s0:e0] = bs[0], bs[1]
            pwald = jstats.pwald_from_beta_se(beta, se)
        return beta, se, pwald


class GenomicSelection:
    """In-memory GS wrapper (reference gs/model.py GenomicSelection); the
    kinship product and the Bayes chains run on ``device``."""

    def __init__(self, method: str = "GBLUP", device=None, **kwargs):
        self.method = method
        self.device = device
        self.kwargs = kwargs
        self.fitted_ = False

    def fit(self, G, y):
        """G: (n, m) marker matrix; y: (n,) with NaN = unobserved."""
        from janusx_tpu_torch.gs.blup import fit_gblup

        dev = config.resolve_device(self.device)
        G = np.asarray(G, np.float64)
        y = np.asarray(y, np.float64).reshape(-1)
        self._G = G - np.nanmean(G, axis=0, keepdims=True)
        # NaN genotypes impute to the marker mean (0 after centering);
        # without this a single missing call NaN-poisons K and every gebv
        self._G = np.where(np.isfinite(self._G), self._G, 0.0)
        Gt = torch.as_tensor(self._G, dtype=f64, device=dev)
        self._K = (Gt @ Gt.T).cpu().numpy() / max(G.shape[1], 1)
        del Gt
        self._train = np.nonzero(np.isfinite(y))[0]
        self._y = y
        if self.method in ("BLUP", "GBLUP", "rrBLUP"):
            self._model = fit_gblup(self._K, y, self._train)
        elif self.method in ("BayesA", "BayesB", "BayesCpi"):
            from janusx_tpu_torch.gs.bayes import bayes_fit

            sd = self._G.std(axis=0)
            sd[sd == 0] = 1.0
            self._Z = self._G / sd
            self._beta, self._mu = bayes_fit(
                self._Z[self._train], y[self._train], self.method, device=dev,
                **self.kwargs
            )
        else:
            raise ValueError(f"unsupported method {self.method}")
        self.fitted_ = True
        return self

    def predict(self, idx=None):
        """Predict gebv for sample indices (default: all samples)."""
        if not self.fitted_:
            raise RuntimeError("call fit() first")
        idx = np.arange(len(self._y)) if idx is None else np.asarray(idx)
        if self.method in ("BLUP", "GBLUP", "rrBLUP"):
            from janusx_tpu_torch.gs.blup import predict_gblup

            return predict_gblup(self._model, self._K, idx)
        return self._mu + self._Z[idx] @ self._beta
