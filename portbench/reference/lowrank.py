"""Plain reference of the FaST-LMM low-rank scan (``jx gwas -lowrank``,
genetic model ``add``).

From the raw codes, on the scan's samples:

- the QC and minor-allele rule of ``common.qc_rows``;
- q kinship SNPs evenly spaced over the SNPs that pass, positions
  round(linspace(0, m - 1, q)) among them;
- W = their centred codes / sqrt(Σ 2p(1-p)) (the kinship's method 1), so
  K = W W';
- the basis from an eigh of the q x q Gram W'W: U = W V S^-½, keeping the
  eigenvalues S > S_max·1e-12. K's complement, the n - k directions
  outside U, has eigenvalue r, the configuration's ridge, so with
  V = K + r I + λ I every quadratic form is the k rotated terms weighted
  1/(S + r + λ) plus the raw-minus-rotated remainder weighted 1/(r + λ),
  and log|V| = Σ log(S + r + λ) + (n - k) log(r + λ);
- per trait: y less its least-squares fit on X (the intercept and any
  covariates), and the null REML, profiled over σ², minimised over
  log10 λ in the traffic's range;
- per SNP: gr = U'g in blocks (the rotation of every SNP is made once for
  all the traits checked), the complement grams g'g - gr'gr, g'y - gr'yr
  and g'X - gr'Xr, the profiled REML on the log10-λ grid, its argmin with
  the parabolic refinement, then beta, se and the Wald p at λ*.

Departures from FaST-LMM as published (Lippert et al. 2011, Nat Methods
8:833), each that of JanusX's ``-lowrank``:

- K's complement has eigenvalue r = 1e-6, not 0: the diagonal ridge the
  dense route adds before its eigh, kept so that both routes agree;
- λ is fitted again for every SNP, on a fixed grid with a parabolic
  refinement, not by a one-dimensional optimisation to convergence;
- the test is Wald's on the REML fit, not a likelihood ratio on ML;
- a ridge of ``gram_ridge`` on X'V⁻¹X and on the SNP's Schur complement,
  a numerical guard of the port's;
- y is first made orthogonal to X, which in exact arithmetic changes no
  statistic.

float64 throughout at ``prec="ref"``; at ``prec="low"`` every step one
precision lower (``common``): float32, and the products the program forms
in float32 with TF32 operands.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.common import (centered, matmul, minimize, pwald, qc_rows,
                                        unpack)
from portbench.reference.lmm import argmin_parabolic

BAD = 1e8
REL_TOL = 1e-12  # eigenvalues kept: S > S_max * REL_TOL


def kinship_positions(m: int, q: int) -> np.ndarray:
    """Positions of q SNPs evenly spaced among m."""
    if q >= m:
        return np.arange(m)
    return np.unique(np.round(np.linspace(0, m - 1, q)).astype(np.int64))


def neg_reml_null(lg: float, S, r: float, n: int, Xr, yr, cXX, cXy, cyy,
                  ridge: float) -> float:
    """-REML (less a constant) of the null at log10 λ, profiled over σ²,
    in the dtype of the arrays (host)."""
    k, p = Xr.shape
    one = S.dtype.type
    lam = one(10.0 ** lg)
    v, v0 = S + lam, one(r) + lam
    if np.any(v <= 0) or v0 <= 0:
        return BAD
    w, w0 = one(1) / v, one(1) / v0
    M = (Xr * w[:, None]).T @ Xr + w0 * cXX
    rhs = Xr.T @ (w * yr) + w0 * cXy
    ayy = (w * yr) @ yr + w0 * cyy
    A = M + one(ridge) * np.eye(p, dtype=S.dtype)
    sign, logdetA = np.linalg.slogdet(A)
    if sign <= 0:
        return BAD
    beta = np.linalg.solve(A, rhs)
    rtwr = ayy - 2 * beta @ rhs + beta @ (M @ beta)
    if not np.isfinite(rtwr) or rtwr <= 0:
        return BAD
    logdetV = np.sum(np.log(v)) + one(n - k) * np.log(v0)
    return float(0.5 * ((n - p) * np.log(rtwr) + logdetV + logdetA))


def schur_stats(Axx, axy, ayy, axg, agy, agg, ridge: float):
    """The profiled fit of a SNP beside X, from its grams: the covariates'
    Axx (..., p, p), axy (..., p), ayy (...), broadcast against the SNP's
    axg (..., p), agy and agg (...). Returns (beta_g, schur, rtwr,
    log|Axx + ridge I|)."""
    p = axy.shape[-1]
    Ar = Axx + ridge * torch.eye(p, dtype=Axx.dtype, device=Axx.device)
    Ar_inv = torch.linalg.inv(Ar)
    u = torch.einsum("...pq,...q->...p", Ar_inv, axg)
    Ainv_axy = torch.einsum("...pq,...q->...p", Ar_inv, axy)
    schur = agg + ridge - torch.sum(axg * u, dim=-1)
    beta_g = (agy - torch.sum(axg * Ainv_axy, dim=-1)) / schur
    beta_x = Ainv_axy - beta_g[..., None] * u
    lin = torch.sum(beta_x * axy, dim=-1) + beta_g * agy
    quad = (torch.einsum("...p,...pq,...q->...", beta_x, Axx, beta_x)
            + 2 * beta_g * torch.sum(axg * beta_x, dim=-1) + beta_g * beta_g * agg)
    return beta_g, schur, ayy - 2 * lin + quad, torch.linalg.slogdet(Ar)[1]


class LowRankLmm:
    """The low-rank basis and the scan rows of one panel."""

    def __init__(self, raw: np.ndarray, n: int, scan_samples: np.ndarray, cfg: dict,
                 scan: dict, device, prec: str = "ref", block: int = 8192):
        # plain float32 products where the reference states float32 (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.raw, self.n, self.prec, self.block = raw, n, prec, block
        self.dev = torch.device(device)
        self.dt = torch.float64 if prec == "ref" else torch.float32
        self.S_idx = torch.as_tensor(np.asarray(scan_samples), device=self.dev)
        self.n_scan = len(self.S_idx)
        self.scan, self.r = scan, cfg["eigh_ridge"]
        qc = cfg["qc"]
        keep, sign, p = [], [], []
        for s0 in range(0, raw.shape[0], block):
            kb, sb, pb = qc_rows(self._codes(s0, s0 + block), qc["maf"], qc["geno"])
            keep.append(kb)
            sign.append(sb)
            p.append(pb)
        self.keep, self.sign, self.p = torch.cat(keep), torch.cat(sign), torch.cat(p)
        kept = torch.nonzero(self.keep)[:, 0]
        pick = kept[torch.as_tensor(kinship_positions(len(kept), cfg["lowrank_snps"]),
                                    device=self.dev)]
        rows = pick.cpu().numpy()
        codes = unpack(raw[rows], n, self.dev)[:, self.S_idx]
        pk = self.p[pick]
        c0 = float(torch.sum(2.0 * pk * (1.0 - pk)))
        W = centered(codes, pk, self.dt).T / math.sqrt(c0)  # (n_scan, q)
        s, V = torch.linalg.eigh(W.T @ W)
        ok = (s > s.max() * REL_TOL) & (s > 0)
        s, V = s[ok], V[:, ok]
        self.U = (W @ V) / torch.sqrt(s)[None, :]  # (n_scan, k)
        self.S = s + self.r  # K + r I on U's span
        self.k = self.U.shape[1]

    def _codes(self, s0: int, s1: int) -> torch.Tensor:
        return unpack(self.raw[s0:s1], self.n, self.dev)[:, self.S_idx]

    def _trait(self, y: np.ndarray, X: torch.Tensor, grid: torch.Tensor) -> dict:
        """y residualised on X, its rotation, the null fit and the grid's
        shared pieces."""
        dt, dev, U, n = self.dt, self.dev, self.U, self.n_scan
        yt = torch.as_tensor(y, dtype=dt, device=dev)
        yt = yt - X @ torch.linalg.lstsq(X, yt[:, None]).solution[:, 0]
        yr, Xr = U.T @ yt, U.T @ X
        cXX, cXy, cyy = X.T @ X - Xr.T @ Xr, X.T @ yt - Xr.T @ yr, yt @ yt - yr @ yr
        host = lambda t: t.cpu().numpy()
        lo, hi = self.scan["log10_lambda"]
        ridge = self.scan["gram_ridge"]
        args = (host(self.S), self.r, n) + tuple(host(a) for a in (Xr, yr, cXX, cXy, cyy))
        lg0 = minimize(lambda lg: neg_reml_null(lg, *args, ridge), lo, hi)
        lam = torch.pow(10.0, grid).to(dt)
        v, v0 = self.S[None, :] + lam[:, None], self.r + lam
        w, w0 = 1 / v, 1 / v0
        p = X.shape[1]
        PXX = (Xr[:, :, None] * Xr[:, None, :]).reshape(self.k, p * p)
        Axx = (w @ PXX).reshape(-1, p, p) + w0[:, None, None] * cXX
        axy = w @ (Xr * yr[:, None]) + w0[:, None] * cXy
        ayy = w @ (yr * yr) + w0 * cyy
        logdetV = (torch.log(v).sum(dim=1) + (n - self.k) * torch.log(v0))[None]
        return dict(y=yt, yr=yr, Xr=Xr, cXX=cXX, cXy=cXy, cyy=cyy, PXX=PXX, w=w, w0=w0,
                    shared=(Axx, axy, ayy, logdetV), lam=10.0 ** lg0, beta=[], se=[])

    def _lattice(self, gr, cgg, cgy, cgX, t):
        """The -REML lattice (B, G) of one trait's SNP block."""
        Axx, axy, ayy, logdetV = t["shared"]
        wT, w0 = t["w"].T, t["w0"][None, :]
        p = cgX.shape[1]
        dt, prec = self.dt, self.prec
        agg = matmul(gr * gr, wT, prec).to(dt) + cgg[:, None] * w0
        agy = matmul(gr * t["yr"], wT, prec).to(dt) + cgy[:, None] * w0
        axg = torch.stack([matmul(gr * t["Xr"][:, j], wT, prec).to(dt) + cgX[:, j, None] * w0
                           for j in range(p)], dim=-1)  # (B, G, p)
        beta_g, schur, rtwr, logdetAr = schur_stats(Axx, axy, ayy, axg, agy, agg,
                                                    self.scan["gram_ridge"])
        neg = 0.5 * ((self.n_scan - p - 1) * torch.log(rtwr) + logdetV
                     + logdetAr + torch.log(schur))
        bad = ~torch.isfinite(neg) | (rtwr <= 0) | (schur <= 0)
        return torch.where(bad, torch.full_like(neg, float("inf")), neg)

    def _epilogue(self, gr, cgg, cgy, cgX, lg, t):
        """beta, se at each SNP's log10 λ*."""
        dt, prec, n = self.dt, self.prec, self.n_scan
        p = cgX.shape[1]
        lam = torch.pow(10.0, lg).to(dt)
        w = 1 / (self.S[None, :] + lam[:, None])  # (B, k)
        w0 = 1 / (self.r + lam)
        gw = gr * w
        Axx = (matmul(w, t["PXX"], prec).to(dt).reshape(-1, p, p)
               + w0[:, None, None] * t["cXX"])
        axy = matmul(w, t["Xr"] * t["yr"][:, None], prec).to(dt) + w0[:, None] * t["cXy"]
        ayy = matmul(w, (t["yr"] * t["yr"])[:, None], prec)[:, 0].to(dt) + w0 * t["cyy"]
        axg = matmul(gw, t["Xr"], prec).to(dt) + w0[:, None] * cgX
        agy = matmul(gw, t["yr"][:, None], prec)[:, 0].to(dt) + w0 * cgy
        agg = torch.sum(gw * gr, dim=-1) + w0 * cgg
        beta_g, schur, rtwr, _ = schur_stats(Axx, axy, ayy, axg, agy, agg,
                                             self.scan["gram_ridge"])
        var = rtwr / (n - p - 1) / schur
        ok = (schur > 0) & (var > 0) & torch.isfinite(var) & (rtwr > 0)
        nan = torch.full_like(beta_g, float("nan"))
        return torch.where(ok, beta_g, nan), torch.where(ok, torch.sqrt(torch.abs(var)), nan)

    def run(self, Ys: list, covariates: np.ndarray | None = None) -> list[dict]:
        """Per trait: lam (null λ), beta, se, p over the scan's kept SNPs."""
        dt, dev, prec = self.dt, self.dev, self.prec
        X = torch.ones((self.n_scan, 1), dtype=dt, device=dev)
        if covariates is not None:
            X = torch.cat([X, torch.as_tensor(covariates, dtype=dt, device=dev)], dim=1)
        grid = torch.as_tensor(np.linspace(*self.scan["log10_lambda"],
                                           self.scan["grid_points"]),
                               dtype=torch.float64, device=dev)
        traits = [self._trait(y, X, grid) for y in Ys]
        for s0 in range(0, self.raw.shape[0], self.block):
            kb = self.keep[s0:s0 + self.block]
            x = centered(self._codes(s0, s0 + self.block)[kb], self.p[s0:s0 + self.block][kb],
                         dt) * self.sign[s0:s0 + self.block][kb].to(dt)[:, None]
            gr = matmul(x, self.U, prec).to(dt)  # (B, k)
            gg = torch.sum(x * x, dim=-1)
            gX = matmul(x, X, prec).to(dt)
            cgg = gg - torch.sum(gr * gr, dim=-1)
            for t in traits:
                cgy = (matmul(x, t["y"][:, None], prec) - matmul(gr, t["yr"][:, None], prec))
                cgy = cgy[:, 0].to(dt)
                cgX = (gX - matmul(gr, t["Xr"], prec)).to(dt)
                lg = argmin_parabolic(self._lattice(gr, cgg, cgy, cgX, t), grid)
                beta, se = self._epilogue(gr, cgg, cgy, cgX, lg, t)
                bad = gg <= 1e-12
                t["beta"].append(torch.where(bad, float("nan"), beta).double().cpu())
                t["se"].append(torch.where(bad, float("nan"), se).double().cpu())
        out = []
        for t in traits:
            beta = torch.cat(t["beta"]).numpy()
            se = torch.cat(t["se"]).numpy()
            out.append(dict(lam=t["lam"], beta=beta, se=se, p=pwald(beta, se)))
        return out
