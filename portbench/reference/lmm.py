"""Plain reference of the dense-GRM LMM scan, grid route (``jx gwas -lmm``).

From the raw codes: the centered GRM of every genotyped sample over the
SNPs that pass QC on them, its eigenbasis on the phenotyped samples (with
the configuration's ridge), and per trait the null REML fit and, per SNP
that passes QC on the phenotyped samples, the profiled REML on the shared
log10-λ grid, its argmin with the 3-point parabolic refinement, and beta,
se and the Wald p at λ*. The same semantics as the port's route, written
out here; float64 at ``prec="ref"``, one step lower at ``prec="low"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.common import (centered, matmul, minimize, pwald, qc_rows,
                                        unpack)

BAD = 1e8


def neg_reml_null(lg: float, s, Xr, yr, ridge: float) -> float:
    """-REML of the intercept-only null at log10 λ (profiled σ²), in the
    dtype of the arrays."""
    n = len(s)
    v = s + s.dtype.type(10.0 ** lg)
    if np.any(v <= 0):
        return BAD
    w = 1 / v
    M = np.sum(w * Xr * Xr)
    rhs = np.sum(w * Xr * yr)
    ayy = np.sum(w * yr * yr)
    Mr = M + s.dtype.type(ridge)
    beta = rhs / Mr
    rtwr = ayy - 2 * beta * rhs + beta * beta * M
    if not np.isfinite(rtwr) or rtwr <= 0:
        return BAD
    c = (n - 1) * (math.log(n - 1) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    reml = c - 0.5 * ((n - 1) * np.log(rtwr) + np.sum(np.log(v)) + np.log(Mr))
    return float(-reml)


def argmin_parabolic(neg: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Per row: the grid argmin (the first), refined by the parabola through
    it and its neighbours (a shift of at most one spacing, only where the
    parabola opens upwards); at either end of the grid, the end point."""
    G = neg.shape[-1]
    idx = torch.argmin(neg, dim=-1)
    i0 = torch.clamp(idx, 1, G - 2)
    fm, f0, fp = (torch.gather(neg, 1, (i0 + d)[:, None])[:, 0] for d in (-1, 0, 1))
    den = fm - 2 * f0 + fp
    ok = torch.isfinite(den) & (den > 0)
    shift = torch.where(ok, 0.5 * (fm - fp) / torch.where(ok, den, 1.0), 0.0)
    lg = grid[i0] + torch.clamp(shift, -1.0, 1.0).to(grid.dtype) * (grid[1] - grid[0])
    return torch.where((idx == 0) | (idx == G - 1), grid[idx], lg)


class DenseLmm:
    """The GRM, the eigenbasis and the scan rows of one panel."""

    def __init__(self, raw: np.ndarray, n: int, scan_samples: np.ndarray, cfg: dict,
                 scan: dict, device, prec: str = "ref", block: int = 8192):
        self.raw, self.n, self.prec, self.block = raw, n, prec, block
        self.dev = torch.device(device)
        self.dt = torch.float64 if prec == "ref" else torch.float32
        self.S = torch.as_tensor(np.asarray(scan_samples), device=self.dev)
        self.n_scan = len(self.S)
        self.qc, self.scan = cfg["qc"], scan
        K = torch.zeros((n, n), dtype=self.dt, device=self.dev)
        denom = 0.0
        for s0 in range(0, raw.shape[0], block):
            codes = unpack(raw[s0:s0 + block], n, self.dev)
            keep, _, p = qc_rows(codes, self.qc["maf"], self.qc["geno"])
            x = centered(codes[keep], p[keep], self.dt)
            K += matmul(x.T, x, prec).to(self.dt)
            pk = p[keep]
            denom += float(torch.sum(2.0 * pk * (1.0 - pk)))
        K = K / denom
        Ks = K[self.S][:, self.S] + cfg["eigh_ridge"] * torch.eye(len(self.S), dtype=self.dt,
                                                                 device=self.dev)
        self.s, self.U = torch.linalg.eigh(Ks)

    def _null(self, yr: np.ndarray, Xr: np.ndarray) -> float:
        s = self.s.cpu().numpy()
        lo, hi = self.scan["log10_lambda"]
        ridge = self.scan["gram_ridge"]
        return minimize(lambda lg: neg_reml_null(lg, s, Xr, yr, ridge), lo, hi)

    def _lattice(self, Gr, yr, Xr, w, shared):
        """The -REML lattice (B, G) of one trait's SNP block."""
        Axx, axy, ayy, logdetV = shared
        ridge = self.scan["gram_ridge"]
        wT = w.T
        agg = matmul(Gr * Gr, wT, self.prec).to(self.dt)
        agy = matmul(Gr * yr, wT, self.prec).to(self.dt)
        axg = matmul(Gr * Xr, wT, self.prec).to(self.dt)
        Ar = Axx + ridge
        u = axg / Ar
        schur = agg + ridge - axg * u
        beta_g = (agy - axg * (axy / Ar)) / schur
        beta_x = axy / Ar - beta_g * u
        lin = beta_x * axy + beta_g * agy
        quad = beta_x * beta_x * Axx + 2 * beta_g * axg * beta_x + beta_g * beta_g * agg
        rtwr = ayy - 2 * lin + quad
        nfp = self.n_scan - 2
        neg = 0.5 * (nfp * torch.log(rtwr) + logdetV + torch.log(Ar) + torch.log(schur))
        bad = ~torch.isfinite(neg) | (rtwr <= 0) | (schur <= 0)
        return torch.where(bad, torch.full_like(neg, float("inf")), neg)

    def _epilogue(self, Gr, yr, Xr, lg):
        """beta, se at per-SNP log10 λ*."""
        ridge = self.scan["gram_ridge"]
        n = self.n_scan
        w = 1 / (self.s[None, :] + torch.pow(10.0, lg)[:, None].to(self.dt))
        Axx = w @ (Xr * Xr)
        axy = w @ (Xr * yr)
        ayy = w @ (yr * yr)
        Gw = Gr * w
        axg = matmul(Gw, Xr[:, None], self.prec)[:, 0].to(self.dt)
        agy = matmul(Gw, yr[:, None], self.prec)[:, 0].to(self.dt)
        agg = torch.sum(Gw * Gr, dim=-1)
        Ar = Axx + ridge
        u = axg / Ar
        schur = agg + ridge - axg * u
        beta_g = (agy - axg * (axy / Ar)) / schur
        beta_x = axy / Ar - beta_g * u
        lin = beta_x * axy + beta_g * agy
        quad = beta_x * beta_x * Axx + 2 * beta_g * axg * beta_x + beta_g * beta_g * agg
        rtwr = ayy - 2 * lin + quad
        var = rtwr / (n - 2) / schur
        ok = (Ar > 0) & (schur > 0) & (var > 0) & torch.isfinite(var) & (rtwr > 0)
        nan = torch.full_like(beta_g, float("nan"))
        return torch.where(ok, beta_g, nan), torch.where(ok, torch.sqrt(torch.abs(var)), nan)

    def run(self, Ys: list) -> list[dict]:
        """Per trait: lam (null λ), beta, se, p over the scan's kept SNPs."""
        n_all, S = self.n, self.S
        U = self.U
        ones = torch.ones(self.n_scan, dtype=self.dt, device=self.dev)
        grid = torch.as_tensor(np.linspace(*self.scan["log10_lambda"],
                                           self.scan["grid_points"]),
                               dtype=torch.float64, device=self.dev)
        traits = []
        for y in Ys:
            yt = torch.as_tensor(y - np.mean(y), dtype=self.dt, device=self.dev)
            yr, Xr = U.T @ yt, U.T @ ones
            lg0 = self._null(yr.cpu().numpy(), Xr.cpu().numpy())
            v = self.s[None, :] + torch.pow(10.0, grid)[:, None].to(self.dt)
            w = 1 / v
            shared = (w @ (Xr * Xr), w @ (Xr * yr), w @ (yr * yr), torch.log(v).sum(dim=1))
            traits.append(dict(yr=yr, Xr=Xr, w=w, shared=shared, lam=10.0 ** lg0,
                               beta=[], se=[]))
        for s0 in range(0, self.raw.shape[0], self.block):
            codes = unpack(self.raw[s0:s0 + self.block], n_all, self.dev)[:, S]
            keep, sign, p = qc_rows(codes, self.qc["maf"], self.qc["geno"])
            x = centered(codes[keep], p[keep], self.dt) * sign[keep].to(self.dt)[:, None]
            Gr = matmul(x, U, self.prec).to(self.dt)
            ssq = torch.sum(Gr * Gr, dim=-1)
            for t in traits:
                neg = self._lattice(Gr, t["yr"], t["Xr"], t["w"], t["shared"])
                lg = argmin_parabolic(neg, grid)
                beta, se = self._epilogue(Gr, t["yr"], t["Xr"], lg)
                bad = ssq <= 1e-12
                t["beta"].append(torch.where(bad, float("nan"), beta).double().cpu())
                t["se"].append(torch.where(bad, float("nan"), se).double().cpu())
        out = []
        for t in traits:
            beta = torch.cat(t["beta"]).numpy()
            se = torch.cat(t["se"]).numpy()
            out.append(dict(lam=t["lam"], beta=beta, se=se, p=pwald(beta, se)))
        return out
