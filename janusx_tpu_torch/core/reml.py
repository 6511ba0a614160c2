"""Spectral-scale REML/ML machinery, batched over SNPs (port of
janusx_tpu/core/reml.py: the grid-scan and null-fit halves).

For eigenvalues s, rotated design Xr (n, p) (intercept included), rotated
phenotype yr and rotated SNP rows Gr (B, n), each λ evaluation needs only
weighted sums over the sample axis with weights w = 1/(s + λ):

    A_XX = w @ (X⊗X),  a_Xy = w @ (X*y),  a_yy = w @ y²      (shared pairs)
    a_Xg = (w*g) @ X,  a_gy = (w*g) @ y,  a_gg = Σ w g²      (per-SNP pairs)

Objectives (profiled σ², the reference's):
    REML = c_r - ½[(n-p')·ln(r'Wr) + ln|V| + ln|X'WX + ridge·I|]
    ML   = c_m - ½[ n    ·ln(r'Wr) + ln|V|]

Dtypes follow the reference exactly: RotatedData, the grid, GridShared's
source algebra, the null fit and the final Schur epilogue are float64;
the per-SNP lattice, argmin shift and final grams are float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.core.spectral import SpectralBasis
from janusx_tpu_torch.ops.brent import brent_minimize_batched
from janusx_tpu_torch.ops.kernels import neg_reml_closed_form

_BAD = 1e8  # reference sentinel: invalid loglik = -1e8
f32, f64 = torch.float32, torch.float64


class RotatedData(NamedTuple):
    """Device-resident rotated quantities (float64); ``yr`` is rotated
    AFTER the exact f64 residualization onto span(X) (see make_rotated)."""

    s: torch.Tensor  # (n,)
    Xr: torch.Tensor  # (n, p)
    yr: torch.Tensor  # (n,)
    PXX: torch.Tensor  # (n, p*p) pairwise X products
    PXy: torch.Tensor  # (n, p)
    Pyy: torch.Tensor  # (n,)

    @property
    def n(self) -> int:
        return self.s.shape[0]

    @property
    def p(self) -> int:
        return self.Xr.shape[1]


def make_rotated(basis: SpectralBasis, y: np.ndarray, X_cov: np.ndarray | None,
                 device=None) -> RotatedData:
    """Rotate y and the design (intercept prepended) into the eigenbasis.

    y is first residualized onto span(X) by f64 OLS: an exact
    reparameterization (REML and the GLS SNP effects are invariant to it)
    that keeps the f32 per-SNP grams from losing precision to a large
    phenotype mean (janusx_tpu/core/reml.py:79-90)."""
    dev = config.resolve_device(device)
    n = basis.n
    ones = np.ones((n, 1), dtype=np.float64)
    X = ones if X_cov is None else np.concatenate([ones, np.asarray(X_cov, np.float64)], axis=1)
    y = np.asarray(y, np.float64).reshape(-1)
    c, *_ = np.linalg.lstsq(X, y, rcond=None)
    y = y - X @ c
    Xr = basis.U.T @ X
    yr = basis.U.T @ y
    PXX = (Xr[:, :, None] * Xr[:, None, :]).reshape(n, -1)
    PXy = Xr * yr[:, None]
    Pyy = yr * yr
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=f64, device=dev)
    return RotatedData(s=t(basis.S), Xr=t(Xr), yr=t(yr), PXX=t(PXX),
                       PXy=t(PXy), Pyy=t(Pyy))


def _chol_pieces(M_ridged: torch.Tensor, rhs: torch.Tensor):
    """Batched Cholesky solve + logdet: M_ridged (B, q, q), rhs (B, q) ->
    (beta, logdet, bad). Failed factorizations are flagged, not raised."""
    L, info = torch.linalg.cholesky_ex(M_ridged)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    bad = (info != 0) | torch.any(~torch.isfinite(diag) | (diag <= 0), dim=-1)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Ls = torch.where(bad[:, None, None], eye, L)
    beta = torch.cholesky_solve(rhs[..., None], Ls)[..., 0]
    logdet = 2.0 * torch.sum(
        torch.log(torch.where(bad[:, None], torch.ones_like(diag), diag)), dim=-1)
    return beta, logdet, bad


def _quad_rtwr(M, rhs, ayy, beta):
    return (ayy - 2.0 * torch.sum(beta * rhs, dim=-1)
            + torch.einsum("bi,bij,bj->b", beta, M, beta))


# ------------------------------------------------------------- grid scan
class GridShared(NamedTuple):
    """λ-grid quantities independent of the SNP block (computed once per
    trait and reused by every block)."""

    grid_lg: torch.Tensor  # (G,) f64
    w32: torch.Tensor  # (G, n) f32 weights
    logdetV32: torch.Tensor  # (G,) f32
    Axx32: torch.Tensor  # (G, p, p) f32
    axy32: torch.Tensor  # (G, p)
    ayy32: torch.Tensor  # (G,)
    Ar_inv32: torch.Tensor  # (G, p, p)
    Ainv_axy32: torch.Tensor  # (G, p)
    logdetAr32: torch.Tensor  # (G,)


def make_grid(grid_points: int, device=None) -> torch.Tensor:
    """The shared log10-λ grid, f64 (np.linspace as in the reference)."""
    return torch.as_tensor(
        np.linspace(config.LOG10_LAMBDA_LOW, config.LOG10_LAMBDA_HIGH,
                    grid_points), dtype=f64, device=config.resolve_device(device))


def grid_shared(rot: RotatedData, grid_lg: torch.Tensor) -> GridShared:
    p = rot.p
    G = grid_lg.shape[0]
    lbd = torch.pow(10.0, grid_lg)
    v = rot.s[None, :] + lbd[:, None]  # (G, n) f64
    w64 = 1.0 / v
    logdetV = torch.sum(torch.log(v), dim=-1)
    Axx = (w64 @ rot.PXX).reshape(G, p, p)
    axy = w64 @ rot.PXy
    ayy = w64 @ rot.Pyy
    Ar = Axx + config.GRAM_RIDGE * torch.eye(p, dtype=f64, device=Axx.device)
    L = torch.linalg.cholesky(Ar)
    logdetAr = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    eyeP = torch.eye(p, dtype=f64, device=Ar.device).expand(G, p, p)
    Ar_inv = torch.cholesky_solve(eyeP, L)
    Ainv_axy = torch.einsum("gpq,gq->gp", Ar_inv, axy)
    return GridShared(
        grid_lg=grid_lg, w32=w64.to(f32), logdetV32=logdetV.to(f32),
        Axx32=Axx.to(f32), axy32=axy.to(f32), ayy32=ayy.to(f32),
        Ar_inv32=Ar_inv.to(f32), Ainv_axy32=Ainv_axy.to(f32),
        logdetAr32=logdetAr.to(f32),
    )


def grid_argmin_schur(sh: GridShared, agg, agy, axg, n: int):
    """λ*-selection from per-SNP (B, G) grid pieces + shared pieces: the
    Schur closed form per cell (shared with the lattice kernel's plain
    version, ops.kernels.neg_reml_closed_form) -> argmin + parabolic
    refinement. Returns lg_star (B,) f64."""
    neg = neg_reml_closed_form(
        agg, agy, axg, sh.Ar_inv32, sh.Ainv_axy32, sh.Axx32, sh.axy32,
        sh.ayy32, sh.logdetAr32, sh.logdetV32, nf=float(n))
    return argmin_parabolic(neg, sh.grid_lg)


def argmin_parabolic(neg_reml: torch.Tensor, grid_lg: torch.Tensor):
    """Per-row argmin over the λ grid + 3-point parabolic refinement.
    ``torch.argmin`` returns the first minimum, as jnp.argmin does; an
    all-inf row therefore picks index 0."""
    G = neg_reml.shape[-1]
    idx = torch.argmin(neg_reml, dim=-1)
    i0 = torch.clamp(idx, 1, G - 2)
    fm = torch.gather(neg_reml, 1, (i0 - 1)[:, None])[:, 0]
    f0 = torch.gather(neg_reml, 1, i0[:, None])[:, 0]
    fp = torch.gather(neg_reml, 1, (i0 + 1)[:, None])[:, 0]
    h = grid_lg[1] - grid_lg[0]
    denom = fm - 2.0 * f0 + fp
    shift = torch.where(
        torch.isfinite(denom) & (denom > 0),
        0.5 * (fm - fp) / torch.where(denom == 0, torch.ones_like(denom), denom),
        torch.zeros_like(denom),
    )
    shift = torch.clamp(shift, -1.0, 1.0)
    lg_star = grid_lg[i0] + shift.to(grid_lg.dtype) * h
    return torch.where((idx == 0) | (idx == G - 1), grid_lg[idx], lg_star)


def lmm_grid_scan_with(sh: GridShared, rot: RotatedData, Gr: torch.Tensor):
    """Per-block grid scan against precomputed shared pieces: the 2+p
    per-SNP grid grams as ONE ((2+p)B, n) @ (n, G) f32 matmul, then the
    closed form. The route for p > 4, which the lattice kernel does not
    take (janusx_tpu/models/lmm.py:124-128,176-197)."""
    n, p = rot.n, rot.p
    Gr32 = Gr.to(f32)
    yr32 = rot.yr.to(f32)
    Xr32 = rot.Xr.to(f32)
    B = Gr32.shape[0]
    E = torch.cat([Gr32 * Gr32, Gr32 * yr32[None, :]]
                  + [Gr32 * Xr32[None, :, k] for k in range(p)], dim=0)
    A = E @ sh.w32.T  # ((2+p)B, G)
    axg = torch.stack([A[(2 + k) * B:(3 + k) * B] for k in range(p)], dim=-1)
    return grid_argmin_schur(sh, A[:B], A[B:2 * B], axg, n)


def final_grams_f32(rot: RotatedData, Gr32: torch.Tensor,
                    log10_lbd: torch.Tensor, with_ml: bool):
    """f32 gram pieces at per-lane λ*: (A1 (B, p²+p+1), A2 (B, p+1),
    agg (B,), logdetV (B,) or zeros)."""
    s32 = rot.s.to(f32)
    lbd32 = torch.pow(10.0, log10_lbd).to(f32)
    v = s32[None, :] + lbd32[:, None]  # (B, n) f32
    w = 1.0 / v
    Gw = Gr32 * w
    P1 = torch.cat([rot.PXX.to(f32), rot.PXy.to(f32), rot.Pyy.to(f32)[:, None]], dim=1)
    P2 = torch.cat([rot.Xr.to(f32), rot.yr.to(f32)[:, None]], dim=1)
    A1 = w @ P1
    A2 = Gw @ P2
    agg = torch.sum(Gw * Gr32, dim=-1)
    if not with_ml:
        return A1, A2, agg, torch.zeros_like(agg)
    return A1, A2, agg, torch.sum(torch.log(v), dim=-1)


def final_stats_from_grams(n: int, p: int, A1, A2, agg64, with_ml: bool,
                           logdetV=None):
    """f64 Schur epilogue over the whole scan's stacked (N, ...) grams.
    Returns (beta, se, ml) f64."""
    A1 = A1.to(f64)
    A2 = A2.to(f64)
    Axx = A1[..., : p * p].reshape(-1, p, p)
    axy = A1[..., p * p: p * p + p]
    ayy = A1[..., p * p + p]
    axg = A2[..., :p]
    agy = A2[..., p]
    agg = agg64.to(f64)

    ridge = config.GRAM_RIDGE
    if p == 1:
        # intercept-only design: the 1x1 "Cholesky solve" is a division
        Ar1 = Axx[..., 0, 0] + ridge
        badA = ~torch.isfinite(Ar1) | (Ar1 <= 0)
        Ars = torch.where(badA, torch.ones_like(Ar1), Ar1)
        u = (axg[..., 0] / Ars)[..., None]
        Ainv_axy = (axy[..., 0] / Ars)[..., None]
    else:
        eye = torch.eye(p, dtype=f64, device=Axx.device)
        L, info = torch.linalg.cholesky_ex(Axx + ridge * eye)
        diag = torch.diagonal(L, dim1=-2, dim2=-1)
        badA = (info != 0) | torch.any(~torch.isfinite(diag) | (diag <= 0), dim=-1)
        Ls = torch.where(badA[:, None, None], eye, L)
        u = torch.cholesky_solve(axg[..., None], Ls)[..., 0]
        Ainv_axy = torch.cholesky_solve(axy[..., None], Ls)[..., 0]
    schur = (agg + ridge) - torch.sum(axg * u, dim=-1)
    beta_g = (agy - torch.sum(axg * Ainv_axy, dim=-1)) / schur
    beta_X = Ainv_axy - beta_g[:, None] * u
    lin = torch.sum(beta_X * axy, dim=-1) + beta_g * agy
    quad = (torch.einsum("bp,bpq,bq->b", beta_X, Axx, beta_X)
            + 2.0 * beta_g * torch.sum(axg * beta_X, dim=-1)
            + beta_g * beta_g * agg)
    rtwr = ayy - 2.0 * lin + quad
    sigma2 = rtwr / (float(n) - float(p + 1))
    var_k = sigma2 / schur  # (Mr^-1)_kk = 1/schur for the last coordinate
    ok = ~badA & (schur > 0) & (var_k > 0) & torch.isfinite(var_k) & (rtwr > 0)
    nan = torch.full_like(beta_g, float("nan"))
    beta = torch.where(ok, beta_g, nan)
    se = torch.where(ok, torch.sqrt(torch.where(ok, var_k, torch.ones_like(var_k))), nan)
    if not with_ml:
        return beta, se, torch.zeros_like(beta)
    nf = float(n)
    c = nf * (math.log(nf) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    ml = c - 0.5 * (nf * torch.log(rtwr) + logdetV.to(f64))
    return beta, se, torch.where(ok, ml, torch.full_like(ml, -_BAD))


def final_stats_f32(rot: RotatedData, Gr32: torch.Tensor,
                    log10_lbd: torch.Tensor, with_ml: bool):
    """final_grams_f32 + final_stats_from_grams for callers outside the
    resident scan."""
    A1, A2, agg, logdetV = final_grams_f32(rot, Gr32, log10_lbd, with_ml)
    return final_stats_from_grams(rot.n, rot.p, A1, A2, agg, with_ml, logdetV)


# ------------------------------------------------------------- null model
def _null_grams(log10_lbd: torch.Tensor, rot: RotatedData):
    p = rot.p
    lbd = torch.pow(10.0, log10_lbd)
    v = rot.s[None, :] + lbd[:, None]
    valid = torch.all(v > 0, dim=-1) & torch.isfinite(lbd) & (lbd > 0)
    vsafe = torch.where(v > 0, v, torch.ones_like(v))
    w = 1.0 / vsafe
    logdetV = torch.sum(torch.log(vsafe), dim=-1)
    M = (w @ rot.PXX).reshape(-1, p, p)
    rhs = w @ rot.PXy
    ayy = w @ rot.Pyy
    return M, rhs, ayy, logdetV, valid


def _ridged(M):
    return M + config.GRAM_RIDGE * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def neg_reml_null(log10_lbd: torch.Tensor, rot: RotatedData):
    n, p = rot.n, rot.p
    M, rhs, ayy, logdetV, valid = _null_grams(log10_lbd, rot)
    beta, logdetA, badchol = _chol_pieces(_ridged(M), rhs)
    rtwr = _quad_rtwr(M, rhs, ayy, beta)
    nf, pf = float(n), float(p)
    c = (nf - pf) * (math.log(nf - pf) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    reml = c - 0.5 * ((nf - pf) * torch.log(rtwr) + logdetV + logdetA)
    ok = valid & ~badchol & torch.isfinite(reml) & (rtwr > 0)
    return torch.where(ok, -reml, torch.full_like(reml, _BAD))


def ml_null(log10_lbd: torch.Tensor, rot: RotatedData):
    n = rot.n
    M, rhs, ayy, logdetV, valid = _null_grams(log10_lbd, rot)
    beta, _, badchol = _chol_pieces(_ridged(M), rhs)
    rtwr = _quad_rtwr(M, rhs, ayy, beta)
    nf = float(n)
    c = nf * (math.log(nf) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    ml = c - 0.5 * (nf * torch.log(rtwr) + logdetV)
    ok = valid & ~badchol & torch.isfinite(ml) & (rtwr > 0)
    return torch.where(ok, ml, torch.full_like(ml, -_BAD))


def null_fit_stats(rot: RotatedData, log10_lbd: float):
    """(beta, sigma2) of the null (covariates-only) model at a given λ;
    beta is fitted against the residualized yr and is ~0 (see
    RotatedData), sigma2 = rtWr/(n-p) is the meaningful output."""
    lg = torch.tensor([log10_lbd], dtype=f64, device=rot.s.device)
    M, rhs, ayy, _, _ = _null_grams(lg, rot)
    beta, _, _ = _chol_pieces(_ridged(M), rhs)
    rtwr = _quad_rtwr(M, rhs, ayy, beta)
    return beta[0].cpu().numpy(), float(rtwr[0]) / (rot.n - rot.p)


class NullFit(NamedTuple):
    lbd: float  # λ at the REML optimum
    log10_lbd: float
    reml: float
    ml: float  # ML loglik evaluated at the REML-optimal λ


def fit_null_reml(
    rot: RotatedData,
    low: float = config.LOG10_LAMBDA_LOW,
    high: float = config.LOG10_LAMBDA_HIGH,
    tol: float = config.NULL_BRENT_TOL,
    max_iter: int = config.NULL_BRENT_MAX_ITER,
) -> NullFit:
    """Null REML fit by the batched Brent over log10 λ on rot's device
    (reference lmm_reml_null_f32, src/stats/reml.rs:572)."""
    x, fx = brent_minimize_batched(lambda t: neg_reml_null(t, rot), low, high,
                                   tol, max_iter, batch_shape=(1,),
                                   device=rot.s.device)
    ml = ml_null(x, rot)
    xf = float(x[0])
    return NullFit(lbd=10.0 ** xf, log10_lbd=xf, reml=-float(fx[0]), ml=float(ml[0]))


def fit_null_reml_host(
    S: np.ndarray,
    Xr: np.ndarray,
    yr: np.ndarray,
    low: float = config.LOG10_LAMBDA_LOW,
    high: float = config.LOG10_LAMBDA_HIGH,
    tol: float = config.NULL_BRENT_TOL,
    max_iter: int = config.NULL_BRENT_MAX_ITER,
):
    """Host (numpy/LAPACK) twin of fit_null_reml — same objective, scipy
    bounded-Brent over log10 λ. Returns (NullFit, beta, vg). Copied from
    janusx_tpu/core/reml.py (it is numpy-only there too)."""
    import scipy.linalg as sla
    from scipy.optimize import minimize_scalar

    S = np.asarray(S, np.float64).reshape(-1)
    Xr = np.asarray(Xr, np.float64)
    yr = np.asarray(yr, np.float64).reshape(-1)
    n, p = Xr.shape
    ridge = config.GRAM_RIDGE * np.eye(p)

    def pieces(lg: float):
        lbd = 10.0 ** lg
        v = S + lbd
        if not np.all(v > 0):
            return None
        w = 1.0 / v
        Xw = Xr * w[:, None]
        M = Xw.T @ Xr
        rhs = Xw.T @ yr
        ayy = float((w * yr) @ yr)
        try:
            L = sla.cholesky(M + ridge, lower=True)
        except sla.LinAlgError:
            return None
        beta = sla.cho_solve((L, True), rhs)
        logdetA = 2.0 * float(np.sum(np.log(np.diag(L))))
        rtwr = float(ayy - 2.0 * beta @ rhs + beta @ (M @ beta))
        logdetV = float(np.sum(np.log(v)))
        return beta, rtwr, logdetV, logdetA

    def neg_reml(lg: float) -> float:
        pc = pieces(float(lg))
        if pc is None:
            return _BAD
        _, rtwr, logdetV, logdetA = pc
        if not np.isfinite(rtwr) or rtwr <= 0:
            return _BAD
        c = (n - p) * (math.log(n - p) - 1.0 - math.log(2.0 * math.pi)) / 2.0
        return -(c - 0.5 * ((n - p) * math.log(rtwr) + logdetV + logdetA))

    res = minimize_scalar(
        neg_reml, bounds=(low, high), method="bounded",
        options={"xatol": tol, "maxiter": max_iter},
    )
    lg = float(res.x)
    out = pieces(lg)
    if out is None or not np.isfinite(out[1]) or out[1] <= 0.0:
        fit = NullFit(lbd=10.0 ** lg, log10_lbd=lg, reml=float("nan"),
                      ml=float("nan"))
        return fit, np.zeros(p), float("nan")
    beta, rtwr, logdetV, _ = out
    cm = n * (math.log(n) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    ml = cm - 0.5 * (n * math.log(rtwr) + logdetV)
    fit = NullFit(
        lbd=10.0 ** lg, log10_lbd=lg, reml=float(-neg_reml(lg)), ml=float(ml)
    )
    return fit, np.asarray(beta, np.float64), float(rtwr / (n - p))
