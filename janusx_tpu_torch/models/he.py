"""Haseman-Elston regression and heritability estimation (port of
janusx_tpu/models/he.py).

Reference: JanusX src/stats/he.rs (HE variance components with PCG trace
estimation, used as the fast VC pre-fit for GS) and heritability.rs.

HE cross-product estimator: with centered phenotype residuals r,
minimize || r r' - σg² K - σe² I ||_F over the (K, I) basis — a 2x2
(or (k+1)x(k+1) for multiple kernels) normal-equation solve whose entries
are traces of kernel products.

The host code (the 2x2 solve, its NNLS projection, the probes and the
traces) is the reference's line for line; the streamed pass over the
packed SNP blocks (decode, then C V and Cᵀ(C V)) runs on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class HeFit:
    vg: float
    ve: float
    h2: float
    se_h2: float | None = None
    trace_k: float | None = None
    trace_k2: float | None = None
    probes: int | None = None
    # boundary status mirrors the reference (he.rs HE_BOUNDARY_*):
    # "interior" | "sigma_g_zero" | "sigma_e_zero"
    boundary: str = "interior"


def _project_nnls_2x2(a11, a12, a22, b1, b2, vg, ve):
    """NNLS projection of the 2x2 HE normal-equation solution onto
    vg, ve >= 0 (reference he_project_nnls_2x2, he.rs:815-860): evaluate
    the unconstrained point and both single-boundary least-squares refits
    plus the origin, keep the feasible candidate with the smallest
    residual. Returns (vg, ve, boundary_tag)."""

    def resid(x0, x1):
        r0 = a11 * x0 + a12 * x1 - b1
        r1 = a12 * x0 + a22 * x1 - b2
        return r0 * r0 + r1 * r1

    best = (0.0, 0.0, resid(0.0, 0.0), "origin")

    def consider(x0, x1, tag):
        nonlocal best
        if not (np.isfinite(x0) and np.isfinite(x1)) or x0 < 0 or x1 < 0:
            return
        obj = resid(x0, x1)
        if np.isfinite(obj) and obj < best[2]:
            best = (x0, x1, obj, tag)

    consider(vg, ve, "interior")
    col1 = a12 * a12 + a22 * a22
    if np.isfinite(col1) and col1 > 0:
        consider(0.0, max((a12 * b1 + a22 * b2) / col1, 0.0), "sigma_g_zero")
    col0 = a11 * a11 + a12 * a12
    if np.isfinite(col0) and col0 > 0:
        consider(max((a11 * b1 + a12 * b2) / col0, 0.0), 0.0, "sigma_e_zero")
    return best[0], best[1], best[3]


def he_regression(
    K: np.ndarray, y: np.ndarray, covariates: np.ndarray | None = None
) -> HeFit:
    y = np.asarray(y, np.float64).reshape(-1)
    n = len(y)
    X = np.ones((n, 1)) if covariates is None else np.concatenate(
        [np.ones((n, 1)), np.asarray(covariates, np.float64)], axis=1
    )
    # residualize
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    r = y - X @ beta
    K = np.asarray(K, np.float64)
    # normal equations over basis (K, I) using the off-diagonal + diagonal
    # moment identities: <rr', K>, <rr', I>, <K, K>, <K, I>, <I, I>
    Kr = K @ r
    a11 = float(np.sum(K * K))
    a12 = float(np.trace(K))
    a22 = float(n)
    b1 = float(r @ Kr)
    b2 = float(r @ r)
    A = np.array([[a11, a12], [a12, a22]])
    b = np.array([b1, b2])
    vg, ve = np.linalg.solve(A, b)
    vg, ve, boundary = _project_nnls_2x2(a11, a12, a22, b1, b2, vg, ve)
    ve = max(ve, 1e-12)
    h2 = vg / (vg + ve) if vg + ve > 0 else 0.0
    return HeFit(vg=float(vg), ve=float(ve), h2=float(h2), boundary=boundary)


def _he_stream_pass(pk: torch.Tensor, mn: torch.Tensor, iv: torch.Tensor,
                    V: torch.Tensor):
    """One streamed pass over pre-blocked (nblk, B, nb) packed SNP data:
    returns T = sum_b C_b^T (C_b V) and colsq[s] = sum_b sum_j C_b[j, s]^2
    (the per-sample kernel diagonal numerators), never forming the (n, n)
    kernel. Each block decodes on the device in f32; both products are f32
    and each block's sums are added in f64, as in the reference."""
    from janusx_tpu_torch.ops import decode

    accT = torch.zeros((V.shape[0], V.shape[1]), dtype=torch.float64, device=V.device)
    colsq = torch.zeros((V.shape[0],), dtype=torch.float64, device=V.device)
    for b in range(pk.shape[0]):
        c = decode.decode_standardized(pk[b], mn[b], iv[b], torch.float32)
        cv = c @ V
        accT += (c.T @ cv).to(torch.float64)
        colsq += (c * c).sum(0, dtype=torch.float64)
    return accT, colsq


def he_streamed(
    pg,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    method: int = 1,
    probes: int = 32,
    block: int = 4096,
    seed: int = 0,
    sample_idx: np.ndarray | None = None,
    device=None,
) -> HeFit:
    """Haseman-Elston h² without ever forming the (n, n) GRM.

    Streams K.v products from packed SNP blocks (device decode + matmuls)
    and estimates tr(K²) with Rademacher (Hutchinson) probes; tr(K) and
    y'Ky are computed exactly in the same pass. Accepts in-RAM
    PackedGenotypes or disk-backed WindowedPacked inputs. ``sample_idx``
    restricts the analysis to a sample subset (e.g. the GS training set)
    without re-packing: probe/phenotype vectors are zeroed outside the
    subset, which realizes products with the principal submatrix
    K[idx, idx]. The probes are the reference's draws from
    ``np.random.default_rng(seed)``.

    Reference: src/stats/he.rs he_pcg_bed (HE + PCG trace estimation,
    the fast VC pre-fit for GS at biobank n)."""
    from janusx_tpu_torch import config
    from janusx_tpu_torch.models.grm import _snp_scales
    from janusx_tpu_torch.utils import devcache

    dev = config.resolve_device(device)
    y = np.asarray(y, np.float64).reshape(-1)
    n_full = pg.n_samples
    if sample_idx is None:
        idx = np.arange(n_full)
    else:
        idx = np.asarray(sample_idx, np.int64).reshape(-1)
        yi = np.zeros(n_full)
        yi[idx] = y if len(y) == len(idx) else y[idx]
        y = yi
    n = len(idx)
    X = np.zeros((n_full, 1))
    X[idx, 0] = 1.0
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        covf = np.zeros((n_full, cov.shape[1]))
        covf[idx] = cov if len(cov) == n else cov[idx]
        X = np.concatenate([X, covf], axis=1)
    beta, *_ = np.linalg.lstsq(X[idx], y[idx], rcond=None)
    r = np.zeros(n_full)
    r[idx] = y[idx] - X[idx] @ beta
    rng = np.random.default_rng(seed)
    probes = max(int(probes), 1)
    P = np.zeros((n_full, probes))
    P[idx] = rng.choice([-1.0, 1.0], size=(n, probes))
    Vh = np.concatenate([r[:, None], P], axis=1).astype(np.float32)

    def run_sub(sub):
        m = sub.m
        mean, inv_sd, var = _snp_scales(sub, method)
        blk = min(block, m)
        nblk = -(-m // blk)
        shape = (nblk, blk)
        pk = devcache.device_packed_blocks(sub, shape, dev, lane_align=4)
        mn = devcache.to_device_blocks(mean.astype(np.float32), shape, 0.0,
                                       torch.float32, dev)
        iv = devcache.to_device_blocks(inv_sd.astype(np.float32), shape, 0.0,
                                       torch.float32, dev)
        n_pad = pk.shape[-1] * 4
        Vp = np.zeros((n_pad, probes + 1), np.float32)
        Vp[:n_full] = Vh
        T, colsq = _he_stream_pass(pk, mn, iv, torch.as_tensor(Vp, device=dev))
        d = float(var.sum()) if method in (1, 3) else float(m)
        return T[:n_full].cpu().numpy(), colsq[:n_full].cpu().numpy(), d

    if hasattr(pg, "packed"):
        T, colsq, denom = run_sub(pg)
    else:
        T = np.zeros((n_full, probes + 1))
        colsq = np.zeros(n_full)
        denom = 0.0
        for _, _, sub in pg.iter_materialized():
            Ts, cs, ds = run_sub(sub)
            T += Ts
            colsq += cs
            denom += ds
    if denom <= 0:
        raise ValueError("HE denominator is zero (no polymorphic SNPs?)")
    KV = T / denom
    tr_k = float(colsq[idx].sum()) / denom
    # Hutchinson: E[v' K² v] = tr(K²) for Rademacher v (restricted to idx)
    tr_k2 = float(np.mean(np.sum(KV[idx, 1:] ** 2, axis=0)))
    b1 = float(r @ KV[:, 0])
    b2 = float(r @ r)
    A = np.array([[tr_k2, tr_k], [tr_k, float(n)]])
    vg, ve = np.linalg.solve(A, np.array([b1, b2]))
    vg, ve, boundary = _project_nnls_2x2(tr_k2, tr_k, float(n), b1, b2, vg, ve)
    ve = max(ve, 1e-12)
    h2 = vg / (vg + ve) if vg + ve > 0 else 0.0
    return HeFit(
        vg=float(vg), ve=float(ve), h2=float(h2),
        trace_k=tr_k, trace_k2=tr_k2, probes=probes, boundary=boundary,
    )


def reml_h2(K: np.ndarray, y: np.ndarray, covariates: np.ndarray | None = None,
            device=None):
    """Spectral REML heritability (exact single-kernel route)."""
    from janusx_tpu_torch.core.reml import fit_null_reml, make_rotated, null_fit_stats
    from janusx_tpu_torch.core.spectral import eigh_grm

    y = np.asarray(y, np.float64).reshape(-1)
    basis = eigh_grm(np.asarray(K, np.float64), diag_ridge=1e-6)
    rot = make_rotated(basis, y, covariates, device=device)
    null = fit_null_reml(rot)
    _, vg = null_fit_stats(rot, null.log10_lbd)
    ve = null.lbd * vg
    h2 = vg / (vg + ve) if vg + ve > 0 else 0.0
    return HeFit(vg=float(vg), ve=float(ve), h2=float(h2))
