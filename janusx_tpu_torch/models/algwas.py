"""ALGWAS: adaptive-lasso two-stage GWAS (port of janusx_tpu/models/algwas.py).

Functional re-design of the reference JanusX's ``-algwas`` route
(src/stats/algwas.rs: stage-1 lasso path with EBIC selection — 64 path
steps, λ_min ratio 1e-3, standardized design — then a stage-2 conditional
scan).

Stage 1 is a FISTA proximal-gradient path with warm starts, run on one
device as torch loops (the reference's one jit of ``lax.scan`` over λ
steps): a 30-step power iteration for the Lipschitz bound, then for each λ
a fixed 150 iterations of two (m, n) f32 matvecs at full precision. It
holds the dense standardized (m, n) f32 marker block on the device — 3.4
GB at m = 600,000 and n = 1,410 — and its host twin (the block is built on
the host in f64 and cast to f32, as the reference builds it). EBIC(γ=0.5)
selects the path point, which an exact host f64 coordinate descent on its
support polishes. Stage 2 re-scans all markers with the selected set as
covariates (pseudo-QTN p-values from their joint model, as in FarmCPU).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.models.farmcpu import _decode_rows, _qtn_pvalues
from janusx_tpu_torch.models.lm import lm_scan
from janusx_tpu_torch.models.scan_common import ScanResult
from janusx_tpu_torch.parallel.mesh import home_device

PATH_STEPS = 64
LAMBDA_MIN_RATIO = 1e-3
EBIC_GAMMA = 0.5
f32 = torch.float32


def _momentum(inner_iters: int) -> list[float]:
    """FISTA's momentum weights (t_k - 1)/t_{k+1}, t_0 = 1, in f32 as the
    reference computes its t on the device (algwas.py:66-67); they do not
    depend on the data."""
    t, out = np.float32(1.0), []
    for _ in range(inner_iters):
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        out.append(float((t - np.float32(1.0)) / t_new))
        t = t_new
    return out


def _lasso_path(Zt: torch.Tensor, y: torch.Tensor, lambdas: torch.Tensor,
                inner_iters: int = 150):
    """FISTA over a λ path with warm starts, on Zt's device.

    Zt: (m, n) f32 standardized marker rows; y: (n,) f32 centered;
    lambdas: (steps,) f32. Returns betas (steps, m) and rss (steps,), f32.
    """
    m, n = Zt.shape
    # Lipschitz bound: power iteration on Z'Z
    v = torch.full((m,), 1.0 / np.sqrt(m), dtype=f32, device=Zt.device)
    for _ in range(30):
        w = (v @ Zt) @ Zt.T
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-12)
    L = torch.clamp(torch.linalg.vector_norm((v @ Zt) @ Zt.T), min=1e-6)
    step = 1.0 / L
    mom = _momentum(inner_iters)
    beta = torch.zeros((m,), dtype=f32, device=Zt.device)
    betas, rss = [], []
    for lam in lambdas:
        thr = step * lam
        b, z = beta, beta
        for c in mom:
            grad = Zt @ (z @ Zt - y)  # (m,)
            b_new = z - step * grad
            b_new = torch.sign(b_new) * torch.clamp(torch.abs(b_new) - thr, min=0.0)
            z = b_new + c * (b_new - b)
            b = b_new
        beta = b
        resid = b @ Zt - y
        betas.append(b)
        rss.append(resid @ resid)
    return torch.stack(betas), torch.stack(rss)


def active_set_polish(
    Zs: np.ndarray, r: np.ndarray, lam: float, b0: np.ndarray,
    max_iter: int = 500, tol: float = 1e-10,
) -> np.ndarray:
    """Exact coordinate descent on the active set (reference
    src/math/active_path.rs role: CD restricted to the current support).

    FISTA's fixed iteration budget leaves tiny non-zero coefficients and
    slightly biased values; polishing the EBIC-selected path point with
    exact CD drives true zeros to zero (sharper support) and satisfies
    the KKT conditions on the support. The support is small (q <= a few
    hundred), so f64 host CD is exact and effectively free."""
    Zs = np.asarray(Zs, np.float64)
    b = np.asarray(b0, np.float64).copy()
    resid = r - Zs.T @ b
    d = np.einsum("qn,qn->q", Zs, Zs)
    d = np.where(d > 0, d, 1.0)
    for _ in range(max_iter):
        delta = 0.0
        for j in range(len(b)):
            rho = Zs[j] @ resid + d[j] * b[j]
            bj = np.sign(rho) * max(abs(rho) - lam, 0.0) / d[j]
            if bj != b[j]:
                resid += Zs[j] * (b[j] - bj)
                delta = max(delta, abs(bj - b[j]))
                b[j] = bj
        if delta < tol:
            break
    return b


@dataclass
class AlgwasResult:
    result: ScanResult
    selected: np.ndarray  # stage-1 selected marker indices
    ebic_path: np.ndarray
    lambda_path: np.ndarray


def algwas_scan(
    pg: PackedGenotypes,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    path_steps: int = PATH_STEPS,
    max_selected: int = 200,
    block: int = config.DEFAULT_SNP_BLOCK,
    pg_qtn: PackedGenotypes | None = None,
    mesh=None,
    device=None,
) -> AlgwasResult:
    """pg_qtn (reference -qbfile/-qvcf/...): an alternate panel for the
    stage-1 lasso QTN search; the stage-2 conditional scan still runs on
    the main panel. `selected` then indexes the QTN panel. ``mesh``: the
    stage-2 conditional scan (the O(m) pass) SNP-shards across the mesh."""
    dev = home_device(mesh, device)
    y = np.asarray(y, np.float64).reshape(-1)
    pgq = pg if pg_qtn is None else pg_qtn
    n, m = pg.n, pgq.m
    if pgq.n != pg.n:
        raise ValueError("QTN-search panel sample count differs from the main panel")
    # residualize y on [1, covariates] (stage 1 operates on the centered scale)
    X = np.ones((n, 1)) if covariates is None else np.concatenate(
        [np.ones((n, 1)), np.asarray(covariates, np.float64)], axis=1
    )
    b0, *_ = np.linalg.lstsq(X, y, rcond=None)
    r = y - X @ b0

    var = 2.0 * pgq.af * (1.0 - pgq.af)
    inv_sd = np.where(var > 0, 1.0 / np.sqrt(var), 0.0)
    Zt = (pgq.centered() * inv_sd[:, None]).astype(np.float32)  # (m, n)
    lam_max = float(np.abs(Zt @ r).max())
    lambdas = np.geomspace(lam_max * 0.98, lam_max * LAMBDA_MIN_RATIO,
                           path_steps).astype(np.float32)
    betas, rss = _lasso_path(torch.as_tensor(Zt, device=dev),
                             torch.as_tensor(r, dtype=f32, device=dev),
                             torch.as_tensor(lambdas, device=dev))
    betas = betas.cpu().numpy()
    rss = rss.cpu().numpy().astype(np.float64)
    k = (np.abs(betas) > 1e-8).sum(axis=1)
    with np.errstate(divide="ignore"):
        ebic = (
            n * np.log(np.maximum(rss, 1e-12) / n)
            + k * np.log(n)
            + 2.0 * EBIC_GAMMA * k * np.log(max(m, 2))
        )
    ebic = np.where(k <= max_selected, ebic, np.inf)
    best = int(np.argmin(ebic))
    support = np.nonzero(np.abs(betas[best]) > 1e-8)[0]
    if len(support):
        # exact active-set CD polish at the chosen λ, then re-evaluate the
        # support and EBIC from the polished solution
        b_pol = active_set_polish(
            Zt[support].astype(np.float64), r,
            float(lambdas[best]), betas[best][support],
        )
        keep = np.abs(b_pol) > 1e-8
        selected = support[keep]
        resid = r - Zt[support].astype(np.float64).T @ b_pol
        rss_pol = float(resid @ resid)
        kq = int(keep.sum())
        ebic[best] = (
            n * np.log(max(rss_pol, 1e-12) / n)
            + kq * np.log(n)
            + 2.0 * EBIC_GAMMA * kq * np.log(max(m, 2))
        )
    else:
        selected = support

    # stage 2: conditional LM scan with selected markers as covariates
    cov2 = covariates
    if len(selected):
        Zsel = _decode_rows(pgq, selected).T
        cov2 = Zsel if cov2 is None else np.concatenate([cov2, Zsel], axis=1)
    res = lm_scan(pg, y, cov2, block=block, mesh=mesh, device=dev)
    if len(selected) and pg_qtn is None:
        # QTN rows get conditional refit stats only when they live in the
        # scanned panel (indices refer to the QTN panel otherwise)
        res.pwald[selected] = _qtn_pvalues(pg, y, covariates, selected)
    return AlgwasResult(
        result=res, selected=selected, ebic_path=ebic,
        lambda_path=lambdas.astype(np.float64),
    )
