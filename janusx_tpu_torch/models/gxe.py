"""G×E / G×C interaction scans, the hidden ``-lm2`` and ``-fvlmm2`` routes
(port of janusx_tpu/models/gxe.py; reference JanusX src/stats/glm2.rs
per-SNP interaction covariates, fvlmm2.rs joint rotated variant).

Model per SNP:  y = X b + g βg + (g ∘ c) βi + e   (c = interaction covariate)

Reported per SNP: βg, se(βg), pwald (two-sided t) in the base columns, and
the interaction coefficient, its tests and the joint 2-df test in the extra
columns. ``fvlmm2`` runs the same design whitened by W^(1/2) = U w^(1/2) U'
with the null-model λ fixed.

Device mapping: both regressors are residualized against X by closed form,
so each SNP block is a few (B, n) x (n, k) f64 matmuls plus 2x2 solves
vectorized over SNPs, kept in f64 as the reference keeps them; the
whitening G0 @ W^(1/2) is a plain f64 ``torch.matmul`` (native on Hopper),
not K1, which is an f32-accuracy kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.core.reml import NullFit, fit_null_reml, make_rotated
from janusx_tpu_torch.core.spectral import SpectralBasis
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.models.lm import design_matrix, student_t_p_two_sided
from janusx_tpu_torch.models.scan_common import ScanResult
from janusx_tpu_torch.models.superblocks import replicas, scan_resident
from janusx_tpu_torch.ops.decode import decode_centered
from janusx_tpu_torch.parallel.mesh import home_device

f32, f64 = torch.float32, torch.float64


def _gxe_block(packed, mean, X, Cinv, My, cvec, WhT, n: int):
    """Residualized 2-regressor stats for one block: the Gram entries and
    right-hand sides of [g, g*c] against M = I - X (X'X)^-1 X'
    (janusx_tpu/models/gxe.py:33-81, whose weights are ones on both
    routes). With ``WhT`` (fvlmm2) the decoded genotypes, and the
    interaction product formed in the original space, are whitened first."""
    G = decode_centered(packed, mean, f32)[:, :n].to(f64)
    GC = G * cvec[None, :]
    if WhT is not None:
        G, GC = G @ WhT, GC @ WhT

    def proj(A, B):
        return torch.sum(A * B, dim=-1) - torch.einsum("bp,pq,bq->b", A @ X, Cinv, B @ X)

    return torch.stack([proj(G, G), proj(G, GC), proj(GC, GC), G @ My, GC @ My])


def _finalize_gxe(a11, a12, a22, b1, b2, yMy, n, p):
    """Reference-exact lm2 statistics from per-SNP projected Gram pieces
    (src/stats/glm2.rs lm2_fit_single_snp :165-311; a copy of
    janusx_tpu/models/gxe.py:_finalize_gxe).

    Design per SNP: Z = [g, g*c]; Schur = Z' M_X Z (a11..a22), rhs e =
    Z' M_X y (b1, b2); beta = Schur^-1 e; rss = rss0 - e.beta;
    sigma2 = rss / df with df = n - (q_base + 1 + n_interactions)
    (glm2.rs:149-161: p = q_base + m, df = n - p — the FULL fitted
    design rank). Per-coefficient: se_k = sqrt(sigma2 * SchurInv_kk),
    t-test with df. Joint tests: interaction chisq = beta_i^2 /
    (SchurInv_11 sigma2) ~ chi2(1) (:294-297); full chisq = e.beta /
    sigma2 ~ chi2(2) (:306-310)."""
    from scipy import stats as sps

    det = a11 * a22 - a12 * a12
    ok = np.isfinite(det) & (det > 1e-12 * np.maximum(a11 * a22, 1e-300))
    det_s = np.where(ok, det, 1.0)
    # SchurInv = [[a22, -a12], [-a12, a11]] / det
    bg = (a22 * b1 - a12 * b2) / det_s
    bi = (a11 * b2 - a12 * b1) / det_s
    explained = bg * b1 + bi * b2
    rss = np.maximum(yMy - explained, 0.0)
    df = n - p - 2  # base rank + [g, g*c] (glm2.rs:150 p = q_base + m)
    sigma2 = rss / df
    with np.errstate(invalid="ignore", divide="ignore"):
        se_g = np.sqrt(np.maximum(sigma2 * a22 / det_s, 0))
        se_i = np.sqrt(np.maximum(sigma2 * a11 / det_s, 0))
        t_g = bg / se_g
        t_i = bi / se_i
    pw_g = student_t_p_two_sided(np.where(np.isfinite(t_g), t_g, 0.0), df)
    pw_i = student_t_p_two_sided(np.where(np.isfinite(t_i), t_i, 0.0), df)
    # joint interaction (K=1): chisq = bi^2 / (SchurInv_11 * sigma2)
    with np.errstate(invalid="ignore", divide="ignore"):
        chisq_int = np.where(
            ok & (sigma2 > 0), bi * bi * det_s / (a11 * sigma2), np.nan
        )
        chisq_joint = np.where(ok & (sigma2 > 0), explained / sigma2, np.nan)
    chisq_int = np.maximum(chisq_int, 0.0)
    chisq_joint = np.maximum(chisq_joint, 0.0)
    p_int = sps.chi2.sf(chisq_int, df=1)
    p_joint = sps.chi2.sf(chisq_joint, df=2)

    def clean(beta, se, pw):
        bad = ~ok | ~np.isfinite(beta) | ~np.isfinite(se) | (se <= 0)
        return (np.where(bad, np.nan, beta), np.where(bad, np.nan, se),
                np.where(bad, 1.0, np.clip(pw, np.finfo(float).tiny, 1.0)))

    bg, se_g, pw_g = clean(bg, se_g, pw_g)
    bi, se_i, pw_i = clean(bi, se_i, pw_i)
    p_int = np.where(np.isfinite(p_int), np.clip(p_int, np.finfo(float).tiny, 1.0), 1.0)
    p_joint = np.where(np.isfinite(p_joint), np.clip(p_joint, np.finfo(float).tiny, 1.0), 1.0)
    return (bg, se_g, pw_g, bi, se_i, pw_i,
            chisq_int, p_int, chisq_joint, p_joint)


def gxe_scan(
    pg: PackedGenotypes,
    y: np.ndarray,
    inter_cov: np.ndarray,
    covariates: np.ndarray | None = None,
    basis: SpectralBasis | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    mesh=None,
    null: NullFit | None = None,
    device=None,
) -> tuple[ScanResult, NullFit | None]:
    """Interaction scan. Plain OLS (lm2) when basis is None; fixed-λ mixed
    (fvlmm2) when an eigenbasis of the GRM subset is supplied, at ``null``'s
    λ (fitted here when None). With ``mesh`` the per-SNP block stats run
    SNP-sharded over its 'snp' axis."""
    dev = home_device(mesh, device)
    y = np.asarray(y, np.float64).reshape(-1)
    # interaction covariate stays RAW: the reference builds z = g * cv from
    # the covariate column as loaded (glm2.rs:216); centering it would shift
    # the reported SNP main effect by beta_i * mean(c)
    cvec = np.asarray(inter_cov, np.float64).reshape(-1)
    n = pg.n
    Xcov = (
        cvec[:, None]
        if covariates is None
        else np.concatenate([np.asarray(covariates, np.float64), cvec[:, None]], axis=1)
    )
    Wh = None
    if basis is None:
        null = None
        y_use, X_use = y, design_matrix(n, Xcov)
    else:
        if null is None:
            null = fit_null_reml(make_rotated(basis, y, Xcov, device=dev))
        w = 1.0 / (basis.S + null.lbd)
        # the interaction product must be built in the ORIGINAL space
        # (decode gives g there), so the weighted case whitens with
        # W^(1/2) = U w^(1/2) U' instead of rotating first
        Wh = (basis.U * np.sqrt(w)[None, :]) @ basis.U.T
        y_use = Wh @ y
        X_use = Wh @ design_matrix(n, Xcov)

    p = X_use.shape[1]
    Cinv = np.linalg.inv(X_use.T @ X_use + config.GRAM_RIDGE * np.eye(p))
    My = y_use - X_use @ (Cinv @ (X_use.T @ y_use))
    yMy = float(y_use @ My)

    m = pg.m
    if not hasattr(pg, "packed"):  # lazy input: materialize
        pg = pg.take_snps(np.arange(m))
    block = min(block, m)
    t64 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=f64, device=dev)
    reps = replicas((t64(X_use), t64(Cinv), t64(My), t64(cvec),
                     None if Wh is None else t64(Wh.T)), mesh)

    def compute(i, pk, mn, d):
        return (torch.cat([_gxe_block(pk[b], mn[b], *reps[i], n)
                           for b in range(pk.shape[0])], dim=1),)

    stats = scan_resident(pg, block, dev, mesh, compute)[0]

    (bg, se_g, pw_g, bi, se_i, pw_i, chisq_int, p_int, chisq_joint,
     p_joint) = _finalize_gxe(*stats, yMy, n, p)
    # reference lm2 column layout (glm2.rs lm2_header :58-67): base
    # columns carry the SNP main effect; interaction + joint tests follow
    res = ScanResult(
        sites=pg.sites, af=pg.af, miss=pg.miss, beta=bg, se=se_g,
        pwald=pw_g,
        extra_cols={
            "beta_i1": bi, "se_i1": se_i, "pwald_i1": pw_i,
            "chisq_int_joint": chisq_int, "p_int_joint": p_int,
            "chisq_joint": chisq_joint, "p_joint": p_joint,
        },
        extras={"interaction": True, "lambda_null": None if null is None else null.lbd},
    )
    return res, null
