"""Linear-model GWAS scan (``-lm``), residualized OLS (port of
janusx_tpu/models/lm.py).

Math (reference JanusX src/stats/glm.rs:1-8):
    M_X = I - X(X'X)^{-1}X'
    beta = (g'M_X y)/(g'M_X g)
    rss  = y'M_X y - (g'M_X y)^2/(g'M_X g)
    se   = sqrt(rss/(n - p - 1) / (g'M_X g))
    p    = two-sided Student-t with df = n - p - 1 (glm.rs:458,786)

Device step per SNP block: decode the packed 2-bit codes to centered f32,
then the f32 grams G @ M_X Y and G @ X as plain ``torch.matmul`` (the
reference computes them in XLA, outside any Pallas kernel) + row
reductions; centering makes the pad lanes exact zeros so no masking is
needed. The reference pads the design with zero columns to a width of 8
(lm.py:151-164) only to spare XLA a recompile per covariate count; PyTorch
runs eagerly, so the port takes the design as it is (zero columns leave
every statistic bit-identical). One trait is the multi-trait scan with T = 1.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import special as sp_special

from janusx_tpu_torch import config
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.models.scan_common import ScanResult
from janusx_tpu_torch.models.superblocks import scan_resident, stream
from janusx_tpu_torch.ops.decode import decode_centered
from janusx_tpu_torch.parallel.mesh import home_device
from janusx_tpu_torch.utils import trace

_DBL_MIN = np.finfo(np.float64).tiny
f32 = torch.float32


def student_t_p_two_sided(t: np.ndarray, df: int) -> np.ndarray:
    """Two-sided t-test p via the regularized incomplete beta
    (reference glm.rs:458: betai(df/2, 1/2, df/(df+t^2)))."""
    t = np.asarray(t, dtype=np.float64)
    if df <= 0:
        return np.full_like(t, np.nan)
    x = df / (df + t * t)
    p = sp_special.betainc(df / 2.0, 0.5, x)
    p = np.where(np.isfinite(p), p, 1.0)
    p = np.clip(p, _DBL_MIN, 1.0)
    # non-finite t: NaN -> NaN handled by caller; +/-inf -> min positive
    p = np.where(np.isnan(t), np.nan, p)
    p = np.where(np.isinf(t), _DBL_MIN, p)
    return p


def design_matrix(n: int, covariates: np.ndarray | None) -> np.ndarray:
    ones = np.ones((n, 1), dtype=np.float64)
    if covariates is None:
        return ones
    return np.concatenate([ones, np.asarray(covariates, np.float64)], axis=1)


def _lm_grams(pk, mn, X, C, MY, n: int):
    """f32 grams of pre-blocked (nblk, B, nb) packed rows on their device:
    g'M_X Y (nblk*B, T) and g'M_X g (nblk*B,), returned as f64."""
    X32, C32, MY32 = (trace.uploaded(torch.as_tensor(a, dtype=f32, device=pk.device))
                      for a in (X, C, MY))
    gMY, gMg = [], []
    for i in range(pk.shape[0]):
        G = decode_centered(pk[i], mn[i], f32)[:, :n]
        GX = G @ X32
        gMY.append(G @ MY32)
        gMg.append(torch.sum(G * G, dim=-1) - torch.einsum("bp,pq,bq->b", GX, C32, GX))
    return torch.cat(gMY).double(), torch.cat(gMg).double()


def lm_scan_multi(
    pg: PackedGenotypes,
    Y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    mesh=None,
    superblock: int = 1 << 20,
    device=None,
) -> list[ScanResult]:
    """Batched multi-trait LM scan: all columns of Y share the sample set
    and covariates; the decode and the X grams are shared, the numerators
    come from one (B, n) x (n, T) matmul per block. With ``mesh`` each
    shard forms the grams of its SNP slice on its device (janusx_tpu's
    _lm_scan_sharded_multi)."""
    dev = home_device(mesh, device)
    Y = np.asarray(Y, np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    n, T = pg.n, Y.shape[1]
    if Y.shape[0] != n:
        raise ValueError(f"Y rows {Y.shape[0]} != samples {n}")
    X = design_matrix(n, covariates)
    p = X.shape[1]
    df = n - p - 1
    if df <= 0:
        raise ValueError("not enough samples for LM scan (df <= 0)")
    C = np.linalg.inv(X.T @ X)
    MY = Y - X @ (C @ (X.T @ Y))  # (n, T)
    yMy = np.einsum("nt,nt->t", Y, MY)
    block = min(block, pg.m) if pg.m else block

    def compute(i, pk, mn, d):
        gMY, gMg = _lm_grams(pk, mn, X, C, MY, n)
        return gMY.T, gMg

    def chunk(pg):
        gMY, gMg = scan_resident(pg, block, dev, mesh, compute)
        gMY = gMY.T
        results = []
        for t in range(T):
            gMy = gMY[:, t]
            with np.errstate(divide="ignore", invalid="ignore"):
                beta = gMy / gMg
                rss = yMy[t] - gMy * gMy / gMg
                se = np.sqrt(rss / df / gMg)
            ok = np.isfinite(beta) & np.isfinite(se) & (se > 0) & (gMg > 1e-12)
            with np.errstate(divide="ignore", invalid="ignore"):
                tt = np.where(ok, beta / se, 0.0)
            pw = student_t_p_two_sided(tt, df)
            results.append(ScanResult(
                sites=pg.sites, af=pg.af, miss=pg.miss,
                beta=np.where(ok, beta, np.nan),
                se=np.where(ok, se, np.nan),
                pwald=np.where(ok, pw, 1.0),
            ))
        return results

    return stream(pg, superblock, block, chunk, mesh)


def lm_scan(
    pg: PackedGenotypes,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    mesh=None,
    superblock: int = 1 << 20,
    device=None,
) -> ScanResult:
    """Run the LM scan over all SNPs of an (already subset) PackedGenotypes."""
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if len(y) != pg.n:
        raise ValueError(f"y length {len(y)} != samples {pg.n}")
    return lm_scan_multi(pg, y[:, None], covariates, block=block, mesh=mesh,
                         superblock=superblock, device=device)[0]
