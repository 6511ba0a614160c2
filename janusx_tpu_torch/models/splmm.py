"""SparseLMM: sparse-GRM mixed-model scans for biobank-scale n (port of
janusx_tpu/models/splmm.py).

Reference JanusX: src/stats/spgrm.rs (thresholded sparse GRM), splmm.rs
(exact scan), splmm_approx.rs (GRAMMAR-gamma residualized scan),
spreml.rs (sparse REML null fits).

GRAMMAR-gamma (``-splmm``, the default approx route — splmm_approx.rs:1-18):
    M_X = I - X(X'X)^-1 X';  y~ = M_X y;  V_λ = K_sparse + λI
    λ from REML-style fit of y~ under V_λ;  a = V_λ^-1 y~
    γ = mean over sampled null markers (χ² < 5) of (g~'V^-1 g~)/(g~'g~)
    β ≈ (g~'a)/(γ g~'g~);  se ≈ 1/sqrt(γ g~'g~);  χ² = (g~'a)²/(γ g~'g~)

Exact (``-splmm-exact``, splmm.rs:1-9): V = K_sparse + λI at the null λ,
P = V^-1 - V^-1 X (X'V^-1X)^-1 X'V^-1, beta = g'Py/g'Pg, se =
sqrt(sigma2/g'Pg), sigma2 = y'Py/(n - p - 1).

Split: the sparse factorizations and the null fits run on the host (they
are O(n) with a sparse K); the per-SNP work runs on the device, one
resident superblock per pass (models.superblocks.stream), its SNP blocks
looped on the device with one device-to-host copy per superblock. The
GRAMMAR grams are the LM scan's (models.lm._lm_grams with Ma in place of
M_X Y); the exact scan's g'V^-1 g (f32) and the GRAMMAR γ's g~'V^-1 g~
over the sampled markers (f64) are sparse_spectral's device quadratic.
The thresholded GRM is built band by band (``build_sparse_grm``): decode
on the device and ``rows.T @ c`` as ``torch.matmul``, never the dense n².

Default sparse cutoff 0.05 (reference workflow.py:6701); negative cutoff
disables off-diagonal thresholding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.core import stats as jstats
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.models.lm import _lm_grams, design_matrix
from janusx_tpu_torch.models.scan_common import ScanResult, finalize_invalid, iter_blocks
from janusx_tpu_torch.models.superblocks import scan_resident, stream
from janusx_tpu_torch.ops.decode import decode_centered, decode_standardized
from janusx_tpu_torch.parallel.mesh import home_device
from janusx_tpu_torch.utils import devcache, trace

DEFAULT_SPARSE_CUTOFF = 0.05
NULL_CHI2_CUTOFF = 5.0  # fastGWA-style null-marker filter
N_GAMMA_MARKERS = 500
f32 = torch.float32
f64 = torch.float64


def _rowband_accum(sub, method: int, lo: int, band: int, block: int, dev):
    """One chunk's contribution to GRM rows [lo, lo+band): (rows, n) f64,
    summed in f32 over the chunk's SNP blocks on the device (the
    reference's one lax.scan per chunk, splmm.py:47-87)."""
    from janusx_tpu_torch.models.grm import _snp_scales

    mean, inv_sd, _ = _snp_scales(sub, method)
    n = sub.n_samples
    blk = min(block, sub.m)
    nblk = -(-sub.m // blk)
    pk = devcache.device_packed_blocks(sub, (nblk, blk), dev)
    mn = devcache.to_device_blocks(mean, (nblk, blk), 0.0, f32, dev)
    iv = devcache.to_device_blocks(inv_sd, (nblk, blk), 0.0, f32, dev)
    hi = min(lo + band, n)
    acc = torch.zeros((hi - lo, n), dtype=f32, device=dev)
    for i in range(nblk):
        c = decode_standardized(pk[i], mn[i], iv[i], f32)[:, :n]  # (B, n)
        acc += c[:, lo:hi].T @ c
    return acc.cpu().numpy().astype(np.float64)


def build_sparse_grm(
    pg,
    cutoff: float = DEFAULT_SPARSE_CUTOFF,
    method: int = 1,
    row_band: int = 4096,
    block: int = config.DEFAULT_SNP_BLOCK,
    device=None,
) -> scipy.sparse.csr_matrix:
    """Thresholded sparse GRM built band by band — memory O(row_band x n)
    instead of O(n²), for biobank n (reference spgrm tile pipeline,
    JanusX src/stats/spgrm.rs:33-45).

    Accepts in-RAM PackedGenotypes or the disk-backed WindowedPacked: lazy
    inputs stream materialized windows per row-band, so neither the dense
    n² matrix nor the full packed matrix is ever resident. Each chunk sums
    in f32 on the device, chunks in f64 on the host.

    Diagonal entries always kept; off-diagonals kept when |K_ij| >= cutoff
    (negative cutoff keeps everything — then prefer the dense builder).
    """
    if method == 3:
        # the row-band decode is standardized-additive only; the dominance
        # het-indicator decode lives in the dense builder. Fail loudly
        # instead of silently returning an additive matrix.
        raise ValueError("build_sparse_grm supports methods 1/2 "
                         "(dominance kinship: use the dense grm builder)")
    dev = config.resolve_device(device)
    n = pg.n_samples
    m = pg.m
    lazy = not hasattr(pg, "packed")
    # denominator from the handle's per-SNP stats: methods 1/2 need only
    # af (held in RAM even for disk-backed inputs) — no materialize pass
    if method == 1:
        var = 2.0 * pg.af * (1.0 - pg.af)
        denom = float(var.sum())
    else:
        denom = float(m)
    if denom <= 0:
        raise ValueError("GRM denominator is zero (no polymorphic SNPs?)")
    block = min(block, m)
    # the reference's band: a lane multiple of at most row_band rows
    band = max(128, (min(row_band, n) // 128) * 128)
    parts = []
    for lo in range(0, n, band):
        if lazy:
            tile = None
            for _, _, sub in pg.iter_materialized():
                part = _rowband_accum(sub, method, lo, band, block, dev)
                tile = part if tile is None else tile + part
        else:
            tile = _rowband_accum(pg, method, lo, band, block, dev)
        tile = tile / denom
        if cutoff >= 0:
            mask = np.abs(tile) >= cutoff
            rr = np.arange(lo, lo + tile.shape[0])
            mask[np.arange(tile.shape[0]), rr] = True  # keep diagonal
            tile = np.where(mask, tile, 0.0)
        parts.append(scipy.sparse.csr_matrix(tile))
    K = scipy.sparse.vstack(parts).tocsr()
    return K


def sparsify_grm(K: np.ndarray, cutoff: float = DEFAULT_SPARSE_CUTOFF):
    """Threshold off-diagonals (keep |K_ij| >= cutoff); diagonal always kept.

    Negative cutoff keeps everything (reference rule)."""
    K = np.asarray(K, np.float64)
    if cutoff < 0:
        return scipy.sparse.csc_matrix(K)
    mask = np.abs(K) >= cutoff
    np.fill_diagonal(mask, True)
    return scipy.sparse.csc_matrix(np.where(mask, K, 0.0))


class _SpectralFactor:
    """Drop-in ``.solve(b)`` handle for a fixed lambda over BlockSpectralK."""

    def __init__(self, bs, lbd: float):
        self.bs = bs
        self.lbd = lbd

    def solve(self, b: np.ndarray) -> np.ndarray:
        return self.bs.solve(self.lbd, b)


@dataclass
class SparseNullFit:
    lbd: float
    sigma2: float
    loglik: float
    factor: _SpectralFactor  # V_lambda^-1 apply (block-spectral)


@trace.spanned("sparse_null")
def fit_sparse_null(
    Ks: scipy.sparse.spmatrix,
    ytilde: np.ndarray,
    n_eff: int,
    low: float = config.LOG10_LAMBDA_LOW,
    high: float = config.LOG10_LAMBDA_HIGH,
    tol: float = 1e-6,
    max_iter: int = 100,
    bs=None,
) -> SparseNullFit:
    """Profiled-variance null fit of the residualized phenotype over
    log10 λ.

    The reference pays one sparse LLT factorization per λ evaluation
    (spreml.rs golden search over cholesky.rs LLT); here the thresholded
    K is eigendecomposed once per connected component (sparse_spectral),
    after which every λ evaluation is O(n) elementwise — and the returned
    factor solves V^-1 b with batched tiny matmuls at any λ."""
    from janusx_tpu_torch.models.sparse_spectral import (
        BlockSpectralK, profiled_null_fit,
    )

    if bs is None:
        with trace.span("block_spectral"):
            bs = BlockSpectralK.from_sparse(Ks)
    lbd, sigma2, loglik = profiled_null_fit(
        bs, ytilde, n_eff, low, high, tol=tol, max_iter=max_iter
    )
    return SparseNullFit(
        lbd=lbd, sigma2=sigma2, loglik=loglik, factor=_SpectralFactor(bs, lbd)
    )


def _coerce_sparse(K, cutoff: float) -> scipy.sparse.csc_matrix:
    """Accept a dense kinship (thresholded here) or an already-sparse one."""
    if scipy.sparse.issparse(K):
        return K.tocsc()
    return sparsify_grm(K, cutoff)


@trace.spanned("gamma")
def _calibrate_gamma(pg, X, C, null: SparseNullFit, a, seed: int, dev):
    """GRAMMAR-gamma calibration on sampled null markers, batched over the
    sample in f64 (the reference's per-marker loop, splmm_approx.rs gamma
    pass). γ needs per marker g~'g~, g~'a and the quadratic g~'V^-1 g~.
    With every kinship component on the spectral route they are formed on
    ``dev``: the sample's packed rows decoded there, projected, and the
    quadratic taken by the bucketed device quadratic (device_quad_fn), one
    copy of the three (k,) vectors back. A percolated kinship keeps the
    host route: host decode and projection, V^-1 G~ by the block-spectral
    and sparse-LU solve."""
    rng = np.random.default_rng(seed)
    m = pg.m
    n_samp = min(N_GAMMA_MARKERS, m)
    samp = np.sort(rng.choice(m, size=n_samp, replace=False))
    sub = pg.take_snps(samp)
    bs = null.factor.bs
    if bs.sparse_comps:
        trace.count("gamma.host")
        G = sub.centered()  # (k, n)
        Gt = (G.T - X @ (C @ (X.T @ G.T))).T  # (k, n)
        gg = np.einsum("kn,kn->k", Gt, Gt)
        VG = null.factor.solve(Gt.T)  # (n, k)
        gPg = np.einsum("kn,nk->k", Gt, VG) / null.sigma2
        ga = Gt @ a
    else:
        trace.count("gamma.card")
        pk = trace.uploaded(torch.as_tensor(sub.packed, device=dev))
        mn, Xd, Cd, ad = trace.uploaded(
            [torch.as_tensor(v, dtype=f64, device=dev) for v in (sub.mean, X, C, a)])
        G = decode_centered(pk, mn, f64)[:, :sub.n]  # (k, n)
        Gt = G - ((G @ Xd) @ Cd.T) @ Xd.T
        quad = bs.device_quad_fn(null.lbd, dev, dtype=f64)
        gg, ga, gPg = torch.stack(
            [(Gt * Gt).sum(1), Gt @ ad, quad(Gt) / null.sigma2]).cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        chi2 = np.where(gPg > 0, ga * ga / gPg, np.inf)
    mask = (gg > 1e-12) & (chi2 < NULL_CHI2_CUTOFF) & (gPg > 0)
    if not mask.any():
        return 1.0, 0
    gammas = gPg[mask] / gg[mask] * null.sigma2
    return float(np.mean(gammas)), int(mask.sum())


@trace.spanned("splmm_grammar_scan")
def splmm_grammar_scan(
    pg: PackedGenotypes,
    K,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    cutoff: float = DEFAULT_SPARSE_CUTOFF,
    block: int = config.DEFAULT_SNP_BLOCK,
    seed: int = 0,
    superblock: int = 1 << 20,
    mesh=None,
    device=None,
) -> tuple[ScanResult, dict]:
    """GRAMMAR-gamma approximate scan (the ``-splmm`` route).

    ``K`` may be a dense kinship (thresholded at ``cutoff`` here) or an
    already-thresholded scipy sparse matrix (the biobank path — the dense
    n² matrix is then never formed). ``pg`` may be in-RAM or the
    disk-backed WindowedPacked (streamed by superblock). With ``mesh`` the
    per-SNP grams run SNP-sharded over the device mesh."""
    dev = home_device(mesh, device)
    y = np.asarray(y, np.float64).reshape(-1)
    n = pg.n
    X = design_matrix(n, covariates)
    p = X.shape[1]
    C = np.linalg.inv(X.T @ X)
    proj = lambda v: v - X @ (C @ (X.T @ v))
    ytilde = proj(y)
    n_eff = n - p

    Ks = _coerce_sparse(K, cutoff)
    null = fit_sparse_null(Ks, ytilde, n_eff)
    a = null.factor.solve(ytilde) / null.sigma2
    gamma, n_markers = _calibrate_gamma(pg, X, C, null, a, seed, dev)
    gamma_eff = gamma / null.sigma2
    info = {
        "lambda_null": null.lbd,
        "sigma2": null.sigma2,
        "gamma": gamma,
        "nnz_frac": Ks.nnz / (n * n),
        "n_gamma_markers": n_markers,
        "max_component": null.factor.bs.max_comp,
    }

    # device scan: g~'a and g~'g~ are the LM grams with Ma in place of
    # M_X y (so that G @ Ma = g~'a)
    Ma = proj(a)[:, None]
    block = min(block, pg.m) if pg.m else block

    def compute(i, pk, mn, d):
        gA, gMg = _lm_grams(pk, mn, X, C, Ma, n)
        return gA[:, 0], gMg

    def chunk(sub):
        gA, gMg = scan_resident(sub, block, dev, mesh, compute)
        with trace.span("host_p"):
            with np.errstate(divide="ignore", invalid="ignore"):
                beta = gA / (gamma_eff * gMg)
                se = 1.0 / np.sqrt(gamma_eff * gMg)
            pwald = jstats.pwald_from_beta_se(beta, se)
            beta, se, pwald, _ = finalize_invalid(beta, se, pwald, gMg)
            return [ScanResult(sites=sub.sites, af=sub.af, miss=sub.miss, beta=beta,
                               se=se, pwald=pwald, extras=info)]

    return stream(pg, superblock, block, chunk, mesh)[0], info


def splmm_exact_scan(
    pg: PackedGenotypes,
    K,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    cutoff: float = DEFAULT_SPARSE_CUTOFF,
    block: int = config.DEFAULT_SNP_BLOCK,
    superblock: int = 1 << 20,
    mesh=None,
    device=None,
) -> tuple[ScanResult, dict]:
    """Exact SparseLMM scan (the ``-splmm-exact`` route).

    The reference JanusX runs one sparse triangular solve per SNP; here
    ``g'V^-1 g`` is the bucketed block-spectral quadratic on the device
    (sparse_spectral.device_quad_fn) and everything else is two device
    matmuls per SNP block against precomputed V^-1 X and P y. The blocks
    of a resident superblock are looped on the device; janusx_tpu
    dispatches one call per block from the host (splmm.py:473-482). A
    percolated kinship keeps the reference's host sparse-LU route. With
    ``mesh`` the device route's blocks run SNP-sharded (the host route, as
    in the reference, does not shard)."""
    dev = home_device(mesh, device)
    y = np.asarray(y, np.float64).reshape(-1)
    n = pg.n
    X = design_matrix(n, covariates)
    p = X.shape[1]
    C0 = np.linalg.inv(X.T @ X)
    proj = lambda v: v - X @ (C0 @ (X.T @ v))
    n_eff = n - p

    Ks = _coerce_sparse(K, cutoff)
    null = fit_sparse_null(Ks, proj(y), n_eff)
    bs = null.factor.bs
    lbd = null.lbd

    a_y = bs.solve(lbd, y)  # V^-1 y
    A_X = bs.solve(lbd, X)  # V^-1 X  (n, p)
    XVX = X.T @ A_X
    Cv = np.linalg.inv(XVX)  # (X'V^-1X)^-1
    Xa = X.T @ a_y  # (p,)
    CvXa = Cv @ Xa
    # Py = V^-1 y - V^-1 X (X'V^-1X)^-1 X'V^-1 y formed in f64 on the host
    # before the f32 cast: a_y carries the full phenotype mean in its
    # span(X) component, and forming g'Py on the device as the small
    # difference of two large f32 dots leaked that mean (the reference's
    # metamorphic-found bug, splmm.py:403-410). Py is mean-free, so one
    # f32 dot per block is exact-class.
    Py_host = a_y - A_X @ CvXa
    yPy = float(y @ a_y) - float(Xa @ CvXa)
    df = n - p - 1
    sigma2 = yPy / max(df, 1)
    info = {
        "lambda_null": null.lbd,
        "sigma2": sigma2,
        "nnz_frac": Ks.nnz / (n * n),
        "max_component": bs.max_comp,
    }
    block = min(block, pg.m) if pg.m else block

    def host_block(G):
        """(g'Py, g'Pg) of centered rows G (b, n) through the host LU
        route (percolated components)."""
        T2 = G @ A_X
        gPg = bs.quad(lbd, G.T) - np.einsum("bp,pq,bq->b", T2, Cv, T2)
        return G @ Py_host, gPg

    if bs.sparse_comps:
        device_block, mesh = None, None
    else:
        def operands(d):
            """V's bucketed quadratic and the f32 constants on device d."""
            return (bs.device_quad_fn(lbd, d),
                    *(torch.as_tensor(a, dtype=f32, device=d) for a in (Py_host, A_X, Cv)))

        per_dev = {d: operands(d) for d in (mesh.distinct if mesh else (dev,))}

        def device_block(pk, mn, d):
            quad_fn, Pyd, AXd, Cvd = per_dev[d]
            G = decode_centered(pk, mn, f32)[:, :n]
            T2 = G @ AXd  # g'V^-1 X  (B, p)
            gPg = quad_fn(G) - torch.einsum("bp,pq,bq->b", T2, Cvd, T2)
            return torch.stack([G @ Pyd, gPg])  # g'Py directly

    def compute(i, pk, mn, d):
        return (torch.cat([device_block(pk[b], mn[b], d) for b in range(pk.shape[0])],
                          dim=1).double(),)

    def chunk(sub):
        m = sub.m
        if device_block is None:
            outs = [host_block(sub.take_snps(np.arange(s0, e0)).centered())
                    for s0, e0 in iter_blocks(m, block)]
            gPy, gPg = (np.concatenate(x) for x in zip(*outs))
        else:
            gPy, gPg = scan_resident(sub, block, dev, mesh, compute)[0]
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = gPy / gPg
            se = np.sqrt(sigma2 / gPg)
        pwald = jstats.pwald_from_beta_se(beta, se)
        beta, se, pwald, _ = finalize_invalid(beta, se, pwald, gPg)
        return [ScanResult(sites=sub.sites, af=sub.af, miss=sub.miss, beta=beta,
                           se=se, pwald=pwald, extras=info)]

    return stream(pg, superblock, block, chunk, mesh)[0], info
