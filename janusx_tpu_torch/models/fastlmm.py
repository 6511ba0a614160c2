"""FaST-LMM low-rank exact LMM scan, ``-lowrank`` (port of
janusx_tpu/models/fastlmm.py).

Reference JanusX: src/stats/fastlmm_lowrank.rs (per-SNP Brent on the
low-rank spectral REML, U1/U2 split, add/dom/rec/het genetic models) and
src/math/FaST.rs (fastlmm_prepare_lowrank_f64).

When the kinship is built from q selected SNPs with q < n, K = W W' has
rank k <= q and its eigensystem is the economy SVD of W — O(n q^2)
instead of the O(n^3) dense eigh, and the per-SNP rotation drops from
O(n^2) to O(n k). With V = diag(S) + λ I in the eigenbasis, every
quadratic form splits into the k-dim rotated part plus the (n-k)-dim
complement, where all eigenvalues equal the kinship diag ridge r:

    a' V^-1 b = Σ_i ar_i br_i / (S_i + r + λ)  +  (a'b − ar'br)/(r + λ)
    log|V|    = Σ_i log(S_i + r + λ)  +  (n − k) log(r + λ)

so the complement never needs its eigenvectors — only raw-minus-rotated
Gram corrections, carried in f64 (fastlmm.py:502-506).

Host f64, as the reference: the basis (economy SVD), the rotated design,
the null REML fit and the LMM→LM switch. Device, per resident superblock
of SNPs (models.superblocks.stream; the chunk is sized as the dense grid
route's, models.lmm.lattice_superblock, since it holds Gr (m, k <= n)):

- the rotation Gr = G @ Uk. Genetic model ``add``: one K1 launch
  (ops.kernels.decode_rotate) over the whole superblock with N = k
  columns, U's bf16 pieces split once per basis; its mean is the
  reference's f32 mean of the observed codes (``tm``), so the rotated
  rows equal the reference's decode-then-matmul whatever the genotypes'
  QC stats were taken over (-global). Models ``dom``/``rec``/``het``:
  the 2-bit codes are decoded and transformed in torch, then
  ``torch.matmul`` (K1 decodes additive dosage only, and the reference
  has no Pallas kernel for this product either);
- the λ lattice: per chunk of rows one stacked ((2+p)B, k) @ (k, G)
  ``torch.matmul`` plus the rank-1 complement corrections, then
  core.reml.grid_argmin_schur — the reference's XLA route (K2 is not on
  this path) — with y's side of each grid point scaled so that the f32
  terms stay O(1) at any n (``_grid_shared_lr``);
- beta/se (and the ML loglik for lmm2) at each λ*: f32 grams, then the
  small (p+1) Schur algebra in f64 (``_final_stats_lr``).

Once per design, (basis, covariates): U'X and its products, and per device
the grid's covariate pieces and the constants (``_grid_shared_lr``,
``_lr_consts``). Per trait: U'y, y's products and the grid's y side.

Spans (utils.trace): ``lowrank_scan``, the route; ``lr_rotate_y``, the
host's rotated state; ``lr_null``, the host null fit and the switch test;
``lr_basis``, the basis (set-up); ``lr_lattice``, a superblock's lattice
and epilogue after its rotation; inside the route the shared ``feed``,
``superblock``, ``upload``, ``kernels``, ``to_host`` and ``results``.
Counter ``lowrank.superblocks``: one per resident superblock scanned. The
operands of the grid and the constants count under ``h2d_bytes`` as they
go up (the design's once).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.core import stats as jstats
from janusx_tpu_torch.core.reml import GridShared, NullFit, grid_argmin_schur
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.models.lmm import lattice_superblock
from janusx_tpu_torch.models.scan_common import ScanResult, finalize_invalid
from janusx_tpu_torch.models.superblocks import replicas, scan_resident, stream
from janusx_tpu_torch.ops import decode, kernels
from janusx_tpu_torch.parallel.mesh import home_device
from janusx_tpu_torch.utils import devcache, trace

_BAD = 1e8
GENETIC_MODELS = ("add", "dom", "rec", "het")
f32, f64 = torch.float32, torch.float64

# bytes of the stacked lattice operand E ((2+p)·rows, max(k, G)) f32 per
# chunk of a superblock's rows
_LATTICE_CHUNK_BYTES = 1 << 28


class LowRankBasis(NamedTuple):
    """Economy eigensystem of a rank-deficient kinship K = U diag(S) U'.

    ``ridge`` is the implicit eigenvalue of the (n-k)-dim complement —
    the diag ridge the dense route adds before eigh (spectral.eigh_grm),
    kept here so low-rank and dense scans agree numerically."""

    U: np.ndarray  # (n, k) top eigenvectors
    S: np.ndarray  # (k,) eigenvalues (descending), EXCLUDING the ridge
    n: int
    ridge: float = 1e-6
    snp_idx: np.ndarray | None = None  # SNPs the kinship was built from

    @property
    def k(self) -> int:
        return self.U.shape[1]


def select_kinship_snps(m: int, q: int) -> np.ndarray:
    """Evenly-spaced kinship SNP subset (deterministic; the reference
    leaves selection to the caller — fastlmm_lowrank.rs takes eigvecs)."""
    if q >= m:
        return np.arange(m)
    return np.unique(np.round(np.linspace(0, m - 1, q)).astype(np.int64))


def select_kinship_snps_ld(pg: PackedGenotypes, q: int,
                           r2_threshold: float = 0.2, device=None) -> np.ndarray:
    """LD-pruned kinship SNP subset: windowed greedy prune (the standard
    FaST-LMM practice — kinship markers in approximate linkage
    equilibrium give a better-conditioned low-rank K than evenly-spaced
    picks in high-LD regions), then thin the survivors evenly to q."""
    from janusx_tpu_torch.models.ldprune import ld_prune

    kept = ld_prune(pg, r2_threshold=r2_threshold, device=device)
    if len(kept) <= q:
        return kept
    take = np.unique(np.round(np.linspace(0, len(kept) - 1, q)).astype(np.int64))
    return kept[take]


@trace.spanned("lr_basis")
def lowrank_basis_from_snps(
    pg: PackedGenotypes,
    q: int | None = None,
    snp_idx: np.ndarray | None = None,
    method: int = 1,
    ridge: float = 1e-6,
    rel_tol: float = 1e-12,
    ld_prune: bool = False,
    device=None,
) -> LowRankBasis:
    """Build the low-rank kinship basis from q SNP columns via economy SVD
    (host f64).

    method 1 (cGRM): K = Σ x x' / Σ 2p(1-p); method 2 (sGRM): K = Σ z z'/q
    (models/grm.py conventions). Mirrors fastlmm_prepare_lowrank_f64's
    eigenvalue thresholding (math/FaST.rs rel_tol) on the squared
    singular values. ``device`` runs the LD prune's correlations."""
    if snp_idx is None:
        q = q or min(pg.m, 4096)
        snp_idx = (select_kinship_snps_ld(pg, q, device=device) if ld_prune
                   else select_kinship_snps(pg.m, q))
    sel = pg.take_snps(np.asarray(snp_idx, np.int64))
    Xc = sel.centered().astype(np.float64).T  # (n, q) centered columns
    if method == 2:
        var = 2.0 * sel.af * (1.0 - sel.af)
        with np.errstate(divide="ignore"):
            inv_sd = np.where(var > 0, 1.0 / np.sqrt(var), 0.0)
        Xc = Xc * inv_sd[None, :]
        c0 = float(len(snp_idx))
    else:
        c0 = float(np.sum(2.0 * sel.af * (1.0 - sel.af)))
    W = Xc / math.sqrt(max(c0, 1e-30))
    # economy SVD on host (n x q, q small); K = U diag(sv^2) U'
    U, sv, _ = np.linalg.svd(W, full_matrices=False)
    S = sv * sv
    keep = S > (S[0] * rel_tol if S.size else 0.0)
    keep &= S > 0
    return LowRankBasis(
        U=np.ascontiguousarray(U[:, keep]),
        S=S[keep],
        n=pg.n,
        ridge=ridge,
        snp_idx=np.asarray(snp_idx, np.int64),
    )


class RotatedLR(NamedTuple):
    """Host-side rotated design + complement corrections (all float64)."""

    S: np.ndarray  # (k,) eigenvalues INCLUDING the ridge shift
    Xr: np.ndarray  # (k, p)
    yr: np.ndarray  # (k,)
    PXX: np.ndarray  # (k, p*p)
    PXy: np.ndarray  # (k, p)
    Pyy: np.ndarray  # (k,)
    cXX: np.ndarray  # (p, p)  X'X − Xr'Xr
    cXy: np.ndarray  # (p,)
    cyy: float
    X: np.ndarray  # (n, p) raw design (for per-SNP raw products)
    y: np.ndarray  # (n,)
    n: int
    ridge: float

    @property
    def k(self) -> int:
        return self.S.shape[0]

    @property
    def p(self) -> int:
        return self.Xr.shape[1]


@trace.spanned("lr_rotate_y")
def make_rotated_lr(
    lrb: LowRankBasis, y: np.ndarray, X_cov: np.ndarray | None
) -> RotatedLR:
    n = lrb.n

    def design():  # cached on lrb.U under the covariates' digest
        ones = np.ones((n, 1), np.float64)
        X = ones if X_cov is None else np.concatenate(
            [ones, np.asarray(X_cov, np.float64)], axis=1
        )
        Xr = lrb.U.T @ X  # (k, p)
        PXX = (Xr[:, :, None] * Xr[:, None, :]).reshape(Xr.shape[0], -1)
        return lrb.S + lrb.ridge, X, Xr, PXX, X.T @ X - Xr.T @ Xr

    S, X, Xr, PXX, cXX = devcache.derived(
        lrb.U, ("lr.design", lrb.ridge, devcache.digest(X_cov)), "host", design)
    y = np.asarray(y, np.float64).reshape(-1)
    # Exact reparameterization: subtract the f64 OLS projection of y onto
    # span(X) BEFORE building the rotated and complement pieces. REML/ML
    # values, λ and every per-SNP statistic are invariant (GLS effects are
    # translation-invariant in span(X)); without it a constant phenotype
    # offset is only absorbed through the GRAM_RIDGE'd null solve, which
    # on flat optima moved λ̂ by ~0.5 log10 units, and a large phenotype
    # mean leaked into the f32 per-SNP G-side products (the reference's
    # round-5 metamorphic fix, fastlmm.py:170-181).
    c, *_ = np.linalg.lstsq(X, y, rcond=None)
    y = y - X @ c
    yr = lrb.U.T @ y
    return RotatedLR(
        S=S,
        Xr=Xr,
        yr=yr,
        PXX=PXX,
        PXy=Xr * yr[:, None],
        Pyy=yr * yr,
        cXX=cXX,
        cXy=X.T @ y - Xr.T @ yr,
        cyy=float(y @ y - yr @ yr),
        X=X,
        y=y,
        n=n,
        ridge=lrb.ridge,
    )


def _null_pieces_lr(rot: RotatedLR, lg: float):
    """Weighted null grams at log10 λ (host, float64)."""
    lbd = 10.0 ** lg
    v = rot.S + lbd
    v0 = rot.ridge + lbd
    if not (np.all(v > 0) and v0 > 0):
        return None
    w = 1.0 / v
    w0 = 1.0 / v0
    M = (rot.Xr * w[:, None]).T @ rot.Xr + w0 * rot.cXX
    rhs = rot.Xr.T @ (w * rot.yr) + w0 * rot.cXy
    ayy = float((w * rot.yr) @ rot.yr + w0 * rot.cyy)
    logdetV = float(np.sum(np.log(v)) + (rot.n - rot.k) * math.log(v0))
    return M, rhs, ayy, logdetV


@trace.spanned("lr_null")
def fit_null_reml_lr(rot: RotatedLR) -> tuple[NullFit, np.ndarray, float]:
    """Host Brent null REML fit on the low-rank objective.

    Same profiled-REML formulas as core.reml.fit_null_reml_host (reference
    JanusX src/stats/reml.rs:255,364,572), with low-rank weighted grams.
    Returns (NullFit, beta_null, vg); beta_null is ~0 by construction
    (make_rotated_lr residualizes y onto span(X)); vg is the meaningful
    output."""
    import scipy.linalg as sla
    from scipy.optimize import minimize_scalar

    n, p = rot.n, rot.p
    ridge = config.GRAM_RIDGE * np.eye(p)

    def solve(lg: float):
        pc = _null_pieces_lr(rot, float(lg))
        if pc is None:
            return None
        M, rhs, ayy, logdetV = pc
        try:
            L = sla.cholesky(M + ridge, lower=True)
        except sla.LinAlgError:
            return None
        beta = sla.cho_solve((L, True), rhs)
        logdetA = 2.0 * float(np.sum(np.log(np.diag(L))))
        rtwr = float(ayy - 2.0 * beta @ rhs + beta @ (M @ beta))
        return beta, rtwr, logdetV, logdetA

    def neg_reml(lg: float) -> float:
        pc = solve(lg)
        if pc is None:
            return _BAD
        _, rtwr, logdetV, logdetA = pc
        if not np.isfinite(rtwr) or rtwr <= 0:
            return _BAD
        c = (n - p) * (math.log(n - p) - 1.0 - math.log(2.0 * math.pi)) / 2.0
        return -(c - 0.5 * ((n - p) * math.log(rtwr) + logdetV + logdetA))

    res = minimize_scalar(
        neg_reml,
        bounds=(config.LOG10_LAMBDA_LOW, config.LOG10_LAMBDA_HIGH),
        method="bounded",
        options={"xatol": config.NULL_BRENT_TOL,
                 "maxiter": config.NULL_BRENT_MAX_ITER},
    )
    lg = float(res.x)
    pc = solve(lg)
    if pc is None:
        raise ValueError(
            "low-rank null REML fit failed: covariate Gram is not positive"
            " definite at the optimum (collinear or constant covariates?)"
        )
    beta, rtwr, logdetV, _ = pc
    cm = n * (math.log(n) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    ml = cm - 0.5 * (n * math.log(rtwr) + logdetV)
    fit = NullFit(
        lbd=10.0 ** lg, log10_lbd=lg, reml=float(-neg_reml(lg)), ml=float(ml)
    )
    return fit, np.asarray(beta), float(rtwr / (n - p))


@trace.spanned("lr_null")
def lowrank_switch_p(rot: RotatedLR) -> tuple[float, NullFit]:
    """Boundary LRT p for Va=0 (LMM->LM auto-switch) from the low-rank
    null — workflows.gwas.lmm_to_lm_switch_p's semantics. Returns
    (p, null_fit) so the caller can reuse the null in the scan."""
    null, _, _ = fit_null_reml_lr(rot)
    X, y = rot.X, rot.y
    n = rot.n
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    rss = float(np.sum((y - X @ beta) ** 2))
    ml_lm = -0.5 * n * (math.log(2.0 * math.pi * rss / n) + 1.0)
    stat = 2.0 * (null.ml - ml_lm)
    stat = max(stat, 0.0) if np.isfinite(stat) else 0.0
    p = 0.5 * float(jstats.chi2_sf_df1(np.asarray(stat)))
    p = min(max(p if np.isfinite(p) else 1.0, np.finfo(np.float64).tiny), 1.0)
    return p, null


def _grid_shared_lr(rot: RotatedLR, grid_lg: np.ndarray,
                    dev) -> tuple[GridShared, torch.Tensor]:
    """Shared λ-grid pieces (host f64 -> f32 device tensors; the grid f64),
    and ``ysc`` (G,) f32, the scale of each grid point's per-SNP y gram.

    w32 carries the (G, k) LOW-RANK weights; the complement weight w0 is
    folded into the shared grams here and applied to the per-SNP pieces
    on the device via rank-1 outer products.

    The lattice compares each SNP's -REML across λ in f32, and its terms
    grow with n: at n = 60,000, (n-p-1)·log(r'V⁻¹r) and log|V| are ~10^6,
    an f32 ulp of ~0.1, enough to move λ* within its grid cell and p by up
    to 0.1 in log10. So y's side of every grid point is scaled by
    1/sqrt(y'V⁻¹y) (ayy32 = 1, axy32 and Ainv_axy32 by ``ysc``, the SNPs'
    agy by ``ysc`` in ``_lr_rows``), which scales each cell's r'V⁻¹r by
    1/y'V⁻¹y, and (n-p-1)·log(y'V⁻¹y) is added to log|V| in f64, less its
    minimum over the grid: each cell's -REML less a constant, with terms
    of O(1) near the optimum. The design's half is cached on rot.PXX."""
    t32 = lambda a: trace.uploaded(torch.as_tensor(a, dtype=f32, device=dev))

    def design():  # (w, w0, log|V| before y's term, Ar_inv, GridShared part)
        p = rot.p
        G = len(grid_lg)
        lbd = 10.0 ** grid_lg
        v = rot.S[None, :] + lbd[:, None]  # (G, k)
        v0 = rot.ridge + lbd  # (G,)
        w = 1.0 / v
        w0 = 1.0 / v0
        logdetV = np.sum(np.log(v), axis=1) + (rot.n - rot.k) * np.log(v0)
        Axx = (w @ rot.PXX).reshape(G, p, p) + w0[:, None, None] * rot.cXX
        Ar = Axx + config.GRAM_RIDGE * np.eye(p)
        try:
            L = np.linalg.cholesky(Ar)
        except np.linalg.LinAlgError as e:
            raise ValueError(
                "low-rank grid setup failed: covariate Gram is not positive"
                " definite on the λ grid (collinear or constant covariates?)"
            ) from e
        logdetAr = 2.0 * np.sum(np.log(np.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
        Ar_inv = np.linalg.inv(Ar)
        return w, w0, logdetV, Ar_inv, GridShared(
            grid_lg=trace.uploaded(torch.as_tensor(grid_lg, dtype=f64, device=dev)),
            w32=t32(w), logdetV32=None, Axx32=t32(Axx), axy32=None, ayy32=None,
            Ar_inv32=t32(Ar_inv), Ainv_axy32=None, logdetAr32=t32(logdetAr),
        )

    w, w0, logdetV, Ar_inv, sh = devcache.derived(
        rot.PXX, ("lr.grid", devcache.digest(grid_lg)), dev, design)
    axy = w @ rot.PXy + w0[:, None] * rot.cXy
    ayy = w @ rot.Pyy + w0 * rot.cyy
    Ainv_axy = np.einsum("gpq,gq->gp", Ar_inv, axy)
    ysc = 1.0 / np.sqrt(ayy)
    logdetV = logdetV + (rot.n - rot.p - 1) * np.log(ayy)
    sh = sh._replace(
        logdetV32=t32(logdetV - logdetV.min()), axy32=t32(axy * ysc[:, None]),
        ayy32=t32(np.ones(len(grid_lg))), Ainv_axy32=t32(Ainv_axy * ysc[:, None]),
    )
    return sh, t32(ysc)


def _transform_codes(codes: torch.Tensor, model: str) -> torch.Tensor:
    """Genetic-model indicator on TRUE hardcall codes 0/1/2
    (fastlmm_lowrank.rs GeneticModel::apply). Missing (3) handled by the
    caller — indicators must never see imputed means."""
    if model == "add":
        return codes.to(f32)
    if model == "dom":
        return ((codes == 1) | (codes == 2)).to(f32)
    if model == "rec":
        return (codes == 2).to(f32)
    if model == "het":
        return (codes == 1).to(f32)
    raise ValueError(f"unknown genetic model: {model}")


def _transformed(packed: torch.Tensor, n: int, model: str):
    """(B, nb) packed -> the transformed codes t (B, n) f32, the observed
    mask (B, n) and each row's f32 mean of t over observed samples (B, 1)."""
    codes = decode.unpack_codes(packed)[:, :n]
    obs = codes != 3
    t = _transform_codes(torch.where(obs, codes, torch.zeros_like(codes)), model)
    cnt = torch.clamp(torch.sum(obs, dim=-1, keepdim=True), min=1)
    zero = torch.zeros((), dtype=f32, device=t.device)
    tm = torch.sum(torch.where(obs, t, zero), dim=-1, keepdim=True) / cnt
    return t, obs, tm


def _decode_transformed_centered(packed: torch.Tensor, n: int, model: str):
    """(B, nb) packed -> (B, n) centered genetic-model values.

    The transform is applied to the RAW codes; missing genotypes are
    imputed with the per-SNP mean of the TRANSFORMED non-missing values
    (then centering sends them to exactly 0). Applying indicators to
    mean-imputed dosages would instead code every missing sample as a
    deterministic carrier/non-carrier."""
    t, obs, tm = _transformed(packed, n, model)
    return torch.where(obs, t - tm, torch.zeros((), dtype=f32, device=t.device))


class _LrConsts(NamedTuple):
    """Device-resident per-trait constants for the low-rank scan."""

    Uk: torch.Tensor  # (n, k) f32
    X: torch.Tensor  # (n, p) f32
    y: torch.Tensor  # (n,) f32
    Xr: torch.Tensor  # (k, p) f32
    yr: torch.Tensor  # (k,) f32
    S64: torch.Tensor  # (k,) f64 (ridge-shifted)
    PXX64: torch.Tensor  # (k, p*p) f64
    PXy64: torch.Tensor  # (k, p) f64
    Pyy64: torch.Tensor  # (k,) f64
    cXX64: torch.Tensor  # (p, p) f64
    cXy64: torch.Tensor  # (p,) f64
    cyy64: float
    ridge64: float


def _lr_consts(rot: RotatedLR, Uk: torch.Tensor, dev) -> _LrConsts:
    t = lambda a, dt: trace.uploaded(torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                                     device=dev))
    # the design's, cached on X: an f64 upload to the CPU shares its array
    X, Xr, S64, PXX64, cXX64 = devcache.derived(
        rot.X, "lr.consts", dev, lambda: (t(rot.X, f32), t(rot.Xr, f32), t(rot.S, f64),
                                          t(rot.PXX, f64), t(rot.cXX, f64)))
    return _LrConsts(
        Uk=Uk, X=X, y=t(rot.y, f32), Xr=Xr, yr=t(rot.yr, f32),
        S64=S64, PXX64=PXX64, PXy64=t(rot.PXy, f64),
        Pyy64=t(rot.Pyy, f64), cXX64=cXX64, cXy64=t(rot.cXy, f64),
        cyy64=float(rot.cyy), ridge64=float(rot.ridge),
    )


def _final_stats_lr(cs: _LrConsts, Gr, cgX, cgy, cgg, lg_star, n: int,
                    with_ml: bool):
    """(beta, se, ml) at per-lane λ* — the low-rank twin of
    core.reml.final_stats_f32: f32 (B, k) grams + f64 corrections, then
    the small (p+1) Schur algebra in f64 (fastlmm.py:411-488)."""
    p = cs.Xr.shape[1]
    lbd = torch.pow(10.0, lg_star)  # (B,) f64
    v = cs.S64[None, :] + lbd[:, None]  # (B, k) f64
    v0 = cs.ridge64 + lbd  # (B,)
    w = (1.0 / v).to(f32)
    w0 = 1.0 / v0  # f64
    Gw = Gr * w  # (B, k) f32
    Axx = ((w @ cs.PXX64.to(f32)).double().reshape(-1, p, p)
           + w0[:, None, None] * cs.cXX64)
    axy = (w @ cs.PXy64.to(f32)).double() + w0[:, None] * cs.cXy64
    ayy = (w @ cs.Pyy64.to(f32)).double() + w0 * cs.cyy64
    axg = (Gw @ cs.Xr).double() + w0[:, None] * cgX
    agy = (Gw @ cs.yr).double() + w0 * cgy
    agg = torch.sum(Gw * Gr, dim=-1).double() + w0 * cgg

    ridge = config.GRAM_RIDGE
    eye = torch.eye(p, dtype=f64, device=Gr.device)
    L, info = torch.linalg.cholesky_ex(Axx + ridge * eye)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    badA = (info != 0) | torch.any(~torch.isfinite(diag) | (diag <= 0), dim=-1)
    Ls = torch.where(badA[:, None, None], eye, L)

    def chosolve(b):
        z = torch.linalg.solve_triangular(Ls, b[..., None], upper=False)
        return torch.linalg.solve_triangular(Ls.mT, z, upper=True)[..., 0]

    u = chosolve(axg)
    Ainv_axy = chosolve(axy)
    schur = (agg + ridge) - torch.sum(axg * u, dim=-1)
    beta_g = (agy - torch.sum(axg * Ainv_axy, dim=-1)) / schur
    beta_X = Ainv_axy - beta_g[:, None] * u
    lin = torch.sum(beta_X * axy, dim=-1) + beta_g * agy
    quad = (torch.einsum("bp,bpq,bq->b", beta_X, Axx, beta_X)
            + 2.0 * beta_g * torch.sum(axg * beta_X, dim=-1)
            + beta_g * beta_g * agg)
    rtwr = ayy - 2.0 * lin + quad
    sigma2 = rtwr / (float(n) - float(p + 1))
    var_k = sigma2 / schur
    ok = ~badA & (schur > 0) & (var_k > 0) & torch.isfinite(var_k) & (rtwr > 0)
    nan = torch.full_like(beta_g, float("nan"))
    beta = torch.where(ok, beta_g, nan)
    se = torch.where(ok, torch.sqrt(torch.where(ok, var_k, torch.ones_like(var_k))), nan)
    if not with_ml:
        return beta, se, torch.zeros_like(beta)
    k = cs.S64.shape[0]
    logdetV = (torch.sum(torch.log(v.to(f32)), dim=-1).double()
               + (float(n) - float(k)) * torch.log(v0))
    nf = float(n)
    c = nf * (math.log(nf) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    ml = c - 0.5 * (nf * torch.log(rtwr) + logdetV)
    return beta, se, torch.where(ok, ml, torch.full_like(ml, -_BAD))


def _lr_rows(G, Gr, cs: _LrConsts, sh: GridShared, ysc, n: int, with_ml: bool):
    """A chunk of rows: centered genetic-model values G (B, n) and their
    rotation Gr (B, k) -> grid λ* and per-lane beta/se. Returns (5, B) f64:
    (log10 λ*, beta, se, ml, g'g) (fastlmm.py:491-534). ``sh`` and ``ysc``
    are ``_grid_shared_lr``'s, y's side scaled per grid point."""
    gX = G @ cs.X  # (B, p)
    gy = G @ cs.y  # (B,)
    gg = torch.sum(G * G, dim=-1)
    # complement corrections (raw − rotated), carried in f64
    cgX = gX.double() - (Gr @ cs.Xr).double()
    cgy = gy.double() - (Gr @ cs.yr).double()
    cgg = gg.double() - torch.sum(Gr * Gr, dim=-1).double()
    # (B, G) grid pieces: one stacked ((2+p)B, k) @ (k, G) matmul + rank-1
    # complement corrections
    wT = sh.w32.T  # (k, G)
    lbdg = torch.pow(10.0, sh.grid_lg).to(f32)
    w0g = (1.0 / (torch.tensor(cs.ridge64, dtype=f32, device=G.device) + lbdg))[None, :]
    p = cs.Xr.shape[1]
    B = Gr.shape[0]
    E = torch.cat([Gr * Gr, Gr * cs.yr[None, :]]
                  + [Gr * cs.Xr[None, :, j] for j in range(p)], dim=0)
    A = E @ wT  # ((2+p)B, G)
    del E
    agg = A[:B] + cgg.to(f32)[:, None] * w0g
    agy = (A[B:2 * B] + cgy.to(f32)[:, None] * w0g) * ysc[None, :]
    axg = torch.stack([A[(2 + j) * B:(3 + j) * B] + cgX[:, j].to(f32)[:, None] * w0g
                       for j in range(p)], dim=-1)  # (B, G, p)
    lg_star = grid_argmin_schur(sh, agg, agy, axg, n)
    beta, se, ml = _final_stats_lr(cs, Gr, cgX, cgy, cgg, lg_star, n, with_ml)
    return torch.stack([lg_star, beta, se, ml, gg.double()])


def _scan_chunk(pk, n: int, model: str, cs: _LrConsts, U_split, sh: GridShared, ysc,
                with_ml: bool, rows: int):
    """One resident superblock (nblk, B, nb) packed -> (5, nblk*B) f64 on
    the device. ``add``: one K1 launch rotates every row; the lattice and
    the epilogue then run over chunks of ``rows`` rows."""
    nblk, B, _ = pk.shape
    M = nblk * B
    flat = pk.reshape(M, -1)
    Gr_all = None
    if model == "add":
        tm = torch.cat([_transformed(pk[i], n, "add")[2][:, 0] for i in range(nblk)])
        Gr_all = kernels.decode_rotate(flat, tm, cs.Uk, U_split=U_split)
    outs = []
    with trace.span("lr_lattice"):
        for r0 in range(0, M, rows):
            G = _decode_transformed_centered(flat[r0:r0 + rows], n, model)
            Gr = G @ cs.Uk if Gr_all is None else Gr_all[r0:r0 + rows]
            outs.append(_lr_rows(G, Gr, cs, sh, ysc, n, with_ml))
        return torch.cat(outs, dim=1)


@trace.spanned("lowrank_scan")
def fastlmm_scan(
    pg: PackedGenotypes,
    lrb: LowRankBasis,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    lmm2: bool = False,
    grid_points: int | None = None,
    model: str = "add",
    rot: RotatedLR | None = None,
    null: NullFit | None = None,
    mesh=None,
    superblock: int = 1 << 20,
    device=None,
) -> tuple[ScanResult, NullFit]:
    """Low-rank exact LMM scan over all SNPs (FaST-LMM semantics).

    ``rot``/``null`` accept a precomputed rotation and null fit (the
    workflow computes both for the LMM->LM switch). The grid-shared state
    and the constants (the design's once) are carried through every
    superblock. With ``mesh`` each shard scans its slice of
    every superblock, K1 at N = k per shard (janusx_tpu's _lr_scan_sharded)."""
    if model not in GENETIC_MODELS:
        raise ValueError(f"unknown genetic model: {model}")
    dev = home_device(mesh, device)
    if grid_points is None:
        grid_points = config.knob("JX_TPU_GRID_POINTS")
    if rot is None:
        rot = make_rotated_lr(lrb, y, covariates)
    if null is None:
        null, _, _ = fit_null_reml_lr(rot)
    grid_lg = np.linspace(config.LOG10_LAMBDA_LOW, config.LOG10_LAMBDA_HIGH, grid_points)
    sh, ysc = _grid_shared_lr(rot, grid_lg, dev)
    cs = _lr_consts(rot, devcache.to_device(lrb.U, f32, dev), dev)
    n = pg.n
    block = min(block, pg.m) if pg.m else block
    rows = max(block, _LATTICE_CHUNK_BYTES // ((2 + rot.p) * max(lrb.k, grid_points) * 4)
               // block * block)
    extras = ({"lambda_null": null.lbd, "ml_null": null.ml, "rank": lrb.k} if lmm2
              else {"lambda_null": null.lbd, "rank": lrb.k})

    reps = replicas((cs, sh, ysc), mesh)

    def compute(i, pk, mn, d):
        cs_d, sh_d, ysc_d = reps[i]
        # K1's bf16 pieces of Uk, made once per basis and device
        U_split = (devcache.derived(lrb.U, "u_split", d, lambda: kernels.split_u(cs_d.Uk))
                   if model == "add" else None)
        return (_scan_chunk(pk, n, model, cs_d, U_split, sh_d, ysc_d, lmm2, rows),)

    def chunk(sub):
        trace.count("lowrank.superblocks")
        lg, beta, se, ml, ssq = scan_resident(sub, block, dev, mesh, compute, mean=False)[0]
        pwald = jstats.pwald_from_beta_se(beta, se)
        if lmm2:
            plrt = jstats.plrt_from_ml(ml, null.ml)
            beta, se, pwald, plrt = finalize_invalid(beta, se, pwald, ssq, plrt)
            return [ScanResult(sites=sub.sites, af=sub.af, miss=sub.miss, beta=beta,
                               se=se, pwald=pwald, plrt=plrt, lbd=10.0 ** lg, ml=ml,
                               extras=extras)]
        beta, se, pwald, _ = finalize_invalid(beta, se, pwald, ssq)
        return [ScanResult(sites=sub.sites, af=sub.af, miss=sub.miss, beta=beta,
                           se=se, pwald=pwald, extras=extras)]

    sb = lattice_superblock(n, grid_points, block, superblock)
    return stream(pg, sb, block, chunk, mesh)[0], null
