"""FvLMM: fixed-λ mixed-model scan (EMMAX-style, ``-fvlmm``; port of
janusx_tpu/models/fvlmm.py).

One REML null fit gives λ for the whole GWAS; each SNP is then a weighted
regression on the rotated scale (reference JanusX src/stats/fvlmm.rs:1-8):

    beta = (g'P y)/(g'P g),  se = sqrt((y'P y / df)/(g'P g)),  df = n-p-1
    P = W - W X (X'WX)^{-1} X'W,  W = diag(1/(s_i + λ))
    pwald = 2*Phi_bar(|beta/se|)  (fvlmm.rs:1774-1778)

Device step per resident superblock: K1 (ops.kernels.decode_rotate)
decodes and rotates every SNP row into the eigenbasis once — the
reference's f32 ``decode_centered @ U`` (HIGHEST), shared by every trait —
then each trait's weighted f32 grams are torch ops against its precomputed
P-pieces. One trait is the multi-trait scan with T = 1.
"""

from __future__ import annotations

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.core import stats as jstats
from janusx_tpu_torch.core.reml import NullFit, fit_null_reml, make_rotated
from janusx_tpu_torch.core.spectral import SpectralBasis
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.models.lmm import _basis_operands
from janusx_tpu_torch.models.scan_common import ScanResult, finalize_invalid
from janusx_tpu_torch.models.superblocks import replicas, scan_resident, stream
from janusx_tpu_torch.ops import kernels
from janusx_tpu_torch.parallel.mesh import home_device

f32 = torch.float32


def _trait_pieces(basis: SpectralBasis, y, covariates, null: NullFit | None, dev):
    """One trait's fixed-λ pieces: (null, w (n,), Xr (n, p), Cw (p, p),
    Py (n,), y'Py), the reference's host algebra (fvlmm.py:113-129)."""
    rot = make_rotated(basis, y, covariates, device=dev)
    if null is None:
        null = fit_null_reml(rot)
    p = rot.p
    w = 1.0 / (basis.S + null.lbd)
    Xr = rot.Xr.cpu().numpy()
    yr = rot.yr.cpu().numpy()
    XWX = Xr.T * w @ Xr + config.GRAM_RIDGE * np.eye(p)
    Cw = np.linalg.inv(XWX)
    XWy = Xr.T @ (w * yr)
    Py = w * yr - (w[:, None] * Xr) @ (Cw @ XWy)
    return null, w, Xr, Cw, Py, float(yr @ Py)


def _fvlmm(pg, basis, Y, covariates, block, nulls, superblock, dev, mesh=None):
    T, n = Y.shape[1], pg.n
    pieces = [_trait_pieces(basis, Y[:, t], covariates,
                            None if nulls is None else nulls[t], dev) for t in range(T)]
    nulls = [pc[0] for pc in pieces]
    Xr = pieces[0][2]
    p = Xr.shape[1]
    df = n - p - 1
    if df <= 0:
        raise ValueError("df <= 0 in fvlmm scan")
    t32 = lambda a: torch.as_tensor(np.asarray(a), dtype=f32, device=dev)
    W32, CW32, PY32 = (t32(np.stack([pc[i] for pc in pieces])) for i in (1, 3, 4))
    reps = replicas((W32, CW32, PY32, t32(Xr)), mesh)
    block = min(block, pg.m) if pg.m else block

    def compute(i, pk, mn, d):
        W32, CW32, PY32, X32 = reps[i]
        U32, U_split = _basis_operands(basis, d)
        Gr = kernels.decode_rotate(pk.reshape(-1, pk.shape[-1]), mn.reshape(-1), U32,
                                   U_split=U_split)
        gPy, gPg = [], []
        for t in range(T):
            wG = Gr * W32[t][None, :]
            XWg = wG @ X32
            gPy.append(Gr @ PY32[t])
            gPg.append(torch.sum(wG * Gr, dim=-1)
                       - torch.einsum("bp,pq,bq->b", XWg, CW32[t], XWg))
        return (torch.sum(Gr * Gr, dim=-1).double(), torch.stack(gPy).double(),
                torch.stack(gPg).double())

    def chunk(pg):
        ssq, gPys, gPgs = scan_resident(pg, block, dev, mesh, compute)
        res = []
        for t in range(T):
            gPy, gPg = gPys[t], gPgs[t]
            with np.errstate(divide="ignore", invalid="ignore"):
                beta = gPy / gPg
                se = np.sqrt((pieces[t][5] / df) / gPg)
            pwald = jstats.pwald_from_beta_se(beta, se)
            beta, se, pwald, _ = finalize_invalid(beta, se, pwald, ssq)
            res.append(ScanResult(
                sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se, pwald=pwald,
                extras={"lambda_null": nulls[t].lbd, "reml_null": nulls[t].reml}))
        return res

    return stream(pg, superblock, block, chunk, mesh), nulls


def fvlmm_scan(
    pg: PackedGenotypes,
    basis: SpectralBasis,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    null: NullFit | None = None,
    mesh=None,
    superblock: int = 1 << 20,
    device=None,
) -> tuple[ScanResult, NullFit]:
    """Fixed-λ scan. ``basis`` must be the eigh of the (ridged) GRM on the
    same sample subset as ``pg``."""
    y = np.asarray(y, np.float64).reshape(-1)
    res, nulls = _fvlmm(pg, basis, y[:, None], covariates, block,
                        None if null is None else [null], superblock,
                        home_device(mesh, device), mesh)
    return res[0], nulls[0]


def fvlmm_scan_multi(
    pg: PackedGenotypes,
    basis: SpectralBasis,
    Y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    mesh=None,
    superblock: int = 1 << 20,
    device=None,
) -> tuple[list[ScanResult], list[NullFit]]:
    """Batched fixed-λ scan for traits sharing one sample mask/basis: one
    K1 launch per superblock for all of them."""
    Y = np.asarray(Y, np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    if Y.shape[0] != pg.n:
        raise ValueError(f"Y rows {Y.shape[0]} != samples {pg.n}")
    return _fvlmm(pg, basis, Y, covariates, block, None, superblock,
                  home_device(mesh, device), mesh)
