"""Exact per-SNP REML LMM scan, grid method, single trait (port of
janusx_tpu/models/lmm.py:lmm_scan).

Over each resident superblock of SNPs the scan runs the two hand-written
kernels (ops.kernels) once each: K1 decodes the packed genotypes and
rotates them into the GRM eigenbasis, K2 evaluates the profiled -REML on
the shared λ lattice. Then ``argmin_parabolic`` picks λ*, the f32 final
grams are formed at λ*, and the f64 Schur epilogue gives beta/se and the
device Wald p — the reference's lattice route. For p > 4 covariate
columns (beyond the lattice kernel) each SNP block goes K1 ->
``lmm_grid_scan_with`` instead, as the reference does.
"""

from __future__ import annotations

import hashlib
import weakref

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.core import stats as jstats
from janusx_tpu_torch.core.reml import (
    NullFit,
    RotatedData,
    argmin_parabolic,
    final_grams_f32,
    final_stats_from_grams,
    fit_null_reml,
    grid_shared,
    lmm_grid_scan_with,
    make_grid,
    make_rotated,
)
from janusx_tpu_torch.core.spectral import SpectralBasis
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.models.scan_common import ScanResult, finalize_invalid
from janusx_tpu_torch.ops import kernels
from janusx_tpu_torch.utils import devcache

f32 = torch.float32

# largest covariate count (intercept included) the lattice kernel takes
_LATTICE_MAX_P = 4

# -log10 p beyond which the device f32 erfc has underflowed: recompute
# those (few) lanes exactly on host.
_PWALD_F32_FLOOR = 1e-30

# default cap on the SNPs resident on the device per host chunk
_SUPERBLOCK = 1 << 20


def _lattice_operands(sh, rot: RotatedData):
    """(W (G, n), YX (1+p, n), SH) f32 operands of the λ-lattice kernel;
    the SH row layout is ops.kernels.pack_sh's."""
    YX = torch.cat([rot.yr[None, :], rot.Xr.T], dim=0).to(f32).contiguous()
    SH = kernels.pack_sh(sh.Ar_inv32, sh.Ainv_axy32, sh.Axx32, sh.axy32,
                         sh.ayy32, sh.logdetAr32, sh.logdetV32)
    return sh.w32.contiguous(), YX, SH


def lattice_superblock(n: int, grid_points: int, block: int,
                       superblock: int = _SUPERBLOCK) -> int:
    """SNPs per resident chunk of the lattice route. It carries Gr (m, n)
    f32 and the (m, G) lattice in device memory, so the chunk is bounded to
    ~2 GB of carry (the reference's formula, janusx_tpu/models/lmm.py:
    407-412) and rounded down to whole blocks."""
    N2 = (-(-n // 256)) * 256
    cap = (2 << 30) // ((N2 + grid_points) * 4)
    return max(min(superblock, (cap // block) * block), block)


def _lmm_scan_resident(pk, mn, U32, U_split, rot: RotatedData, sh, n: int,
                       rot_prec: str):
    """Whole resident-chunk scan on pre-blocked (nblk, B, nb) packed rows.
    Returns (beta, se, pwald) f64 tensors of nblk*B lanes."""
    p = rot.p
    nblk, B = mn.shape
    if p <= _LATTICE_MAX_P:
        # one launch of each kernel over the whole resident chunk: a single
        # 2048-row block leaves a quarter of the card idle (csrc/rotate.cu)
        W, YX, SH = _lattice_operands(sh, rot)
        Gr = kernels.decode_rotate(pk.reshape(nblk * B, -1), mn.reshape(-1), U32,
                                   prec=rot_prec, U_split=U_split)
        neg = kernels.grid_neg_reml_lattice(Gr, W, YX, SH, p=p,
                                            ridge=config.GRAM_RIDGE, nf=float(n))
        lgs = argmin_parabolic(neg, sh.grid_lg)
        ssq = torch.sum(Gr * Gr, dim=-1)
        A1, A2, agg, ldV = final_grams_f32(rot, Gr, lgs, False)
    else:
        parts = []
        for i in range(nblk):
            Gr32 = kernels.decode_rotate(pk[i], mn[i], U32, prec=rot_prec,
                                         U_split=U_split)
            lgs_b = lmm_grid_scan_with(sh, rot, Gr32)
            parts.append(final_grams_f32(rot, Gr32, lgs_b, False)
                         + (torch.sum(Gr32 * Gr32, dim=-1),))
        A1, A2, agg, ldV, ssq = (torch.cat(x) for x in zip(*parts))
    beta, se, _ = final_stats_from_grams(n, p, A1, A2, agg, False, ldV)
    # monomorphic/degenerate lanes (reference rules, src/math/linalg.rs:99-108)
    bad = ~torch.isfinite(beta) | ~torch.isfinite(se) | (se <= 0) | (ssq <= 1e-12)
    nan = torch.full_like(beta, float("nan"))
    beta = torch.where(bad, nan, beta)
    se = torch.where(bad, nan, se)
    return beta, se, jstats.pwald_from_beta_se_device(beta, se)


# Per-trait scan state cache: rotated data + λ-grid shared pieces stay on
# the device across repeated scans of the same (basis, y, cov, device).
_state_cache: dict = {}
_STATE_CACHE_MAX = 8


def _scan_state(basis: SpectralBasis, y: np.ndarray, covariates,
                grid_points: int, device: torch.device):
    # strong digests, not hash(): a collision would silently serve one
    # trait's rotated data to another
    key = (
        id(basis.U),
        hashlib.blake2b(y.tobytes(), digest_size=16).digest(),
        None if covariates is None else hashlib.blake2b(
            np.ascontiguousarray(covariates).tobytes(), digest_size=16).digest(),
        grid_points,
        str(device),
    )
    hit = _state_cache.get(key)
    if hit is not None:
        return hit
    rot = make_rotated(basis, y, covariates, device=device)
    grid_lg = make_grid(grid_points, device)
    sh = grid_shared(rot, grid_lg)
    state = (rot, grid_lg, sh)
    try:
        # id(basis.U) is unique only while basis.U lives: evict on GC
        weakref.finalize(basis.U, _state_cache.pop, key, None)
    except TypeError:
        return state  # not weakref-able: don't cache at all
    if len(_state_cache) >= _STATE_CACHE_MAX:
        _state_cache.pop(next(iter(_state_cache)))
    _state_cache[key] = state
    return state


def fit_null(basis: SpectralBasis, y: np.ndarray, covariates=None,
             grid_points: int | None = None, device=None) -> NullFit:
    """Null REML fit of one trait on the device, sharing lmm_scan's
    cached rotated state (pass the result to lmm_scan as ``null``)."""
    if grid_points is None:
        grid_points = config.knob("JX_TPU_GRID_POINTS")
    y = np.asarray(y, np.float64).reshape(-1)
    rot, _, _ = _scan_state(basis, y, covariates, grid_points,
                            config.resolve_device(device))
    return fit_null_reml(rot)


def lmm_scan(
    pg: PackedGenotypes,
    basis: SpectralBasis,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    lmm2: bool = False,
    null: NullFit | None = None,
    method: str = "grid",
    grid_points: int | None = None,  # None = JX_TPU_GRID_POINTS (default 256)
    superblock: int = _SUPERBLOCK,  # SNPs resident on the device per host chunk
    mesh=None,
    device=None,
) -> tuple[ScanResult, NullFit]:
    """Exact LMM scan over all SNPs of the (subset) packed genotypes."""
    if method not in ("grid", "brent"):
        raise ValueError(
            f"unknown lmm scan method {method!r} (expected 'grid' or 'brent')")
    if method == "brent":
        raise NotImplementedError(
            "lmm_scan(method='brent') is not ported yet (ROADMAP queue 1, "
            "item 12: method='brent')")
    if lmm2:
        raise NotImplementedError(
            "lmm_scan(lmm2=True) is not ported yet (ROADMAP queue 1, "
            "item 10: lmm2)")
    if mesh is not None:
        raise NotImplementedError(
            "SNP-sharded scans are not ported yet (ROADMAP queue 1, item 23)")
    dev = config.resolve_device(device)
    rot_prec = config.choice_knob("JX_TPU_ROTATE_PREC", kernels.ROTATE_PRECS)
    if grid_points is None:
        grid_points = config.knob("JX_TPU_GRID_POINTS")
    y = np.asarray(y, np.float64).reshape(-1)
    n = pg.n
    rot, _, sh = _scan_state(basis, y, covariates, grid_points, dev)
    if null is None:
        null = fit_null_reml(rot)

    m = pg.m
    block = min(block, m) if m else block
    superblock = min(superblock, getattr(pg, "max_resident_snps", superblock))
    if rot.p <= _LATTICE_MAX_P:
        superblock = lattice_superblock(n, grid_points, block, superblock)
    if m > superblock:
        # streaming superblocks: host IO of chunk k+1 overlaps chunk k
        from janusx_tpu_torch.utils.prefetch import prefetch_one_ahead

        sb = max((superblock // block) * block, block)
        spans = [(s0, min(s0 + sb, m)) for s0 in range(0, m, sb)]
        parts = []
        for sub in prefetch_one_ahead(
                spans, lambda se: pg.take_snps(np.arange(se[0], se[1]))):
            r, null = lmm_scan(sub, basis, y, covariates, block=block,
                               null=null, grid_points=grid_points, device=dev)
            parts.append(r)
        return ScanResult.concat(parts), null
    if not hasattr(pg, "packed"):  # lazy input small enough: materialize
        pg = pg.take_snps(np.arange(m))
    m_pad = -(-m // block) * block
    nblk = m_pad // block
    pk = devcache.device_packed_blocks(pg, (nblk, block), dev)
    mn = devcache.to_device_blocks(pg.mean, (nblk, block), 0.0, f32, dev)
    U32 = devcache.to_device(basis.U, f32, dev)
    # K1's bf16 pieces of U, made once per basis and device
    U_split = devcache.derived(basis.U, "u_split", dev, lambda: kernels.split_u(U32))
    beta_d, se_d, pw_d = _lmm_scan_resident(pk, mn, U32, U_split, rot, sh, n,
                                            rot_prec)
    # one f32 stack to the host, as the reference ships it
    out = torch.stack([beta_d.to(f32), se_d.to(f32), pw_d.to(f32)])
    out = out.cpu().numpy().astype(np.float64)[:, :m]
    beta, se, pwald = out[0], out[1], out[2]
    # device f32 erfc is exact to ~1e-7 relative; lanes at/below the f32
    # underflow floor get the exact host value
    tiny = pwald <= _PWALD_F32_FLOOR
    if tiny.any():
        pwald = pwald.copy()
        pwald[tiny] = jstats.pwald_from_beta_se(beta[tiny], se[tiny])
    beta, se, pwald, _ = finalize_invalid(beta, se, pwald, np.ones(m))
    res = ScanResult(
        sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se,
        pwald=pwald, extras={"lambda_null": null.lbd},
    )
    return res, null
