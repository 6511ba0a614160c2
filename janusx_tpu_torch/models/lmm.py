"""Exact per-SNP REML LMM scans, ``-lmm`` / ``-lmm2``, single and
multi-trait, grid and brent methods (port of janusx_tpu/models/lmm.py).

Grid method (the default). Over each resident superblock of SNPs the scan
runs the two hand-written kernels (ops.kernels) once each, for all the
traits it scans: K1 decodes the packed genotypes and rotates them into the
GRM eigenbasis (the rotation is the same for every trait), K2 evaluates
the profiled -REML of every trait on the shared λ lattice in one launch
(the reference loops over traits, lmm.py:578-591). Then ``argmin_parabolic``
picks each λ*, the f32 final grams are formed at λ* trait by trait, and one
f64 Schur epilogue over (T, m) gives beta/se (and, for ``lmm2``, the ML
loglik) and the device Wald p — the reference's lattice route. For p > 4
covariate columns (beyond the lattice kernel) each SNP block goes K1 ->
``lmm_grid_scan_with`` per trait instead, as the reference does.

Brent method (``method="brent"``, lmm.py:51-73, 482-507): per SNP block K1
rotates (f32, then f64), and a lockstep f64 Brent over log10 λ, warm-started
at λ_null, optimizes the per-SNP REML; beta/se (and ML) come at the optimum.

With a device mesh (parallel.mesh) the grid method shards every resident
superblock: each shard launches K1 and K2 on its slice on its own device
(janusx_tpu's ``shard_map`` scans, lmm.py:241, 633); brent runs on one
device, as the reference's does.

What no trait changes is built once per design, (basis, covariates,
device), in core.reml, and K2's split W here; ``_scan_state`` caches a
trait's own pieces. The T traits of ``lmm_scan_multi`` share one design.

Spans (utils.trace): ``fit_null``; ``rotate_y``, a trait's rotated state,
made once; ``lmm_scan``, the route; ``results``, a chunk's host epilogue.
models.superblocks opens the chunks' own.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.core import stats as jstats
from janusx_tpu_torch.core.reml import (
    NullFit,
    RotatedData,
    argmin_parabolic,
    beta_se_snp_batch,
    final_grams_f32,
    final_stats_from_grams,
    fit_null_reml,
    fit_null_reml_multi,
    grid_shared,
    lmm_grid_scan_with,
    make_grid,
    make_rotated,
    ml_snp_batch,
    neg_reml_snp_batch,
)
from janusx_tpu_torch.core.spectral import SpectralBasis
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.models.scan_common import ScanResult, finalize_invalid
from janusx_tpu_torch.models.superblocks import replicas, scan_resident, stream
from janusx_tpu_torch.ops import kernels
from janusx_tpu_torch.ops.brent import brent_minimize_batched
from janusx_tpu_torch.parallel.mesh import home_device
from janusx_tpu_torch.utils import devcache, trace

f32, f64 = torch.float32, torch.float64

# largest covariate count (intercept included) the lattice kernel takes
_LATTICE_MAX_P = 4

# -log10 p beyond which the device f32 erfc has underflowed: recompute
# those (few) lanes exactly on host.
_PWALD_F32_FLOOR = 1e-30

# default cap on the SNPs resident on the device per host chunk
_SUPERBLOCK = 1 << 20


def _lattice_operands(sh, rot: RotatedData):
    """(W (G, n), YX (1+p, n), SH) f32 operands of the λ-lattice kernel for
    one trait; the SH row layout is ops.kernels.pack_sh's."""
    YX = torch.cat([rot.yr[None, :], rot.Xr.T], dim=0).to(f32).contiguous()
    SH = kernels.pack_sh(sh.Ar_inv32, sh.Ainv_axy32, sh.Axx32, sh.axy32,
                         sh.ayy32, sh.logdetAr32, sh.logdetV32)
    return sh.w32.contiguous(), YX, SH


def _lattice_operands_multi(shs, rots):
    """The kernel's operands for T traits that share the eigenbasis, the
    covariates and the grid. W (G, n) and the Xr rows are trait 0's: on
    the main path the design's, one set of objects (core.reml); states
    carried in from elsewhere must hold equal values. YX (T + p, n) stacks
    the T yr rows over the Xr rows, SH (T, R, G) each trait's rows."""
    YX = torch.cat([torch.stack([rot.yr for rot in rots]), rots[0].Xr.T]).to(f32)
    SH = torch.stack([_lattice_operands(sh, rot)[2] for sh, rot in zip(shs, rots)])
    return shs[0].w32.contiguous(), YX.contiguous(), SH


def lattice_superblock(n: int, grid_points: int, block: int,
                       superblock: int = _SUPERBLOCK, traits: int = 1) -> int:
    """SNPs per resident chunk of the grid route. It carries Gr (m, n) f32
    and the (T, m, G) lattice in device memory, so the chunk is bounded to
    ~2 GB of carry (the reference's formula, janusx_tpu/models/lmm.py:
    407-412, with the T lattices counted) and rounded down to whole
    blocks."""
    N2 = (-(-n // 256)) * 256
    cap = (2 << 30) // ((N2 + traits * grid_points) * 4)
    return max(min(superblock, (cap // block) * block), block)


def _grid_resident(pk, mn, U32, U_split, rots, shs, n: int, with_ml: bool,
                   rot_prec: str, lattice, grid_prec: str):
    """Grid scan of T traits on pre-blocked (nblk, B, nb) packed rows;
    ``lattice`` = (W, YX, SH, W_split), K2's operands made once per scan
    (None for p > 4). Returns (beta, se, pwald, log10 λ*, ml), each (T, nblk*B)
    f64."""
    T, p = len(rots), rots[0].p
    nblk, B = mn.shape
    M = nblk * B
    if p <= _LATTICE_MAX_P:
        # one launch of each kernel over the whole resident chunk and every
        # trait: a single 2048-row block leaves a quarter of the card idle
        # (csrc/rotate.cu)
        W, YX, SH, W_split = lattice
        Gr = kernels.decode_rotate(pk.reshape(M, -1), mn.reshape(-1), U32,
                                   prec=rot_prec, U_split=U_split, row_align=4)
        neg = kernels.grid_neg_reml_lattice(Gr, W, YX, SH, p=p,
                                            ridge=config.GRAM_RIDGE, nf=float(n),
                                            prec=grid_prec, W_split=W_split)
        lgs = argmin_parabolic(neg.reshape(T * M, -1), shs[0].grid_lg).reshape(T, M)
        del neg
    else:
        Grs, lg_parts = [], []
        for i in range(nblk):
            Gr_b = kernels.decode_rotate(pk[i], mn[i], U32, prec=rot_prec,
                                         U_split=U_split)
            lg_parts.append(torch.stack([lmm_grid_scan_with(sh, rot, Gr_b)
                                         for sh, rot in zip(shs, rots)]))
            Grs.append(Gr_b)
        Gr, lgs = torch.cat(Grs), torch.cat(lg_parts, dim=1)
    ssq = torch.sum(Gr * Gr, dim=-1)
    # the final grams depend on each trait's λ*: formed trait by trait (a
    # (T, m, n) weight tensor would not fit), then one f64 epilogue
    grams = [final_grams_f32(rot, Gr, lgs[t], with_ml) for t, rot in enumerate(rots)]
    A1, A2, agg, ldV = (torch.cat(x) for x in zip(*grams))
    beta, se, ml = (x.reshape(T, M) for x in
                    final_stats_from_grams(n, p, A1, A2, agg, with_ml, ldV))
    # monomorphic/degenerate lanes (reference rules, src/math/linalg.rs:99-108)
    bad = ~torch.isfinite(beta) | ~torch.isfinite(se) | (se <= 0) | (ssq <= 1e-12)
    nan = torch.full_like(beta, float("nan"))
    beta = torch.where(bad, nan, beta)
    se = torch.where(bad, nan, se)
    return beta, se, jstats.pwald_from_beta_se_device(beta, se), lgs, ml


def _result(pg, null: NullFit, beta, se, pwald, ssq, lmm2: bool, lbd, ml) -> ScanResult:
    """One trait's ScanResult with the reference's invalid-row rule; the
    ``lmm2`` route adds lambda/ml/plrt (janusx_tpu/models/lmm.py:519-532)."""
    if lmm2:
        plrt = jstats.plrt_from_ml(ml, null.ml)
        beta, se, pwald, plrt = finalize_invalid(beta, se, pwald, ssq, plrt)
        return ScanResult(
            sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se,
            pwald=pwald, plrt=plrt, lbd=lbd, ml=ml,
            extras={"lambda_null": null.lbd, "ml_null": null.ml})
    beta, se, pwald, _ = finalize_invalid(beta, se, pwald, ssq)
    return ScanResult(sites=pg.sites, af=pg.af, miss=pg.miss, beta=beta, se=se,
                      pwald=pwald, extras={"lambda_null": null.lbd})


def _basis_operands(basis: SpectralBasis, dev):
    """U f32 and K1's bf16 pieces of U, made once per basis and device (the
    shards of one device share them)."""
    U32 = devcache.to_device(basis.U, f32, dev)
    U_split = devcache.derived(basis.U, "u_split", dev, lambda: kernels.split_u(U32))
    return U32, U_split


def _grid_scan(pg, basis: SpectralBasis, states, nulls, block: int, lmm2: bool,
               superblock: int, dev, mesh=None) -> list[ScanResult]:
    """Grid scan of the traits in ``states`` [(rot, grid_lg, sh)], one
    ScanResult each; superblocks are capped so the T lattices fit. With
    ``mesh`` every shard launches K1 and K2 on its slice of each superblock
    (janusx_tpu's _lmm_scan_sharded / _lmm_scan_sharded_multi)."""
    rot_prec = config.choice_knob("JX_TPU_ROTATE_PREC", kernels.ROTATE_PRECS)
    # the lattice's gram precision, read by both the single-trait and the
    # trait-level scan as the reference reads it (lmm.py:387, 725)
    grid_prec = config.choice_knob("JX_TPU_GRID_MXU_PREC", kernels.GRID_PRECS)
    rots = [s[0] for s in states]
    shs = [s[2] for s in states]
    T, n = len(states), pg.n
    block = min(block, pg.m) if pg.m else block
    lattice = None
    if rots[0].p <= _LATTICE_MAX_P:
        # K2's operands, the same for every superblock: W's bf16 pieces
        # (the card's B operand) are split once per design, grid and device
        W, YX, SH = _lattice_operands_multi(shs, rots)
        lattice = (W, YX, SH, devcache.derived(W, "w_split", W.device,
                                               lambda: kernels.split_w(W)))
    reps = replicas((rots, shs, lattice), mesh)

    def compute(i, pk, mn, d):
        rots_d, shs_d, lattice_d = reps[i]
        beta, se, pw, lgs, ml = _grid_resident(pk, mn, *_basis_operands(basis, d), rots_d,
                                               shs_d, n, lmm2, rot_prec, lattice_d, grid_prec)
        # one f32 stack to the host, as the reference ships it; λ* and ml
        # only on the lmm2 route (lmm.py:474-479)
        out = torch.stack([beta.to(f32), se.to(f32), pw.to(f32)])
        return (out, lgs.to(f32), ml) if lmm2 else (out, None, None)

    def chunk(pg):
        m = pg.m
        out, lgs, ml = scan_resident(pg, block, dev, mesh, compute)
        with trace.span("results"):
            out = out.astype(np.float64)
            if lmm2:
                lbd = 10.0 ** lgs.astype(np.float64)
            res = []
            for t in range(T):
                beta_t, se_t, pwald = out[0, t], out[1, t], out[2, t]
                # device f32 erfc is exact to ~1e-7 relative; lanes at/below
                # the f32 underflow floor get the exact host value
                tiny = pwald <= _PWALD_F32_FLOOR
                if tiny.any():
                    pwald = pwald.copy()
                    pwald[tiny] = jstats.pwald_from_beta_se(beta_t[tiny], se_t[tiny])
                # degenerate lanes are already sanitized on the device
                res.append(_result(pg, nulls[t], beta_t, se_t, pwald, np.ones(m), lmm2,
                                   lbd[t] if lmm2 else None, ml[t] if lmm2 else None))
            return res

    grid_points = shs[0].grid_lg.shape[0]
    return stream(pg, lattice_superblock(n, grid_points, block, superblock, T),
                  block, chunk, mesh)


def _brent_scan(pg, basis: SpectralBasis, rot: RotatedData, null: NullFit,
                block: int, lmm2: bool, superblock: int, dev) -> ScanResult:
    """Per-SNP lockstep Brent, one SNP block at a time (the reference's
    cross-check path, janusx_tpu/models/lmm.py:51-73, 482-507)."""
    block = min(block, pg.m) if pg.m else block
    init = torch.full((block,), null.log10_lbd, dtype=f64, device=dev)

    def compute(i, pk, mn, d):
        U32, U_split = _basis_operands(basis, d)
        parts = []
        for b in range(pk.shape[0]):
            # K1 computes the reference's f32 decode @ U (HIGHEST); the
            # objective is f64
            Gr = kernels.decode_rotate(pk[b], mn[b], U32, U_split=U_split).to(f64)
            lgs, _ = brent_minimize_batched(
                lambda lg: neg_reml_snp_batch(lg, rot, Gr),
                config.LOG10_LAMBDA_LOW, config.LOG10_LAMBDA_HIGH,
                config.SCAN_BRENT_TOL, config.SCAN_BRENT_MAX_ITER, init_x=init)
            beta, se = beta_se_snp_batch(lgs, rot, Gr)
            ml = ml_snp_batch(lgs, rot, Gr) if lmm2 else torch.zeros_like(lgs)
            parts.append(torch.stack([lgs, beta, se, ml, torch.sum(Gr * Gr, dim=-1)]))
        return (torch.cat(parts, dim=1),)

    def chunk(pg):
        lgs, beta, se, ml, ssq = scan_resident(pg, block, dev, None, compute)[0]
        pwald = jstats.pwald_from_beta_se(beta, se)
        return [_result(pg, null, beta, se, pwald, ssq, lmm2,
                        10.0 ** lgs if lmm2 else None, ml if lmm2 else None)]

    return stream(pg, superblock, block, chunk)[0]


# Per-trait scan state cache: rotated data + λ-grid shared pieces stay on
# the device across repeated scans of the same (basis, y, cov, device).
_state_cache: dict = {}
_STATE_CACHE_MAX = 8


def _scan_state(basis: SpectralBasis, y: np.ndarray, covariates,
                grid_points: int, device: torch.device):
    # strong digests, not hash(): a collision would silently serve one
    # trait's rotated data to another
    key = (id(basis.U), devcache.digest(y), devcache.digest(covariates), grid_points,
           str(device))
    hit = _state_cache.get(key)
    if hit is not None:
        return hit
    with trace.span("rotate_y"):
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


@trace.spanned("fit_null")
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


@trace.spanned("lmm_scan")
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
    if method == "brent" and mesh is not None:
        import warnings

        warnings.warn(
            "lmm_scan(method='brent') runs single-device; the mesh argument "
            "is ignored on this path (use method='grid' for sharded scans)",
            stacklevel=2)
        mesh = None
    dev = home_device(mesh, device)
    if grid_points is None:
        grid_points = config.knob("JX_TPU_GRID_POINTS")
    y = np.asarray(y, np.float64).reshape(-1)
    state = _scan_state(basis, y, covariates, grid_points, dev)
    if null is None:
        null = fit_null_reml(state[0])
    if method == "brent":
        return _brent_scan(pg, basis, state[0], null, block, lmm2, superblock, dev), null
    return _grid_scan(pg, basis, [state], [null], block, lmm2, superblock, dev,
                      mesh)[0], null


@trace.spanned("lmm_scan")
def lmm_scan_multi(
    pg: PackedGenotypes,
    basis: SpectralBasis,
    Y: np.ndarray,
    covariates: np.ndarray | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    lmm2: bool = False,
    grid_points: int | None = None,
    mesh=None,
    superblock: int = _SUPERBLOCK,
    _prepared=None,
    device=None,
) -> tuple[list[ScanResult], list[NullFit]]:
    """Grid LMM scan of the columns of Y, traits sharing one sample mask,
    basis and covariates: per resident superblock one K1 launch for all
    traits and one trait-axis K2 launch. Each trait's result is the one
    ``lmm_scan`` gives it. ``_prepared`` = ([(rot, grid_lg, sh)], [NullFit])
    per trait, computed here when None."""
    dev = home_device(mesh, device)
    Y = np.asarray(Y, np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    if Y.shape[0] != pg.n:
        raise ValueError(f"Y rows {Y.shape[0]} != samples {pg.n}")
    if grid_points is None:
        grid_points = config.knob("JX_TPU_GRID_POINTS")
    # per-trait rotations/null fits are SNP-independent: computed once and
    # carried through the superblocks; the traits share one design (s and
    # PXX), so their null fits are one launch on a card
    if _prepared is None:
        states = [_scan_state(basis, Y[:, t].copy(), covariates, grid_points, dev)
                  for t in range(Y.shape[1])]
        nulls = fit_null_reml_multi([rot for rot, _, _ in states])
    else:
        states, nulls = _prepared
    return _grid_scan(pg, basis, states, nulls, block, lmm2, superblock, dev,
                      mesh), nulls
