"""Measured CPU baseline for bench.py (native/jxbaseline.cpp bindings).

Runs a faithful reproduction of the reference's exact-LMM scan loop
(per-SNP warm-started Brent, tol 1e-2 / max 50 iterations —
JanusX src/stats/lmm.rs:334,1480; REML objective reml.rs:255;
final beta/se reml.rs:472) on the host CPU with row-parallel threads,
so ``vs_baseline`` divides by a MEASUREMENT on this machine instead of
an analytic estimate. Built on demand with g++ like the other native
helpers; callers must handle ``available() == False``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("janusx_tpu.baseline")

from janusx_tpu_torch.utils.nativelib import locate as _locate_native

_SRC, _SO = _locate_native("jxbaseline")
_lock = threading.Lock()
_lib = None
_tried = False

# reference per-SNP scan Brent settings (lmm.rs:334,1480)
SCAN_TOL = 1e-2
SCAN_MAX_ITER = 50


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
             "-o", _SO, "-lpthread"],
            check=True, capture_output=True, timeout=120,
        )
        return True
    except Exception as e:
        log.debug("baseline build failed: %s", e)
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        have_src = os.path.exists(_SRC)
        if not os.path.exists(_SO) or (
            have_src and os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        ):
            if (not have_src or not _build()) and not os.path.exists(_SO):
                return None  # stale-but-present .so still loads below
        try:
            lib = ctypes.CDLL(_SO)
            lib.jx_baseline_lmm_scan.restype = None
            lib.jx_baseline_lmm_scan.argtypes = [
                ctypes.POINTER(ctypes.c_double),  # S
                ctypes.POINTER(ctypes.c_double),  # Xr
                ctypes.POINTER(ctypes.c_double),  # yr
                ctypes.POINTER(ctypes.c_float),   # Gr
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,  # m, n, p
                ctypes.c_double, ctypes.c_int,    # lg_init, n_threads
                ctypes.c_double, ctypes.c_int,    # tol, max_iter
                ctypes.c_double, ctypes.c_double,  # low, high
                ctypes.POINTER(ctypes.c_double),  # out_lg
                ctypes.POINTER(ctypes.c_double),  # out_beta
                ctypes.POINTER(ctypes.c_double),  # out_se
            ]
            _lib = lib
        except (OSError, AttributeError) as e:
            log.debug("baseline load failed: %s", e)
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def baseline_scan(
    basis,
    y: np.ndarray,
    Gc: np.ndarray,
    covariates: np.ndarray | None = None,
    lg_init: float | None = None,
    n_threads: int | None = None,
):
    """Reference-loop scan: rotate (BLAS sgemm, timed by the caller) is
    NOT included here — pass pre-centered genotypes ``Gc`` (m, n) and this
    rotates + scans, returning (lg, beta, se).

    ``basis``: core.spectral.SpectralBasis of the analysis-subset GRM.
    """
    from janusx_tpu_torch import config

    lib = _load()
    if lib is None:
        raise RuntimeError("native baseline unavailable (no g++?)")
    n = basis.n
    ones = np.ones((n, 1))
    X = ones if covariates is None else np.concatenate(
        [ones, np.asarray(covariates, np.float64)], axis=1)
    Xr = np.ascontiguousarray(basis.U.T @ X)
    yr = np.ascontiguousarray(
        basis.U.T @ np.asarray(y, np.float64).reshape(-1))
    S = np.ascontiguousarray(basis.S, np.float64)
    if lg_init is None:
        from janusx_tpu_torch.core.reml import fit_null_reml_host

        null, _, _ = fit_null_reml_host(S, Xr, yr)
        lg_init = null.log10_lbd
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    # the reference rotates f32 genotype blocks via sgemm (lmm.rs hot loop)
    Gr = np.ascontiguousarray(
        np.asarray(Gc, np.float32) @ basis.U.astype(np.float32))
    m = Gr.shape[0]
    out_lg = np.empty(m)
    out_beta = np.empty(m)
    out_se = np.empty(m)
    pd = ctypes.POINTER(ctypes.c_double)
    lib.jx_baseline_lmm_scan(
        S.ctypes.data_as(pd), Xr.ctypes.data_as(pd), yr.ctypes.data_as(pd),
        Gr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        m, n, X.shape[1], float(lg_init), int(n_threads),
        SCAN_TOL, SCAN_MAX_ITER,
        config.LOG10_LAMBDA_LOW, config.LOG10_LAMBDA_HIGH,
        out_lg.ctypes.data_as(pd), out_beta.ctypes.data_as(pd),
        out_se.ctypes.data_as(pd),
    )
    return out_lg, out_beta, out_se
