"""Distribution tails and p-value sanitization.

P-value rules mirror the reference exactly
(JanusX src/math/linalg.rs:99-108 sanitize; src/stats/lmm.rs
pwald = 2*normal_sf(|beta/se|) clamped to [f64::MIN_POSITIVE, 1]):

- non-finite beta/se or se<=0  ->  p = 1.0
- finite p clamped to [DBL_MIN, 1.0]

The numpy functions are copies of janusx_tpu/core/stats.py; the device
Wald p is its torch counterpart (f32 erfc, as the reference runs it).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import special as sp_special

_DBL_MIN = np.finfo(np.float64).tiny


# ---------------------------------------------------------------- numpy side
def normal_sf(z: np.ndarray) -> np.ndarray:
    return 0.5 * sp_special.erfc(np.asarray(z) / np.sqrt(2.0))


def chi2_sf_df1(x: np.ndarray) -> np.ndarray:
    return sp_special.erfc(np.sqrt(np.maximum(np.asarray(x), 0.0) / 2.0))


def pwald_from_beta_se(beta: np.ndarray, se: np.ndarray) -> np.ndarray:
    """2-sided Wald p with reference sanitize rules."""
    beta = np.asarray(beta, dtype=np.float64)
    se = np.asarray(se, dtype=np.float64)
    ok = np.isfinite(beta) & np.isfinite(se) & (se > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.abs(beta / np.where(ok, se, 1.0))
    p = 2.0 * normal_sf(z)
    p = np.clip(p, _DBL_MIN, 1.0)
    return np.where(ok & np.isfinite(p), p, 1.0)


def sanitize_pvalue(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64)
    return np.where(np.isfinite(p), np.clip(p, _DBL_MIN, 1.0), 1.0)


def plrt_from_ml(ml: np.ndarray, null_ml: float) -> np.ndarray:
    """LRT p from per-SNP ML loglik vs null ML (reference src/stats/lmm.rs:186)."""
    stat = 2.0 * (np.asarray(ml, dtype=np.float64) - null_ml)
    stat = np.where(np.isfinite(stat) & (stat > 0), stat, 0.0)
    p = chi2_sf_df1(stat)
    return np.where(np.isfinite(np.asarray(ml, dtype=np.float64)), p, 1.0)


# ---------------------------------------------------------------- torch side
def pwald_from_beta_se_device(beta: torch.Tensor, se: torch.Tensor) -> torch.Tensor:
    """Device Wald p (f64 out) with the reference sanitize rules.

    The erfc runs in f32, as in the reference; lanes whose p underflows
    f32 are recomputed on the host by the caller (models.lmm
    _PWALD_F32_FLOOR)."""
    f32, f64 = torch.float32, torch.float64
    beta = beta.to(f64)
    se = se.to(f64)
    ok = torch.isfinite(beta) & torch.isfinite(se) & (se > 0)
    z = torch.abs(beta / torch.where(ok, se, torch.ones_like(se))).to(f32)
    sqrt2 = torch.sqrt(torch.tensor(2.0, dtype=f32, device=z.device))
    p = (2.0 * (0.5 * torch.special.erfc(z / sqrt2))).to(f64)
    p = torch.clamp(p, _DBL_MIN, 1.0)
    return torch.where(ok & torch.isfinite(p), p, torch.ones_like(p))
