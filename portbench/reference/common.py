"""Plain pieces the references share: decode of the raw 2-bit codes, the
QC and minor-allele rule, a tight bounded 1-D minimizer, the Wald p-value,
and the precision each reference step runs in.

A reference runs at ``prec="ref"``: float64 throughout. ``prec="low"`` is
the control: every step one precision below what the configuration
states (float64 steps in float32; float32 products with TF32 operands,
rounded here to 10 mantissa bits, summed in float32).
"""

from __future__ import annotations

import numpy as np
import scipy.optimize
import scipy.special
import torch

MISSING = 3
DBL_MIN = np.finfo(np.float64).tiny


def unpack(packed: np.ndarray, n: int, device) -> torch.Tensor:
    """(k, nb) host bytes -> (k, n) int16 codes on ``device``."""
    pk = torch.as_tensor(np.ascontiguousarray(packed), device=device)
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=device)
    return ((pk.unsqueeze(-1) >> shifts) & 3).reshape(pk.shape[0], -1)[:, :n].to(torch.int16)


def qc_rows(codes: torch.Tensor, maf: float, geno: float):
    """Per row: (keep, sign, alt frequency). ``sign`` is -1 where the drawn
    allele is the major one (the counted allele is always the minor)."""
    n = codes.shape[1]
    obs = codes != MISSING
    nm = obs.sum(dim=1).double()
    alt = torch.where(obs, codes, 0).sum(dim=1).double()
    p = alt / torch.clamp(2.0 * nm, min=1.0)
    minor = torch.where(p > 0.5, 1.0 - p, p)
    keep = (1.0 - nm / n <= geno) & (nm > 0) & (torch.minimum(minor, 1.0 - minor) >= maf)
    sign = torch.where(p > 0.5, -1.0, 1.0).double()
    return keep, sign, p


def centered(codes: torch.Tensor, p: torch.Tensor, dtype) -> torch.Tensor:
    """g - 2p with missing genotypes at 0."""
    x = codes.to(dtype) - (2.0 * p).to(dtype)[:, None]
    return torch.where(codes == MISSING, torch.zeros((), dtype=dtype, device=x.device), x)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10 mantissa bits (to nearest)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b for a step the configuration states in float32: float64 in
    the reference, TF32 operands summed in float32 in the control."""
    if prec == "ref":
        return a.double() @ b.double()
    return tf32(a.float()) @ tf32(b.float())


def minimize(f, low: float, high: float, points: int = 2001) -> float:
    """The minimum of f over [low, high]: the best of a dense grid, then a
    bounded Brent inside the neighbouring grid cells to 1e-11."""
    xs = np.linspace(low, high, points)
    fs = np.array([f(x) for x in xs])
    i = int(np.nanargmin(fs))
    a, b = xs[max(i - 1, 0)], xs[min(i + 1, points - 1)]
    res = scipy.optimize.minimize_scalar(f, bounds=(a, b), method="bounded",
                                         options={"xatol": 1e-11, "maxiter": 500})
    return float(res.x) if res.fun <= fs[i] else float(xs[i])


def pwald(beta: np.ndarray, se: np.ndarray) -> np.ndarray:
    """Two-sided Wald p, 1 where beta or se is not a valid number."""
    ok = np.isfinite(beta) & np.isfinite(se) & (se > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.abs(beta / np.where(ok, se, 1.0))
    p = np.clip(scipy.special.erfc(z / np.sqrt(2.0)), DBL_MIN, 1.0)
    return np.where(ok, p, 1.0)
