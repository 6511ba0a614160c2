"""Jacobi-preconditioned conjugate gradient on tensors (port of
janusx_tpu/ops/cg.py).

The reference runs the whole solve as one ``lax.while_loop`` on the
device. Here the iterations are eager torch ops on b's device, and the
host reads the reference's loop condition (``it < max_iter`` and
``||r|| / ||b|| > tol``) before each iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class CgResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor
    rel_res: torch.Tensor


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    diag_precond: torch.Tensor | None = None,
    tol: float = 1e-8,
    max_iter: int = 500,
    x0: torch.Tensor | None = None,
) -> CgResult:
    """Solve A x = b for SPD A; all state stays on b's device."""
    minv = 1.0 / diag_precond if diag_precond is not None else torch.ones_like(b)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x)
    z = minv * r
    p = z
    rz = torch.dot(r, z)
    bnorm = torch.linalg.norm(b)
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    it = 0
    while it < max_iter and bool(torch.linalg.norm(r) / bnorm > tol):
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = minv * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return CgResult(x=x, iters=torch.tensor(it), rel_res=torch.linalg.norm(r) / bnorm)
