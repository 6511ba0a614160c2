"""Batched lockstep Brent minimizer (port of janusx_tpu/ops/brent.py).

All lanes run the same Brent iteration together: the state is a batch of
(a, c, x, w, v, fx, fw, fv, e, done) tensors and the objective is
evaluated for the whole batch at once. Converged lanes freeze through
masking; the loop ends when every lane is done or max_iter is reached.

The bracket/parabolic logic follows the reference step for step,
including its quirk of leaving ``e`` untouched on accepted parabolic steps
(janusx_tpu/ops/brent.py:95-129), so optima match it to the tolerance.
"""

from __future__ import annotations

from typing import Callable

import torch

_GOLD = 0.3819660


def brent_minimize_batched(
    f: Callable[[torch.Tensor], torch.Tensor],
    low: float,
    high: float,
    tol: float,
    max_iter: int,
    batch_shape: tuple,
    device=None,
):
    """Minimize ``f`` elementwise over a batch of scalar lanes in [low, high],
    in float64, every lane starting at the interval's midpoint.

    f maps a (B,) tensor of positions to a (B,) tensor of objective values
    (each lane independent). Returns (x_best, f_best), both (B,)."""
    kw = dict(dtype=torch.float64, device=device)
    where = torch.where
    lo = torch.tensor(min(low, high), **kw)
    hi = torch.tensor(max(low, high), **kw)
    eps = torch.tensor(torch.finfo(torch.float64).eps, **kw)
    tol_ = torch.clamp(torch.tensor(abs(tol), **kw), min=1e-12)

    x0 = torch.full(batch_shape, float(0.5 * (lo + hi)), **kw)
    fx0 = f(x0)
    a = torch.full(batch_shape, float(lo), **kw)
    c = torch.full(batch_shape, float(hi), **kw)
    x, w, v = x0, x0, x0
    fx, fw, fv = fx0, fx0, fx0
    e = torch.zeros(batch_shape, **kw)
    done = torch.zeros(batch_shape, dtype=torch.bool, device=device)

    for _ in range(max_iter):
        if bool(done.all()):
            break
        m = 0.5 * (a + c)
        tol1 = tol_ * torch.abs(x) + eps
        tol2 = 2.0 * tol1
        done = done | (torch.abs(x - m) <= tol2 - 0.5 * (c - a))

        # --- parabolic trial (reference brent.rs:58-92)
        p = (x - v) * ((x - w) * (fx - fv)) - (x - w) * ((x - v) * (fx - fw))
        q = 2.0 * (((x - v) * (fx - fw)) - ((x - w) * (fx - fv)))
        p = where(q > 0, -p, p)
        q = torch.abs(q)
        safe_q = where(torch.abs(q) > eps, q, torch.ones_like(q))
        sstep = p / safe_q
        u_try = x + sstep
        par_ok = ((torch.abs(e) > tol1) & (torch.abs(q) > eps)
                  & ((u_try - a) >= tol2) & ((c - u_try) >= tol2)
                  & (torch.abs(sstep) < 0.5 * torch.abs(e)))
        d_par = sstep
        # clamp if the accepted parabolic u lands too near the bounds
        near_edge = ((x + d_par - a) < tol2) | ((c - (x + d_par)) < tol2)
        d_par = where(near_edge, where(x < m, tol1, -tol1), d_par)

        # --- golden fallback (updates e)
        e_gold = where(x < m, c - x, a - x)
        d_gold = _GOLD * e_gold

        d_new = where(par_ok, d_par, d_gold)
        e_new = where(par_ok, e, e_gold)
        d_new = where(torch.abs(d_new) < tol1,
                      where(d_new >= 0, tol1, -tol1), d_new)

        u = x + d_new
        fu = f(where(done, x, u))  # frozen lanes re-evaluate at x (discarded)

        better = fu <= fx
        a_n = where(better, where(u >= x, x, a), where(u >= x, a, u))
        c_n = where(better, where(u >= x, c, x), where(u >= x, u, c))
        v_n = where(better, w, v)
        fv_n = where(better, fw, fv)
        w_n = where(better, x, w)
        fw_n = where(better, fx, fw)
        x_n = where(better, u, x)
        fx_n = where(better, fu, fx)
        repl_w = (~better) & ((fu <= fw) | (w == x))
        v_n = where(repl_w, w_n, v_n)
        fv_n = where(repl_w, fw_n, fv_n)
        w_n = where(repl_w, u, w_n)
        fw_n = where(repl_w, fu, fw_n)
        repl_v = (~better) & (~repl_w) & ((fu <= fv) | (v == x) | (v == w))
        v_n = where(repl_v, u, v_n)
        fv_n = where(repl_v, fu, fv_n)

        a, c = where(done, a, a_n), where(done, c, c_n)
        x, w, v = where(done, x, x_n), where(done, w, w_n), where(done, v, v_n)
        fx, fw = where(done, fx, fx_n), where(done, fw, fw_n)
        fv = where(done, fv, fv_n)
        e = where(done, e, e_new)
    return x, fx
