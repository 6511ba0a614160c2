"""TOP: trait-ordered ranking model for multi-trait GS bundles (port of
janusx_tpu/gs/top.py).

Reference: JanusX src/stats/top.rs (Newton/BFGS/minibatch-Adam solvers
over the exact listwise objective, top.rs:843-930) wired into the GS "TOP
bundle" (gs/workflow.py:23260 top_fit_model).

Model: per-trait weights w >= 0 score how well a predicted multi-trait
profile matches a true profile:

    S_ij = -sum_t w_t |pred_i,t - true_j,t|    (standardized columns)

and the listwise loss says sample i's own truth should win the softmax
over all candidates:

    L(w) = sum_i [ -S_ii + logsumexp_j S_ij ] + l2/2 ||w||^2

The (n, n, k) |pred - true| tensor, the softmax reductions and their
gradient and Hessian in w (``torch.func``) run on the device in f64; the
damped-Newton step on the tiny k x k Hessian, the line search and the
calibration run on the host, as in the reference."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

WEIGHT_FLOOR = 1e-12  # reference top.rs:15


def standardize_columns(A: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Column-standardize; non-finite entries become 0 (column mean)."""
    A = np.asarray(A, np.float64)
    mu = np.nanmean(np.where(np.isfinite(A), A, np.nan), axis=0)
    mu = np.where(np.isfinite(mu), mu, 0.0)
    sd = np.nanstd(np.where(np.isfinite(A), A, np.nan), axis=0)
    sd = np.where(np.isfinite(sd) & (sd > 0), sd, 1.0)
    Z = (A - mu) / sd
    return np.where(np.isfinite(Z), Z, 0.0), mu, sd


def _top_loss_fn(w, P, T, l2):
    D = torch.abs(P[:, None, :] - T[None, :, :])  # (n, n, k)
    S = -torch.einsum("ijk,k->ij", D, w)
    row = torch.logsumexp(S, dim=1)
    return torch.sum(row - torch.diagonal(S)) + 0.5 * l2 * torch.dot(w, w)


def _loss_grad_hess(w, P, T, l2):
    """The loss with its gradient and Hessian in w; the backtracking
    evaluations call _top_loss_fn alone (the Hessian costs k extra
    gradient passes over the (n, n, k) tensor)."""
    grad, loss = torch.func.grad_and_value(_top_loss_fn)(w, P, T, l2)
    hess = torch.func.hessian(_top_loss_fn)(w, P, T, l2)
    return loss, grad, hess


@dataclass
class TopModel:
    traits: list
    weights: np.ndarray  # (k,) normalized
    loss: float
    n_iter: int
    converged: bool
    true_mean: np.ndarray
    true_sd: np.ndarray
    # per-trait prediction calibration applied before standardization
    # (reference --top-calibration, src/stats/top.rs LinearCalibration):
    # pred_cal = cal_intercept + cal_slope * pred
    cal_intercept: np.ndarray | None = None
    cal_slope: np.ndarray | None = None

    def calibrate(self, y_pred: np.ndarray) -> np.ndarray:
        P = np.asarray(y_pred, np.float64)
        if self.cal_intercept is None:
            return P
        return self.cal_intercept[None, :] + self.cal_slope[None, :] * P


def fit_calibrations(y_true, y_pred, mode: str):
    """Per-trait prediction calibration (reference top.rs:700-776):
    'linear' = OLS of true on pred over observed rows (< 3 observed
    falls back to addmean); 'addmean' = shift by the observed trait
    mean; 'none' = identity. Returns (intercept (k,), slope (k,))."""
    Y = np.asarray(y_true, np.float64)
    P = np.asarray(y_pred, np.float64)
    k = Y.shape[1]
    icpt = np.zeros(k)
    slope = np.ones(k)
    if mode == "none":
        return icpt, slope
    mu = np.nanmean(np.where(np.isfinite(Y), Y, np.nan), axis=0)
    mu = np.where(np.isfinite(mu), mu, 0.0)
    if mode == "addmean":
        return mu.copy(), slope
    if mode != "linear":
        raise ValueError("calibration must be linear|none|addmean")
    for t in range(k):
        m = np.isfinite(Y[:, t]) & np.isfinite(P[:, t])
        if m.sum() < 3:
            icpt[t] = mu[t]
            continue
        x, y = P[m, t], Y[m, t]
        vx = x.var()
        if not vx > 0:
            icpt[t] = mu[t]
            continue
        slope[t] = float(((x - x.mean()) * (y - y.mean())).mean() / vx)
        icpt[t] = float(y.mean() - slope[t] * x.mean())
    return icpt, slope


def top_fit(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    traits=None,
    l2: float = 1e-3,
    max_iter: int = 50,
    tol: float = 1e-8,
    damping: float = 1e-6,
    normalize: bool = True,
    calibration: str = "linear",
    device=None,
) -> TopModel:
    """Damped-Newton fit of the TOP weights (reference exact-Newton mode).

    y_true/y_pred: (n, k) multi-trait observed / predicted matrices.
    ``calibration`` (reference --top-calibration, default linear): map
    predictions onto the observed scale per trait before standardizing."""
    from janusx_tpu_torch import config

    dev = config.resolve_device(device)
    cal_i, cal_s = fit_calibrations(y_true, y_pred, calibration)
    T, mu, sd = standardize_columns(y_true)
    P_cal = cal_i[None, :] + cal_s[None, :] * np.asarray(y_pred, np.float64)
    P = (P_cal - mu) / sd
    P = np.where(np.isfinite(P), P, 0.0)
    n, k = T.shape
    if traits is None:
        traits = [f"t{i}" for i in range(k)]
    Pd = torch.as_tensor(P, dtype=torch.float64, device=dev)
    Td = torch.as_tensor(T, dtype=torch.float64, device=dev)
    wd = lambda w: torch.as_tensor(w, dtype=torch.float64, device=dev)
    w = np.full(k, 1.0 / k)
    prev = np.inf
    converged = False
    it = 0
    # max_iter <= 0 would leave `loss` unbound below (no iterations run)
    loss = float(_top_loss_fn(wd(w), Pd, Td, l2))
    for it in range(1, max_iter + 1):
        loss, grad, hess = _loss_grad_hess(wd(w), Pd, Td, l2)
        loss = float(loss)
        g = grad.cpu().numpy()
        H = hess.cpu().numpy() + damping * np.eye(k)
        try:
            step = np.linalg.solve(H, g)
        except np.linalg.LinAlgError:
            step = g
        # backtracking line search with the weight floor
        t = 1.0
        for _ in range(30):
            w_new = np.maximum(w - t * step, WEIGHT_FLOOR)
            l_new = float(_top_loss_fn(wd(w_new), Pd, Td, l2))
            if l_new <= loss - 1e-4 * t * float(g @ step):
                break
            t *= 0.5
        w = w_new
        if abs(prev - l_new) < tol * (abs(prev) + 1.0):
            converged = True
            loss = l_new
            break
        prev = l_new
        loss = l_new
    if normalize and w.sum() > 0:
        w = w / w.sum()
    return TopModel(
        traits=list(traits), weights=w, loss=float(loss), n_iter=it,
        converged=converged, true_mean=mu, true_sd=sd,
        cal_intercept=cal_i, cal_slope=cal_s,
    )


def top_rank(
    model: TopModel, y_pred: np.ndarray, target: np.ndarray | str = "max"
) -> np.ndarray:
    """TOP selection index: score candidates by weighted closeness of the
    standardized predicted profile to a target profile (reference
    top_rank_to_target_*). ``target="max"`` ranks toward the best
    observed value per trait. Higher = better; returns (n,) scores."""
    P = (model.calibrate(y_pred) - model.true_mean) / model.true_sd
    P = np.where(np.isfinite(P), P, 0.0)
    if isinstance(target, str):
        if target != "max":
            raise ValueError("target must be 'max' or a (k,) raw-scale vector")
        tgt = P.max(axis=0)
    else:
        tgt = (np.asarray(target, np.float64) - model.true_mean) / model.true_sd
    return -(np.abs(P - tgt[None, :]) @ model.weights)
