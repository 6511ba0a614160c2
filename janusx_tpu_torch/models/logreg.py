"""Logistic regression + AND/NOT-only conjunction search.

Reference: JanusX src/stats/logreg.rs — given binary X (0/1
features) and a binary or continuous y, find the best single conjunction
of literals (Xj or !Xj) by greedy extension, scored by the logistic
log-likelihood (binary y) or MSE (continuous y). Used by GARFIELD for
binary-trait rule refinement.

The logistic fitter itself is a Newton/IRLS solve on device-friendly
dense algebra (host numpy here — the designs are (n, 2) tiny)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_EPS = 1e-12


def logistic_fit(
    X: np.ndarray, y: np.ndarray, max_iter: int = 50, tol: float = 1e-8,
    ridge: float = 1e-8,
):
    """Newton-IRLS logistic regression.

    X: (n, p) design INCLUDING any intercept column; y: (n,) in {0,1}.
    Returns (beta, se, loglik, converged)."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64).reshape(-1)
    n, p = X.shape
    beta = np.zeros(p)
    ll_prev = -np.inf
    converged = False
    for _ in range(max_iter):
        eta = np.clip(X @ beta, -30, 30)
        mu = 1.0 / (1.0 + np.exp(-eta))
        W = mu * (1.0 - mu)
        ll = float(np.sum(y * eta - np.log1p(np.exp(eta))))
        if abs(ll - ll_prev) < tol * (abs(ll_prev) + 1.0):
            converged = True
            break
        ll_prev = ll
        H = X.T @ (W[:, None] * X) + ridge * np.eye(p)
        g = X.T @ (y - mu)
        try:
            beta = beta + np.linalg.solve(H, g)
        except np.linalg.LinAlgError:
            break
    eta = np.clip(X @ beta, -30, 30)
    mu = 1.0 / (1.0 + np.exp(-eta))
    W = mu * (1.0 - mu)
    H = X.T @ (W[:, None] * X) + ridge * np.eye(p)
    cov = np.linalg.inv(H)
    se = np.sqrt(np.maximum(np.diag(cov), 0.0))
    ll = float(np.sum(y * eta - np.log1p(np.exp(eta))))
    return beta, se, ll, converged


def _binary_loglik_split(n1_pos: int, n1: int, n0_pos: int, n0: int) -> float:
    """Max Bernoulli log-likelihood of y given the 0/1 split by a rule —
    the saturated two-group fit the reference's loglik score uses."""

    def h(k, m):
        if m == 0:
            return 0.0
        p = min(max(k / m, _EPS), 1.0 - _EPS)
        return k * np.log(p) + (m - k) * np.log(1.0 - p)

    return h(n1_pos, n1) + h(n0_pos, n0)


@dataclass
class AndNotFit:
    literals: list  # (index, negated)
    expression: str
    rule: np.ndarray  # (n,) uint8 conjunction value
    score: float  # loglik (binary) or -MSE (continuous)


def fit_best_and_not(
    X: np.ndarray,
    y: np.ndarray,
    response: str = "binary",
    score: str = "loglik",
    max_literals: int = 0,
    feature_names=None,
) -> AndNotFit:
    """Greedy best AND/NOT conjunction (reference logreg.rs contract).

    X: (m, n) 0/1 feature rows; literals are X_j or !X_j. Extends the
    conjunction while the score improves (up to ``max_literals``; 0 = no
    cap). Binary response scores by the two-group Bernoulli loglik;
    continuous by negative MSE of the two group means."""
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError("X must be (m, n)")
    m, n = X.shape
    y = np.asarray(y, np.float64).reshape(-1)
    if len(y) != n:
        raise ValueError("y length mismatch")
    binary = response == "binary"
    if binary and score not in ("loglik",):
        raise ValueError("binary response supports score='loglik'")

    y_sum = float(y.sum())
    yy = float(y @ y)

    def rule_score(v: np.ndarray) -> float:
        n1 = int(v.sum())
        n0 = n - n1
        s1 = float(y @ v)
        if binary:
            return _binary_loglik_split(int(round(s1)), n1, int(round(y_sum - s1)), n0)
        # continuous: -MSE of the two-group-mean predictor
        mu1 = s1 / n1 if n1 else 0.0
        mu0 = (y_sum - s1) / n0 if n0 else 0.0
        sse = yy - n1 * mu1 * mu1 - n0 * mu0 * mu0
        return -sse / n

    cur = np.ones(n, np.uint8)
    literals: list = []
    best = rule_score(cur)
    cap = max_literals if max_literals > 0 else m
    used: set = set()
    Xb = X.astype(np.uint8)
    while len(literals) < cap:
        # score every literal extension with two matmuls
        v = cur.astype(np.float64)
        cnt_and = Xb @ v  # support of cur AND X_j
        s_and = (Xb * y[None, :]) @ v  # y-sum over cur AND X_j
        cur_cnt = float(v.sum())
        cur_sum = float(y @ v)
        best_ext = None
        for j in range(m):
            if j in used:
                continue
            for neg in (False, True):
                n1 = cur_cnt - cnt_and[j] if neg else cnt_and[j]
                s1 = cur_sum - s_and[j] if neg else s_and[j]
                n1 = int(round(n1))
                if binary:
                    sc = _binary_loglik_split(
                        int(round(s1)), n1, int(round(y_sum - s1)), n - n1
                    )
                else:
                    mu1 = s1 / n1 if n1 else 0.0
                    mu0 = (y_sum - s1) / (n - n1) if n - n1 else 0.0
                    sse = yy - n1 * mu1 * mu1 - (n - n1) * mu0 * mu0
                    sc = -sse / n
                # strict improvement with fp tolerance: complements give
                # identical splits up to rounding — first (positive) wins
                if best_ext is None or sc > best_ext[0] + 1e-9 * (
                    1.0 + abs(best_ext[0])
                ):
                    best_ext = (sc, j, neg)
        if best_ext is None or best_ext[0] <= best + 1e-12:
            break
        best, j, neg = best_ext
        literals.append((j, neg))
        used.add(j)
        cur = cur & (1 - Xb[j] if neg else Xb[j])
    names = feature_names if feature_names is not None else [
        f"x{j}" for j in range(m)
    ]
    expr = " AND ".join(
        ("!" if neg else "") + str(names[j]) for j, neg in literals
    ) or "TRUE"
    return AndNotFit(literals=literals, expression=expr, rule=cur, score=best)
