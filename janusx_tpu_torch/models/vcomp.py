"""Multi-component AI-REML: variance components, BLUE, BLUP.

Replaces the reference's `jx reml` engine
(JanusX python/janusx/script/reml.py: multi-VC REML with fixed /
random / genetic terms over a repeated-measures phenotype table; AI-REML
core src/math/aireml.rs + src/stats/reml.rs ai_reml_multi_f64).

Model:  y = X b + Σ_r Z_r u_r + e,   u_r ~ N(0, σ_r² K_r),  e ~ N(0, σ_e² I)
V = σ_e² I + Σ_r σ_r² U_r U_r'   with U_r = Z_r chol(K_r).

All iteration quantities run in the REDUCED rank-Q representation
(Q = Σ q_r levels, typically Q ≪ N observations) via the Woodbury
identity — per-iteration cost O(N·Q + Q³) instead of the naive O(N³):

    M = σ_e D^{-1} + U'U          (Q x Q; D = blockdiag(σ_r² I))
    V^{-1} v = (v - U M^{-1} U'v)/σ_e
    log|V| = (N - Q) ln σ_e + ln|M| + ln|D|
    tr(P·U_i U_i'), y'P U_i U_i' P y, AI entries — all from Q x Q blocks.

Average-information updates with EM fallback on negative proposals and a
variance floor (reference aireml defaults: max_iter=100, tol=1e-6,
min_var=1e-12 — src/stats/reml.rs:650).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class RandomTerm:
    name: str
    # (N, q) incidence; None = identity (sample-level kernel terms —
    # avoids materializing an (N, N) eye and the O(N^3) Z @ L identity
    # matmul the GBLUP multi-kernel fit would otherwise pay per term)
    Z: np.ndarray | None
    K: np.ndarray | None = None  # (q, q) covariance; None = identity
    levels: np.ndarray | None = None  # level labels (q,)


@dataclass
class VcompResult:
    sigma2: dict  # term name -> variance (includes "residual")
    h2: dict  # term name -> proportion of total variance
    loglik: float
    n_iter: int
    converged: bool
    blue: np.ndarray
    blue_se: np.ndarray
    fixed_names: list
    blups: dict  # term name -> (levels, u)
    fitted: np.ndarray = field(default=None)  # type: ignore
    Py: np.ndarray = field(default=None)  # type: ignore  # P y (for kernel predictions)


class _Reduced:
    """Precomputed reduced-space pieces shared across iterations."""

    def __init__(self, y, X, terms: list[RandomTerm]):
        self.y = y
        self.X = X
        self.N, self.p = X.shape
        self.Ls = []
        Us = []
        self.slices = []
        q0 = 0
        for t in terms:
            if t.K is None:
                if t.Z is None:
                    raise ValueError(
                        f"term {t.name!r}: Z=None needs an explicit K")
                L = None
                U = t.Z
            else:
                K = np.asarray(t.K, np.float64)
                # ridge for PSD safety (GRMs can be numerically indefinite)
                w, V = np.linalg.eigh(K + 1e-8 * np.eye(K.shape[0]))
                w = np.clip(w, 0.0, None)
                L = V * np.sqrt(w)[None, :]
                U = L if t.Z is None else t.Z @ L
            self.Ls.append(L)
            Us.append(U)
            self.slices.append(slice(q0, q0 + U.shape[1]))
            q0 += U.shape[1]
        self.U = np.concatenate(Us, axis=1)  # (N, Q)
        self.Q = q0
        self.UtU = self.U.T @ self.U
        self.UtX = self.U.T @ X
        self.Uty = self.U.T @ y
        self.XtX = X.T @ X
        self.Xty = X.T @ y
        self.yty = float(y @ y)


class _IterState:
    """Per-σ quantities in the reduced space."""

    def __init__(self, red: _Reduced, sig: np.ndarray):
        self.red = red
        self.sig = sig
        k = len(sig) - 1
        se = sig[-1]
        d = np.concatenate(
            [np.full(red.slices[r].stop - red.slices[r].start, sig[r]) for r in range(k)]
        ) if k else np.empty(0)
        M = red.UtU + np.diag(se / np.maximum(d, 1e-300))
        self.ok = True
        try:
            self.Mc = np.linalg.cholesky(M)
        except np.linalg.LinAlgError:
            self.ok = False
            return
        self.se = se
        self.d = d
        # solve helpers
        self.Minv_Uty = self._msolve(red.Uty)
        self.Minv_UtX = self._msolve(red.UtX)
        # X'V^-1X, X'V^-1y, y'V^-1y (all scaled by 1/se)
        XtViX = (red.XtX - red.UtX.T @ self.Minv_UtX) / se
        XtViy = (red.Xty - red.UtX.T @ self.Minv_Uty) / se
        ytViy = (red.yty - red.Uty @ self.Minv_Uty) / se
        try:
            self.Gc = np.linalg.cholesky(XtViX)
        except np.linalg.LinAlgError:
            self.ok = False
            return
        self.Gi = np.linalg.inv(XtViX)
        self.beta = self.Gi @ XtViy
        self.ytPy = float(ytViy - XtViy @ self.beta)
        # U'Py = U'V^-1 y - (U'V^-1X) beta
        UtVi_y = (red.Uty - red.UtU @ self.Minv_Uty) / se
        self.UtViX = (red.UtX - red.UtU @ self.Minv_UtX) / se  # (Q, p)
        self.UtPy = UtVi_y - self.UtViX @ self.beta
        # U'V^-1U and U'PU (Q x Q)
        self.UtViU = (red.UtU - red.UtU @ self._msolve(red.UtU)) / se
        self.UtPU = self.UtViU - self.UtViX @ self.Gi @ self.UtViX.T
        # Py in N-space (needed for residual-score pieces)
        w = self.Minv_Uty + self.Minv_UtX @ (-self.beta)
        # V^-1(y - X beta) = ((y - X b) - U M^-1 U'(y - X b))/se
        r0 = red.y - red.X @ self.beta
        self.Py = (r0 - red.U @ self._msolve(red.U.T @ r0)) / se
        # log|V| and log|G|
        logdetM = 2.0 * np.sum(np.log(np.diag(self.Mc)))
        logdetD = float(np.sum(np.log(np.maximum(d, 1e-300))))
        self.logdetV = (red.N - red.Q) * np.log(se) + logdetM + logdetD
        sign, self.logdetG = np.linalg.slogdet(XtViX)
        self.ll = -0.5 * (self.logdetV + self.logdetG + self.ytPy)

    def _msolve(self, b):
        z = np.linalg.solve(self.Mc, b)
        return np.linalg.solve(self.Mc.T, z)

    def tr_P(self) -> float:
        # tr(P) = tr(V^-1) - tr(G^-1 X'V^-2 X); use tr(V^-1)=（N - tr(U M^-1 U'))/se
        red = self.red
        trVi = (red.N - np.trace(self._msolve(red.UtU))) / self.se
        # tr(G^-1 (X'V^-1)(V^-1 X)): compute X'V^-2X via reduced pieces
        # V^-1X = (X - U M^-1 U'X)/se  -> X'V^-2X = (V^-1X)'(V^-1X)
        ViX_sq = (
            self.red.XtX
            - 2.0 * red.UtX.T @ self.Minv_UtX
            + self.Minv_UtX.T @ red.UtU @ self.Minv_UtX
        ) / (self.se**2)
        return float(trVi - np.trace(self.Gi @ ViX_sq))

    def P_dot(self, v):
        """P v for an N-vector v."""
        red = self.red
        Viv = (v - red.U @ self._msolve(red.U.T @ v)) / self.se
        XtViv = red.X.T @ Viv
        corr = red.X @ (self.Gi @ XtViv)
        Vicorr = (corr - red.U @ self._msolve(red.U.T @ corr)) / self.se
        return Viv - Vicorr


def ai_reml(
    y: np.ndarray,
    X: np.ndarray,
    terms: list[RandomTerm],
    max_iter: int = 100,
    tol: float = 1e-6,
    min_var: float = 1e-12,
    verbose: bool = False,
) -> VcompResult:
    y = np.asarray(y, np.float64).reshape(-1)
    X = np.asarray(X, np.float64)
    red = _Reduced(y, X, terms)
    N = red.N
    k = len(terms)
    vy = float(np.var(y))
    sig = np.full(k + 1, max(vy, 1e-8) / (k + 1))

    st = _IterState(red, sig)
    if not st.ok:
        raise RuntimeError("initial V not positive definite")
    converged = False
    it = 0
    for it in range(1, max_iter + 1):
        # scores and AI in reduced space
        cs = [st.UtPy[red.slices[r]] for r in range(k)]  # U_r' P y
        score = np.empty(k + 1)
        trPH = np.empty(k + 1)
        for r in range(k):
            sl = red.slices[r]
            trPH[r] = float(np.trace(st.UtPU[sl, sl]))
            score[r] = -0.5 * (trPH[r] - float(cs[r] @ cs[r]))
        trP = st.tr_P()
        trPH[k] = trP
        score[k] = -0.5 * (trP - float(st.Py @ st.Py))

        AI = np.empty((k + 1, k + 1))
        # blocks: HPy_i = U_i c_i; (HPy_i)' P (HPy_j) = c_i' UtPU[i,j] c_j
        for i in range(k):
            for j in range(i, k):
                AI[i, j] = AI[j, i] = 0.5 * float(
                    cs[i] @ st.UtPU[red.slices[i], red.slices[j]] @ cs[j]
                )
        PPy = st.P_dot(st.Py)
        UtPPy = red.U.T @ PPy
        for i in range(k):
            AI[i, k] = AI[k, i] = 0.5 * float(cs[i] @ UtPPy[red.slices[i]])
        AI[k, k] = 0.5 * float(st.Py @ PPy)

        try:
            delta = np.linalg.solve(AI + 1e-10 * np.eye(k + 1), score)
        except np.linalg.LinAlgError:
            delta = score * 1e-2
        new = sig + delta
        # EM fallback for out-of-bounds proposals
        fell_back = []
        for r in range(k):
            if not np.isfinite(new[r]) or new[r] < min_var:
                q_r = red.slices[r].stop - red.slices[r].start
                em = sig[r] + (sig[r] ** 2) * (float(cs[r] @ cs[r]) - trPH[r]) / max(q_r, 1)
                new[r] = max(em, min_var)
                if em < sig[r]:
                    fell_back.append(r)
        if not np.isfinite(new[k]) or new[k] < min_var:
            em = sig[k] + (sig[k] ** 2) * (float(st.Py @ st.Py) - trP) / N
            new[k] = max(em, min_var)

        st_new = _IterState(red, new)
        if fell_back:
            # a shrinking EM component crawls to the boundary geometrically;
            # when pinning it at the floor is at least as likely, jump there
            # (GCTA-style zero-component handling)
            pin = new.copy()
            for r in fell_back:
                pin[r] = min_var
            st_pin = _IterState(red, pin)
            if st_pin.ok and (not st_new.ok or st_pin.ll >= st_new.ll):
                new, st_new = pin, st_pin
        halvings = 0
        while (not st_new.ok or st_new.ll < st.ll - 1e-8) and halvings < 8:
            new = 0.5 * (new + sig)
            st_new = _IterState(red, new)
            halvings += 1
        if not st_new.ok:
            break
        # near-zero components oscillate hugely in per-component relative
        # terms while contributing nothing; judge step size against the
        # total variance so boundary-pinned terms don't block convergence
        rel = float(np.max(np.abs(new - sig))) / max(float(np.sum(sig)), 1e-30)
        dll = abs(st_new.ll - st.ll)
        sig, st = new, st_new
        if verbose:
            print(f"AI-REML iter {it}: ll={st.ll:.6f} sig={sig}")
        if dll < tol and rel < np.sqrt(tol):
            converged = True
            break

    blue = st.beta
    blue_se = np.sqrt(np.maximum(np.diag(st.Gi), 0.0))
    blups = {}
    for r, t in enumerate(terms):
        c = st.UtPy[red.slices[r]]
        u_red = sig[r] * c  # in U-space
        u = u_red if red.Ls[r] is None else red.Ls[r] @ u_red
        blups[t.name] = (
            t.levels if t.levels is not None else np.arange(len(u)), u,
        )
    total = float(sig.sum())
    names = [t.name for t in terms] + ["residual"]
    sigma2 = {nm: float(s) for nm, s in zip(names, sig)}
    h2 = {nm: float(s / total) for nm, s in zip(names, sig)}
    fitted = X @ blue + sum(
        blups[terms[r].name][1] if terms[r].Z is None
        else terms[r].Z @ blups[terms[r].name][1]
        for r in range(k)
    )
    return VcompResult(
        sigma2=sigma2, h2=h2, loglik=float(st.ll), n_iter=it, converged=converged,
        blue=blue, blue_se=blue_se, fixed_names=[], blups=blups, fitted=fitted,
        Py=st.Py,
    )


def onehot(values: np.ndarray, drop_first: bool = False):
    """Categorical encoding -> (levels, (N, q) incidence)."""
    values = np.asarray(values).astype(str)
    levels = np.array(sorted(dict.fromkeys(values)), dtype=object)
    used = levels[1:] if (drop_first and len(levels) > 1) else levels
    idx = {v: i for i, v in enumerate(used)}
    Z = np.zeros((len(values), len(used)))
    for i, v in enumerate(values):
        j = idx.get(v)
        if j is not None:
            Z[i, j] = 1.0
    return used, Z
