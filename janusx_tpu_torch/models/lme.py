"""Line-nested linear mixed models for repeated-measures phenotype tables.

Engine behind the upgraded `jx reml` module (reference:
JanusX python/janusx/script/reml.py — multi-trait REML/BLUE/BLUP
with fixed / random / GxE / GxC terms over an observation table, plus a
narrow-sense joint additive+line kernel fit when a GRM is attached).

The key structural fact (which the reference's "line-nested solver"
exploits, reml.py:_stage1_grouped_random_rows): the line term, every
Line×Env (GxE) term, and every Line×continuous (GxC) slope term have
random levels that each belong to exactly ONE line. The marginal
covariance V = σe²I + Σ_r σr² Z_r Z_r' is therefore block-diagonal by
line, with blocks of size = observations per line (typically 2-10).

We batch those blocks into padded (L, s, s) tensors and do every REML
iteration with one batched Cholesky — the same lattice-of-small-problems
shape the TPU scan kernels use, here in numpy f64 (the per-eval cost at
rice6048 scale, L≈3k s≈6, is sub-millisecond).

Non-line-nested random terms (e.g. a `block` factor shared across lines)
are detected by the caller and routed to the general reduced-space
AI-REML in models/vcomp.py instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class NestedTerm:
    """One line-nested random term: obs -> (level, value).

    level codes are term-local (0..n_levels-1); every level must occur in
    a single line. `h_env` carries the harmonic-mean environment
    replication used for the broad-H² GxE adjustment (1.0 = plain term).
    """

    name: str
    lev: np.ndarray  # (N,) int level code per observation
    val: np.ndarray  # (N,) float value per observation (1.0 for factors)
    n_levels: int
    level_names: list | None = None
    h_env: float = 1.0
    kind: str = "line"  # "line" | "gxe" | "gxc" | "random"


@dataclass
class LineNestedFit:
    sigma2: dict  # term name -> variance (+ "residual")
    loglik: float
    converged: bool
    n_iter: int
    beta: np.ndarray
    beta_se: np.ndarray
    blups: dict  # term name -> (level_names, u)
    n_obs: int
    n_lines: int


@dataclass
class JointKernelFit:
    """Narrow-sense joint additive + line fit on line-level BLUEs.

    Mirrors the reference's `_fit_joint_line_kernel_approx`
    (reml.py:2195): V = va·K + (vline + noise_diag)·I on the BLUE scale,
    h2 = va / (va + vline + mean(noise)).
    """

    va: float
    vline: float
    h2: float
    beta: np.ndarray
    add_blup: np.ndarray  # genetic (GBLUP) values per line
    line_blup: np.ndarray  # non-additive line deviation
    noise_mean: float
    nll: float


def _nm_restarts(minimize, obj, theta0, maxiter: int, tol: float, rounds: int = 3):
    """Nelder-Mead with restarts: re-initialize the simplex at the found
    point until the objective stops improving. Cures the classic NM
    degenerate-simplex stall, which otherwise leaves variance estimates a
    few percent off in an environment-dependent way."""
    best = None
    x = np.asarray(theta0, np.float64)
    for _ in range(rounds):
        res = minimize(
            obj, x, method="Nelder-Mead",
            options={"maxiter": maxiter, "xatol": 1e-8, "fatol": tol},
        )
        if best is not None and res.fun >= best.fun - max(tol, 1e-10):
            if res.fun < best.fun:
                best = res
            break
        best = res
        x = res.x
    return best


class _Blocks:
    """Padded per-line observation blocks shared across REML evaluations."""

    def __init__(self, y, X, line_codes, terms: list[NestedTerm]):
        y = np.asarray(y, np.float64).reshape(-1)
        X = np.asarray(X, np.float64)
        line_codes = np.asarray(line_codes, np.int64)
        N = y.shape[0]
        L = int(line_codes.max()) + 1 if N else 0
        order = np.argsort(line_codes, kind="stable")
        counts = np.bincount(line_codes, minlength=L)
        s = int(counts.max()) if L else 1
        self.N, self.L, self.s, self.p = N, L, s, X.shape[1]
        self.counts = counts
        # padded slots: row i of line l sits at (l, i)
        slot = np.zeros(N, np.int64)
        start = np.zeros(L + 1, np.int64)
        np.cumsum(counts, out=start[1:])
        slot[order] = np.arange(N) - start[line_codes[order]]
        self.lines = line_codes
        self.slot = slot
        self.mask = np.zeros((L, s), bool)
        self.mask[line_codes, slot] = True
        self.yb = np.zeros((L, s))
        self.yb[line_codes, slot] = y
        self.Xb = np.zeros((L, s, self.p))
        self.Xb[line_codes, slot] = X
        # per-term padded (level, value) and the same-level indicator grams
        self.G = []  # (L, s, s) val_i val_j [lev_i == lev_j]
        for t in terms:
            lev = np.full((L, s), -1, np.int64)
            lev[line_codes, slot] = t.lev
            val = np.zeros((L, s))
            val[line_codes, slot] = t.val
            same = (lev[:, :, None] == lev[:, None, :]) & (lev[:, :, None] >= 0)
            self.G.append(np.where(same, val[:, :, None] * val[:, None, :], 0.0))
        self.terms = terms
        self.eye = np.broadcast_to(np.eye(s), (L, s, s))
        # padding rows get V=I so they add 0 to the logdet and 0 to quads
        self.pad_diag = np.where(self.mask, 0.0, 1.0)

    def build_V(self, sig, ve):
        V = ve * np.where(self.mask[:, :, None] & self.mask[:, None, :], self.eye, 0.0)
        for g, G in zip(sig, self.G):
            V = V + g * G
        idx = np.arange(self.s)
        V[:, idx, idx] += self.pad_diag
        return V

    def reml_pieces(self, sig, ve):
        """Batched (logdetV, XtViX, XtViy, ytViy, Vi_chol) for REML."""
        V = self.build_V(sig, ve)
        C = np.linalg.cholesky(V)
        logdetV = 2.0 * np.log(np.diagonal(C, axis1=1, axis2=2)).sum()
        rhs = np.concatenate([self.Xb, self.yb[:, :, None]], axis=2)
        sol = np.linalg.solve(V, rhs)  # (L, s, p+1); batched via LAPACK
        XtViX = np.einsum("lsp,lsq->pq", self.Xb, sol[:, :, : self.p])
        XtViy = np.einsum("lsp,ls->p", self.Xb, sol[:, :, self.p])
        ytViy = float(np.einsum("ls,ls->", self.yb, sol[:, :, self.p]))
        return logdetV, XtViX, XtViy, ytViy, V

    def neg_reml(self, sig, ve):
        logdetV, XtViX, XtViy, ytViy, _ = self.reml_pieces(sig, ve)
        sign, logdetG = np.linalg.slogdet(XtViX)
        if sign <= 0:
            return np.inf
        beta = np.linalg.solve(XtViX, XtViy)
        quad = ytViy - float(XtViy @ beta)
        return 0.5 * (logdetV + logdetG + quad)


def fit_line_nested(
    y,
    X,
    line_codes,
    terms: list[NestedTerm],
    max_iter: int = 200,
    tol: float = 1e-8,
) -> LineNestedFit:
    """REML over a line-nested random design (V block-diagonal by line)."""

    from scipy.optimize import minimize

    y = np.asarray(y, np.float64).reshape(-1)
    blocks = _Blocks(y, X, line_codes, terms)
    vy = max(float(np.var(y)), 1e-12)
    k = len(terms)
    theta0 = np.log(np.full(k + 1, vy / (k + 1)))
    lo, hi = np.log(vy * 1e-10), np.log(vy * 1e6)

    def obj(theta):
        v = np.exp(np.clip(theta, lo, hi))
        return blocks.neg_reml(v[:k], v[k])

    res = _nm_restarts(minimize, obj, theta0, max_iter * (k + 1) * 20, tol)
    v = np.exp(np.clip(res.x, lo, hi))
    sig, ve = v[:k], float(v[k])
    # clamp boundary estimates (variances within ~1e-8 of floor) to 0 for reporting
    sig_rep = np.where(sig < vy * 1e-8, 0.0, sig)

    logdetV, XtViX, XtViy, ytViy, V = blocks.reml_pieces(sig, ve)
    beta = np.linalg.solve(XtViX, XtViy)
    beta_cov = np.linalg.inv(XtViX)
    # BLUPs: u_r = σr Z_r' V⁻¹ (y − Xβ), blockwise
    resid = blocks.yb - np.einsum("lsp,p->ls", blocks.Xb, beta)
    w = np.linalg.solve(V, resid[:, :, None])[:, :, 0] * blocks.mask
    blups = {}
    for g, t in zip(sig, terms):
        contrib = (t.val * w[blocks.lines, blocks.slot]) * g
        u = np.zeros(t.n_levels)
        np.add.at(u, t.lev, contrib)
        names = t.level_names if t.level_names is not None else np.arange(t.n_levels)
        blups[t.name] = (names, u)

    sigma2 = {t.name: float(s_) for t, s_ in zip(terms, sig_rep)}
    sigma2["residual"] = ve
    return LineNestedFit(
        sigma2=sigma2,
        loglik=-float(res.fun),
        converged=bool(res.success),
        n_iter=int(res.nit),
        beta=beta,
        beta_se=np.sqrt(np.clip(np.diag(beta_cov), 0.0, None)),
        blups=blups,
        n_obs=blocks.N,
        n_lines=blocks.L,
    )


def blue_line_nested(
    y,
    X_env,
    line_codes,
    terms_noline: list[NestedTerm],
    sig_noline,
    ve: float,
):
    """Stage-1 line BLUEs: GLS with line FIXED + shared env fixed effects.

    V0 = σe²I + Σ σg² Z_g Z_g' (line-nested nuisance terms only) is block
    diagonal; the full fixed design is [line dummies | X_env]. Solved via
    the Schur complement on the small env block (the line-dummy normal
    block is diagonal because each dummy touches one line's block).

    Returns (blue (L,), se (L,), beta_env (p,)).
    """

    blocks = _Blocks(y, X_env, line_codes, terms_noline)
    V = blocks.build_V(np.asarray(sig_noline, np.float64), float(ve))
    ones = blocks.mask.astype(np.float64)
    rhs = np.concatenate(
        [ones[:, :, None], blocks.Xb, blocks.yb[:, :, None]], axis=2
    )
    sol = np.linalg.solve(V, rhs)
    W1 = sol[:, :, 0]
    p = blocks.p
    d = np.einsum("ls,ls->l", ones, W1)  # 1'V⁻¹1 per line
    A_LE = np.einsum("ls,lsp->lp", ones, sol[:, :, 1 : 1 + p])
    b_L = np.einsum("ls,ls->l", ones, sol[:, :, 1 + p])
    A_EE = np.einsum("lsp,lsq->pq", blocks.Xb, sol[:, :, 1 : 1 + p])
    b_E = np.einsum("lsp,ls->p", blocks.Xb, sol[:, :, 1 + p])
    d = np.maximum(d, 1e-12)
    if p:
        S = A_EE - (A_LE.T / d) @ A_LE
        beta_env = np.linalg.solve(S, b_E - (A_LE.T / d) @ b_L)
        blue = (b_L - A_LE @ beta_env) / d
        Sinv_rows = np.linalg.solve(S, A_LE.T).T  # (L, p)
        var = 1.0 / d + np.einsum("lp,lp->l", A_LE, Sinv_rows) / (d * d)
    else:
        beta_env = np.zeros(0)
        blue = b_L / d
        var = 1.0 / d
    return blue, np.sqrt(np.clip(var, 0.0, None)), beta_env


def fit_joint_kernel(
    y_line,
    K,
    noise_diag,
    x_fixed=None,
    max_iter: int = 200,
    mode: str = "raw",
) -> JointKernelFit:
    """Joint additive (va·K) + line (vline·I) REML on line-level BLUEs.

    K is symmetrized and normalized by its mean diagonal; per-line noise
    (stage-1 BLUE squared SEs) enters as a fixed diagonal — the
    reference's `_joint_kernel_state` objective (reml.py:2141-2185).

    A scipy.sparse K (thresholded `-spk` kinship) keeps the objective
    fully sparse: V = va·K + diag(d + vline) factors by sparse LU per
    eval, so biobank-scale line counts never densify the n² matrix.
    """

    import scipy.sparse as sp
    from scipy.linalg import cho_factor, cho_solve
    from scipy.optimize import minimize

    y = np.asarray(y_line, np.float64).reshape(-1)
    n = y.shape[0]
    sparse_k = sp.issparse(K)
    if sparse_k:
        K = K.tocsc().astype(np.float64)
        K = (K + K.T) * 0.5
        kmean = float(np.mean(K.diagonal()))
    else:
        K = np.asarray(K, np.float64)
        K = (K + K.T) / 2.0
        kmean = float(np.mean(np.diag(K)))
    if not np.isfinite(kmean) or kmean <= 0:
        raise ValueError(f"invalid kinship mean diagonal: {kmean}")
    K = K / kmean
    d = np.asarray(noise_diag, np.float64).reshape(-1)
    d = np.where(np.isfinite(d) & (d >= 0), d, 0.0)
    d_mean = float(np.mean(d)) if n else 0.0
    X = np.ones((n, 1))
    if x_fixed is not None and np.asarray(x_fixed).size:
        X = np.concatenate([X, np.asarray(x_fixed, np.float64)], axis=1)

    vy = max(float(np.var(y)), 1e-12)
    lo, hi = np.log(vy * 1e-8), np.log(vy * 1e4)

    def _beta_nll(logdet_v, solve, _va, _vline):
        ViX = solve(X)
        Viy = solve(y)
        G = X.T @ ViX
        cg = cho_factor((G + G.T) / 2.0, lower=True)
        beta = cho_solve(cg, X.T @ Viy)
        r = y - X @ beta
        Vir = solve(r)
        quad = float(r @ Vir)
        nll = 0.5 * (
            logdet_v + 2.0 * np.log(np.diag(cg[0])).sum() + quad
        )
        return nll, beta, Vir

    if sparse_k:
        from scipy.sparse.linalg import splu

        def state(theta):
            va, vline = np.exp(np.clip(theta, lo, hi))
            V = (va * K + sp.diags(d + vline)).tocsc()
            lu = splu(V)
            # V is SPD: det > 0, L unit-diagonal, so logdet = sum log|U_ii|
            logdet_v = float(np.sum(np.log(np.abs(lu.U.diagonal()))))
            nll, beta, Vir = _beta_nll(logdet_v, lu.solve, va, vline)
            return nll, va, vline, beta, Vir
    else:

        def state(theta):
            va, vline = np.exp(np.clip(theta, lo, hi))
            V = va * K
            V.flat[:: n + 1] += d + vline
            c = cho_factor((V + V.T) / 2.0, lower=True)
            logdet_v = 2.0 * np.log(np.diag(c[0])).sum()
            nll, beta, Vir = _beta_nll(logdet_v, lambda b: cho_solve(c, b),
                                       va, vline)
            return nll, va, vline, beta, Vir

    def obj(theta):
        try:
            return state(theta)[0]
        except np.linalg.LinAlgError:
            return np.inf

    if mode == "fastgwa":
        # fastGWA-REML-style fixed-Vp objective (reference --spk-mode
        # fastgwa / GCTA fastGWA-REML): the total va+vline is pinned to
        # the phenotypic variance (net of the stage-1 noise mean) and
        # only the heritable SHARE is searched — 1-D golden section on
        # the same sparse/dense likelihood
        vp = max(vy - d_mean, vy * 1e-4)

        def obj1(s):
            s = min(max(float(s), 1e-6), 1.0 - 1e-6)
            return obj(np.log([vp * s, vp * (1.0 - s)]))

        import math

        gr = (math.sqrt(5.0) - 1.0) / 2.0
        a, b = 1e-4, 1.0 - 1e-4
        c1, c2 = b - gr * (b - a), a + gr * (b - a)
        f1, f2 = obj1(c1), obj1(c2)
        for _ in range(60):
            if f1 <= f2:
                b, c2, f2 = c2, c1, f1
                c1 = b - gr * (b - a)
                f1 = obj1(c1)
            else:
                a, c1, f1 = c1, c2, f2
                c2 = a + gr * (b - a)
                f2 = obj1(c2)
        s_opt = 0.5 * (a + b)
        nll, va, vline, beta, Vir = state(
            np.log([vp * s_opt, vp * (1.0 - s_opt)]))
    else:
        # The (va, vline) surface often has a flat ridge (va·K vs
        # vline·I are weakly separated when K is close to I), where a
        # single-start simplex lands wherever rounding pushes it. Seed
        # from a coarse deterministic grid over (heritable share,
        # total), then polish.
        best = None
        for share in np.linspace(0.05, 0.95, 10):
            for tot in (0.5 * vy, vy, 2.0 * vy):
                theta = np.log([max(share * tot, 1e-12),
                                max((1 - share) * tot, 1e-12)])
                f = obj(theta)
                if best is None or f < best[0]:
                    best = (f, theta)
        res = _nm_restarts(minimize, obj, best[1], max_iter * 10, 1e-9)
        nll, va, vline, beta, Vir = state(res.x)
    denom = va + vline + d_mean
    return JointKernelFit(
        va=float(va),
        vline=float(vline),
        h2=float(va / denom) if denom > 0 else float("nan"),
        beta=np.asarray(beta).reshape(-1),
        add_blup=va * (K @ Vir),
        line_blup=vline * Vir,
        noise_mean=d_mean,
        nll=float(nll),
    )


def harmonic_mean(x) -> float:
    x = np.asarray(list(x), np.float64)
    x = x[np.isfinite(x) & (x > 0)]
    if x.size == 0:
        return 1.0
    return float(x.size / np.sum(1.0 / x))
