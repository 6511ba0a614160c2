"""GBLUP / rrBLUP fitting and prediction (port of janusx_tpu/gs/blup.py).

Parameterization: V = vg (K + λ I) with λ = ve/vg; the profiled spectral
REML gives λ and vg = rtWr/(n-p). Predictions: u_s = K[s, t] α. Marker
effects (rrBLUP export / back-projection): a = Z' α / denom with Z the
centered (method-1) genotype rows.

Where the work runs: the GBLUP fits (eigh + Brent REML) stay on the host,
as in the reference; the marker-effect back-projection (decode + matvec
per resident SNP block) and the PCG solve of (K_tt + λI) α = r run on the
device in f32 with full-f32 products, as the reference's do on its device.
The multi-kernel AI-REML (GBLUPd/ad), host numpy in the reference
(models/vcomp.py, in a reduced space of k N dimensions), runs here in f64
on the device in sample space: at N = 1,128 training samples and two
kernels one reference state is ~130 GFLOP of solves and products on the
host, and a fit takes up to 100 iterations of one to ten states each.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.core.reml import fit_null_reml_host
from janusx_tpu_torch.core.spectral import eigh_grm
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.ops import decode
from janusx_tpu_torch.ops.cg import cg_solve
from janusx_tpu_torch.utils import devcache

# reference dispatch thresholds (gs/workflow.py:251, :19506; README.md:104-107)
GBLUP_MAX_N = 15_000
RRBLUP_EXACT_MAX_MARKERS = 15_000


@dataclass
class GblupModel:
    train_idx: np.ndarray
    beta: np.ndarray  # fixed effects (intercept [+ covariates])
    alpha: np.ndarray  # (n_train,) kernel weights
    lbd: float
    vg: float
    ve: float
    pve: float
    reml: float


def fit_gblup(
    K: np.ndarray,
    y: np.ndarray,
    train_idx: np.ndarray,
    covariates: np.ndarray | None = None,
    basis=None,
) -> GblupModel:
    """Fit additive GBLUP on the training subset of a dense GRM, on the
    host (LAPACK eigh + scipy-Brent REML), as the reference does.
    ``basis`` accepts a precomputed spectral basis of K[train, train] +
    1e-6 I. JX_TPU_GS_EIGH32 runs the eigh in f32 (ssyevd) with the REML
    itself still in f64 on the cast-back spectrum."""
    train_idx = np.asarray(train_idx)
    y_t = np.asarray(y, np.float64).reshape(-1)[train_idx]
    cov_t = None if covariates is None else np.asarray(covariates)[train_idx]
    if basis is None:
        Ktt = K[np.ix_(train_idx, train_idx)]
        if config.knob("JX_TPU_GS_EIGH32"):
            import scipy.linalg

            from janusx_tpu_torch.core.spectral import SpectralBasis

            Kr = (Ktt + 1e-6 * np.eye(len(train_idx))).astype(np.float32)
            S32, U32 = scipy.linalg.eigh(
                Kr, driver="evd", check_finite=False, overwrite_a=True
            )
            basis = SpectralBasis(
                np.maximum(S32.astype(np.float64), 0.0),
                U32.astype(np.float64),
            )
        else:
            basis = eigh_grm(Ktt, diag_ridge=1e-6)
    n_t = len(train_idx)
    X = np.ones((n_t, 1)) if cov_t is None else np.concatenate(
        [np.ones((n_t, 1)), cov_t], axis=1
    )
    null, beta, vg = fit_null_reml_host(basis.S, basis.U.T @ X, basis.U.T @ y_t)
    ve = null.lbd * vg
    r = y_t - X @ beta
    w = 1.0 / (basis.S + null.lbd)
    alpha = basis.U @ (w * (basis.U.T @ r))
    trace_mean = float(np.clip(basis.S, 0, None).sum() / max(1, n_t))
    pve = vg * trace_mean / (vg * trace_mean + ve) if vg * trace_mean + ve > 0 else 0.0
    return GblupModel(
        train_idx=train_idx, beta=beta, alpha=alpha, lbd=null.lbd,
        vg=vg, ve=ve, pve=pve, reml=null.reml,
    )


def predict_gblup(
    model: GblupModel,
    K: np.ndarray,
    test_idx: np.ndarray,
    covariates: np.ndarray | None = None,
) -> np.ndarray:
    """gebv = X_s β + K[s, t] α."""
    test_idx = np.asarray(test_idx)
    Kst = K[np.ix_(test_idx, model.train_idx)]
    n_s = len(test_idx)
    X = np.ones((n_s, 1)) if covariates is None else np.concatenate(
        [np.ones((n_s, 1)), np.asarray(covariates)[test_idx]], axis=1
    )
    return X @ model.beta + Kst @ model.alpha


def _marker_effects_resident(pk: torch.Tensor, mn: torch.Tensor,
                             alpha: torch.Tensor) -> torch.Tensor:
    """a = Z' α over pre-blocked (nblk, B, nb) packed rows: per block the
    centered f32 decode, then one f32 matvec; (nblk * B,) f32."""
    return torch.cat([decode.decode_centered(pk[b], mn[b], torch.float32) @ alpha
                      for b in range(pk.shape[0])])


def marker_effects(
    pg_train: PackedGenotypes,
    alpha: np.ndarray,
    denom: float,
    block: int = config.DEFAULT_SNP_BLOCK,
    device=None,
) -> np.ndarray:
    """Back-project kernel weights to per-marker additive effects:
    a = Z'α / denom (reference gblup.rs marker back-projection)."""
    dev = config.resolve_device(device)
    m = pg_train.m
    block = min(block, m)
    shape = (-(-m // block), block)
    pk = devcache.device_packed_blocks(pg_train, shape, dev, lane_align=4)
    mn = devcache.to_device_blocks(pg_train.mean, shape, 0.0, torch.float32, dev)
    a_pad = np.zeros(pk.shape[-1] * 4, np.float32)
    a_pad[: pg_train.n] = np.asarray(alpha, np.float32)
    eff = _marker_effects_resident(pk, mn, torch.as_tensor(a_pad, device=dev))
    return eff.cpu().numpy().astype(np.float64)[:m] / denom


@dataclass
class MultiKernelModel:
    train_idx: np.ndarray
    beta: np.ndarray
    Py: np.ndarray  # (n_train,)
    sigma2: dict  # kernel name -> variance
    h2: dict
    kernels: list  # names in order


class _AiState:
    """The AI-REML quantities at one variance point σ = (σ_1..σ_k, σ_e)
    (janusx_tpu/models/vcomp.py _IterState) for identity-incidence kernel
    terms, in sample space: V = Σ_r σ_r K_r + σ_e I is factored directly
    (N^3 / 3), where the reference factors its reduced (Σ_r q_r = k N)
    system by general LU solves. β, P y and the REML log-likelihood come
    from solves against the factor; P = V^-1 - V^-1 X G^-1 X' V^-1 is
    formed only for the states an AI step starts from (``P()``), not for
    the proposals and halvings that are only compared by likelihood. f64
    on the device."""

    def __init__(self, Ks, X, y, sig):
        V = Ks[0] * float(sig[0])
        for s_r, K in zip(sig[1:-1], Ks[1:]):
            V.add_(K, alpha=float(s_r))
        V.diagonal().add_(float(sig[-1]))
        L, info = torch.linalg.cholesky_ex(V)
        self.ok = int(info) == 0
        if not self.ok:
            return
        ViX = torch.cholesky_solve(X, L)
        Gc, info_g = torch.linalg.cholesky_ex(X.T @ ViX)
        self.ok = int(info_g) == 0
        if not self.ok:
            return
        self.L, self.ViX = L, ViX
        self.Gi = torch.cholesky_inverse(Gc)
        self.beta = self.Gi @ (ViX.T @ y)
        self.Py = torch.cholesky_solve((y - X @ self.beta)[:, None], L)[:, 0]
        logdet = 2.0 * (torch.log(torch.diagonal(L)).sum()
                        + torch.log(torch.diagonal(Gc)).sum())
        self.ll = float(-0.5 * (logdet + y @ self.Py))

    def P(self) -> torch.Tensor:
        return torch.cholesky_inverse(self.L) - self.ViX @ self.Gi @ self.ViX.T


def _ai_reml_kernels(y, X, Ks, max_iter: int = 100, tol: float = 1e-6,
                     min_var: float = 1e-12):
    """AI-REML of y ~ X β + Σ_r u_r + e with u_r ~ N(0, σ_r K_r): the
    reference's iteration (janusx_tpu/models/vcomp.py ai_reml: AI-Newton
    steps, the EM fallback and zero-component pin for out-of-bounds
    proposals, step halving, its convergence rule) on the sample-space
    state above. K_r carries the reference's 1e-8 ridge. Returns (σ (k+1,)
    numpy, the final state)."""
    N, k = len(y), len(Ks)
    sig = np.full(k + 1, max(float(torch.var(y, correction=0)), 1e-8) / (k + 1))
    st = _AiState(Ks, X, y, sig)
    if not st.ok:
        raise RuntimeError("initial V not positive definite")
    for it in range(1, max_iter + 1):
        P = st.P()
        KPy = [K @ st.Py for K in Ks]  # K_r P y = U_r (U_r' P y)
        PPy = P @ st.Py
        PKPy = [P @ v for v in KPy]
        # everything the step needs, in one copy: tr(P K_r), y'P K_r P y,
        # tr(P), y'P P y in the score; the AI matrix from the same products
        small = torch.stack(
            [(P * K).sum() for K in Ks] + [v @ st.Py for v in KPy]
            + [torch.trace(P), st.Py @ st.Py, st.Py @ PPy]
            + [KPy[i] @ PKPy[j] for i in range(k) for j in range(i, k)]
            + [v @ PPy for v in KPy]).cpu().numpy()
        trPH, cc = small[:k], small[k:2 * k]
        trP, pp, ppp = small[2 * k:2 * k + 3]
        score = np.empty(k + 1)
        score[:k] = -0.5 * (trPH - cc)
        score[k] = -0.5 * (trP - pp)
        AI = np.empty((k + 1, k + 1))
        pos = 2 * k + 3
        for i in range(k):
            for j in range(i, k):
                AI[i, j] = AI[j, i] = 0.5 * small[pos]
                pos += 1
        for i in range(k):
            AI[i, k] = AI[k, i] = 0.5 * small[pos + i]
        AI[k, k] = 0.5 * ppp
        try:
            delta = np.linalg.solve(AI + 1e-10 * np.eye(k + 1), score)
        except np.linalg.LinAlgError:
            delta = score * 1e-2
        new = sig + delta
        # EM fallback for out-of-bounds proposals
        fell_back = []
        for r in range(k):
            if not np.isfinite(new[r]) or new[r] < min_var:
                em = sig[r] + (sig[r] ** 2) * (cc[r] - trPH[r]) / max(N, 1)
                new[r] = max(em, min_var)
                if em < sig[r]:
                    fell_back.append(r)
        if not np.isfinite(new[k]) or new[k] < min_var:
            em = sig[k] + (sig[k] ** 2) * (pp - trP) / N
            new[k] = max(em, min_var)
        st_new = _AiState(Ks, X, y, new)
        if fell_back:
            # a shrinking EM component crawls to the boundary geometrically;
            # when pinning it at the floor is at least as likely, jump there
            pin = new.copy()
            for r in fell_back:
                pin[r] = min_var
            st_pin = _AiState(Ks, X, y, pin)
            if st_pin.ok and (not st_new.ok or st_pin.ll >= st_new.ll):
                new, st_new = pin, st_pin
        halvings = 0
        while (not st_new.ok or st_new.ll < st.ll - 1e-8) and halvings < 8:
            new = 0.5 * (new + sig)
            st_new = _AiState(Ks, X, y, new)
            halvings += 1
        if not st_new.ok:
            break
        # judge the step against the total variance, so boundary-pinned
        # terms don't block convergence
        rel = float(np.max(np.abs(new - sig))) / max(float(np.sum(sig)), 1e-30)
        dll = abs(st_new.ll - st.ll)
        sig, st = new, st_new
        if dll < tol and rel < np.sqrt(tol):
            break
    return sig, st


def fit_gblup_kernels(
    Ks: dict,
    y: np.ndarray,
    train_idx: np.ndarray,
    covariates: np.ndarray | None = None,
    device=None,
) -> MultiKernelModel:
    """Multi-kernel GBLUP (additive + dominance 'ad' mode — reference
    gs/workflow.py GBLUP kernels a/d/ad) via AI-REML on the device.

    Predictions: u_r(test) = σ_r² K_r[test, train] · Py."""
    dev = config.resolve_device(device)
    train_idx = np.asarray(train_idx)
    y_t = np.asarray(y, np.float64).reshape(-1)[train_idx]
    n_t = len(train_idx)
    cov_t = None if covariates is None else np.asarray(covariates)[train_idx]
    X = np.ones((n_t, 1)) if cov_t is None else np.concatenate(
        [np.ones((n_t, 1)), cov_t], axis=1
    )
    f64 = dict(dtype=torch.float64, device=dev)
    ridge = 1e-8 * torch.eye(n_t, **f64)  # the reference's PSD ridge (vcomp.py:79)
    Kt = [torch.as_tensor(K[np.ix_(train_idx, train_idx)], **f64) + ridge for K in Ks.values()]
    sig, st = _ai_reml_kernels(torch.as_tensor(y_t, **f64), torch.as_tensor(X, **f64), Kt)
    names = list(Ks.keys()) + ["residual"]
    total = float(sig.sum())
    return MultiKernelModel(
        train_idx=train_idx, beta=st.beta.cpu().numpy(), Py=st.Py.cpu().numpy(),
        sigma2={nm: float(s) for nm, s in zip(names, sig)},
        h2={nm: float(s / total) for nm, s in zip(names, sig)},
        kernels=list(Ks.keys()),
    )


def predict_gblup_kernels(
    model: MultiKernelModel,
    Ks: dict,
    test_idx: np.ndarray,
    covariates: np.ndarray | None = None,
) -> np.ndarray:
    test_idx = np.asarray(test_idx)
    n_s = len(test_idx)
    X = np.ones((n_s, 1)) if covariates is None else np.concatenate(
        [np.ones((n_s, 1)), np.asarray(covariates)[test_idx]], axis=1
    )
    pred = X @ model.beta
    for nm in model.kernels:
        Kst = Ks[nm][np.ix_(test_idx, model.train_idx)]
        pred = pred + model.sigma2[nm] * (Kst @ model.Py)
    return pred


def fit_gblup_cg(
    K: np.ndarray,
    y: np.ndarray,
    train_idx: np.ndarray,
    lbd: float,
    covariates: np.ndarray | None = None,
    tol: float | None = None,
    max_iter: int | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """α via Jacobi-PCG on (K_tt + λI) on the device — the large-n route
    that avoids the O(n^3) eigendecomposition (reference rrblup_pcg/splmm
    PCG analog).

    Returns (alpha, beta): beta is the OLS fixed-effect fit used to
    residualize y, so callers can form consistent predictions
    X_new @ beta + K[new, train] @ alpha."""
    dev = config.resolve_device(device)
    tol = config.knob("JX_TPU_CG_TOL") if tol is None else tol
    max_iter = config.knob("JX_TPU_CG_MAX_ITER") if max_iter is None else max_iter
    train_idx = np.asarray(train_idx)
    Ktt = torch.as_tensor(K[np.ix_(train_idx, train_idx)], dtype=torch.float32, device=dev)
    y_t = np.asarray(y, np.float64).reshape(-1)[train_idx]
    n_t = len(train_idx)
    X = np.ones((n_t, 1)) if covariates is None else np.concatenate(
        [np.ones((n_t, 1)), np.asarray(covariates)[train_idx]], axis=1
    )
    beta, *_ = np.linalg.lstsq(X, y_t, rcond=None)
    r = torch.as_tensor(y_t - X @ beta, dtype=torch.float32, device=dev)
    lbd32 = torch.tensor(lbd, dtype=torch.float32, device=dev)
    diag = torch.diagonal(Ktt) + lbd32
    res = cg_solve(lambda v: Ktt @ v + lbd32 * v, r, diag_precond=diag,
                   tol=float(np.float32(tol)), max_iter=int(max_iter))
    return res.x.cpu().numpy().astype(np.float64), np.asarray(beta, np.float64)
