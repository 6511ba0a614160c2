"""Bayes A / B / Cπ marker-effect models — device-resident blocked Gibbs
(port of janusx_tpu/gs/bayes.py).

Model and priors as the reference (BGLR-style defaults: r2=0.5, df0_b=5,
df0_e=5, prob_in=0.5, counts=10):

    y = 1μ + Z a + e,  e ~ N(0, σe² I),  Z standardized (n, m)
    BayesA  : a_j ~ N(0, σ_j²),  σ_j² ~ scaled-inv-χ²(df0_b, S0_b)
    BayesB  : δ_j ~ Bern(π) spike-and-slab over the BayesA hierarchy
    BayesCπ : shared slab variance, π ~ Beta-Binomial posterior

The same chain as the reference's, blocked the same way: markers in blocks
of C = min(block, max(8, m)), zero-padded, with the block Grams Gb = Zb Zbᵀ
and x2 = Σ Zb². BayesB and BayesCπ sweep marker by marker
(``kernels.gibbs_sweep_marker``, G1); BayesA draws each block jointly
(``kernels.gibbs_sweep_block_mvn``, G2). Each iteration is one sweep launch
plus a few scalar torch ops in the reference's order (intercept, sweep, σe²,
then the slab variance and π, then the accumulators and the (μ, σe²)
trace); everything stays on the fit's device, so a fit copies to the host
once, at its end. The chain runs in f32, as the reference's.

Random numbers come from one ``torch.Generator`` seeded from ``seed`` on
the fit's device, not from ``jax.random``: the same seed gives another
chain than the reference's, with the same stationary distribution.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.ops import kernels

f32 = torch.float32
_TAGS = {"BayesA": "A", "BayesB": "B", "BayesCpi": "Cpi"}


class GeneratorDraws:
    """The chain's draws from a ``torch.Generator``: normals and uniforms by
    ``torch.randn``/``torch.rand``, χ² as twice a ``torch._standard_gamma``
    draw, Beta(a, b) as G_a / (G_a + G_b)."""

    def __init__(self, seed: int, device: torch.device, df0_b: float):
        self.g = torch.Generator(device=device)
        self.g.manual_seed(int(seed))
        self.dev = device
        self.df0_b = df0_b

    def _gamma(self, alpha: torch.Tensor) -> torch.Tensor:
        return torch._standard_gamma(alpha, generator=self.g)

    def _full(self, shape, value) -> torch.Tensor:
        return torch.full(shape, value, dtype=f32, device=self.dev)

    def sweep(self, n_blocks: int, C: int, method: str):
        """(μ noise, rn, ru, rca, rci) of one iteration: BayesA's blocked
        sweep takes (μ noise, z, None, χ²_{df0_b+1}, None)."""
        shape = (n_blocks, C)
        mu = torch.randn((), generator=self.g, dtype=f32, device=self.dev)
        rn = torch.randn(shape, generator=self.g, dtype=f32, device=self.dev)
        chi = lambda dof: 2.0 * self._gamma(self._full(shape, dof / 2.0))
        if method == "A":
            return mu, rn, None, chi(self.df0_b + 1.0), None
        ru = torch.rand(shape, generator=self.g, dtype=f32, device=self.dev)
        if method == "B":
            return mu, rn, ru, chi(self.df0_b + 1.0), chi(self.df0_b)
        # BayesCπ never reads var_b, so its χ² draws would be dead work
        ones = self._full(shape, 1.0)
        return mu, rn, ru, ones, ones

    def var_e(self, shape: float) -> torch.Tensor:
        """A χ² draw of 2·shape degrees of freedom (0-d)."""
        return 2.0 * self._gamma(self._full((), shape))

    def slab(self, shape: torch.Tensor) -> torch.Tensor:
        return 2.0 * self._gamma(shape)

    def pi(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ga, gb = self._gamma(a), self._gamma(b)
        return ga / (ga + gb)


def _chain(Zb, Gb, x2, y32, draws, n_iter: int, burnin: int, thin: int, tag: str,
           m_real: int, r2: float, df0_b: float, df0_e: float, prob_in: float,
           counts: float):
    """The reference's ``_gibbs`` (BayesB, BayesCπ) and ``_gibbs_blocked_a``
    (BayesA) iteration on device tensors. Returns (posterior-mean effects
    (n_blocks, C), posterior-mean μ, the (n_iter, 2) trace of (μ, σe²))."""
    n_blocks, C, n = Zb.shape
    m = m_real
    real = x2 > 0  # non-padding, polymorphic markers
    msx = x2.sum() / n
    var_y = torch.var(y32)
    prob_eff = 1.0 if tag == "A" else prob_in
    s0_b = var_y * r2 / msx * (df0_b + 2.0) / prob_eff
    var_e = var_y * (1.0 - r2)
    s0_e = var_e * (df0_e + 2.0)
    counts_in = prob_in * counts
    counts_out = counts - counts_in
    vb_fill = s0_b / (df0_b + 2.0)

    mu = y32.mean()
    r = y32 - mu
    beta = torch.zeros((n_blocks, C), dtype=f32, device=Zb.device)
    var_b = vb_fill.expand(n_blocks, C).clone()
    var_slab = vb_fill
    pi = torch.tensor(prob_in, dtype=f32, device=Zb.device)
    acc_b, acc_mu, n_acc = torch.zeros_like(beta), torch.zeros_like(mu), 0
    trace = []
    for it in range(n_iter):
        mu_noise, rn, ru, rca, rci = draws.sweep(n_blocks, C, tag)
        r_mu = r + mu
        mu = r_mu.mean() + mu_noise * torch.sqrt(var_e / n)
        r = r_mu - mu
        scal = torch.stack([var_e, var_slab, pi, s0_b, vb_fill])
        if tag == "A":
            kernels.gibbs_sweep_block_mvn(Zb, Gb, x2, beta, var_b, rn, rca, r, scal)
        else:
            delta = kernels.gibbs_sweep_marker(Zb, Gb, x2, beta, var_b, rn, ru, rca, rci,
                                               r, scal, tag)
        var_e = (r @ r + s0_e) / draws.var_e((n + df0_e) / 2.0)
        if tag != "A":
            n_active = (delta * real).sum()
            if tag == "Cpi":
                var_slab = ((beta * beta).sum() + s0_b) / draws.slab((df0_b + n_active) / 2.0)
            pi = draws.pi(counts_in + n_active, counts_out + m - n_active)
            pi = torch.clamp(pi, 1e-6, 1.0 - 1e-6)
        if it >= burnin and (it - burnin) % thin == 0:
            acc_b += beta
            acc_mu += mu
            n_acc += 1
        trace.append(torch.stack([mu, var_e]))
    denom = float(max(n_acc, 1))
    return acc_b / denom, acc_mu / denom, torch.stack(trace)


def block_markers(Z: torch.Tensor, block: int = 128):
    """The reference's blocking of an (n, m) standardized f32 matrix: C =
    min(block, max(8, m)) markers per block, the last zero-padded; returns
    the marker rows Zb (n_blocks, C, n), the block Grams Gb = Zb Zbᵀ
    (n_blocks, C, C) and x2 = Σ Zb² (n_blocks, C), on Z's device."""
    n, m = Z.shape
    C = min(block, max(8, m))
    n_blocks = -(-m // C)
    Zt = torch.zeros((n_blocks * C, n), dtype=f32, device=Z.device)
    Zt[:m] = Z.T
    Zb = Zt.view(n_blocks, C, n)
    return Zb, torch.bmm(Zb, Zb.transpose(1, 2)), (Zb * Zb).sum(dim=2)


def bayes_fit(
    Z,  # (n, m) standardized sample-major, numpy or a tensor
    y: np.ndarray,
    method: str,  # "BayesA" | "BayesB" | "BayesCpi"
    n_iter: int = 400,
    burnin: int = 200,
    thin: int = 1,
    seed: int = 0,
    block: int = 128,
    r2: float = 0.5,
    df0_b: float = 5.0,
    df0_e: float = 5.0,
    prob_in: float = 0.5,
    counts: float = 10.0,
    return_trace: bool = False,
    device=None,
    _draws=None,
):
    """Returns (marker_effects (m,), mu); with ``return_trace`` also the
    (n_iter, 2) per-iteration (mu, var_e) global-parameter trace used for
    multi-chain R-hat diagnostics. A tensor ``Z`` runs on its own device,
    a numpy one on ``config.resolve_device(device)``. ``_draws`` replaces
    the generator's draws (GeneratorDraws' methods); only tests set it."""
    tag = _TAGS[method]
    if burnin >= n_iter:
        raise ValueError(
            f"bayes burnin ({burnin}) must be smaller than n_iter "
            f"({n_iter}): no posterior samples would be collected")
    if isinstance(Z, torch.Tensor):
        dev = Z.device
        Z = Z.to(f32)
    else:
        dev = config.resolve_device(device)
        Z = torch.as_tensor(np.asarray(Z, np.float32), device=dev)
    m = Z.shape[1]
    Zb, Gb, x2 = block_markers(Z, block)
    y32 = torch.as_tensor(np.asarray(y, np.float64), device=dev).to(f32)
    draws = _draws if _draws is not None else GeneratorDraws(seed, dev, df0_b)
    beta, mu, tr = _chain(Zb, Gb, x2, y32, draws, n_iter, burnin, thin, tag, m, r2, df0_b,
                          df0_e, prob_in, counts)
    # one copy to the host per fit
    out = torch.cat([beta.reshape(-1)[:m], mu.reshape(1), tr.reshape(-1)]).cpu().numpy()
    beta, mu = out[:m].astype(np.float64), float(out[m])
    if return_trace:
        return beta, mu, out[m + 1:].reshape(n_iter, 2).astype(np.float64)
    return beta, mu


def bayes_fit_predict(cfg, method, Xml, y, train, test, folds):
    """GS-workflow adapter: CV + final fit + test prediction.

    ``folds`` is a precomputed list of (train_loc, val_loc) index pairs
    (empty = CV disabled). ``Xml`` goes to the device once; each fold's
    rows are taken there."""
    from janusx_tpu_torch.gs.metrics import regression_metrics

    dev = config.resolve_device()
    X = torch.as_tensor(np.asarray(Xml, np.float32), device=dev)

    def rows(idx):
        return X.index_select(0, torch.as_tensor(np.asarray(idx, np.int64), device=dev))

    def predict(idx, beta, mu):
        b = torch.as_tensor(beta, dtype=torch.float64, device=dev)
        return mu + (rows(idx).to(torch.float64) @ b).cpu().numpy()

    fold_metrics = []
    oof = np.full(len(train), np.nan)
    for fold, (tr_loc, va_loc) in enumerate(folds):
        t0 = time.monotonic()
        beta, mu = bayes_fit(
            rows(train[tr_loc]), y[train[tr_loc]], method,
            cfg.bayes_iters, cfg.bayes_burnin, cfg.bayes_thin, cfg.seed + fold,
        )
        pv = predict(train[va_loc], beta, mu)
        oof[va_loc] = pv
        mets = regression_metrics(y[train[va_loc]], pv)
        mets.update(fold=fold, elapsed_sec=round(time.monotonic() - t0, 3))
        fold_metrics.append(mets)
    t1 = time.monotonic()
    beta, mu = bayes_fit(
        rows(train), y[train], method,
        cfg.bayes_iters, cfg.bayes_burnin, cfg.bayes_thin, cfg.seed,
    )
    test_pred = predict(test, beta, mu) if len(test) else np.empty(0)
    info = {"fit_seconds": time.monotonic() - t1, "mu": mu, "beta_std": beta,
            "oof_pred": oof}
    return test_pred, fold_metrics, info
