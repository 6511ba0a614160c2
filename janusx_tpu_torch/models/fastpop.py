"""FastPop / ADMIXTURE-style ancestry decomposition (port of
janusx_tpu/models/fastpop.py).

Replaces the reference's adamixture engine (JanusX
src/stats/adamixture.rs: EM + Adam updates of P/Q over streamed BED
log-likelihood, RSVD init, CV error; python/janusx/adamixture/core.py
train_adamixture).

Model: binomial likelihood of dosages g_ij in {0,1,2}
    L = Σ_ij [ g_ij ln f_ij + (2 - g_ij) ln(1 - f_ij) ],  F = Q P
with Q (n, K) on the simplex per sample and P (K, m) in (0, 1).

Both reference solvers run as device loops over the 2-bit packed SNP
blocks (missing genotypes contribute zero), f32 throughout:

- "adam-em" (the reference default): each iteration computes the closed-
  form EM target (p_em, q_em) with per-block f32 products and feeds the EM
  delta through Adam moments, with clip-to-[1e-5,1-1e-5], Q-row
  renormalization, best-loglik keeping and lr decay on non-improvement.
- "adam": full-likelihood Adam on softmax(Q)/sigmoid(P) logits, the
  gradient by ``torch.autograd`` one block at a time (each block's loss is
  back-propagated on its own: Q's gradient accumulates, each P block gets
  its own, so no graph over all blocks is held).

The reference's ``while_loop`` stop test (-check/-tol) is a host check
every ``check_every`` iterations, which stops at the same iteration; the
host reads the device only there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.ops import decode
from janusx_tpu_torch.utils import devcache

_EPS = 1e-6


_EM_EPS = 1e-5  # reference EPS32/EPS64 clip bound (adamixture.rs:49-59)

f32 = torch.float32


@dataclass
class AdmixtureFit:
    Q: np.ndarray  # (n, K) ancestry fractions
    P: np.ndarray  # (K, m) allele frequencies
    loglik: float
    loglik_path: np.ndarray
    n_iter: int
    solver: str = "adam"


def _codes(pkb: torch.Tensor, n: int):
    """(g f32, observed mask) of one packed block's first n samples."""
    codes = decode.unpack_codes(pkb)[:, :n]
    return codes.to(f32), codes != 3


def _block_loglik(qlogit, plogit_b, pkb, n: int):
    """Negative loglik contribution of one packed SNP block."""
    Q = torch.softmax(qlogit, dim=1)  # (n, K)
    g, obs = _codes(pkb, n)
    Pb = torch.sigmoid(plogit_b)  # (B, K)
    F = torch.clamp(Pb @ Q.T, _EPS, 1.0 - _EPS)  # (B, n)
    ll = obs.to(f32) * (g * torch.log(F) + (2.0 - g) * torch.log1p(-F))
    return -ll.sum()


def _adam_step(g, m_, v_, t: torch.Tensor, b1: float, b2: float, eps: float):
    """The reference's Adam arithmetic (fastpop.py:87-93): in-place moments,
    returns the bias-corrected step m̂ / (√v̂ + eps)."""
    m_.mul_(b1).add_((1 - b1) * g)
    v_.mul_(b2).add_((1 - b2) * g * g)
    mhat = m_ / (1 - b1 ** t)
    vhat = v_ / (1 - b2 ** t)
    return mhat / (torch.sqrt(vhat) + eps)


def _check_stop(ll: float, last: float, i: int, check_every: int, tol: float) -> bool:
    """The reference's -check/-tol test at iteration i (0-based), in f32."""
    ll32, last32 = np.float32(ll), np.float32(last)
    with np.errstate(invalid="ignore"):  # the first check: last is -inf, rel NaN
        rel = np.abs(ll32 - last32) / (np.abs(last32) + np.float32(1.0))
    return (i + 1 >= 2 * check_every) and bool(rel < np.float32(tol))


def _train(qlogit0, plogit0, pk, n: int, n_iter: int, lr: float, tol: float = 0.0,
           check_every: int = 0):
    """Full-likelihood Adam over pre-blocked packed rows pk (nblk, B, nb).
    Returns (qlogit, plogit, lls (n_done,), n_done)."""
    nblk, B = pk.shape[0], pk.shape[1]
    ql = qlogit0.clone().requires_grad_(True)
    pl = plogit0.clone().requires_grad_(True)
    mq, vq = torch.zeros_like(ql), torch.zeros_like(ql)
    mp, vp = torch.zeros_like(pl), torch.zeros_like(pl)
    lls, last_ll, i = [], -np.inf, 0
    while i < n_iter:
        ql.grad = pl.grad = None
        loss = torch.zeros((), dtype=f32, device=ql.device)
        for b in range(nblk):
            lb = _block_loglik(ql, pl[b * B:(b + 1) * B], pk[b], n)
            lb.backward()
            loss = loss + lb.detach()
        t = torch.tensor(float(i + 1), dtype=f32, device=ql.device)
        with torch.no_grad():
            dq = _adam_step(ql.grad, mq, vq, t, 0.9, 0.999, 1e-8)
            dp = _adam_step(pl.grad, mp, vp, t, 0.9, 0.999, 1e-8)
            ql -= lr * dq
            pl -= lr * dp
        ll = -loss  # at the pre-update parameters, as the reference
        lls.append(ll)
        i += 1
        if check_every > 0 and i % check_every == 0:
            llf = float(ll)
            done = _check_stop(llf, last_ll, i - 1, check_every, tol)
            last_ll = llf
            if done:
                break
    return ql.detach(), pl.detach(), torch.stack(lls), i


def _em_targets_and_loglik(p, q, pk, n: int):
    """One EM sweep (reference em_step_packed_f32_impl semantics,
    adamixture.rs:5434+) over pre-blocked packed rows pk (nblk, B, nb) and
    p (m_pad, K): returns (p_em (m_pad, K), t (n, K), loglik).

    Per cell aa = g/f, bb = (2-g)/(1-f) with f = p·q clipped to
    [1e-6, 1-1e-6]; per SNP j: a_k = Σ_i q_ik aa, b_k = Σ_i q_ik bb,
    p_em = a p / (p(a-b)+b); per sample i: t_ik = Σ_j p_jk(aa-bb)+bb.
    Missing cells (code 3, incl. SNP-row padding) contribute zero
    everywhere; a fully padded row has denom 0 and keeps p_em = p."""
    nblk, B = pk.shape[0], pk.shape[1]
    K = q.shape[1]
    t_acc = torch.zeros((n, K), dtype=f32, device=q.device)
    ll = torch.zeros((), dtype=f32, device=q.device)
    zero = torch.zeros((), dtype=f32, device=q.device)
    p_em = torch.empty_like(p)
    for b in range(nblk):
        pb = p[b * B:(b + 1) * B]
        g, obs = _codes(pk[b], n)
        F = torch.clamp(pb @ q.T, _EPS, 1.0 - _EPS)  # (B, n)
        AA = torch.where(obs, g / F, zero)
        BB = torch.where(obs, (2.0 - g) / (1.0 - F), zero)
        a = AA @ q  # (B, K)
        bq = BB @ q
        denom = pb * (a - bq) + bq
        p_em[b * B:(b + 1) * B] = torch.where(denom.abs() < 1e-8, pb, a * pb / denom)
        t_acc = t_acc + ((AA - BB).T @ pb + BB.sum(dim=0)[:, None])
        ll = ll + torch.where(obs, g * torch.log(F) + (2.0 - g) * torch.log1p(-F), zero).sum()
    return p_em, t_acc, ll


def _renorm_rows(q):
    qs = q.sum(dim=1, keepdim=True)
    bad = (qs <= 0) | ~torch.isfinite(qs)
    return torch.where(bad, torch.full_like(q, 1.0 / q.shape[1]), q / qs)


def _train_adam_em(p0, q0, pk, nobs2, n: int, n_iter: int, lr: float, tol: float,
                   check_every: int, lr_decay: float = 0.5, min_lr: float = 1e-6):
    """Adam-accelerated EM (reference solver "adam-em", the default:
    adamixture.rs adam_optimize_packed_*_impl): each iteration computes
    the EM target (p_em, q_em) and feeds the EM DELTA through Adam
    moments (beta1=0.80, beta2=0.88 per ADAMixtureConfig), clips to
    [1e-5, 1-1e-5], renormalizes Q rows, and every `check_every`
    iterations keeps the best-loglik (p, q), decays the lr on
    non-improvement (x lr_decay, floor min_lr, stop after 2 misses) and
    stops when the relative improvement drops below tol. Returns (p, q,
    lls (n_done,), n_done, ll_best)."""
    b1, b2, eps = 0.80, 0.88, 1e-8
    p, q = p0.clone(), q0.clone()
    mp, vp, mq, vq = (torch.zeros_like(x) for x in (p, p, q, q))
    lr_cur = np.float32(lr)
    ll_best, p_best, q_best, no_imp = np.float32(-np.inf), p, q, 0
    lls, i = [], 0
    while i < n_iter:
        p_in, q_in = p, q
        p_em, t_acc, ll = _em_targets_and_loglik(p, q, pk, n)  # ll at the pre-update (p, q)
        q_em = _renorm_rows(torch.clamp(q * t_acc / nobs2[:, None], _EM_EPS, 1.0 - _EM_EPS))
        t = torch.tensor(float(i + 1), dtype=f32, device=p.device)
        dp = float(lr_cur) * _adam_step(p_em - p, mp, vp, t, b1, b2, eps)
        dq = float(lr_cur) * _adam_step(q_em - q, mq, vq, t, b1, b2, eps)
        p = torch.clamp(p + dp, _EM_EPS, 1.0 - _EM_EPS)
        q = _renorm_rows(torch.clamp(q + dq, _EM_EPS, 1.0 - _EM_EPS))
        lls.append(ll)
        i += 1
        if check_every > 0:
            if i % check_every == 0:
                llf = np.float32(float(ll))
                improved = bool(llf > ll_best)
                converged = _check_stop(llf, ll_best, i - 1, check_every, tol)
                if improved:
                    # save the state the loglik was EVALUATED at (pre-update)
                    p_best, q_best, ll_best, no_imp = p_in, q_in, llf, 0
                else:
                    no_imp += 1
                    lr_cur = np.maximum(lr_cur * np.float32(lr_decay), np.float32(min_lr))
                if converged or no_imp >= 2:
                    break
        else:
            p_best, q_best = p, q
    # return the best-seen (p, q) when checks ran, else the last iterate —
    # and the loglik THAT STATE was evaluated at
    if np.isfinite(ll_best):
        p, q = p_best, q_best
    return p, q, torch.stack(lls), i, float(ll_best)


def train_admixture(
    pg: PackedGenotypes,
    n_pops: int,
    n_iter: int = 300,
    lr: float | None = None,
    block: int = config.DEFAULT_SNP_BLOCK,
    seed: int = 0,
    rsvd_init: bool = True,
    tol: float = 0.0,
    check_every: int = 0,
    solver: str = "adam",
    device=None,
) -> AdmixtureFit:
    dev = config.resolve_device(device)
    n, m, K = pg.n, pg.m, int(n_pops)
    if K < 2:
        raise ValueError("n_pops must be >= 2")
    rng = np.random.default_rng(seed)
    block = min(block, m)
    m_pad = -(-m // block) * block
    pk = devcache.device_packed_blocks(pg, (m_pad // block, block), dev,
                                       lane_align=config.SAMPLE_ALIGN)

    # init: RSVD PCs -> kmeans-ish soft assignment, P from af
    qlogit0 = rng.normal(0, 0.1, size=(n, K)).astype(np.float32)
    if rsvd_init and K > 1:
        try:
            from janusx_tpu_torch.models.pca import rsvd_pca

            _, pcs = rsvd_pca(pg, n_pc=min(K - 1, 8), block=block, device=dev)
            # soft clusters from quantile splits of PC1..; simple + stable
            z = (pcs - pcs.mean(0)) / (pcs.std(0) + 1e-9)
            centers = z[rng.choice(n, K, replace=False)]
            d2 = ((z[:, None, :] - centers[None]) ** 2).sum(-1)
            qlogit0 = (-0.5 * d2).astype(np.float32)
        except Exception:
            pass
    af = np.clip(pg.af, 0.02, 0.98)
    p0 = np.clip(
        af[:, None] + rng.normal(0, 0.05, size=(m, K)), 0.02, 0.98
    )
    plogit0 = np.log(p0 / (1 - p0)).astype(np.float32)
    plogit0 = np.concatenate(
        [plogit0, np.zeros((m_pad - m, K), np.float32)], axis=0
    )
    qlogit0 = torch.as_tensor(qlogit0, device=dev)
    plogit0 = torch.as_tensor(plogit0, device=dev)

    solver = {"auto": "adam-em"}.get(solver, solver)
    if solver not in ("adam", "adam-em"):
        raise ValueError(f"unknown solver {solver!r}")
    if solver == "adam-em":
        # reference ADAMixtureConfig adam-em defaults (core.py:120-125)
        lr_em = 0.005 if lr is None else lr
        q0 = torch.softmax(qlogit0, dim=1)
        p0 = torch.sigmoid(plogit0)
        nobs2 = 2.0 * (pg.dosages() >= 0).sum(axis=0).astype(np.float32)
        nobs2 = np.maximum(nobs2, 1.0)
        p_fit, q_fit, lls, n_done, ll_best = _train_adam_em(
            torch.clamp(p0, _EM_EPS, 1 - _EM_EPS),
            torch.clamp(q0, _EM_EPS, 1 - _EM_EPS),
            pk, torch.as_tensor(nobs2, device=dev), n, n_iter, lr_em,
            tol=float(tol), check_every=int(check_every),
        )
        Q = q_fit.cpu().numpy().astype(np.float64)
        Q /= Q.sum(axis=1, keepdims=True)
        P = p_fit.cpu().numpy().astype(np.float64)[:m].T
        fit_ll = ll_best if np.isfinite(ll_best) else None
    else:
        fit_ll = None
        ql, pl, lls, n_done = _train(
            qlogit0, plogit0, pk, n, n_iter,
            0.05 if lr is None else lr,
            tol=float(tol), check_every=int(check_every),
        )
        Q = torch.softmax(ql, dim=1).cpu().numpy().astype(np.float64)
        P = torch.sigmoid(pl).cpu().numpy().astype(np.float64)[:m].T
    lls = lls.cpu().numpy().astype(np.float64)
    if fit_ll is None:
        fit_ll = float(lls[-1]) if n_done else float("nan")
    return AdmixtureFit(
        Q=Q, P=P, loglik=fit_ll,
        loglik_path=lls, n_iter=n_done, solver=solver,
    )


def cv_error(
    pg: PackedGenotypes,
    n_pops: int,
    holdout_frac: float = 0.1,
    seed: int = 0,
    **kwargs,
) -> float:
    """ADMIXTURE-style CV: mask a random subset of genotype cells, fit, and
    measure binomial deviance on the held-out cells (host evaluation)."""
    rng = np.random.default_rng(seed)
    d = pg.dosages().astype(np.float64)
    obs = d >= 0
    hold = obs & (rng.random(d.shape) < holdout_frac)
    codes = d.copy()
    codes[hold] = -1
    from janusx_tpu_torch.io.gdata import GenotypeData
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes

    gd = GenotypeData(codes.astype(np.int8), pg.sites, pg.samples)
    pg_masked = pack_genotypes(gd, QcParams(maf=0.0, geno=1.0))
    if pg_masked.m != pg.m:
        raise RuntimeError("cv mask unexpectedly dropped SNP rows")
    fit = train_admixture(pg_masked, n_pops, seed=seed, **kwargs)
    F = np.clip(fit.P.T @ fit.Q.T, 1e-6, 1 - 1e-6)  # (m, n)
    # masking can push alt_freq past 0.5, so the re-pack may flip rows:
    # the fitted frequency then models 2-g; map back to pg's coding
    flipped = pg_masked.sites.allele1 != pg.sites.allele1
    F[flipped] = 1.0 - F[flipped]
    g = d[hold]
    f = F[hold]
    dev = -np.mean(g * np.log(f) + (2 - g) * np.log1p(-f))
    return float(dev)


def write_admixture_outputs(prefix: str, samples, fit: AdmixtureFit) -> None:
    K = fit.Q.shape[1]
    with open(f"{prefix}.{K}.Q", "wt") as fh:
        for i, s in enumerate(samples):
            fh.write(" ".join(f"{v:.6f}" for v in fit.Q[i]) + "\n")
    with open(f"{prefix}.{K}.P", "wt") as fh:
        for j in range(fit.P.shape[1]):
            fh.write(" ".join(f"{fit.P[k, j]:.6f}" for k in range(K)) + "\n")
