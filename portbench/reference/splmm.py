"""Plain reference of the GRAMMAR-gamma sparse-GRM scan (``jx gwas -splmm``).

From the raw codes: the centered GRM over the SNPs that pass QC, every
off-diagonal entry below the cutoff in magnitude set to 0, split into its
connected components and each eigendecomposed (negative eigenvalues set
to 0). Per trait, on the intercept-residualized phenotype y~: the null
fit of log10 λ minimizing ½(n_eff ln q(λ) + ln|V|), V = K + λI, q(λ) =
y~'V^-1 y~, σ² = q/n_eff; a = V^-1 y~ / σ²; γ, the mean of g~'V^-1 g~ /
g~'g~ over the route's sampled markers whose χ² = (g~'a)² σ² / g~'V^-1 g~
is below the cutoff; and per SNP beta = g~'a / (γ/σ² · g~'g~), se =
1/sqrt(γ/σ² · g~'g~) and the Wald p. Float64 at ``prec="ref"``, one step
lower at ``prec="low"``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import torch

from portbench.reference.common import (centered, matmul, minimize, pwald, qc_rows,
                                        unpack)


class SparseGrammar:
    def __init__(self, raw: np.ndarray, n: int, cfg: dict, scan: dict, device,
                 prec: str = "ref", block: int = 4096):
        self.raw, self.n, self.prec, self.block = raw, n, prec, block
        self.dev = torch.device(device)
        self.dt = torch.float64 if prec == "ref" else torch.float32
        self.np_dt = np.float64 if prec == "ref" else np.float32
        self.qc, self.scan = cfg["qc"], scan
        K = torch.zeros((n, n), dtype=self.dt, device=self.dev)
        denom, kept = 0.0, []
        for s0 in range(0, raw.shape[0], block):
            x, pk, rows = self._rows(s0, s0 + block)
            kept.append(rows)
            K += matmul(x.T, x, prec).to(self.dt)
            denom += float(torch.sum(2.0 * pk * (1.0 - pk)))
        self.kept_rows = np.concatenate(kept)
        self.m = len(self.kept_rows)
        K = K / denom
        keep = torch.abs(K) >= cfg["sparse_cutoff"]
        keep |= torch.eye(n, dtype=torch.bool, device=self.dev)
        i, j = torch.nonzero(keep, as_tuple=True)
        vals = K[i, j].double().cpu().numpy()
        del K, keep
        Ks = scipy.sparse.csr_matrix((vals, (i.cpu().numpy(), j.cpu().numpy())), shape=(n, n))
        ncomp, labels = scipy.sparse.csgraph.connected_components(Ks, directed=False)
        self.max_comp = int(np.bincount(labels).max())
        # components grouped by size: (members (c, s), eigenvalues (c, s), vectors (c, s, s))
        self.groups = []
        order = np.argsort(labels, kind="stable")
        sizes = np.bincount(labels)
        starts = np.concatenate([[0], np.cumsum(sizes)])
        for size in np.unique(sizes):
            comps = np.nonzero(sizes == size)[0]
            idx = np.stack([order[starts[c]:starts[c] + size] for c in comps])
            blocks = np.stack([Ks[ix][:, ix].toarray() for ix in idx]).astype(self.np_dt)
            sv, U = np.linalg.eigh(blocks)
            self.groups.append((idx, np.clip(sv, 0, None), U))

    def _rows(self, s0: int, s1: int, rows=None):
        """Centered, minor-allele rows of the raw SNPs [s0, s1) (or of the
        raw rows ``rows``) that pass QC, their minor allele frequencies and
        their raw row indices."""
        idx = np.arange(s0, min(s1, self.raw.shape[0])) if rows is None else rows
        codes = unpack(self.raw[idx], self.n, self.dev)
        keep, sign, p = qc_rows(codes, self.qc["maf"], self.qc["geno"])
        x = centered(codes[keep], p[keep], self.dt) * sign[keep].to(self.dt)[:, None]
        pk = p[keep]
        return x, torch.where(pk > 0.5, 1.0 - pk, pk), idx[keep.cpu().numpy()]

    def _rotate(self, b: np.ndarray) -> list:
        return [np.einsum("cst,cs...->ct...", U, b[idx]) for idx, _, U in self.groups]

    def _solve(self, lam: float, b: np.ndarray) -> np.ndarray:
        """(K + λI)^-1 b for b (n,) or (n, k)."""
        out = np.zeros_like(b)
        for (idx, sv, U), r in zip(self.groups, self._rotate(b)):
            d = 1 / (sv + self.np_dt(lam))
            r = r * (d if r.ndim == 2 else d[..., None])
            out[idx] = np.einsum("cst,ct...->cs...", U, r)
        return out

    def _null(self, yt: np.ndarray) -> tuple[float, float]:
        n_eff = self.n - 1
        rot = [r * r for r in self._rotate(yt)]
        svs = [sv for _, sv, _ in self.groups]

        def nll(lg):
            lam = self.np_dt(10.0 ** lg)
            q = sum(np.sum(r / (sv + lam)) for r, sv in zip(rot, svs))
            if q <= 0:
                return 1e8
            logdet = sum(np.sum(np.log(sv + lam)) for sv in svs)
            return float(0.5 * (n_eff * np.log(q) + logdet))

        lg = minimize(nll, *self.scan["log10_lambda"])
        lam = 10.0 ** lg
        q = sum(np.sum(r / (sv + self.np_dt(lam))) for r, sv in zip(rot, svs))
        return lam, float(q) / n_eff

    def run(self, Ys: list) -> list[dict]:
        """Per trait: lam, sigma2, gamma, beta, se, p over the kept SNPs."""
        n = self.n
        traits = []
        for y in Ys:
            yt = (y - np.mean(y)).astype(self.np_dt)
            lam, s2 = self._null(yt)
            a = self._solve(lam, yt) / self.np_dt(s2)
            traits.append(dict(lam=lam, sigma2=s2, a=a, beta=[], se=[]))
        # γ's markers: the route's own draw over the kept SNPs
        rng = np.random.default_rng(self.scan["gamma_seed"])
        samp = np.sort(rng.choice(self.m, min(self.scan["gamma_markers"], self.m),
                                  replace=False))
        G = self._take(samp)
        Gt = G - G.mean(axis=1, keepdims=True)
        gg = np.einsum("kn,kn->k", Gt, Gt)
        for t in traits:
            VG = self._solve(t["lam"], np.ascontiguousarray(Gt.T))
            gPg = np.einsum("kn,nk->k", Gt, VG) / self.np_dt(t["sigma2"])
            ga = Gt @ t["a"]
            with np.errstate(divide="ignore", invalid="ignore"):
                chi2 = np.where(gPg > 0, ga * ga / gPg, np.inf)
            ok = (gg > 1e-12) & (chi2 < self.scan["null_chi2_cutoff"]) & (gPg > 0)
            t["gamma"] = float(np.mean(gPg[ok] / gg[ok] * t["sigma2"])) if ok.any() else 1.0
            t["Ma"] = torch.as_tensor(t["a"] - t["a"].mean(), dtype=self.dt, device=self.dev)
        for s0 in range(0, self.raw.shape[0], self.block):
            x, _, _ = self._rows(s0, s0 + self.block)
            sx = torch.sum(x, dim=1)
            gMg = (torch.sum(x * x, dim=1) - sx * sx / n).double().cpu().numpy()
            for t in traits:
                gA = matmul(x, t["Ma"][:, None], self.prec)[:, 0].double().cpu().numpy()
                ge = t["gamma"] / t["sigma2"]
                with np.errstate(divide="ignore", invalid="ignore"):
                    beta = gA / (ge * gMg)
                    se = 1.0 / np.sqrt(ge * gMg)
                bad = ~(np.isfinite(beta) & np.isfinite(se) & (se > 0)) | (gMg <= 1e-12)
                t["beta"].append(np.where(bad, np.nan, beta))
                t["se"].append(np.where(bad, np.nan, se))
        out = []
        for t in traits:
            beta, se = np.concatenate(t["beta"]), np.concatenate(t["se"])
            out.append(dict(lam=t["lam"], gamma=t["gamma"], beta=beta, se=se,
                            p=pwald(beta, se)))
        return out

    def _take(self, kept_idx: np.ndarray) -> np.ndarray:
        """Centered rows (k, n) of the kept SNPs with these kept indices."""
        x, _, _ = self._rows(0, 0, rows=self.kept_rows[kept_idx])
        return x.cpu().numpy().astype(self.np_dt)
