"""Plain reference of FarmCPU (``jx gwas -farmcpu``; Liu et al. 2016, PLoS
Genet 12(2):e1005767, with rMVP's rules as the port's docstring states
them), on the configuration's genome map.

From the raw codes: the SNPs that pass QC, minor allele counted, centered
(missing at 0), at their map positions. Per trait, loops t = 0, 1, ... up
to ``max_loops``:

1. FEM: the LM of y on the design X = [1, the current pseudo-QTNs] and
   each SNP g, through a QR of the design: with X = QR, Q'g = R^-T X'g,
   g'Mg = g'g - |Q'g|^2, g'My = g'y - (Q'g)'(Q'y), beta = g'My / g'Mg,
   se^2 = (y'My - beta g'My) / (n - p - 1) / g'Mg and the two-sided
   Student-t p on n - p - 1 degrees of freedom. X'g comes from the columns
   G z_j of the panel against each pseudo-QTN z_j, computed in blocks on
   the card once per trait and marker. A pseudo-QTN's own p is its
   coefficient's t-test in the joint model [1, every pseudo-QTN].
2. At loop 0, if no p is below the threshold (1 / the SNPs scanned), the
   scan is the result.
3. Bins: per window w the bin of a SNP is (chromosome, pos // w); the
   leads for (w, k) are the k bins whose best p is smallest, each by its
   best SNP (the first of equal p in SNP order).
4. REM: each (w, k) set, windows in order and counts within, is scored by
   min over log10 λ in [-5, 5] of 1/2 ((n-1) ln q(λ) + ln|K + λI|) for the
   mean-centered y, K = Z Z' / k of the set's centered rows Z and q(λ) =
   y'(K + λI)^-1 y (this module's own bounded minimizer); the first set
   with the smallest score wins.
5. Its SNPs with p < ``qtn_threshold`` join the current pseudo-QTNs; of
   those, in order of p, a SNP is kept unless its Pearson |r| with one kept
   before it exceeds 0.7.
6. The loop stops when the set equals the current one or one seen before.

Then the final FEM scan with the set; each pseudo-QTN's row takes beta, se
and p of its coefficient in the joint model. Float64 at ``prec="ref"``,
one step lower at ``prec="low"`` (float32, TF32 products summed in
float32).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.optimize
import scipy.special
import torch

from portbench.reference.common import DBL_MIN, centered, matmul, qc_rows, unpack

R_PRUNE = 0.7


def site_map(rows: np.ndarray, m: int, gmap: dict) -> tuple[np.ndarray, np.ndarray]:
    """Chromosome (1-based) and position of raw SNPs ``rows`` of a panel of
    ``m``: raw SNP i lies on chromosome 1 + floor(c i / m), at spacing x
    (its rank within that chromosome + 1) bp."""
    c, step = gmap["n_chrom"], gmap["spacing_bp"]
    rows = np.asarray(rows, np.int64)
    chrom = rows * c // m
    first = -(-chrom * m // c)  # the first raw SNP of each chromosome
    return chrom + 1, (rows - first + 1) * step


def t_p(t: np.ndarray, df: int) -> np.ndarray:
    """Two-sided Student-t p, clipped below at the least normal double."""
    return np.clip(2.0 * scipy.special.stdtr(df, -np.abs(t)), DBL_MIN, 1.0)


class FarmCpu:
    def __init__(self, raw: np.ndarray, n: int, cfg: dict, scan: dict, device,
                 prec: str = "ref", block: int = 8192):
        self.n, self.prec, self.block = n, prec, block
        self.scan = scan
        self.dev = torch.device(device)
        self.dt = torch.float64 if prec == "ref" else torch.float32
        self.np_dt = np.float64 if prec == "ref" else np.float32
        qc = cfg["qc"]
        kept, sign, freq, gg, gs = [], [], [], [], []
        for s0 in range(0, raw.shape[0], block):
            codes = unpack(raw[s0:s0 + block], n, self.dev)
            keep, sg, p = qc_rows(codes, qc["maf"], qc["geno"])
            x = centered(codes[keep], p[keep], self.dt) * sg[keep].to(self.dt)[:, None]
            kept.append(s0 + np.nonzero(keep.cpu().numpy())[0])
            sign.append(sg[keep])
            freq.append(p[keep])
            gg.append(torch.sum(x * x, dim=1))
            gs.append(torch.sum(x, dim=1))
        self.rows = np.concatenate(kept)
        self.m = len(self.rows)
        self.packed = raw[self.rows]
        self.sign, self.freq = torch.cat(sign), torch.cat(freq)
        self.gg = torch.cat(gg).double().cpu().numpy()
        self.gsum = torch.cat(gs).double().cpu().numpy()
        chrom, pos = site_map(self.rows, raw.shape[0], cfg["genome_map"])
        self.chrom, self.pos = chrom, pos

    def _x(self, s0: int, s1: int) -> torch.Tensor:
        """Centered, minor-allele rows [s0, s1) of the kept SNPs."""
        codes = unpack(self.packed[s0:s1], self.n, self.dev)
        return centered(codes, self.freq[s0:s1], self.dt) * self.sign[s0:s1].to(self.dt)[:, None]

    def rows_of(self, idx: np.ndarray) -> np.ndarray:
        """Centered rows (k, n) of the kept SNPs ``idx``."""
        idx = np.asarray(idx, np.int64)
        codes = unpack(self.packed[idx], self.n, self.dev)
        t = torch.as_tensor(idx, device=self.dev)
        x = centered(codes, self.freq[t], self.dt) * self.sign[t].to(self.dt)[:, None]
        return x.cpu().numpy().astype(self.np_dt)

    def _against(self, V: np.ndarray) -> np.ndarray:
        """G V (m, k) for host columns V (n, k), in blocks on the card."""
        Vd = torch.as_tensor(np.ascontiguousarray(V), dtype=self.dt, device=self.dev)
        out = [matmul(self._x(s0, s0 + self.block), Vd, self.prec).double().cpu().numpy()
               for s0 in range(0, self.m, self.block)]
        return np.concatenate(out)

    def _joint(self, y: np.ndarray, Z: np.ndarray):
        """beta, se, p of the columns Z (n, k) in the model [1, Z]."""
        n, k = len(y), Z.shape[1] + 1
        X = np.concatenate([np.ones((n, 1), self.np_dt), Z], axis=1)
        Q, R = np.linalg.qr(X)
        beta = scipy.linalg.solve_triangular(R, Q.T @ y)
        r = y - X @ beta
        df = n - k
        Ri = scipy.linalg.solve_triangular(R, np.eye(k, dtype=self.np_dt))
        se = np.sqrt(float(r @ r) / df * np.sum(Ri * Ri, axis=1))
        beta, se = beta.astype(np.float64), se.astype(np.float64)
        return beta[1:], se[1:], t_p(beta[1:] / se[1:], df)

    def fem(self, y: np.ndarray, gy: np.ndarray, cols: dict, qtns: np.ndarray):
        """beta, se, p of every SNP with the pseudo-QTNs ``qtns`` in the design."""
        n = self.n
        Z = self.rows_of(qtns).T if len(qtns) else np.empty((n, 0), self.np_dt)
        X = np.concatenate([np.ones((n, 1), self.np_dt), Z], axis=1)
        p = X.shape[1]
        _, R = np.linalg.qr(X)
        Xg = np.stack([self.gsum] + [cols[int(j)] for j in qtns]).astype(self.np_dt)
        Qg = scipy.linalg.solve_triangular(R, Xg, trans="T")  # (p, m)
        Qy = scipy.linalg.solve_triangular(R, X.T @ y, trans="T")
        gMg = self.gg - np.sum(Qg.astype(np.float64) ** 2, axis=0)
        gMy = gy - Qg.T.astype(np.float64) @ Qy.astype(np.float64)
        yMy = float(y @ y) - float(Qy @ Qy)
        df = n - p - 1
        ok = gMg > 1e-8 * self.gg
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = np.where(ok, gMy / gMg, np.nan)
            se = np.where(ok, np.sqrt((yMy - beta * gMy) / df / gMg), np.nan)
            ok &= np.isfinite(se) & (se > 0)
            pv = np.where(ok, t_p(beta / np.where(ok, se, 1.0), df), 1.0)
        beta, se = np.where(ok, beta, np.nan), np.where(ok, se, np.nan)
        if len(qtns):
            beta[qtns], se[qtns], pv[qtns] = self._joint(y, Z)
        return beta, se, pv

    def leads(self, order: np.ndarray, window: int) -> np.ndarray:
        """For p order ``order``: the best SNP of each window-bin, the bins
        in order of their best p (the first of equal p in SNP order)."""
        b = self.chrom[order] * (1 << 40) + self.pos[order] // window
        _, first = np.unique(b, return_index=True)
        return order[np.sort(first)]

    def rem(self, y: np.ndarray, idx: np.ndarray) -> float:
        """The REM score of the lead set ``idx``: the objective over a grid
        of 2,001 points of log10 λ, then a bounded Brent to 1e-11 inside the
        best point's neighbouring cells."""
        Z = self.rows_of(idx) / self.np_dt(np.sqrt(len(idx)))
        _, sv, Wt = np.linalg.svd(Z, full_matrices=False)
        s = sv * sv
        keep = s > 1e-10
        s, U = s[keep], Wt[keep]
        yc = y - y.mean()
        yu = U @ yc
        yy, uu = float(yc @ yc), float(yu @ yu)
        n, r = len(y), len(s)

        def f(lg):
            lg = np.atleast_1d(np.asarray(lg, np.float64))
            lam = (10.0 ** lg).astype(self.np_dt)[:, None]
            q = (np.sum(yu * yu / (s + lam), axis=1) + (yy - uu) / lam[:, 0]).astype(np.float64)
            val = 0.5 * ((n - 1) * np.log(np.where(q > 0, q, 1.0))
                         + np.sum(np.log(s + lam), axis=1) + (n - r) * np.log(lam[:, 0]))
            return np.where(q > 0, val, 1e8)

        xs = np.linspace(-5.0, 5.0, 2001)
        fs = f(xs)
        i = int(np.nanargmin(fs))
        res = scipy.optimize.minimize_scalar(
            lambda x: float(f(x)[0]), bounds=(xs[max(i - 1, 0)], xs[min(i + 1, len(xs) - 1)]),
            method="bounded", options={"xatol": 1e-11, "maxiter": 500})
        return float(min(res.fun, fs[i]))

    def prune(self, cand: np.ndarray, pv: np.ndarray) -> np.ndarray:
        if len(cand) <= 1:
            return cand
        R = np.corrcoef(self.rows_of(cand).astype(np.float64))
        kept: list = []
        for i in np.argsort(pv[cand], kind="stable"):
            if all(abs(R[i, j]) <= R_PRUNE for j in kept):
                kept.append(i)
        return np.sort(cand[np.array(kept, np.int64)])

    def trait(self, y: np.ndarray) -> dict:
        sc = self.scan
        y = np.asarray(y, np.float64).astype(self.np_dt)
        gy = self._against(y[:, None])[:, 0]
        n = self.n
        counts = lead_counts(n, sc["nbin"], sc["qtn_bound"])
        tau = sc["p_threshold"] if sc["p_threshold"] is not None else 1.0 / self.m
        cols: dict = {}
        qtns = np.array([], np.int64)
        seen, sets, loops = [], [], 0
        for loop in range(sc["max_loops"]):
            loops = loop + 1
            new = [int(j) for j in qtns if int(j) not in cols]
            if new:
                for j, c in zip(new, self._against(self.rows_of(new).T).T):
                    cols[j] = c
            beta, se, pv = self.fem(y, gy, cols, qtns)
            if loop == 0 and np.nanmin(pv) >= tau:
                return dict(beta=beta, se=se, p=pv, lam=1.0, qtns=qtns, loops=loops,
                            loop_sets=sets)
            best, lead = np.inf, np.array([], np.int64)
            order = np.argsort(pv, kind="stable")
            for w in sc["window_sizes"]:
                bins = self.leads(order, w)
                for k in counts:
                    idx = np.sort(bins[:k])
                    score = self.rem(y, idx)
                    if score < best:
                        best, lead = score, idx
            lead = lead[pv[lead] < sc["qtn_threshold"]]
            cand = self.prune(np.unique(np.concatenate([qtns, lead])), pv)
            if sc["qtn_bound"] is not None and len(cand) > sc["qtn_bound"]:
                cand = np.sort(cand[np.argsort(pv[cand])[:sc["qtn_bound"]]])
            key = tuple(cand.tolist())
            sets.append(key)
            done = np.array_equal(cand, qtns) or key in seen
            seen.append(key)
            qtns = cand
            if done:
                break
        new = [int(j) for j in qtns if int(j) not in cols]
        if new:
            for j, c in zip(new, self._against(self.rows_of(new).T).T):
                cols[j] = c
        beta, se, pv = self.fem(y, gy, cols, qtns)
        return dict(beta=beta, se=se, p=pv, lam=1.0, qtns=qtns, loops=loops, loop_sets=sets)

    def run(self, Ys: list) -> list[dict]:
        return [self.trait(y) for y in Ys]


def lead_counts(n: int, nbin: int, bound) -> tuple:
    """The lead-count grid: ``nbin`` even steps up to the bound, which is
    floor(sqrt(n / log10 n)) when unset."""
    qb = bound if bound else max(int(np.floor(np.sqrt(n / np.log10(n)))), 1)
    step = max(qb // nbin, 1)
    return tuple(range(step, qb + 1, step)) or (qb,)
