"""Block-spectral sparse kinship (port of janusx_tpu/models/sparse_spectral.py).

The reference JanusX factorizes ``V_lambda = K_sparse + lambda I`` with an
AMD-ordered sparse LLT once per lambda evaluation (its symbolic analysis
is cached, the numeric factorization is not — JanusX
src/math/cholesky.rs:31-45) and performs per-SNP sparse triangular solves
(JanusX src/stats/splmm.rs:1-9).

A thresholded GRM is block-diagonal up to a permutation: its nonzero
pattern decomposes into connected components (family/relatedness
clusters; unrelated samples are singletons). This is exploited once, at
construction: each component is eigendecomposed (batched
``np.linalg.eigh`` over size-bucketed, zero-padded stacks), after which

- every lambda evaluation (REML null fit) is O(n) elementwise on the
  rotated coordinates — no numeric refactorization;
- ``V^-1 b`` solves are batched tiny matmuls;
- the per-SNP exact-scan quadratic g' V^-1 g is a bucketed batched einsum
  over SNP blocks on the device (``device_quad_fn``).

Padding convention: components are zero-padded into power-of-two size
buckets with identity diagonal, so every pad dimension contributes an
exact eigenpair (eigenvalue 1.0, eigenvector confined to pad rows).
Solves/quads are exact (gathered pad coordinates are zero); logdet
subtracts the analytic pad contribution ``n_pad * log(1+lambda)``.

Percolation guard: components larger than ``JX_TPU_SPARSE_MAX_DENSE_COMP``
(default 4096) stay sparse and are factorized with a fill-reducing host
sparse LU per lambda evaluation instead (the reference's own strategy).
Solves, quads and logdet combine both representations.

Everything here is host numpy/scipy (janusx_tpu/models/sparse_spectral.py
:85-233, :272-318, line for line) except ``device_quad_fn`` (:237-269),
which is torch on an explicit device.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import torch

from janusx_tpu_torch.utils import trace

log = logging.getLogger("janusx_tpu_torch.sparse")


@dataclass
class _Bucket:
    idx: np.ndarray  # (nc, s) int64 sample indices, pad = n
    U: np.ndarray  # (nc, s, s) eigenvectors (pad dims = unit vectors)
    svals: np.ndarray  # (nc, s) eigenvalues (pad dims = 1.0 exactly)
    n_pad: int  # number of pad dimensions in this bucket


@dataclass
class _SparseComp:
    """A connected component too large for a dense eigh: kept sparse,
    factorized per lambda with scipy splu (fill-reducing ordering)."""

    idx: np.ndarray  # (s,) int64 sample indices
    K: scipy.sparse.csc_matrix  # (s, s) component submatrix
    eye: scipy.sparse.csc_matrix  # cached identity with K's shape


@dataclass
class BlockSpectralK:
    """Spectral form of a (permuted-)block-diagonal symmetric sparse K."""

    n: int
    buckets: list[_Bucket] = field(default_factory=list)
    n_pad: int = 0
    max_comp: int = 0  # largest component size (diagnostic)
    sparse_comps: list[_SparseComp] = field(default_factory=list)
    _lu_cache: dict = field(default_factory=dict, repr=False)

    # -- construction -----------------------------------------------------

    @staticmethod
    def from_sparse(
        K: scipy.sparse.spmatrix, max_dense_comp: int | None = None
    ) -> "BlockSpectralK":
        from janusx_tpu_torch import config

        if max_dense_comp is None:
            max_dense_comp = config.knob("JX_TPU_SPARSE_MAX_DENSE_COMP")
        K = K.tocsr()
        n = K.shape[0]
        ncomp, labels = scipy.sparse.csgraph.connected_components(
            K, directed=False
        )
        order = np.argsort(labels, kind="stable")
        bounds = np.searchsorted(labels[order], np.arange(ncomp + 1))
        sizes = np.diff(bounds)
        out = BlockSpectralK(n=n, max_comp=int(sizes.max()) if ncomp else 0)

        big = sizes > max_dense_comp
        if big.any():
            log.warning(
                "percolated kinship graph: %d component(s) exceed the dense"
                " spectral budget (%d samples > %d, JX_TPU_SPARSE_MAX_DENSE_COMP)"
                " — routing them through per-lambda sparse LU factors instead"
                " of a dense eigh",
                int(big.sum()), int(sizes.max()), max_dense_comp,
            )
            Kc = K.tocsc()
            for c in np.nonzero(big)[0]:
                rows = np.sort(order[bounds[c]:bounds[c + 1]])
                sub = Kc[rows][:, rows].tocsc()
                out.sparse_comps.append(_SparseComp(
                    idx=rows.astype(np.int64), K=sub,
                    eye=scipy.sparse.identity(len(rows), format="csc"),
                ))

        # group the remaining components into power-of-two size buckets
        size_class = np.maximum(1, 1 << np.ceil(np.log2(sizes)).astype(int))
        size_class[big] = -1  # excluded from the dense buckets
        Kl = K.tolil()
        for s in np.unique(size_class):
            if s < 0:
                continue
            comps = np.nonzero(size_class == s)[0]
            nc = len(comps)
            idx = np.full((nc, s), n, np.int64)
            blocks = np.zeros((nc, s, s), np.float64)
            blocks[:, np.arange(s), np.arange(s)] = 1.0  # identity padding
            for bi, c in enumerate(comps):
                rows = order[bounds[c]:bounds[c + 1]]
                k = len(rows)
                idx[bi, :k] = rows
                blocks[bi, :k, :k] = Kl[np.ix_(rows, rows)].todense()
            if s == 1:
                svals = blocks[:, :, 0].copy()
                U = np.ones((nc, 1, 1))
            else:
                svals, U = np.linalg.eigh(blocks)
            # thresholding a PSD GRM can leave indefinite components; a
            # negative eigenvalue makes V = K + lbd I singular inside the
            # lambda search range and silently corrupts logdet/solve
            # (np.abs would hide the sign). Clamp to the PSD projection
            # and say so — matches the dense path's eigenvalue clip.
            neg = float(svals.min()) if svals.size else 0.0
            if neg < -1e-8:
                log.warning("thresholded kinship component indefinite (min eig "
                            "%.3g): clamping to its PSD projection", neg)
            np.clip(svals, 0.0, None, out=svals)
            n_pad = int((idx == n).sum())
            out.buckets.append(_Bucket(idx=idx, U=U, svals=svals, n_pad=n_pad))
            out.n_pad += n_pad
        return out

    # -- sparse-LU route (percolated components) ---------------------------

    def _lus(self, lbd: float) -> list:
        """splu factors of (K_c + lbd I) for every sparse component at this
        lambda, cached on lambda (the null-fit optimizer revisits values;
        the scan then reuses the converged one)."""
        key = float(lbd)
        hit = self._lu_cache.get(key)
        if hit is not None:
            return hit
        from scipy.sparse.linalg import splu

        lus = [splu(c.K + lbd * c.eye) for c in self.sparse_comps]
        if len(self._lu_cache) >= 4:
            self._lu_cache.pop(next(iter(self._lu_cache)))
        self._lu_cache[key] = lus
        return lus

    # -- host ops (null fits, small solves) -------------------------------

    def rotate(self, B: np.ndarray) -> list[np.ndarray]:
        """U_c' B[idx_c] per bucket: list of (nc, s, k) rotated coords."""
        B = np.atleast_2d(np.asarray(B, np.float64))
        if B.shape[0] != self.n:
            B = B.T
        Bz = np.vstack([B, np.zeros((1, B.shape[1]))])
        return [
            np.einsum("cst,csk->ctk", b.U, Bz[b.idx]) for b in self.buckets
        ]

    def svals_concat(self) -> np.ndarray:
        """All eigenvalues (incl. pads — pads are exactly 1.0)."""
        return np.concatenate([b.svals.ravel() for b in self.buckets])

    def logdet(self, lbd: float) -> float:
        """log det(K + lbd I), pad contribution removed analytically."""
        tot = 0.0
        for b in self.buckets:
            tot += float(np.sum(np.log(b.svals + lbd)))
        for lu in self._lus(lbd):
            # V_c is SPD so det > 0: |prod diag(U)| is exactly det(V_c)
            tot += float(np.sum(np.log(np.abs(lu.U.diagonal()))))
        return tot - self.n_pad * np.log(1.0 + lbd)

    def solve(self, lbd: float, B: np.ndarray) -> np.ndarray:
        """(K + lbd I)^-1 B for (n,) or (n, k) B."""
        B = np.asarray(B, np.float64)
        squeeze = B.ndim == 1
        B2 = B.reshape(self.n, -1)
        out = np.zeros((self.n + 1, B2.shape[1]))
        Bz = np.vstack([B2, np.zeros((1, B2.shape[1]))])
        for b in self.buckets:
            rot = np.einsum("cst,csk->ctk", b.U, Bz[b.idx])
            rot /= (b.svals + lbd)[:, :, None]
            back = np.einsum("cst,ctk->csk", b.U, rot)
            # pad indices all collide on row n (dropped); real indices are
            # unique across components so assignment scatter is exact
            out[b.idx.ravel()] = back.reshape(-1, B2.shape[1])
        for c, lu in zip(self.sparse_comps, self._lus(lbd)):
            out[c.idx] = lu.solve(B2[c.idx])
        res = out[: self.n]
        return res[:, 0] if squeeze else res

    def quad(self, lbd: float, B: np.ndarray) -> np.ndarray:
        """b' (K + lbd I)^-1 b for each column of B — (k,)."""
        B = np.asarray(B, np.float64).reshape(self.n, -1)
        tot = np.zeros(B.shape[1])
        for rot, b in zip(self.rotate(B), self.buckets):
            tot += np.einsum("ctk,ct->k", rot**2, 1.0 / (b.svals + lbd))
        for c, lu in zip(self.sparse_comps, self._lus(lbd)):
            Bc = B[c.idx]
            tot += np.einsum("sk,sk->k", Bc, lu.solve(Bc))
        return tot

    # -- device op (per-SNP scan quadratics) -------------------------------

    def device_quad_fn(self, lbd: float, device, dtype=torch.float32):
        """G (B, n) tensor on ``device`` -> per-row g' (K + lbd I)^-1 g
        (B,) in ``dtype``: per size bucket a gather of the bucket's
        samples, one batched einsum against its eigenvectors and the
        weights 1/(s + lbd), all in ``dtype`` (float32: the reference's
        jitted twin, sparse_spectral.py:237-269). The bucket operands are
        uploaded once, here.

        Only valid when every component fit the dense spectral budget —
        callers must take the host ``quad`` route when ``sparse_comps``
        is non-empty (splmm.splmm_exact_scan does)."""
        if self.sparse_comps:
            raise ValueError(
                "device_quad_fn is spectral-only; this kinship has "
                "percolated components on the sparse-LU route — use "
                ".quad(lbd, B) instead"
            )
        parts = [
            trace.uploaded([
                torch.as_tensor(b.idx, dtype=torch.long, device=device),
                torch.as_tensor(b.U, dtype=dtype, device=device),
                torch.as_tensor(1.0 / (b.svals + lbd), dtype=dtype, device=device),
            ])
            for b in self.buckets
        ]

        def quad(G: torch.Tensor) -> torch.Tensor:
            # the zero column n is every pad index's target
            Gz = torch.nn.functional.pad(G.to(dtype), (0, 1))
            tot = torch.zeros(G.shape[0], dtype=dtype, device=G.device)
            for I, U, w in parts:
                Gg = Gz[:, I]  # (B, nc, s)
                rot = torch.einsum("bcs,cst->bct", Gg, U)
                tot = tot + torch.einsum("bct,ct->b", rot * rot, w)
            return tot

        return quad


def profiled_null_fit(
    bs: BlockSpectralK,
    ytilde: np.ndarray,
    n_eff: int,
    low: float,
    high: float,
    tol: float = 1e-6,
    max_iter: int = 100,
):
    """Profiled-variance null fit of the residualized phenotype over
    log10 lambda — every evaluation is O(n) on cached rotated coordinates
    (replaces one sparse factorization per evaluation).

    Returns (lbd, sigma2, loglik)."""
    import scipy.optimize

    y64 = np.asarray(ytilde, np.float64).reshape(-1, 1)
    rots = bs.rotate(y64)
    yr2 = [r[:, :, 0] ** 2 for r in rots]
    svals = [b.svals for b in bs.buckets]
    y_sc = [y64[c.idx, 0] for c in bs.sparse_comps]

    def quad_at(lbd):
        q = sum(float(np.sum(y2 / (s + lbd))) for y2, s in zip(yr2, svals))
        # percolated components: one sparse-LU numeric factorization per
        # lambda evaluation (cached across the quad+logdet pair and the
        # final scan) — the reference's own per-eval refactorization
        # pattern (JanusX src/math/cholesky.rs:31-45)
        for yc, lu in zip(y_sc, bs._lus(lbd)):
            q += float(yc @ lu.solve(yc))
        return q

    def nll(lg):
        lbd = 10.0 ** lg
        quad = quad_at(lbd)
        if quad <= 0:
            return 1e8
        logdet = bs.logdet(lbd)
        return 0.5 * (n_eff * np.log(quad) + logdet)

    res = scipy.optimize.minimize_scalar(
        nll, bounds=(low, high), method="bounded",
        options={"xatol": tol, "maxiter": max_iter},
    )
    lbd = 10.0 ** float(res.x)
    sigma2 = quad_at(lbd) / n_eff
    return lbd, sigma2, -float(res.fun)
