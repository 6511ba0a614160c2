"""PCA of the genotype matrix: GRM-eigh route and randomized SVD route
(port of janusx_tpu/models/pca.py).

Replaces the reference's `jx pca` (python/janusx/script/pca.py: eigh of
GRM via LAPACK, or streamed RSVD src/stats/rsvd.rs:1-28).

RSVD on the device: each subspace-iteration step is one pass over the
resident packed blocks, A' (A V) with A the standardized SNP-major (m, n)
matrix decoded block by block; both products are full-f32
``torch.matmul``. The QR, the projected eigh and the starting V (drawn
from ``np.random.default_rng(seed)``) stay on the host in f64, as in the
reference, so with the same seed both packages run the same iteration.
Output convention matches the reference: eigenvectors scaled by
sqrt(eigenvalue) are NOT applied; {prefix}.eigenvec rows are samples.
"""

from __future__ import annotations

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.core.spectral import eigh_grm
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.models.grm import _snp_scales
from janusx_tpu_torch.ops import decode
from janusx_tpu_torch.utils import devcache


def pca_from_grm(K: np.ndarray, n_pc: int = 10):
    """Top-k PCs from a precomputed GRM. Returns (eigvals desc, eigvecs)."""
    basis = eigh_grm(K, diag_ridge=0.0)
    vals = basis.S[::-1][:n_pc]
    vecs = basis.U[:, ::-1][:, :n_pc]
    return vals, vecs


def _rsvd_av(pk: torch.Tensor, mn: torch.Tensor, iv: torch.Tensor,
             V: torch.Tensor) -> torch.Tensor:
    """A' (A V) over pre-blocked (nblk, B, nb) packed rows: per block the
    standardized decode a (B, n_pad), then a (a V) accumulated in f32."""
    acc = torch.zeros((pk.shape[-1] * 4, V.shape[1]), dtype=torch.float32,
                      device=pk.device)
    for b in range(pk.shape[0]):
        a = decode.decode_standardized(pk[b], mn[b], iv[b], torch.float32)
        acc += a.T @ (a @ V)
    return acc


def rsvd_pca(
    pg: PackedGenotypes,
    n_pc: int = 10,
    oversample: int = 10,
    power_iters: int = 4,
    method: int = 2,
    seed: int = 0,
    block: int = config.DEFAULT_SNP_BLOCK,
    device=None,
):
    """Randomized PCA of the standardized genotype matrix.

    Computes the top eigenpairs of K = A'A/denom (A = standardized (m, n))
    by subspace iteration against the device-resident packed blocks.
    Returns (eigvals desc (k,), PCs (n, k))."""
    dev = config.resolve_device(device)
    n = pg.n_samples
    k = min(n_pc + oversample, n)
    _, inv_sd, var = _snp_scales(pg, method)
    m = pg.m
    block = min(block, m)
    shape = (-(-m // block), block)
    # the reference's 128-sample lane padding: V and each pass's result
    # carry the same n_pad rows (zero past n) into the host QR
    pk = devcache.device_packed_blocks(pg, shape, dev, lane_align=config.SAMPLE_ALIGN)
    mn = devcache.to_device_blocks(pg.mean, shape, 0.0, torch.float32, dev)
    iv = devcache.to_device_blocks(inv_sd, shape, 0.0, torch.float32, dev)
    n_pad = pk.shape[-1] * 4
    rng = np.random.default_rng(seed)
    V = np.zeros((n_pad, k), np.float32)
    V[:n] = rng.normal(size=(n, k)).astype(np.float32)
    V = torch.as_tensor(V, device=dev)
    for _ in range(power_iters):
        W = _rsvd_av(pk, mn, iv, V)
        # orthonormalize on host in f64 (small: n x k)
        Q, _ = np.linalg.qr(W.cpu().numpy().astype(np.float64))
        V = torch.as_tensor(Q.astype(np.float32), device=dev)
    W = _rsvd_av(pk, mn, iv, V).cpu().numpy().astype(np.float64)  # = K_unnorm V
    Vh = V.cpu().numpy().astype(np.float64)
    B = Vh.T @ W  # (k, k) projected operator
    B = 0.5 * (B + B.T)
    evals, evecs = np.linalg.eigh(B)
    order = np.argsort(evals)[::-1][:n_pc]
    denom = float(var.sum()) if method == 1 else float(m)
    vals = evals[order] / denom
    vecs = (Vh @ evecs[:, order])[:n]
    return vals, vecs


def write_pca_outputs(prefix: str, sample_ids, vals, vecs) -> None:
    """{prefix}.eigenvec / {prefix}.eigenval in reference layout."""
    with open(prefix + ".eigenval", "wt") as fh:
        for v in vals:
            fh.write(f"{v:.6g}\n")
    with open(prefix + ".eigenvec", "wt") as fh:
        for i, sid in enumerate(sample_ids):
            cols = "\t".join(f"{vecs[i, j]:.6g}" for j in range(vecs.shape[1]))
            fh.write(f"{sid}\t{cols}\n")
