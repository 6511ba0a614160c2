"""Signed feature hashing (count-sketch) of the marker matrix — the GS
``-hash`` preprocessing (port of janusx_tpu/models/hashing.py).

Reference: JanusX src/stats/packed.rs bed_packed_signed_hash_f32
(splitmix64 bucket+sign per SNP row :24-41, bucket accumulation :930-1060,
output normalized so the hashed GRM has mean diagonal 1) wired in
gs/workflow.py _hash_packed_for_gs (:17720; CLI -hash, defaults
dim=2048 seed=520 :19199).

Each kept SNP row j gets a deterministic (bucket b_j, sign s_j) from
splitmix64(seed, j); the sketch is H[b] = sum_{j: b_j=b} s_j z_j with
z the centered (or standardized) genotype row. E[H H'] equals the GRM
numerator, so GS models fit on the D-dimensional H instead of m markers.

Device mapping: per SNP block the decoded rows, each scaled by its sign,
are added into their bucket rows with ``index_add_`` — B·n additions per
block. The reference's signed one-hot product Sᵀ C does the same sum as a
(D, B) x (B, n) matmul, 2·D·B·n operations of which all but B·n multiply
by zero. On a CUDA tensor ``index_add_`` adds through atomics, so the order
of the f32 additions into a bucket is not fixed; the reference's own
bound on the sketch (rtol 2e-4, atol 2e-4) covers it.
"""

from __future__ import annotations

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.ops import decode
from janusx_tpu_torch.utils import devcache

DEFAULT_HASH_DIM = config.knob("JX_TPU_HASH_DIM")  # reference gs/workflow.py:19207
DEFAULT_HASH_SEED = config.knob("JX_TPU_HASH_SEED")

_M1 = np.uint64(0x9E3779B97F4A7C15)
_M2 = np.uint64(0xBF58476D1CE4E5B9)
_M3 = np.uint64(0x94D049BB133111EB)
_SIGN_K = np.uint64(0x517CC1B727220A95)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 (reference packed.rs:24-31), wrapping u64."""
    with np.errstate(over="ignore"):
        x = (x + _M1).astype(np.uint64)
        z = x
        z = ((z ^ (z >> np.uint64(30))) * _M2).astype(np.uint64)
        z = ((z ^ (z >> np.uint64(27))) * _M3).astype(np.uint64)
        return (z ^ (z >> np.uint64(31))).astype(np.uint64)


def hash_bucket_sign(seed: int, row_idx: np.ndarray, n_buckets: int):
    """Exact mirror of signed_hash_bucket_sign (packed.rs:33-41):
    bucket = splitmix64(seed ^ (j * M1)) % D,
    sign from splitmix64((seed + K) ^ rotl(j * M1, 17)) parity."""
    seed = np.uint64(seed)
    j = np.asarray(row_idx, np.uint64)
    with np.errstate(over="ignore"):
        key = (j * _M1).astype(np.uint64)
        bucket = _splitmix64(seed ^ key) % np.uint64(n_buckets)
        rot = ((key << np.uint64(17)) | (key >> np.uint64(47))).astype(np.uint64)
        h_sign = _splitmix64((seed + _SIGN_K).astype(np.uint64) ^ rot)
    sign = np.where((h_sign & np.uint64(1)) == 0, 1.0, -1.0).astype(np.float32)
    return bucket.astype(np.int32), sign


def _hash_accum(pk: torch.Tensor, mn: torch.Tensor, iv: torch.Tensor,
                bucket: torch.Tensor, sign: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Streamed sketch over pre-blocked (nblk, B, nb) packed rows: per
    block the standardized f32 decode, each row times its sign, added into
    its bucket row of the (D, n_pad) f32 sketch. Dropped rows carry sign 0."""
    acc = torch.zeros((n_buckets, pk.shape[-1] * 4), dtype=torch.float32, device=pk.device)
    for b in range(pk.shape[0]):
        c = decode.decode_standardized(pk[b], mn[b], iv[b], torch.float32)
        acc.index_add_(0, bucket[b], c * sign[b].unsqueeze(-1))
    return acc


def signed_hash_features(
    pg,
    n_buckets: int = DEFAULT_HASH_DIM,
    seed: int = DEFAULT_HASH_SEED,
    standardize: bool = True,
    min_maf: float = 0.0,
    max_missing: float = 1.0,
    block: int = config.DEFAULT_SNP_BLOCK,
    device=None,
):
    """Hash the packed genotype matrix into (n, D) signed-sketch features.

    Returns (H (n_samples, n_buckets) f32, scale, kept_snps). H is
    normalized so mean(diag(H H^T)) = 1 (reference scale semantics,
    packed.rs:1060)."""
    if n_buckets <= 0:
        raise ValueError("hash dim must be > 0")
    dev = config.resolve_device(device)
    m, n = pg.m, pg.n_samples
    af = np.asarray(pg.af, np.float64)
    maf = np.minimum(af, 1.0 - af)
    keep = np.isfinite(maf) & (maf >= min_maf) & (maf <= 0.5)
    miss = np.asarray(getattr(pg, "miss", np.zeros(m)), np.float64)
    keep &= np.isfinite(miss) & (miss <= max_missing)
    var = 2.0 * maf * (1.0 - maf)
    if standardize:
        keep &= var > 1e-12
        inv_sd = np.where(keep, 1.0 / np.sqrt(np.maximum(var, 1e-12)), 0.0)
    else:
        inv_sd = np.where(keep, 1.0, 0.0)
    kept = int(keep.sum())
    if kept == 0:
        raise ValueError(
            "No SNPs left after signed-hash filters; relax min_maf/max_missing."
        )
    bucket, sign = hash_bucket_sign(seed, np.arange(m), n_buckets)
    sign = np.where(keep, sign, 0.0).astype(np.float32)

    blk = min(block, m)
    nblk = -(-m // blk)
    shape = (nblk, blk)
    pk = devcache.device_packed_blocks(pg, shape, dev, lane_align=4)
    mn = devcache.to_device_blocks(pg.mean.astype(np.float32), shape, 0.0,
                                   torch.float32, dev)
    iv = devcache.to_device_blocks(inv_sd.astype(np.float32), shape, 0.0,
                                   torch.float32, dev)
    bk = devcache.to_device_blocks(bucket.astype(np.int64), shape, 0, torch.int64, dev)
    sg = devcache.to_device_blocks(sign, shape, 0.0, torch.float32, dev)
    H = _hash_accum(pk, mn, iv, bk, sg, n_buckets).cpu().numpy()[:, :n]
    if not standardize:
        # reference hashes RAW dosages (missing -> mean_g) when !standardize
        # (packed.rs:1016-1022); the kernel accumulates centered values, and
        # raw = centered + mean_g uniformly across samples, so the bucket
        # sketch differs by the constant column sum(sign_j * mean_j)
        offs = np.zeros(n_buckets, np.float64)
        np.add.at(offs, bucket[keep], sign[keep].astype(np.float64) * pg.mean[keep])
        H = H + offs[:, None].astype(np.float32)
    mean_diag = float(np.mean(np.sum(H.astype(np.float64) ** 2, axis=0)))
    scale = np.sqrt(mean_diag)
    if not np.isfinite(scale) or scale <= 0:
        scale = 1.0
    else:
        H = H / np.float32(scale)
    return H.T.copy(), float(scale), kept
