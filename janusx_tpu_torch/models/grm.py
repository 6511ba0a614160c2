"""Genomic relationship matrix build (port of janusx_tpu/models/grm.py).

Per SNP block the packed 2-bit buffer is decoded on the device to a
centered (method 1), standardized (method 2) or dominance (method 3) f32
block C (B, n) and CᵀC accumulates with a full-f32 ``torch.matmul`` — the
reference leaves this to XLA too; it is not one of its Pallas kernels.
Accumulation is two-level, as in the reference (grm.py:73-111): FLUSH
blocks sum in f32, then each superblock's f32 sum is added to an f64
accumulator (``JX_TPU_GRM_FLUSH``).

Definitions (reference src/stats/spgrm.rs:8-22):
  method 1 (cGRM): K = sum_j x_j x_j' / sum_j 2 p_j (1-p_j),  x = g - 2p
  method 2 (sGRM): K = sum_j z_j z_j' / m,  z = x / sqrt(2p(1-p))
  method 3: centered heterozygosity indicator / sum_j hf_j (1-hf_j)
"""

from __future__ import annotations

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.ops import decode
from janusx_tpu_torch.utils import devcache


def _snp_scales(pg: PackedGenotypes, method: int):
    """Per-SNP (mean, inv_sd, var) with monomorphic guard; for method 3 the
    "mean" is the heterozygote frequency."""
    if method == 3:
        from janusx_tpu_torch.io import bitcodec

        nm, alt, het = bitcodec.row_stats(pg.packed, pg.n_samples)
        with np.errstate(divide="ignore", invalid="ignore"):
            hf = np.where(nm > 0, het / nm, 0.0)
        var = hf * (1.0 - hf)
        return hf, np.ones_like(var), var
    p = pg.af
    var = 2.0 * p * (1.0 - p)
    if method == 1:
        inv_sd = np.ones_like(var)
    else:
        with np.errstate(divide="ignore"):
            inv_sd = np.where(var > 0, 1.0 / np.sqrt(var), 0.0)
    return pg.mean, inv_sd, var


def _grm_accumulate(pk, mn, iv, n: int, dom: bool) -> torch.Tensor:
    """Unnormalized (n, n) f64 sum over pre-blocked (n_super, FLUSH, B, nb)
    packed rows: f32 CᵀC within a superblock, f64 across superblocks."""
    acc = torch.zeros((n, n), dtype=torch.float64, device=pk.device)
    for s in range(pk.shape[0]):
        acc32 = torch.zeros((n, n), dtype=torch.float32, device=pk.device)
        for f in range(pk.shape[1]):
            if dom:
                c = decode.decode_dominance(pk[s, f], mn[s, f], torch.float32)
            else:
                c = decode.decode_standardized(pk[s, f], mn[s, f], iv[s, f],
                                               torch.float32)
            c = c[:, :n]
            acc32 += c.T @ c
        acc += acc32.to(torch.float64)
    return acc


def grm_partial(pg: PackedGenotypes, method: int = 1,
                block: int = config.DEFAULT_SNP_BLOCK, device=None) -> tuple:
    """UNNORMALIZED (n, n) f64 host sum of scaled outer products over pg's
    SNPs plus this slice's denominator (sum of per-SNP variances for
    methods 1/3, SNP count for method 2) — both additive over SNP slices."""
    dev = config.resolve_device(device)
    mean, inv_sd, var = _snp_scales(pg, method)
    m = pg.m
    block = min(block, m)
    flush = config.knob("JX_TPU_GRM_FLUSH")
    nblk = -(-m // block)
    shape = (-(-nblk // flush), flush, block)
    pk = devcache.device_packed_blocks(pg, shape, dev, lane_align=4)
    mn = devcache.to_device_blocks(mean, shape, 0.0, torch.float32, dev)
    iv = devcache.to_device_blocks(inv_sd, shape, 0.0, torch.float32, dev)
    K = _grm_accumulate(pk, mn, iv, pg.n_samples, method == 3)
    denom = float(var.sum()) if method in (1, 3) else float(m)
    return K.cpu().numpy(), denom


def grm_from_packed(pg: PackedGenotypes, method: int = 1,
                    block: int = config.DEFAULT_SNP_BLOCK,
                    dtype=np.float64, mesh=None, device=None) -> np.ndarray:
    """Dense (n, n) float64 GRM from packed genotypes, streaming SNP blocks
    through the device. Disk-backed inputs (io.windowed.WindowedPacked)
    stream materialized windows, the next window's IO overlapping this
    window's device work."""
    if dtype != np.float64:
        raise NotImplementedError("the port builds the GRM in float64 only")
    if mesh is not None:
        raise NotImplementedError(
            "SNP-sharded GRM builds are not ported yet (ROADMAP queue 1, item 23)")
    if not hasattr(pg, "packed"):
        from janusx_tpu_torch.utils.prefetch import prefetch_iter

        K, denom = None, 0.0
        for _, _, sub in prefetch_iter(pg.iter_materialized()):
            part, d = grm_partial(sub, method=method, block=block, device=device)
            K = part if K is None else K + part
            denom += d
    else:
        K, denom = grm_partial(pg, method=method, block=block, device=device)
    if K is None or denom <= 0:
        raise ValueError("GRM denominator is zero (no polymorphic SNPs?)")
    return K / denom
