"""Genomic relationship matrix build (port of janusx_tpu/models/grm.py).

Per SNP block the packed 2-bit buffer is decoded on the device to a
centered (method 1), standardized (method 2) or dominance (method 3) f32
block C (B, n) and CᵀC accumulates with a full-f32 ``torch.matmul`` — the
reference leaves this to XLA too; it is not one of its Pallas kernels.
Accumulation is two-level, as in the reference (grm.py:73-111): FLUSH
blocks sum in f32, then each superblock's f32 sum is added to an f64
accumulator (``JX_TPU_GRM_FLUSH``; f32 on request, ``dtype``).

Multi-device: with a mesh each shard accumulates the partial CᵀC of its
slice of every SNP block on its own device, and the (n, n) partials are
summed once, on the first shard's device (the reference's single psum).

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
from janusx_tpu_torch.models.superblocks import shard_block
from janusx_tpu_torch.ops import decode
from janusx_tpu_torch.parallel.mesh import home_device, on_device
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


def _decode_block(pk, mn, iv, n: int, dom: bool) -> torch.Tensor:
    """One packed SNP block decoded to its f32 (B, n) C: the centered
    heterozygosity indicator for method 3, else standardized rows."""
    if dom:
        c = decode.decode_dominance(pk, mn, torch.float32)
    else:
        c = decode.decode_standardized(pk, mn, iv, torch.float32)
    return c[:, :n]


def _grm_accumulate(pk, mn, iv, n: int, dom: bool, acc_dtype=torch.float64) -> torch.Tensor:
    """Unnormalized (n, n) sum over pre-blocked (n_super, FLUSH, B, nb)
    packed rows on their device: f32 CᵀC within a superblock, then each
    superblock's sum added to an ``acc_dtype`` accumulator."""
    acc = torch.zeros((n, n), dtype=acc_dtype, device=pk.device)
    for s in range(pk.shape[0]):
        acc32 = torch.zeros((n, n), dtype=torch.float32, device=pk.device)
        for f in range(pk.shape[1]):
            c = _decode_block(pk[s, f], mn[s, f], iv[s, f], n, dom)
            acc32 += c.T @ c
        acc += acc32.to(acc_dtype)
    return acc


def _acc_dtype(dtype) -> torch.dtype:
    """The outer accumulator: f64, or f32 on request (janusx_tpu/models/
    grm.py:165,204)."""
    if np.dtype(dtype) == np.float64:
        return torch.float64
    if np.dtype(dtype) == np.float32:
        return torch.float32
    raise ValueError(f"GRM accumulator dtype {dtype!r}: expected float64 or float32")


def _grm_parts(pg: PackedGenotypes, method: int, block: int, dtype, mesh, dev) -> tuple:
    """The unnormalized partial sums of a resident ``pg``, one per shard
    (on the shard's device; one on ``dev`` without a mesh), and pg's
    denominator. A mesh rounds ``block`` up to a multiple of its size and
    gives each shard an equal slice of every block (janusx_tpu/models/
    grm.py:189,242, its shard_axis 2)."""
    mean, inv_sd, var = _snp_scales(pg, method)
    m = pg.m
    block = shard_block(min(block, m), mesh)
    flush = config.knob("JX_TPU_GRM_FLUSH")
    nblk = -(-m // block)
    shape = (-(-nblk // flush), flush, block)
    acc_dtype = _acc_dtype(dtype)
    kw = dict(device=dev) if mesh is None else dict(mesh=mesh, shard_axis=2)
    pk = devcache.device_packed_blocks(pg, shape, lane_align=4, **kw)
    mn = devcache.to_device_blocks(mean, shape, 0.0, torch.float32, **kw)
    iv = devcache.to_device_blocks(inv_sd, shape, 0.0, torch.float32, **kw)
    if mesh is None:
        parts = [_grm_accumulate(pk, mn, iv, pg.n_samples, method == 3, acc_dtype)]
    else:
        parts = []
        for i, d in enumerate(mesh.device_list):
            with on_device(d):
                parts.append(_grm_accumulate(pk[i], mn[i], iv[i], pg.n_samples,
                                             method == 3, acc_dtype))
    denom = float(var.sum()) if method in (1, 3) else float(m)
    return parts, denom


def reduce_shards(parts: list) -> np.ndarray:
    """The one cross-shard sum of a GRM build, on the first shard's device
    (the twin of janusx_tpu's single psum); returns the f64 host array.
    ``reduce_shards.calls`` counts the sums over more than one shard."""
    acc = parts[0]
    if len(parts) > 1:
        reduce_shards.calls += 1
        acc = acc.clone()
        for p in parts[1:]:
            acc += p.to(acc.device)
    return acc.cpu().numpy().astype(np.float64, copy=False)


reduce_shards.calls = 0


def grm_partial(pg: PackedGenotypes, method: int = 1,
                block: int = config.DEFAULT_SNP_BLOCK, dtype=np.float64,
                mesh=None, device=None) -> tuple:
    """UNNORMALIZED (n, n) f64 host sum of scaled outer products over pg's
    SNPs plus this slice's denominator (sum of per-SNP variances for
    methods 1/3, SNP count for method 2) — both additive over SNP slices
    (the contract of parallel.distributed.distributed_grm). ``dtype``
    float32 accumulates across superblocks in f32. With ``mesh`` each
    shard accumulates its slice and the partials are summed once."""
    dev = home_device(mesh, device)
    parts, denom = _grm_parts(pg, method, block, dtype, mesh, dev)
    return reduce_shards(parts), denom


def grm_from_packed(pg: PackedGenotypes, method: int = 1,
                    block: int = config.DEFAULT_SNP_BLOCK,
                    dtype=np.float64, mesh=None, device=None) -> np.ndarray:
    """Dense (n, n) float64 GRM from packed genotypes, streaming SNP blocks
    through the device. Disk-backed inputs (io.windowed.WindowedPacked)
    stream materialized windows, the next window's IO overlapping this
    window's device work. ``dtype`` float32 keeps the accumulator in f32
    (the result is still an f64 array). With ``mesh`` SNP blocks shard
    across the mesh; each shard's partial stays on its device across
    windows and the partials are summed once per call."""
    dev = home_device(mesh, device)
    if not hasattr(pg, "packed"):
        from janusx_tpu_torch.utils.prefetch import prefetch_iter

        acc, denom = None, 0.0
        for _, _, sub in prefetch_iter(pg.iter_materialized()):
            parts, d = _grm_parts(sub, method, block, dtype, mesh, dev)
            acc = parts if acc is None else [a.add_(p) for a, p in zip(acc, parts)]
            denom += d
        K = None if acc is None else reduce_shards(acc)
    else:
        parts, denom = _grm_parts(pg, method, block, dtype, mesh, dev)
        K = reduce_shards(parts)
    if K is None or denom <= 0:
        raise ValueError("GRM denominator is zero (no polymorphic SNPs?)")
    return K / denom


def grm_denominator(pg: PackedGenotypes, method: int = 1) -> float:
    """Normalizer matching grm_from_packed's accumulation: method 1
    sum 2p(1-p); method 2 m; method 3 (dominance het-indicator)
    sum hf(1-hf)."""
    if method == 3:
        _, _, var = _snp_scales(pg, 3)
        return float(var.sum())
    if method == 1:
        var = 2.0 * pg.af * (1.0 - pg.af)
        return float(var.sum())
    return float(pg.m)


def grm_strip_from_packed(pg: PackedGenotypes, rows: np.ndarray, method: int = 1,
                          block: int = config.DEFAULT_SNP_BLOCK,
                          device=None) -> np.ndarray:
    """Row strip K[rows, :] of the GRM without the full (n, n) matrix (the
    engine of ``jx grm -part``/``-part-group``): per resident SNP block,
    a full-f32 C[:, rows]ᵀC added to an f64 (|rows|, n) accumulator on the
    device, then one division by the denominator."""
    dev = config.resolve_device(device)
    rows = np.asarray(rows, np.int64)
    mean, inv_sd, var = _snp_scales(pg, method)
    n, m = pg.n_samples, pg.m
    block = min(block, m)
    shape = (-(-m // block), block)
    pk = devcache.device_packed_blocks(pg, shape, dev, lane_align=4)
    mn = devcache.to_device_blocks(mean, shape, 0.0, torch.float32, dev)
    iv = devcache.to_device_blocks(inv_sd, shape, 0.0, torch.float32, dev)
    rows_d = torch.as_tensor(rows, device=dev)
    acc = torch.zeros((len(rows), n), dtype=torch.float64, device=dev)
    for b in range(shape[0]):
        c = _decode_block(pk[b], mn[b], iv[b], n, method == 3)
        acc += (c[:, rows_d].T @ c).to(torch.float64)
    denom = float(var.sum()) if method in (1, 3) else float(m)
    if denom <= 0:
        raise ValueError("GRM denominator is zero (no polymorphic SNPs?)")
    return acc.cpu().numpy() / denom


def balanced_part_bounds(n: int, n_parts: int) -> list:
    """GCTA-like work-balanced row partition of the lower triangle:
    row i contributes i+1 cells, so part boundaries equalize cumulative
    i(i+1)/2 shares. Returns [(start, end), ...]."""
    total = n * (n + 1) / 2.0
    bounds = []
    start = 0
    for k in range(1, n_parts + 1):
        target = total * k / n_parts
        # smallest e with e(e+1)/2 >= target
        e = int(np.ceil((-1 + np.sqrt(1 + 8 * target)) / 2))
        e = min(max(e, start + 1), n)
        if k == n_parts:
            e = n
        bounds.append((start, e))
        start = e
    return bounds
