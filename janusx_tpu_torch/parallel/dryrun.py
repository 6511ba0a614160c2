"""Dry runs of the flagship step and of the multi-device path (the
port's twin of the repository's ``__graft_entry__.py``).

- ``entry()``: one LMM scan block of ``jx gwas -lmm`` as a function and
  its example arguments (decode -> rotate (K1) -> batched per-SNP REML
  Brent -> beta/se);
- ``dryrun_multichip(n)``: the production ``grm_from_packed``,
  ``lmm_scan`` and ``lmm_scan_multi`` on an n-shard mesh at small shapes
  (m >= 4096 with an uneven tail, n = 256), checking that every SNP-axis
  upload is split into n equal shards and that the GRM's partials are
  summed exactly once; then ``distributed_grm``/``distributed_scan`` in one
  process against the full builds.

Run ``python -m janusx_tpu_torch.parallel.dryrun`` for both: on the
visible devices, or on the CPU (``JX_TPU_PLATFORM=cpu``), where the mesh
repeats the one CPU device eight times.
"""

from __future__ import annotations

import numpy as np
import torch


def _toy_problem(m=16, n=32, p=2, seed=0, device=None):
    from janusx_tpu_torch import config
    from janusx_tpu_torch.core.reml import make_rotated
    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.io import bitcodec
    from janusx_tpu_torch.ops.decode import pad_packed_cols

    dev = config.resolve_device(device)
    rng = np.random.default_rng(seed)
    g_all = rng.binomial(2, 0.3, size=(4 * m, n)).astype(np.float64)
    gc = g_all - g_all.mean(axis=1, keepdims=True)
    K = gc.T @ gc / (4 * m)
    basis = eigh_grm(K, diag_ridge=1e-6)
    cov = rng.normal(size=(n, p - 1))
    y = rng.normal(size=n)
    rot = make_rotated(basis, y, cov, device=dev)

    codes = rng.integers(0, 3, size=(m, n)).astype(np.uint8)
    packed = torch.as_tensor(pad_packed_cols(bitcodec.pack_codes(codes), 4), device=dev)
    mean = torch.as_tensor(codes.mean(axis=1), dtype=torch.float32, device=dev)
    U32 = torch.as_tensor(basis.U, dtype=torch.float32, device=dev)
    return packed, mean, U32, rot


def entry(device=None):
    """Return (fn, example_args): the flagship forward step on the port's
    device (the card unless ``device`` or JX_TPU_PLATFORM says otherwise)."""
    from janusx_tpu_torch import config
    from janusx_tpu_torch.core.reml import beta_se_snp_batch, neg_reml_snp_batch
    from janusx_tpu_torch.ops import kernels
    from janusx_tpu_torch.ops.brent import brent_minimize_batched

    packed, mean, U32, rot = _toy_problem(device=device)

    def lmm_block_step(packed, mean, U32, rot, init_lg):
        Gr = kernels.decode_rotate(packed, mean, U32).to(torch.float64)
        lgs, _ = brent_minimize_batched(
            lambda lg: neg_reml_snp_batch(lg, rot, Gr),
            config.LOG10_LAMBDA_LOW, config.LOG10_LAMBDA_HIGH,
            config.SCAN_BRENT_TOL, 8,
            init_x=torch.full((Gr.shape[0],), init_lg, dtype=torch.float64,
                              device=Gr.device))
        beta, se = beta_se_snp_batch(lgs, rot, Gr)
        return lgs, beta, se

    return lmm_block_step, (packed, mean, U32, rot, 0.0)


def _toy_panel(m: int, n: int, seed: int = 7):
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes

    rng = np.random.default_rng(seed)
    g = rng.binomial(2, rng.uniform(0.1, 0.5, (m, 1)), size=(m, n)).astype(np.int8)
    sites = SiteInfo(
        chrom=np.array(["1"] * m, object),
        pos=np.arange(m, dtype=np.int64) + 1,
        snp=np.array([f"s{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object),
        allele1=np.array(["G"] * m, object),
    )
    gd = GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object))
    return pack_genotypes(gd, QcParams(maf=0.0)), rng


def _sharded_uploads(mesh) -> list:
    """The device-cache entries split over ``mesh``: lists of one tensor
    per shard, each on its shard's device, all of one shape."""
    from janusx_tpu_torch.utils import devcache

    return [v for v in devcache._cache.values()
            if isinstance(v, list) and len(v) == mesh.size
            and all(torch.is_tensor(t) and t.device == d
                    for t, d in zip(v, mesh.device_list))
            and len({tuple(t.shape) for t in v}) == 1]


def dryrun_multichip(n_devices: int, repeat: bool = False) -> None:
    """Run the production multi-device path on an n-shard mesh: the first
    ``n_devices`` visible devices, or (``repeat``) the first one n times.
    Raises RuntimeError on any broken invariant."""
    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.models import grm as grm_mod
    from janusx_tpu_torch.models.grm import grm_from_packed
    from janusx_tpu_torch.models.lm import lm_scan
    from janusx_tpu_torch.models.lmm import lmm_scan, lmm_scan_multi
    from janusx_tpu_torch.parallel import distributed as dist
    from janusx_tpu_torch.parallel.mesh import Mesh, make_mesh, visible_devices

    devs = visible_devices()
    if repeat:
        mesh = Mesh(devs[:1] * n_devices)
    elif len(devs) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devs)}")
    else:
        mesh = make_mesh(n_devices)

    # uneven tail: m not divisible by any block/device multiple
    m, n = max(4096, 16 * n_devices) + 37, 256
    pg, rng = _toy_panel(m, n)
    y = rng.normal(size=n)

    # production GRM: each shard's partial CᵀC, summed once
    block = n_devices * 64
    calls = grm_mod.reduce_shards.calls
    K = grm_from_packed(pg, method=1, block=block, mesh=mesh)
    if grm_mod.reduce_shards.calls - calls != 1:
        raise RuntimeError(f"expected 1 cross-shard GRM sum, found "
                           f"{grm_mod.reduce_shards.calls - calls}")
    if not np.all(np.isfinite(K)):
        raise RuntimeError("non-finite GRM in multichip dryrun")
    basis = eigh_grm(K, diag_ridge=1e-6)
    res, _ = lmm_scan(pg, basis, y, block=block, mesh=mesh)
    if not np.any(np.isfinite(res.beta)):
        raise RuntimeError("no finite betas in multichip dryrun")
    if not np.all((res.pwald > 0) & (res.pwald <= 1.0)):
        raise RuntimeError("invalid p-values in multichip dryrun")
    if len(res.beta) != m:
        raise RuntimeError("scan dropped the uneven tail block")

    # trait-level batched multi-trait scan through the same mesh
    Y = np.column_stack([y, rng.normal(size=n), rng.normal(size=n)])
    multi_res, _ = lmm_scan_multi(pg, basis, Y, block=block, mesh=mesh)
    for t_res in multi_res:
        if len(t_res.beta) != m or not np.any(np.isfinite(t_res.beta)):
            raise RuntimeError("trait-level sharded scan failed in dryrun")

    # shard-shape invariant: the scan's packed upload (nblk, block, nb) is
    # split into n slices of block / n rows, one per shard
    w = block // n_devices
    packed = [v for v in _sharded_uploads(mesh)
              if v[0].dtype == torch.uint8 and v[0].dim() == 3 and v[0].shape[1] == w]
    if not packed:
        raise RuntimeError("no device-cache buffer is SNP-sharded over the mesh")

    # the multi-host drivers reduce exactly to the full builds in one process
    K_d = dist.distributed_grm(pg)
    if not np.allclose(K_d, grm_from_packed(pg), rtol=1e-8, atol=1e-8):
        raise RuntimeError("distributed_grm != grm_from_packed in dryrun")
    scan_d = dist.distributed_scan(pg, lambda sub: lm_scan(sub, y))
    scan_ref = lm_scan(pg, y)
    if not np.allclose(scan_d.beta, scan_ref.beta, equal_nan=True):
        raise RuntimeError("distributed_scan != lm_scan in dryrun")


if __name__ == "__main__":
    from janusx_tpu_torch import config

    cpu = config.resolve_device().type == "cpu"
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in out])
    n = 8 if cpu else max(torch.cuda.device_count(), 2)
    dryrun_multichip(n, repeat=cpu or torch.cuda.device_count() < 2)
    print(f"dryrun_multichip({n}) OK")
