"""Multi-process worker for janusx_tpu_torch.parallel.distributed (helper
for tests/test_torch_sharding.py and chip_smoke.py; imports no jax).

Run as:  python torch_dist_worker.py <process_id> <num_processes> <port> <outdir> [<inputs>]

Joins a gloo process group at 127.0.0.1:<port> and runs the documented
multi-host recipe. It computes on the card unless JX_TPU_PLATFORM=cpu.

- Without <inputs>: the contract on a small deterministic panel whose SNP
  count is not divisible by the device count. It checks host_snp_range,
  make_global_snp_array, one summed GRM and an all-gathered marginal scan
  against a numpy reference, then distributed_grm and distributed_scan
  (lm_scan and lmm_scan) against the full single-process builds.
  Process 0 writes <outdir>/dist_result.npz.
- With <inputs> (a directory holding full/*.npy and sub/*.npy, two
  PackedGenotypes as save_packed writes them, and scan.npz with the
  eigenbasis U, S and the trait y of sub's samples): distributed_grm on
  full, then distributed_scan of lmm_scan on sub. Process 0 writes
  <outdir>/dist_result.npz (K, beta, se, pwald).

Prints "DIST_OK" and the kernels' launch counts, and exits 0 on success;
any failed check exits non-zero.
"""

from __future__ import annotations

import os
import sys

import numpy as np

_FIELDS = ("packed", "af", "miss", "mean", "samples", "chrom", "pos", "snp",
           "allele0", "allele1")


def save_packed(d: str, pg) -> None:
    """A PackedGenotypes as plain .npy files (no pickled objects)."""
    os.makedirs(d, exist_ok=True)
    arrays = dict(packed=pg.packed, af=pg.af, miss=pg.miss, mean=pg.mean,
                  samples=np.asarray(pg.samples).astype(str),
                  n_samples=np.array(pg.n_samples))
    for f in ("chrom", "pos", "snp", "allele0", "allele1"):
        v = np.asarray(getattr(pg.sites, f))
        arrays[f] = v if f == "pos" else v.astype(str)
    for k, v in arrays.items():
        np.save(os.path.join(d, k + ".npy"), v)


def load_packed(d: str):
    from janusx_tpu_torch.io.gdata import SiteInfo
    from janusx_tpu_torch.io.packed import PackedGenotypes

    a = {k: np.load(os.path.join(d, k + ".npy")) for k in _FIELDS + ("n_samples",)}
    obj = lambda k: a[k].astype(object)
    sites = SiteInfo(chrom=obj("chrom"), pos=a["pos"], snp=obj("snp"),
                     allele0=obj("allele0"), allele1=obj("allele1"))
    return PackedGenotypes(packed=a["packed"], n_samples=int(a["n_samples"]), sites=sites,
                           samples=obj("samples"), af=a["af"], miss=a["miss"],
                           mean=a["mean"])


def _toy_contract(dist, pid: int, nproc: int, outdir: str) -> None:
    import torch
    import torch.distributed as tdist

    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes
    from janusx_tpu_torch.models.grm import grm_from_packed
    from janusx_tpu_torch.models.lm import lm_scan

    ndev = dist.device_count()
    assert dist.process_count() == nproc
    # m_total NOT divisible by the device count: the padded-tail contract
    m_total, n = 101, 24
    rng = np.random.default_rng(7)
    G = rng.integers(0, 3, size=(m_total, n)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    m_pad = dist.padded_snp_total(m_total)
    assert m_pad % ndev == 0 and m_pad >= m_total
    # host_snp_range: contiguous, process-major, device-count weighted
    lo, hi = dist.host_snp_range(m_total)
    per = m_pad // nproc
    assert (lo, hi) == (pid * per, (pid + 1) * per), (lo, hi)
    # "host-local read": only this host's rows; tail rows are padding
    Gp = np.zeros((m_pad, n), np.float32)
    Gp[:m_total] = G
    g = dist.make_global_snp_array(dist.global_snp_mesh(), Gp[lo:hi], m_total)
    assert g.global_shape == (m_pad, n) and (g.lo, g.hi) == (lo, hi)
    # one summed GRM and an embarrassingly parallel scan, all-gathered back
    gs = torch.cat([s.cpu() for s in g.shards])
    k = gs.T @ gs
    tdist.all_reduce(k)
    den = (gs * gs).sum(axis=1)
    beta = torch.where(den > 0, (gs @ torch.as_tensor(y)) / den.clamp_min(1e-30),
                       torch.full_like(den, float("nan")))
    parts = [torch.empty_like(beta) for _ in range(nproc)]
    tdist.all_gather(parts, beta)
    K, beta = k.numpy(), torch.cat(parts).numpy()
    np.testing.assert_allclose(K, G.T @ G, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(beta[:m_total], (G @ y) / (G * G).sum(axis=1),
                               rtol=1e-5, atol=1e-6)
    assert np.isnan(beta[m_total:]).all()  # padding rows must be masked

    # production multi-host GRM: each process contributes only its slice
    mg, ng = 97, 18  # not divisible by the device count
    rng2 = np.random.default_rng(21)
    codes = rng2.integers(0, 3, size=(mg, ng)).astype(np.int8)
    sites = SiteInfo(
        chrom=np.array(["1"] * mg, object), pos=np.arange(1, mg + 1, dtype=np.int64),
        snp=np.array([f"s{i}" for i in range(mg)], object),
        allele0=np.array(["A"] * mg, object), allele1=np.array(["G"] * mg, object))
    gd = GenotypeData(codes, sites, np.array([f"i{j}" for j in range(ng)], object))
    pgv = pack_genotypes(gd, QcParams(maf=0.0, geno=1.0))
    K_dist = dist.distributed_grm(pgv)
    np.testing.assert_allclose(K_dist, grm_from_packed(pgv), rtol=1e-4, atol=1e-6)
    yv = rng2.normal(size=ng)
    d_scan = dist.distributed_scan(pgv, lambda sub: lm_scan(sub, yv))
    ref_scan = lm_scan(pgv, yv)
    _close(d_scan, ref_scan)

    # the multi-host LMM flow: distributed GRM -> eigh -> distributed scan
    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.models.lmm import lmm_scan

    basis = eigh_grm(K_dist, diag_ridge=1e-6)
    yl = yv + pgv.centered()[7] * 0.6
    d_lmm = dist.distributed_scan(pgv, lambda sub: lmm_scan(sub, basis, yl)[0])
    _close(d_lmm, lmm_scan(pgv, basis, yl)[0])
    if pid == 0:
        np.savez(os.path.join(outdir, "dist_result.npz"), K=K, beta=beta[:m_total],
                 K_grm=K_dist, scan_beta=d_scan.beta, lmm_beta=d_lmm.beta)


def _close(a, b) -> None:
    """beta rtol 2e-3 / atol 1e-6 and Δ(-log10 p) < 5e-3 (tests/test_sharding.py)."""
    np.testing.assert_allclose(a.beta, b.beta, rtol=2e-3, atol=1e-6, equal_nan=True)
    ok = np.isfinite(b.pwald) & (b.pwald > 0)
    assert np.nanmax(np.abs(np.log10(a.pwald[ok]) - np.log10(b.pwald[ok]))) < 5e-3


def _panel_run(dist, pid: int, inputs: str, outdir: str) -> None:
    from janusx_tpu_torch.core.spectral import SpectralBasis
    from janusx_tpu_torch.models.lmm import lmm_scan

    full, sub = load_packed(os.path.join(inputs, "full")), load_packed(
        os.path.join(inputs, "sub"))
    z = np.load(os.path.join(inputs, "scan.npz"))
    basis = SpectralBasis(U=z["U"], S=z["S"])
    K = dist.distributed_grm(full)
    res = dist.distributed_scan(sub, lambda s: lmm_scan(s, basis, z["y"])[0])
    if pid == 0:
        np.savez(os.path.join(outdir, "dist_result.npz"), K=K, beta=res.beta, se=res.se,
                 pwald=res.pwald)


NO_GROUP = 3  # exit code: the process group did not form on the given port


def main() -> int:
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                sys.argv[4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from janusx_tpu_torch import config
    from janusx_tpu_torch.ops import kernels
    from janusx_tpu_torch.parallel import distributed as dist

    config.set_full_f32_matmul()
    dist.initialize(coordinator=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
    if dist.process_count() != nproc:  # the group did not form on this port
        print(f"DIST_NO_GROUP rank {pid} port {port}: {dist.process_count()} process(es)",
              flush=True)
        return NO_GROUP
    if len(sys.argv) > 5:
        _panel_run(dist, pid, sys.argv[5], outdir)
    else:
        _toy_contract(dist, pid, nproc, outdir)
    print(f"DIST_OK rank {pid} launches {kernels.launch_counts()} "
          f"jax_loaded={'jax' in sys.modules} reference_loaded="
          f"{any(k.split('.')[0] == 'janusx_tpu' for k in sys.modules)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
