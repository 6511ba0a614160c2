"""Port parity: janusx_tpu_torch.models.lmm.lmm_scan vs janusx_tpu's.

The reference runs its CPU route (XLA grid, lmm.py:375-380); the port runs
its lattice route (p <= 4) or the grid route (p > 4) with the kernels'
plain versions on CPU tensors. Setup: n = 200, m = 1,500, block = 512.
Streaming: a small ``superblock`` so superblock chunks and the ragged tail
block both run. Bounds: max Δ(-log10 p) <= 5e-3 (the grid-vs-brent bound,
tests/test_scans.py:155), the same NaN lanes, and log10 λ_null within
1e-6 — the null Brent's own tolerance (NULL_BRENT_TOL): both packages fit
the same f64 objective with the same Brent, but their matmuls sum in
another order, and a 1e-16 change of the objective can move Brent's
final step anywhere inside that tolerance.
"""

import numpy as np
import pytest

from janusx_tpu.core.spectral import eigh_grm
from janusx_tpu.io.gdata import GenotypeData as JGenotypeData, SiteInfo as JSiteInfo
from janusx_tpu.io.packed import QcParams as JQc, pack_genotypes as j_pack
from janusx_tpu.models.grm import grm_from_packed as j_grm
from janusx_tpu.models.lmm import lmm_scan as j_lmm_scan
from janusx_tpu_torch import interop
from janusx_tpu_torch.io.gdata import GenotypeData as TGenotypeData, SiteInfo as TSiteInfo
from janusx_tpu_torch.io.packed import QcParams as TQc, pack_genotypes as t_pack
from janusx_tpu_torch.models import lmm as tlmm
from janusx_tpu_torch.ops import kernels


@pytest.fixture(scope="module")
def panel():
    rng = np.random.default_rng(2026)
    m, n = 1500, 200
    g = rng.binomial(2, rng.uniform(0.05, 0.5, m)[:, None], size=(m, n)).astype(np.int8)
    g[rng.random((m, n)) < 0.02] = -1
    g[7] = 1  # monomorphic in the panel: dropped by QC
    site = dict(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                snp=np.array([f"rs{i}" for i in range(m)], object),
                allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    samples = np.array([f"i{j}" for j in range(n)], object)
    pj = j_pack(JGenotypeData(g, JSiteInfo(**site), samples), JQc())
    pt = t_pack(TGenotypeData(g, TSiteInfo(**site), samples), TQc())
    basis = eigh_grm(j_grm(pj), diag_ridge=1e-6)
    gc = pj.centered()
    h = rng.normal(0, 0.03, pj.m)
    h[[10, 400, 900]] = [0.8, -0.6, 0.7]  # planted QTLs
    y = 3.0 + gc.T @ h + rng.normal(size=n)
    cov = rng.normal(size=(n, 4))
    return pj, pt, basis, y, cov


def _compare(rj, nj, rt, nt):
    assert rt.m == rj.m
    np.testing.assert_array_equal(np.isnan(rt.beta), np.isnan(rj.beta))
    dl = np.abs(np.log10(rt.pwald) - np.log10(rj.pwald))
    assert dl.max() <= 5e-3, dl.max()
    assert abs(nt.log10_lbd - nj.log10_lbd) <= 1e-6


@pytest.mark.parametrize("p", [1, 3, 5], ids=["p1", "p3", "p5_grid_route"])
def test_lmm_scan_matches_reference(panel, p):
    pj, pt, basis, y, cov = panel
    c = cov[:, : p - 1] if p > 1 else None
    rj, nj = j_lmm_scan(pj, basis, y, c, block=512)
    kernels.reset_launches()
    rt, nt = tlmm.lmm_scan(pt, interop.basis_from_numpy(basis), y, c,
                           block=512, device="cpu")
    _compare(rj, nj, rt, nt)
    assert rt.extras["lambda_null"] == nt.lbd
    # CPU tensors take the plain versions: no kernel launch is counted
    assert kernels.launch_counts()["decode_rotate"] == 0
    assert kernels.launch_counts()["grid_neg_reml_lattice"] == 0


def test_lmm_scan_streaming_matches_reference(panel):
    pj, pt, basis, y, cov = panel
    rj, nj = j_lmm_scan(pj, basis, y, cov[:, :2], block=512)
    tb = interop.basis_from_numpy(basis)
    rt, nt = tlmm.lmm_scan(pt, tb, y, cov[:, :2], block=512, superblock=1024,
                           device="cpu")
    _compare(rj, nj, rt, nt)
    # streaming is exactly the resident scan, chunked
    rr, _ = tlmm.lmm_scan(pt, tb, y, cov[:, :2], block=512, null=nt, device="cpu")
    np.testing.assert_array_equal(rt.pwald, rr.pwald)


def test_lmm_scan_unported_routes_raise(panel):
    """The SNP-sharded scan, the last route this test once found
    unported, now runs: on a mesh of eight CPU shards both scans agree
    with the single-device scan within tests/test_sharding.py:82-84's
    bounds (beta rtol 2e-3 / atol 1e-6, Δ(-log10 p) < 5e-3), and brent
    warns that it ignores the mesh."""
    from janusx_tpu_torch.parallel.mesh import Mesh

    pj, pt, basis, y, cov = panel
    tb = interop.basis_from_numpy(basis)
    mesh = Mesh(["cpu"] * 8)
    Y = np.stack([y, y[::-1]], axis=1)
    for scan, yy in ((tlmm.lmm_scan, y), (tlmm.lmm_scan_multi, Y)):
        one = scan(pt, tb, yy, cov[:, :2], block=512, device="cpu")[0]
        many = scan(pt, tb, yy, cov[:, :2], block=512, mesh=mesh)[0]
        for a, b in zip(np.atleast_1d(one), np.atleast_1d(many)):
            np.testing.assert_allclose(b.beta, a.beta, rtol=2e-3, atol=1e-6, equal_nan=True)
            assert np.nanmax(np.abs(np.log10(b.pwald) - np.log10(a.pwald))) < 5e-3
    with pytest.warns(UserWarning, match="single-device"):
        tlmm.lmm_scan(pt.take_snps(np.arange(64)), tb, y,
                      method="brent", mesh=mesh, device="cpu")
