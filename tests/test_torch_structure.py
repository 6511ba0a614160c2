"""Port parity of the population-structure models: the GRM row strips,
PCA (eigh of a GRM and randomized SVD), KING and the LD scores of ``jx
gstats``, each against janusx_tpu on the same inputs, on the CPU.

Bounds:
- ``grm_strip_from_packed``: rtol 1e-6 with the floor 1e-6 x max|K|, as
  the dense GRM (tests/test_torch_grm.py; the reference checks its strips
  against its own dense K at tests/test_grm.py:44); the port's stacked
  strips against the port's dense K under the same bound;
  ``balanced_part_bounds`` equal.
- ``pca_from_grm``: eigenvalues rtol 1e-8, eigenvectors equal up to sign
  at atol 1e-8 (both are LAPACK's f64 eigh of the same matrix).
- ``rsvd_pca`` with the same seed: eigenvalues rtol 1e-5, eigenvectors up
  to sign atol 1e-4 (both packages sum f32 block products in their own
  order over five passes).
- KING with ``tile`` < n: the same pairs in the same order, φ atol 1e-6
  (the counts are exact integers in f32, so φ is the same f32 quotient),
  and the same unrelated set (tests/test_popgen.py:48,100).
- ``_site_ldscores``: rtol 1e-5 across chunk and chromosome boundaries,
  with and without missing calls, in SNP-count and bp windows
  (tests/test_cli.py:505 holds the reference to a direct numpy sum).
"""

import numpy as np
import pytest

from janusx_tpu.io.gdata import GenotypeData as JGenotypeData, SiteInfo as JSiteInfo
from janusx_tpu.io.packed import QcParams as JQc, pack_genotypes as j_pack
from janusx_tpu.models import grm as jgrm, king as jking, pca as jpca
from janusx_tpu.models.sim import simulate_genotypes
from janusx_tpu_torch.io.gdata import GenotypeData as TGenotypeData, SiteInfo as TSiteInfo
from janusx_tpu_torch.io.packed import QcParams as TQc, pack_genotypes as t_pack
from janusx_tpu_torch.models import grm as tgrm, king as tking, pca as tpca

_SITE = ("chrom", "pos", "snp", "allele0", "allele1")


def _both(gd, **qc):
    """The same genotypes packed by each package (equal packed bytes)."""
    site = {k: getattr(gd.sites, k) for k in _SITE}
    pj = j_pack(JGenotypeData(gd.genotypes, JSiteInfo(**site), gd.samples), JQc(**qc))
    pt = t_pack(TGenotypeData(gd.genotypes, TSiteInfo(**site), gd.samples), TQc(**qc))
    np.testing.assert_array_equal(pt.packed, pj.packed)
    return pj, pt


@pytest.fixture(scope="module")
def families():
    """220 samples, 40 % in nuclear families of 5, 2 % missing calls."""
    gd = simulate_genotypes(220, 900, seed=9, structure="mixed", family_size=5,
                            family_frac=0.4, missing_rate=0.02)
    return _both(gd, maf=0.01, geno=0.1)


@pytest.mark.parametrize("method", [1, 2, 3])
def test_grm_strips_match_reference(families, method):
    pj, pt = families
    n = pt.n
    bounds = tgrm.balanced_part_bounds(n, 3)
    assert bounds == jgrm.balanced_part_bounds(n, 3)
    # 900 SNPs in blocks of 128: seven blocks, the last one ragged
    strips = []
    for s0, e0 in bounds:
        st = tgrm.grm_strip_from_packed(pt, np.arange(s0, e0), method=method, block=128,
                                        device="cpu")
        sj = jgrm.grm_strip_from_packed(pj, np.arange(s0, e0), method=method, block=128)
        assert st.shape == (e0 - s0, n) and st.dtype == np.float64
        np.testing.assert_allclose(st, sj, rtol=1e-6, atol=1e-6 * np.abs(sj).max())
        strips.append(st)
    K = tgrm.grm_from_packed(pt, method=method, block=128, device="cpu")
    np.testing.assert_allclose(np.vstack(strips), K, rtol=1e-6, atol=1e-6 * np.abs(K).max())
    # a -part-group strip: every 7th row
    rows = np.arange(n)[::7]
    st = tgrm.grm_strip_from_packed(pt, rows, method=method, block=128, device="cpu")
    np.testing.assert_allclose(st, K[rows], rtol=1e-6, atol=1e-6 * np.abs(K).max())


@pytest.mark.parametrize("n,parts", [(1, 1), (7, 3), (75, 4), (1940, 4), (10, 10)])
def test_balanced_part_bounds_match_reference(n, parts):
    assert tgrm.balanced_part_bounds(n, parts) == jgrm.balanced_part_bounds(n, parts)


def _same_up_to_sign(a, b, atol):
    signs = np.sign(np.sum(a * b, axis=0))
    np.testing.assert_allclose(a * signs, b, rtol=0, atol=atol)


def test_pca_from_grm_matches_reference(families):
    pj, pt = families
    K = jgrm.grm_from_packed(pj)
    vt, Vt = tpca.pca_from_grm(K, n_pc=10)
    vj, Vj = jpca.pca_from_grm(K, n_pc=10)
    np.testing.assert_allclose(vt, vj, rtol=1e-8)
    _same_up_to_sign(Vt, Vj, 1e-8)


@pytest.mark.parametrize("method,power", [(1, 4), (2, 3)])
def test_rsvd_pca_matches_reference(families, method, power):
    pj, pt = families
    vt, Vt = tpca.rsvd_pca(pt, n_pc=5, method=method, power_iters=power, seed=3,
                           block=256, device="cpu")
    vj, Vj = jpca.rsvd_pca(pj, n_pc=5, method=method, power_iters=power, seed=3, block=256)
    assert Vt.shape == (pt.n, 5)
    np.testing.assert_allclose(vt, vj, rtol=1e-5)
    _same_up_to_sign(Vt, Vj, 1e-4)


def test_rsvd_av_pass_matches_direct_product(families):
    """One device pass is A'(A V) of the standardized panel, in f32."""
    import torch

    from janusx_tpu_torch.utils import devcache

    _, pt = families
    _, inv_sd, _ = tgrm._snp_scales(pt, 2)
    shape = (-(-pt.m // 256), 256)
    pk = devcache.device_packed_blocks(pt, shape, torch.device("cpu"), lane_align=128)
    mn = devcache.to_device_blocks(pt.mean, shape, 0.0, torch.float32, torch.device("cpu"))
    iv = devcache.to_device_blocks(inv_sd, shape, 0.0, torch.float32, torch.device("cpu"))
    V = np.random.default_rng(0).normal(size=(pk.shape[-1] * 4, 7))
    got = tpca._rsvd_av(pk, mn, iv, torch.as_tensor(V, dtype=torch.float32)).numpy()
    A = pt.centered() * inv_sd[:, None]  # (m, n), missing -> 0
    want = A.T @ (A @ V[:pt.n])
    np.testing.assert_allclose(got[:pt.n], want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert not got[pt.n:].any()


def test_king_kinship_matches_reference(families):
    pj, pt = families
    phi_t = tking.king_kinship(pt, block=128, device="cpu")
    phi_j = jking.king_kinship(pj, block=128)
    np.testing.assert_allclose(phi_t, phi_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tking.unrelated_set(phi_t), jking.unrelated_set(phi_j))


@pytest.mark.parametrize("tile", [64, 220, 8192])
def test_king_related_pairs_match_reference(families, tile):
    pj, pt = families
    it, jt, vt = tking.king_related_pairs(pt, tile=tile, block=128, device="cpu")
    ij, jj, vj = jking.king_related_pairs(pj, tile=tile, block=128)
    assert len(it) > 10  # the families
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(jt, jj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-6)
    assert np.all(it < jt)
    keep = tking.unrelated_set_from_pairs(it, jt, pt.n)
    np.testing.assert_array_equal(keep, jking.unrelated_set_from_pairs(ij, jj, pj.n))
    # the sparse sweep and the dense kinship agree (tests/test_popgen.py:100)
    phi = tking.king_kinship(pt, block=128, device="cpu")
    np.testing.assert_array_equal(keep, tking.unrelated_set(phi))


def _ld_panel(tmp_path, missing: bool):
    """4,500 SNPs on two chromosomes (2,300 and 2,200 SNPs): each crosses
    a 2,048-SNP chunk edge; planted LD with the previous site."""
    from janusx_tpu.io import plink

    rng = np.random.default_rng(3)
    m, n = 4500, 30
    g = rng.integers(0, 3, (m, n)).astype(np.int8)
    for i in range(1, m):
        mask = rng.random(n) < 0.7
        g[i, mask] = g[i - 1, mask]
    g[17] = 1  # a monomorphic site scores 0
    if missing:
        g[rng.random((m, n)) < 0.05] = -1
    pos = np.concatenate([np.arange(1, 2301), np.arange(1, 2201)]) * 100
    pos[2350:] += 5_000  # a gap in chromosome 2: bp windows of unequal width
    sites = JSiteInfo(chrom=np.array(["1"] * 2300 + ["2"] * 2200, object),
                      pos=pos.astype(np.int64),
                      snp=np.array([f"s{i}" for i in range(m)], object),
                      allele0=np.array(["A"] * m, object),
                      allele1=np.array(["G"] * m, object))
    prefix = str(tmp_path / "ld")
    plink.write_plink_genotypes(
        prefix, JGenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object)))
    return prefix


@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("kind,win", [("variants", 25), ("bp", 3000)])
def test_site_ldscores_match_reference(tmp_path, missing, kind, win):
    from janusx_tpu.cli.gstats import _site_ldscores as j_ld
    from janusx_tpu.io.gfreader import load_raw_packed as j_load
    from janusx_tpu_torch.cli.gstats import _site_ldscores as t_ld
    from janusx_tpu_torch.io.gfreader import load_raw_packed as t_load

    prefix = _ld_panel(tmp_path, missing)
    got = t_ld(t_load(prefix), kind, win, device="cpu")
    want = j_ld(j_load(prefix), kind, win)
    assert got.shape == (4500,) and got[17] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5)
