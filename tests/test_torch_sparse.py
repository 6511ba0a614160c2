"""Port parity of the sparse-GRM path: the ``.jxgrm`` format, the
block-spectral solver, the band-streamed sparse GRM and the ``-splmm`` /
``-splmm-exact`` scans, janusx_tpu_torch against janusx_tpu on the same
seeded inputs (the port on the CPU: plain torch).

Bounds: the host f64 code (jxgrm, BlockSpectralK, the null fits) is the
reference's line for line and is held to rtol 1e-12; the device quadratic
g'V^-1 g (f32) to the host ``quad`` at rtol 2e-4 (tests/test_sparse_path.py
:106); the sparse GRM's values to rtol 1e-5 off the cutoff's f32 rounding
band, whose entries may be kept by one package and dropped by the other;
the scans' λ_null within the null Brent's tolerance (1e-6 in log10 λ) and
beta/se at rtol 5e-4 (tests/test_sparse_path.py:176), tighter where the
test says so.
"""

import numpy as np
import pytest
import scipy.sparse

from janusx_tpu.io import jxgrm as jj
from janusx_tpu.models import sparse_spectral as jss
from janusx_tpu.models import splmm as jsp
from janusx_tpu.models.grm import grm_from_packed as j_grm
from janusx_tpu_torch.io import jxgrm as tj
from janusx_tpu_torch.models import sparse_spectral as tss
from janusx_tpu_torch.models import splmm as tsp

from test_sparse_path import _family_sparse_k
from test_torch_lowrank import family_panel  # noqa: F401  (module fixture)


def test_jxgrm_round_trip_between_packages(tmp_path):
    K = _family_sparse_k(61, np.random.default_rng(0))
    a, b = str(tmp_path / "ref.jxgrm"), str(tmp_path / "port.jxgrm")
    jj.write_jxgrm(a, K)
    tj.write_jxgrm(b, K)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert tj.jxgrm_n_samples(a) == 61
    np.testing.assert_array_equal(tj.read_jxgrm(a).toarray(), K.toarray())
    np.testing.assert_array_equal(jj.read_jxgrm(b).toarray(), K.toarray())


def _indefinite_family_k(n, rng):
    """Family blocks and singletons, plus one chain component whose
    thresholded values leave it indefinite (min eigenvalue < 0)."""
    K = _family_sparse_k(n - 3, rng).tolil()
    chain = np.array([[1.0, 0.9, 0.0], [0.9, 1.0, 0.9], [0.0, 0.9, 1.0]])
    assert np.linalg.eigvalsh(chain)[0] < 0
    return scipy.sparse.block_diag([K, chain], format="csc")


@pytest.mark.parametrize("route", ["spectral", "lu"])
def test_block_spectral_matches_reference(route):
    rng = np.random.default_rng(42)
    K = _indefinite_family_k(100, rng)
    budget = 4 if route == "lu" else None  # "lu": every family > 4 is percolated
    bj = jss.BlockSpectralK.from_sparse(K, max_dense_comp=budget)
    bt = tss.BlockSpectralK.from_sparse(K, max_dense_comp=budget)
    assert bool(bt.sparse_comps) == bool(bj.sparse_comps) == (route == "lu")
    assert (bt.max_comp, bt.n_pad, len(bt.buckets)) == (bj.max_comp, bj.n_pad, len(bj.buckets))
    assert bt.svals_concat().min() >= 0  # the indefinite chain clamped
    B = rng.normal(size=(100, 3))
    for lbd in (0.05, 1.0, 37.0):
        assert bt.logdet(lbd) == pytest.approx(bj.logdet(lbd), rel=1e-12)
        np.testing.assert_allclose(bt.solve(lbd, B), bj.solve(lbd, B), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(bt.solve(lbd, B[:, 0]), bj.solve(lbd, B[:, 0]),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(bt.quad(lbd, B), bj.quad(lbd, B), rtol=1e-12)
    y = rng.normal(size=100)
    fit_t = tss.profiled_null_fit(bt, y, 98, -5.0, 5.0)
    fit_j = jss.profiled_null_fit(bj, y, 98, -5.0, 5.0)
    np.testing.assert_allclose(fit_t, fit_j, rtol=1e-12)
    if route == "lu":
        with pytest.raises(ValueError, match="sparse-LU"):
            bt.device_quad_fn(0.5, "cpu")


def test_device_quad_matches_host_quad_and_reference():
    """The device quadratic on a kinship with singletons and padded
    components: f32 by default (the reference's bound, and bit for bit the
    bucketed gather/rotate/weight sum in f32), and in f64 the host ``quad``
    at rtol 1e-12."""
    import torch

    rng = np.random.default_rng(42)
    K = _family_sparse_k(97, rng)
    bt = tss.BlockSpectralK.from_sparse(K)
    bj = jss.BlockSpectralK.from_sparse(K)
    sizes = [b.idx.shape[1] for b in bt.buckets]
    assert 1 in sizes and bt.n_pad > 0
    G = rng.normal(size=(8, 97)).astype(np.float32)
    lbd = 0.7
    got = bt.device_quad_fn(lbd, "cpu")(torch.from_numpy(G)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, bt.quad(lbd, G.T.astype(np.float64)), rtol=2e-4)
    np.testing.assert_allclose(got, np.asarray(bj.device_quad_fn(lbd)(G)), rtol=2e-4)
    Gz = torch.nn.functional.pad(torch.from_numpy(G), (0, 1))
    plain = torch.zeros(8, dtype=torch.float32)
    for b in bt.buckets:
        rot = torch.einsum("bcs,cst->bct", Gz[:, torch.as_tensor(b.idx)],
                           torch.as_tensor(b.U, dtype=torch.float32))
        w = torch.as_tensor(1.0 / (b.svals + lbd), dtype=torch.float32)
        plain = plain + torch.einsum("bct,ct->b", rot * rot, w)
    np.testing.assert_array_equal(got, plain.numpy())
    G64 = rng.normal(size=(8, 97))
    got64 = bt.device_quad_fn(lbd, "cpu", dtype=torch.float64)(torch.from_numpy(G64))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), bt.quad(lbd, G64.T), rtol=1e-12)


def test_build_sparse_grm_matches_reference(family_panel):  # noqa: F811
    """The band-streamed GRM over two row bands of a family panel with
    missing genotypes, both methods, at the default cutoff 0.05 and at
    0.1, which splits this panel's kinship into its sibships: the same
    kept pattern except entries within the values' bound (rtol 1e-5) of the
    cutoff, which either package may keep (counted: the pattern differs
    nowhere else), values rtol 1e-5 (the two f32 sums differ in their
    summation order only)."""
    pj, pt = family_panel[:2]
    sibs = np.kron(np.eye(60, dtype=bool), np.ones((4, 4), bool))
    for method in (1, 2):
        dense = j_grm(pj, method=method)
        for cut in (0.05, 0.1):
            Kj = jsp.build_sparse_grm(pj, cutoff=cut, method=method, row_band=128)
            Kt = tsp.build_sparse_grm(pt, cutoff=cut, method=method, row_band=128,
                                      device="cpu")
            Kj, Kt = Kj.toarray(), Kt.toarray()
            near = np.abs(np.abs(dense) - cut) <= 1e-5 * cut  # the cutoff's band
            flips = (Kj != 0) != (Kt != 0)
            assert not flips[~near].any() and near.sum() <= 4, (flips.sum(), near.sum())
            both = (Kj != 0) & (Kt != 0)
            assert both[sibs].all()  # the diagonal and every sibling pair kept
            np.testing.assert_allclose(Kt[both], Kj[both], rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(Kt[both], dense[both], rtol=1e-5, atol=1e-7)
        assert both.mean() < 0.02  # at 0.1: the sibships and a few more pairs
    with pytest.raises(ValueError, match="methods 1/2"):
        tsp.build_sparse_grm(pt, method=3, device="cpu")


@pytest.fixture(scope="module")
def sparse_problem(family_panel):  # noqa: F811
    """The panel's kinship at cutoff 0.1: components of 4, 8 and 12
    samples, in buckets of 4, 8 and 16."""
    pj, pt, y, cov = family_panel
    return pj, pt, jsp.build_sparse_grm(pj, cutoff=0.1), y, cov


def _close(a, b, rtol, what, floor=0.0):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    ok = ~np.isnan(b)
    floor = np.broadcast_to(floor, b.shape)[ok]
    err = np.abs(a[ok] - b[ok])
    assert np.all(err <= rtol * np.abs(b[ok]) + floor), (
        what, np.max(err / (np.abs(b[ok]) + floor)))


@pytest.mark.parametrize("percolated", [False, True], ids=["spectral", "lu"])
@pytest.mark.parametrize("ncov", [0, 2])
def test_splmm_grammar_matches_reference(sparse_problem, monkeypatch, ncov, percolated):
    """-splmm on the same sparse K: the host null fit and γ calibration
    are the reference's (λ_null, σ², γ rtol 1e-12), γ's statistics formed
    in f64 by torch (spectral: one ``gamma.card`` count a scan) or on the
    host (a percolated kinship: one ``gamma.host``); the per-SNP grams are
    f32 in both packages: beta/se rtol 1e-5, a beta of ~0 with the
    absolute floor 1e-5 se (tests/test_torch_lm_fvlmm.py's)."""
    from janusx_tpu_torch.utils import trace

    pj, pt, K, y, cov = sparse_problem
    if percolated:
        monkeypatch.setenv("JX_TPU_SPARSE_MAX_DENSE_COMP", "6")
    c = cov[:, :ncov] if ncov else None
    rj, ij = jsp.splmm_grammar_scan(pj, K, y, c, block=256)
    before = trace.counts()
    rt, it = tsp.splmm_grammar_scan(pt, K, y, c, block=256, superblock=512, device="cpu")
    after = trace.counts()
    route = "gamma.host" if percolated else "gamma.card"
    for name in ("gamma.card", "gamma.host"):
        gained = after.get(name, 0) - before.get(name, 0)
        assert gained == (name == route), (name, gained)
    for key in ("lambda_null", "sigma2", "gamma"):
        assert it[key] == pytest.approx(ij[key], rel=1e-12), key
    assert (it["n_gamma_markers"], it["max_component"]) == (ij["n_gamma_markers"],
                                                              ij["max_component"])
    assert it["nnz_frac"] == ij["nnz_frac"]
    _close(rt.beta, rj.beta, 1e-5, "beta", floor=1e-5 * np.nan_to_num(rj.se))
    _close(rt.se, rj.se, 1e-5, "se")
    _close(rt.pwald, rj.pwald, 1e-4, "pwald")


@pytest.mark.parametrize("percolated", [False, True], ids=["spectral", "lu"])
def test_splmm_exact_matches_reference(sparse_problem, monkeypatch, percolated):
    """-splmm-exact on the same sparse K, the device quadratic (f32) or,
    with a percolated kinship, the host LU route (f64): λ_null within the
    null Brent's tolerance, beta/se rtol 5e-4 (tests/test_sparse_path.py:
    176; measured below 1e-5 on the spectral route)."""
    pj, pt, K, y, cov = sparse_problem
    if percolated:
        monkeypatch.setenv("JX_TPU_SPARSE_MAX_DENSE_COMP", "6")
    rj, ij = jsp.splmm_exact_scan(pj, K, y, cov[:, :2], block=256)
    rt, it = tsp.splmm_exact_scan(pt, K, y, cov[:, :2], block=256, superblock=512,
                                  device="cpu")
    assert abs(np.log10(it["lambda_null"]) - np.log10(ij["lambda_null"])) <= 1e-6
    assert it["sigma2"] == pytest.approx(ij["sigma2"], rel=1e-6)
    assert rt.m == pt.m and np.isfinite(rt.pwald).all()
    _close(rt.beta, rj.beta, 5e-4, "beta")
    _close(rt.se, rj.se, 5e-4, "se")
    if not percolated:
        _close(rt.beta, rj.beta, 1e-5, "beta", floor=1e-5 * np.nan_to_num(rj.se))
        _close(rt.se, rj.se, 1e-5, "se")


def test_splmm_exact_matches_dense_formula(sparse_problem):
    """The port's exact scan against the dense reference formulas
    (splmm.rs:1-9) at its own λ (tests/test_sparse_path.py:155-179)."""
    pj, pt, K, y, cov = sparse_problem
    n = pt.n
    res, info = tsp.splmm_exact_scan(pt, K, y, cov[:, :2], device="cpu")
    V = K.toarray() + info["lambda_null"] * np.eye(n)
    Vi = np.linalg.inv(V)
    X = np.concatenate([np.ones((n, 1)), cov[:, :2]], axis=1)
    P = Vi - Vi @ X @ np.linalg.solve(X.T @ Vi @ X, X.T @ Vi)
    sigma2 = float(y @ P @ y) / (n - X.shape[1] - 1)
    G = pt.centered()
    gPg = np.einsum("kn,nm,km->k", G, P, G)
    np.testing.assert_allclose(res.beta, G @ (P @ y) / gPg, rtol=5e-4)
    np.testing.assert_allclose(res.se, np.sqrt(sigma2 / gPg), rtol=5e-4)
    assert info["sigma2"] == pytest.approx(sigma2, rel=1e-6)


def test_dense_kinship_is_thresholded_as_the_reference(sparse_problem):
    pj, pt, _, y, _ = sparse_problem
    Kd = j_grm(pj)
    np.testing.assert_array_equal(tsp.sparsify_grm(Kd, 0.1).toarray(),
                                  jsp.sparsify_grm(Kd, 0.1).toarray())
    rt, it = tsp.splmm_grammar_scan(pt, Kd, y, cutoff=0.1, device="cpu")
    rs, is_ = tsp.splmm_grammar_scan(pt, tsp.sparsify_grm(Kd, 0.1), y, device="cpu")
    assert it["lambda_null"] == is_["lambda_null"]
    np.testing.assert_array_equal(rt.beta, rs.beta)


def test_build_sparse_grm_windowed_input_matches_in_ram(tmp_path):
    """A disk-backed WindowedPacked streams its windows through each row
    band (chunks summed in f64 on the host) and gives the in-RAM build
    (tests/test_sparse_path.py::test_build_sparse_grm_windowed_input's
    bound), which gives the reference's."""
    from janusx_tpu_torch.io import plink
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes
    from janusx_tpu_torch.io.windowed import WindowedBed

    rng = np.random.default_rng(9)
    m, n = 600, 130
    g = rng.binomial(2, rng.uniform(0.05, 0.5, size=m)[:, None], size=(m, n)).astype(np.int8)
    sites = SiteInfo(chrom=np.array(["1"] * m, object), pos=np.arange(m, dtype=np.int64) + 1,
                     snp=np.array([f"s{i}" for i in range(m)], object),
                     allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    gd = GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object))
    prefix = str(tmp_path / "w")
    plink.write_plink_genotypes(prefix, gd)
    ram = pack_genotypes(gd, QcParams())
    wp = WindowedBed(prefix, window=113).prepare(QcParams())
    wp.max_resident_snps = 128
    K1 = tsp.build_sparse_grm(ram, cutoff=0.05, row_band=64, device="cpu")
    K2 = tsp.build_sparse_grm(wp, cutoff=0.05, row_band=64, device="cpu")
    np.testing.assert_allclose(K2.toarray(), K1.toarray(), rtol=2e-3, atol=1e-9)
    np.testing.assert_allclose(K1.toarray(), jsp.build_sparse_grm(
        _reference_panel(ram), cutoff=0.05, row_band=64).toarray(), rtol=1e-5, atol=1e-7)


def _reference_panel(pt):
    """The port's packed panel as janusx_tpu's PackedGenotypes."""
    import dataclasses

    from janusx_tpu.io.gdata import SiteInfo as JSiteInfo
    from janusx_tpu.io.packed import PackedGenotypes as JPacked

    sites = JSiteInfo(*(getattr(pt.sites, f.name) for f in dataclasses.fields(pt.sites)))
    return JPacked(packed=pt.packed, n_samples=pt.n_samples, sites=sites,
                   samples=pt.samples, af=pt.af, miss=pt.miss, mean=pt.mean)
