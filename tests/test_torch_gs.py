"""Port parity of the genomic-selection modules: janusx_tpu_torch against
janusx_tpu on the same inputs, module by module, on the CPU.

Bounds (each stated at its test): grm_denominator rtol 1e-12; cg_solve at
a reachable tol 1e-4, iterations within 1 and x within 1e-4 ||x||;
fit_gblup + predict_gblup rtol 1e-8 on the same K and rtol 1e-5 / atol
1e-7 on each package's own K (tests/test_gs.py:52); marker_effects rtol
1e-4 / atol 1e-6 (tests/test_gs.py:78); the GBLUPad AI-REML fit rtol 1e-5;
he_streamed with the same seed and probes trace_k rel 1e-6, trace_k2 rel
1e-5, h2 abs 1e-5; the signed hash H rtol 2e-4 / atol 2e-4
(tests/test_hashing.py:133), scale rel 1e-5, kept equal; top_fit weights
atol 1e-8 with the same n_iter / converged, top_rank atol 1e-10. The
fitted objects cross between the packages through janusx_tpu_torch.interop.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from janusx_tpu.io.gdata import GenotypeData as JGenotypeData, SiteInfo as JSiteInfo
from janusx_tpu.io.packed import QcParams as JQc, pack_genotypes as j_pack
from janusx_tpu_torch import interop
from janusx_tpu_torch.io.gdata import GenotypeData as TGenotypeData, SiteInfo as TSiteInfo
from janusx_tpu_torch.io.packed import QcParams as TQc, pack_genotypes as t_pack


def _sites(m, cls):
    return cls(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1, dtype=np.int64),
               snp=np.array([f"s{i}" for i in range(m)], object),
               allele0=np.array(["A"] * m, object), allele1=np.array(["C"] * m, object))


def _panel(m=1500, n=200, seed=11, h2=0.6):
    """The same packed panel in both packages (simulate_genotypes' draws:
    MAF ~ U[0.05, 0.5], 2 % missing) and a polygenic trait."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 0.5, size=m)
    g = rng.binomial(2, p[:, None], size=(m, n)).astype(np.int8)
    g[rng.random((m, n)) < 0.02] = -1
    samples = np.array([f"i{j}" for j in range(n)], object)
    qc = dict(maf=0.02, geno=0.05)
    pj = j_pack(JGenotypeData(g, _sites(m, JSiteInfo), samples), JQc(**qc))
    pt = t_pack(TGenotypeData(g, _sites(m, TSiteInfo), samples), TQc(**qc))
    np.testing.assert_array_equal(pt.packed, pj.packed)
    gv = pj.centered().T @ rng.normal(size=pj.m)
    gv = gv / gv.std() * np.sqrt(h2)
    y = 3.0 + gv + rng.normal(size=n) * np.sqrt(1.0 - h2)
    return pj, pt, y


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")  # read by the port only


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """GBLUPad's AI-REML (the port's in torch, the reference's in numpy)
    and the PCG solve are loops of small linear-algebra calls on the CPU;
    with the suite's six workers sharing the cores, each call's threads
    wait on one another. One torch and one BLAS thread per worker run them
    as fast as they run alone."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def panel():
    return _panel()


@pytest.fixture(scope="module")
def kernels(panel):
    from janusx_tpu.models.grm import grm_from_packed as j_grm
    from janusx_tpu_torch.models.grm import grm_from_packed as t_grm

    pj, pt, _ = panel
    return j_grm(pj), t_grm(pt, device="cpu")


@pytest.mark.parametrize("method", [1, 2, 3])
def test_grm_denominator(panel, method):
    from janusx_tpu.models.grm import grm_denominator as j_den
    from janusx_tpu_torch.models.grm import grm_denominator as t_den

    pj, pt, _ = panel
    assert t_den(pt, method) == pytest.approx(j_den(pj, method), rel=1e-12)


@pytest.mark.parametrize("precond", [True, False])
def test_cg_solve(precond):
    from janusx_tpu.ops.cg import cg_solve as j_cg
    from janusx_tpu_torch.ops.cg import cg_solve as t_cg

    rng = np.random.default_rng(4)
    n = 150
    B = rng.normal(size=(n, 40))
    A = (B @ B.T / 40 + np.diag(rng.uniform(0.2, 3.0, n))).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    d = np.diag(A).copy() if precond else None
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    rj = j_cg(lambda v: jnp.dot(Aj, v, precision="highest"), jnp.asarray(b),
              diag_precond=None if d is None else jnp.asarray(d), tol=1e-4, max_iter=500)
    rt = t_cg(lambda v: At @ v, torch.as_tensor(b),
              diag_precond=None if d is None else torch.as_tensor(d), tol=1e-4, max_iter=500)
    assert abs(int(rt.iters) - int(rj.iters)) <= 1
    assert 0 < int(rt.iters) < 500 and float(rt.rel_res) <= 1e-4
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-4 * np.linalg.norm(xj)


def test_cg_solve_stops_where_the_reference_stops():
    """The iteration cap and the tolerance are the reference's rule: the
    solve stops at the first iteration whose relative residual is <= tol,
    or after max_iter iterations, with the iterate of that iteration."""
    from janusx_tpu_torch.ops.cg import cg_solve

    rng = np.random.default_rng(5)
    B = rng.normal(size=(80, 80))
    A = torch.as_tensor(B @ B.T / 80 + np.eye(80), dtype=torch.float64)
    b = torch.as_tensor(rng.normal(size=80))
    mv = lambda v: A @ v
    full = cg_solve(mv, b, tol=1e-6, max_iter=400)
    k = int(full.iters)
    assert 0 < k < 400 and float(full.rel_res) <= 1e-6
    before = cg_solve(mv, b, tol=0.0, max_iter=k - 1)
    assert int(before.iters) == k - 1 and float(before.rel_res) > 1e-6
    assert torch.equal(cg_solve(mv, b, tol=0.0, max_iter=k).x, full.x)


def test_fit_predict_gblup(panel, kernels):
    from janusx_tpu.gs.blup import fit_gblup as j_fit, predict_gblup as j_pred
    from janusx_tpu_torch.gs.blup import GblupModel, fit_gblup as t_fit, predict_gblup as t_pred

    pj, pt, y = panel
    Kj, Kt = kernels
    train, test = np.arange(0, 160), np.arange(160, 200)
    mj = j_fit(Kj, y, train)
    same = t_fit(Kj, y, train)
    np.testing.assert_allclose(t_pred(same, Kj, test), j_pred(mj, Kj, test), rtol=1e-8)
    np.testing.assert_allclose(same.alpha, mj.alpha, rtol=1e-8, atol=1e-12)
    assert same.lbd == pytest.approx(mj.lbd, rel=1e-8)
    own = t_fit(Kt, y, train)
    np.testing.assert_allclose(t_pred(own, Kt, test), j_pred(mj, Kj, test),
                               rtol=1e-5, atol=1e-7)
    # a model fitted by one package predicts in the other
    np.testing.assert_allclose(t_pred(interop.gs_fit_as(mj, GblupModel), Kj, test),
                               j_pred(mj, Kj, test), rtol=1e-12)
    import janusx_tpu.gs.blup as jb

    np.testing.assert_allclose(j_pred(interop.gs_fit_as(same, jb.GblupModel), Kj, test),
                               t_pred(same, Kj, test), rtol=1e-12)


def test_gblup_eigh32_knob(panel, kernels, monkeypatch):
    from janusx_tpu.gs.blup import fit_gblup as j_fit
    from janusx_tpu_torch.gs.blup import fit_gblup as t_fit

    _, _, y = panel
    Kj, _ = kernels
    monkeypatch.setenv("JX_TPU_GS_EIGH32", "1")
    train = np.arange(0, 160)
    mj, mt = j_fit(Kj, y, train), t_fit(Kj, y, train)
    np.testing.assert_allclose(mt.alpha, mj.alpha, rtol=1e-8, atol=1e-12)


def test_marker_effects(panel, kernels):
    from janusx_tpu.gs.blup import fit_gblup, marker_effects as j_eff
    from janusx_tpu.models.grm import grm_denominator
    from janusx_tpu_torch.gs.blup import marker_effects as t_eff

    pj, pt, y = panel
    Kj, _ = kernels
    model = fit_gblup(Kj, y, np.arange(pj.n))
    denom = grm_denominator(pj)
    for block in (512, 2048):  # ragged and single-block
        want = j_eff(pj, model.alpha, denom, block=block)
        got = t_eff(pt, model.alpha, denom, block=block, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_fit_gblup_kernels_ad(panel):
    from janusx_tpu.gs.blup import fit_gblup_kernels as j_fit, predict_gblup_kernels as j_pred
    from janusx_tpu.models.grm import grm_from_packed as j_grm
    from janusx_tpu_torch.gs.blup import (MultiKernelModel, fit_gblup_kernels as t_fit,
                                          predict_gblup_kernels as t_pred)
    from janusx_tpu_torch.models.grm import grm_from_packed as t_grm

    # a small training set keeps the reference's host AI-REML quick; a
    # dominance component keeps both variances off the boundary, where
    # the fit is determined only to the f32 rounding of the kernels
    pj, pt, y = _panel(m=600, n=90, seed=21)
    het = (pj.dosages() == 1).astype(np.float64)
    dv = (het - het.mean(axis=1, keepdims=True)).T @ np.random.default_rng(2).normal(size=pj.m)
    y = y + dv / dv.std()
    train, test = np.arange(0, 70), np.arange(70, 90)
    Kj = {"add": j_grm(pj), "dom": j_grm(pj, method=3)}
    Kt = {"add": t_grm(pt, device="cpu"), "dom": t_grm(pt, method=3, device="cpu")}
    mj, mt = j_fit(Kj, y, train), t_fit(Kt, y, train)
    assert mt.kernels == mj.kernels == ["add", "dom"]
    for k in mj.sigma2:
        assert mt.sigma2[k] == pytest.approx(mj.sigma2[k], rel=1e-5)
    np.testing.assert_allclose(mt.Py, mj.Py, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(t_pred(mt, Kt, test), j_pred(mj, Kj, test), rtol=1e-5)
    np.testing.assert_allclose(t_pred(interop.gs_fit_as(mj, MultiKernelModel), Kj, test),
                               j_pred(mj, Kj, test), rtol=1e-12)


def test_fit_gblup_cg(panel, kernels):
    from janusx_tpu.gs.blup import fit_gblup_cg as j_cg
    from janusx_tpu_torch.gs.blup import fit_gblup_cg as t_cg

    _, _, y = panel
    Kj, _ = kernels
    train = np.arange(0, 160)
    cov = np.random.default_rng(3).normal(size=(200, 1))
    for c in (None, cov):
        aj, bj = j_cg(Kj, y, train, 0.7, covariates=c, tol=1e-5, max_iter=300)
        at, bt = t_cg(Kj, y, train, 0.7, covariates=c, tol=1e-5, max_iter=300,
                      device="cpu")
        np.testing.assert_allclose(bt, bj, rtol=1e-12)
        assert np.linalg.norm(at - aj) <= 1e-4 * np.linalg.norm(aj)


def _he_pair(pj, pt, y, **kw):
    from janusx_tpu.models.he import he_streamed as j_he
    from janusx_tpu_torch.models.he import he_streamed as t_he

    return j_he(pj, y, **kw), t_he(pt, y, device="cpu", **kw)


def _he_close(hj, ht):
    assert ht.probes == hj.probes and ht.boundary == hj.boundary
    assert ht.trace_k == pytest.approx(hj.trace_k, rel=1e-6)
    assert ht.trace_k2 == pytest.approx(hj.trace_k2, rel=1e-5)
    assert ht.h2 == pytest.approx(hj.h2, abs=1e-5)
    assert ht.vg == pytest.approx(hj.vg, rel=1e-4, abs=1e-9)
    assert ht.ve == pytest.approx(hj.ve, rel=1e-4, abs=1e-9)


@pytest.mark.parametrize("case", ["plain", "covariates", "sample_idx", "block"])
def test_he_streamed(panel, case):
    pj, pt, y = panel
    kw = dict(probes=32, seed=1)
    if case == "covariates":
        kw.update(covariates=np.random.default_rng(9).normal(size=(pj.n, 2)), seed=2)
    elif case == "sample_idx":
        kw.update(sample_idx=np.arange(0, pj.n, 2), probes=64, seed=3)
    elif case == "block":
        kw.update(block=256, method=2)  # ragged last block, standardized GRM
    hj, ht = _he_pair(pj, pt, y, **kw)
    _he_close(hj, ht)
    from janusx_tpu_torch.models.he import HeFit

    back = interop.gs_fit_as(hj, HeFit)
    assert (back.h2, back.trace_k, back.boundary) == (hj.h2, hj.trace_k, hj.boundary)


def test_he_streamed_windowed(tmp_path, panel):
    from janusx_tpu.io import plink as j_plink
    from janusx_tpu.io.windowed import WindowedBed as JWin
    from janusx_tpu_torch.io.windowed import WindowedBed as TWin

    pj, _, y = panel
    prefix = str(tmp_path / "hewin")
    j_plink.write_plink_genotypes(prefix, JGenotypeData(pj.dosages(), pj.sites, pj.samples))
    qc = dict(maf=0.01, geno=0.05)
    wj = JWin(prefix, window=256).prepare(JQc(**qc))
    wt = TWin(prefix, window=256).prepare(TQc(**qc))
    hj, ht = _he_pair(wj, wt, y, probes=32, seed=4)
    _he_close(hj, ht)


def test_he_regression_and_boundary(panel, kernels):
    from janusx_tpu.models.he import he_regression as j_reg
    from janusx_tpu_torch.models.he import he_regression as t_reg

    _, _, y = panel
    Kj, _ = kernels
    for yy in (y, np.random.default_rng(0).normal(size=len(y))):
        fj, ft = j_reg(Kj, yy), t_reg(Kj, yy)
        assert (ft.vg, ft.ve, ft.h2, ft.boundary) == (fj.vg, fj.ve, fj.h2, fj.boundary)


def test_reml_h2(panel, kernels):
    """The spectral REML h2 (tests/test_he.py:46's route): log10 λ to the
    null Brent's tolerance, 1e-6, so h2 within 1e-6."""
    from janusx_tpu.models.he import reml_h2 as j_reml
    from janusx_tpu_torch.models.he import reml_h2 as t_reml

    _, _, y = panel
    Kj, _ = kernels
    fj, ft = j_reml(Kj, y), t_reml(Kj, y, device="cpu")
    assert ft.h2 == pytest.approx(fj.h2, abs=1e-6)
    assert ft.vg == pytest.approx(fj.vg, rel=1e-5)


@pytest.mark.parametrize("standardize", [True, False])
def test_signed_hash_features(panel, standardize):
    from janusx_tpu.models.hashing import signed_hash_features as j_hash
    from janusx_tpu_torch.models.hashing import hash_bucket_sign, signed_hash_features as t_hash

    pj, pt, _ = panel
    kw = dict(n_buckets=256, seed=520, standardize=standardize, block=512)
    Hj, sj, kj = j_hash(pj, **kw)
    Ht, st, kt = t_hash(pt, device="cpu", **kw)
    assert kt == kj and Ht.shape == Hj.shape == (pj.n, 256)
    assert st == pytest.approx(sj, rel=1e-5)
    np.testing.assert_allclose(Ht, Hj, rtol=2e-4, atol=2e-4)
    from janusx_tpu.models.hashing import hash_bucket_sign as j_bs

    for a, b in zip(hash_bucket_sign(7, np.arange(5000), 2048), j_bs(7, np.arange(5000), 2048)):
        np.testing.assert_array_equal(a, b)


def _top_problem(seed=7, n=120, k=3):
    rng = np.random.default_rng(seed)
    y_true = rng.normal(size=(n, k))
    y_pred = np.empty_like(y_true)
    y_pred[:, 0] = y_true[:, 0] + 0.1 * rng.normal(size=n)
    y_pred[:, 1] = y_true[:, 1] + 0.8 * rng.normal(size=n)
    y_pred[:, 2] = rng.normal(size=n)
    y_true[::7, 1] = np.nan
    return y_true, 2.0 + 1.5 * y_pred


@pytest.mark.parametrize("calibration", ["linear", "none", "addmean"])
def test_top_fit_and_rank(calibration):
    from janusx_tpu.gs.top import TopModel as JTop, top_fit as j_fit, top_rank as j_rank
    from janusx_tpu_torch.gs.top import TopModel, top_fit as t_fit, top_rank as t_rank

    y_true, y_pred = _top_problem()
    mj = j_fit(y_true, y_pred, traits=["a", "b", "c"], calibration=calibration)
    mt = t_fit(y_true, y_pred, traits=["a", "b", "c"], calibration=calibration,
               device="cpu")
    assert (mt.n_iter, mt.converged) == (mj.n_iter, mj.converged)
    np.testing.assert_allclose(mt.weights, mj.weights, rtol=0, atol=1e-8)
    assert mt.loss == pytest.approx(mj.loss, rel=1e-10)
    for target in ("max", y_pred[5]):
        np.testing.assert_allclose(t_rank(mt, y_pred, target), j_rank(mj, y_pred, target),
                                   rtol=0, atol=1e-10)
    np.testing.assert_allclose(t_rank(interop.gs_fit_as(mj, TopModel), y_pred, "max"),
                               j_rank(mj, y_pred, "max"), rtol=0, atol=1e-15)
    np.testing.assert_allclose(j_rank(interop.gs_fit_as(mt, JTop), y_pred, "max"),
                               t_rank(mt, y_pred, "max"), rtol=0, atol=1e-15)


def test_top_loss_grad_hess_match_reference():
    from janusx_tpu.gs.top import _loss_grad_hess as j_lgh
    from janusx_tpu_torch.gs.top import _loss_grad_hess as t_lgh

    rng = np.random.default_rng(2)
    P, T = rng.normal(size=(60, 4)), rng.normal(size=(60, 4))
    w = rng.uniform(0.1, 1.0, 4)
    lj, gj, hj = j_lgh(jnp.asarray(w), jnp.asarray(P), jnp.asarray(T), 1e-3)
    lt, gt, ht = t_lgh(*(torch.as_tensor(a) for a in (w, P, T)), 1e-3)
    assert float(lt) == pytest.approx(float(lj), rel=1e-12)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-10, atol=1e-12)


def test_resolve_mesh(monkeypatch):
    """One visible device: no mesh, whatever is asked. Eight (the seam
    patched, as the sharded run_gwas/run_gs tests do): n_devices, else
    JX_TPU_DEVICES, else all of them (the reference's rule)."""
    import torch

    from janusx_tpu_torch.parallel import mesh as mesh_mod
    from janusx_tpu_torch.workflows.gwas import resolve_mesh

    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    monkeypatch.delenv("JX_TPU_DEVICES", raising=False)
    assert resolve_mesh(None) is None and resolve_mesh(1) is None
    assert resolve_mesh(2) is None
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda: [torch.device("cpu")] * 8)
    assert resolve_mesh(None).devices.size == 8 and resolve_mesh(1) is None
    assert resolve_mesh(3).devices.size == 3 and resolve_mesh(20).devices.size == 8
    monkeypatch.setenv("JX_TPU_DEVICES", "2")
    assert resolve_mesh(None).devices.size == 2


def test_gs_knobs_match_reference():
    from janusx_tpu import config as jc
    from janusx_tpu_torch import config as tc

    for name in ("JX_TPU_GBLUP_MAX_N", "JX_TPU_GS_EIGH32", "JX_TPU_RRBLUP_EXACT_MAX_M",
                 "JX_TPU_HE_PROBES", "JX_TPU_HASH_DIM", "JX_TPU_HASH_SEED", "JX_TPU_CG_TOL",
                 "JX_TPU_CG_MAX_ITER"):
        assert tc.KNOBS[name][:2] == jc.KNOBS[name][:2], name
