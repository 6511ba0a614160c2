"""Port parity of the fixed-effect and fixed-λ scans: ``lm_scan`` /
``lm_scan_multi`` (``-lm``), ``fvlmm_scan`` / ``fvlmm_scan_multi``
(``-fvlmm``) and ``gxe_scan`` (``-lm2`` / ``-fvlmm2``), janusx_tpu_torch
against janusx_tpu and against independent numpy formulas, on the panel of
tests/test_torch_lmm.py (n = 200, m = 1,500, 2 % missing genotypes).

Bounds are the reference's own: LM beta/se rel 1e-6 and p rel 1e-5
(tests/test_scans.py:59-61), FvLMM beta/se rel 1e-5 (tests/test_scans.py:
82-83), each against the exact f64 formula; the G×E scans, f64 on both
sides, rtol 1e-6 on every column. Both packages form the LM and FvLMM
grams in f32, so a beta of ~0 gets an absolute floor of 1e-5 se (measured
up to 3.4e-6 se at n = 200), and two f32 results are held to twice each
one's bound against the exact value.
"""

import numpy as np
import pytest
import scipy.stats

from janusx_tpu.models import fvlmm as jfv
from janusx_tpu.models import gxe as jgxe
from janusx_tpu.models import lm as jlm
from janusx_tpu_torch import interop
from janusx_tpu_torch.models import fvlmm as tfv
from janusx_tpu_torch.models import gxe as tgxe
from janusx_tpu_torch.models import lm as tlm
from janusx_tpu_torch.ops import kernels

from test_torch_lmm import panel  # noqa: F401  (module fixture)


def _cov(cov, p):
    return cov[:, : p - 1] if p > 1 else None


def _traits(pj, y, T, seed=5):
    rng = np.random.default_rng(seed)
    gc = pj.centered()
    return np.stack([y] + [gc.T @ rng.normal(0, 0.04, pj.m) + rng.normal(size=pj.n)
                           for _ in range(T - 1)], axis=1)


def _close(a, b, rtol, what, floor=0.0):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    ok = ~np.isnan(b)
    floor = np.broadcast_to(floor, b.shape)[ok]
    assert np.all(np.abs(a[ok] - b[ok]) <= rtol * np.abs(b[ok]) + floor), (
        what, np.max(np.abs(a[ok] - b[ok]) / (np.abs(b[ok]) + floor)))


def _close_scan(a, b, rtol_beta_se, rtol_p=None, k=2):
    """beta, se, pwald of two ScanResults that both carry f32 rounding: k
    times each one's bound against the exact value (a beta of ~0 against
    its standard error gets the floor 1e-5 se each)."""
    _close(a.beta, b.beta, k * rtol_beta_se, "beta", floor=k * 1e-5 * np.nan_to_num(b.se))
    _close(a.se, b.se, k * rtol_beta_se, "se")
    _close(a.pwald, b.pwald, k * (rtol_p or rtol_beta_se), "pwald")


def _numpy_lm(G, y, X):
    """tests/test_scans.py:41-61's formula, all rows at once."""
    n, p = X.shape
    df = n - p - 1
    M = np.eye(n) - X @ np.linalg.inv(X.T @ X) @ X.T
    gMy, gMg = G @ (M @ y), np.einsum("ij,jk,ik->i", G, M, G)
    beta = gMy / gMg
    se = np.sqrt((y @ M @ y - gMy ** 2 / gMg) / df / gMg)
    return beta, se, 2 * scipy.stats.t.sf(np.abs(beta / se), df)


@pytest.mark.parametrize("p", [1, 3])
def test_lm_scan_matches_reference_and_numpy(panel, p):  # noqa: F811
    pj, pt, _, y, cov = panel
    c = _cov(cov, p)
    rj = jlm.lm_scan(pj, y, c, block=512)
    rt = tlm.lm_scan(pt, y, c, block=512, superblock=1024, device="cpu")
    _close_scan(rt, rj, 1e-6, 1e-5)
    with np.errstate(divide="ignore", invalid="ignore"):
        beta, se, pw = _numpy_lm(pj.centered(), y, tlm.design_matrix(pj.n, c))
    ok = np.isfinite(beta)  # a lane with g'Mg = 0: NaN, and p 1 in the scan
    assert np.all(np.isnan(rt.beta[~ok]) & (rt.pwald[~ok] == 1.0))
    _close(rt.beta[ok], beta[ok], 1e-6, "beta", floor=1e-5 * se[ok])
    _close(rt.se[ok], se[ok], 1e-6, "se")
    _close(rt.pwald[ok], pw[ok], 1e-5, "pwald")
    # SNP-sharded over eight CPU shards: the single-device scan's values
    from janusx_tpu_torch.parallel.mesh import Mesh

    rm = tlm.lm_scan(pt, y, c, block=512, superblock=1024, mesh=Mesh(["cpu"] * 8))
    _close_scan(rm, rt, 1e-6, 1e-5)


def test_lm_scan_multi_matches_reference(panel):  # noqa: F811
    pj, pt, _, y, cov = panel
    Y = _traits(pj, y, 3)
    rj = jlm.lm_scan_multi(pj, Y, cov[:, :2], block=512)
    rt = tlm.lm_scan_multi(pt, Y, cov[:, :2], block=512, device="cpu")
    assert len(rt) == 3
    for t in range(3):
        one = tlm.lm_scan(pt, Y[:, t], cov[:, :2], block=512, device="cpu")
        _close_scan(rt[t], rj[t], 1e-6, 1e-5)
        _close_scan(rt[t], one, 1e-6, 1e-5)


def _numpy_fvlmm(pj, basis, y, X, lbd):
    """tests/test_scans.py:64-83's formula, all rows at once."""
    Xr, yr = basis.U.T @ X, basis.U.T @ y
    w = 1.0 / (basis.S + lbd)
    n, p = Xr.shape
    W = np.diag(w)
    P = W - W @ Xr @ np.linalg.inv(Xr.T @ W @ Xr + 1e-6 * np.eye(p)) @ Xr.T @ W
    Gr = pj.centered() @ basis.U
    gPg = np.einsum("ij,jk,ik->i", Gr, P, Gr)
    return (Gr @ (P @ yr)) / gPg, np.sqrt((yr @ P @ yr / (n - p - 1)) / gPg)


@pytest.mark.parametrize("p", [1, 3])
def test_fvlmm_scan_matches_reference_and_numpy(panel, p):  # noqa: F811
    pj, pt, basis, y, cov = panel
    c = _cov(cov, p)
    rj, nj = jfv.fvlmm_scan(pj, basis, y, c, block=512)
    kernels.reset_launches()
    rt, nt = tfv.fvlmm_scan(pt, interop.basis_from_numpy(basis), y, c, block=512,
                            superblock=1024, device="cpu")
    assert kernels.launch_counts()["decode_rotate"] == 0  # CPU tensors: the plain version
    assert abs(nt.log10_lbd - nj.log10_lbd) <= 1e-6
    assert rt.extras == {"lambda_null": nt.lbd, "reml_null": nt.reml}
    _close_scan(rt, rj, 1e-5)
    with np.errstate(divide="ignore", invalid="ignore"):
        beta, se = _numpy_fvlmm(pj, basis, y, tlm.design_matrix(pj.n, c), nt.lbd)
    ok = ~np.isnan(rt.beta)
    _close(rt.beta[ok], beta[ok], 1e-5, "beta", floor=1e-5 * se[ok])
    _close(rt.se[ok], se[ok], 1e-5, "se")


def test_fvlmm_scan_multi_matches_reference(panel):  # noqa: F811
    pj, pt, basis, y, cov = panel
    Y = _traits(pj, y, 3)
    tb = interop.basis_from_numpy(basis)
    rj, nj = jfv.fvlmm_scan_multi(pj, basis, Y, cov[:, :2], block=512)
    rt, nt = tfv.fvlmm_scan_multi(pt, tb, Y, cov[:, :2], block=512, device="cpu")
    for t in range(3):
        assert abs(nt[t].log10_lbd - nj[t].log10_lbd) <= 1e-6
        one, _ = tfv.fvlmm_scan(pt, tb, Y[:, t], cov[:, :2], block=512, null=nt[t],
                                device="cpu")
        _close_scan(rt[t], rj[t], 1e-5)
        _close_scan(rt[t], one, 1e-6)


_GXE_COLS = ("beta_i1", "se_i1", "pwald_i1", "chisq_int_joint", "p_int_joint",
             "chisq_joint", "p_joint")


@pytest.mark.parametrize("mixed", [False, True], ids=["lm2", "fvlmm2"])
@pytest.mark.parametrize("ncov", [0, 2])
def test_gxe_matches_reference(panel, mixed, ncov):  # noqa: F811
    """The interaction covariate is the raw last column (a level shift
    away from zero, as a real covariate has); both routes f64, fvlmm2 at
    the reference's null λ (the port's own is within the null Brent's
    tolerance, 1e-6 in log10 λ)."""
    pj, pt, basis, y, cov = panel
    inter = 2.0 + cov[:, 3]
    main = cov[:, :ncov] if ncov else None
    rj, nj = jgxe.gxe_scan(pj, y, inter, main, basis=basis if mixed else None, block=512)
    tb = interop.basis_from_numpy(basis) if mixed else None
    rt, nt = tgxe.gxe_scan(pt, y, inter, main, basis=tb, block=512,
                           null=interop.null_from_numpy(nj) if mixed else None,
                           device="cpu")
    assert (nt is None) == (nj is None) == (not mixed)
    if mixed:
        _, own = tgxe.gxe_scan(pt, y, inter, main, basis=tb, block=512, device="cpu")
        assert abs(own.log10_lbd - nj.log10_lbd) <= 1e-6
    assert list(rt.extra_cols) == list(_GXE_COLS) == list(rj.extra_cols)
    _close_scan(rt, rj, 1e-6, k=1)
    for col in _GXE_COLS:
        _close(rt.extra_cols[col], rj.extra_cols[col], 1e-6, col)
    assert rt.extras["interaction"] is True
