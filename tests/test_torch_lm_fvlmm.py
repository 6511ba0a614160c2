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


_DBL_MIN = np.finfo(np.float64).tiny


@pytest.mark.parametrize("df", [1, 2, 5, 197, 4930, 60000])
def test_student_t_p_is_the_t_distribution(df):
    """The p the LM scan forms on its device (on the CPU T1's plain
    version) against the t distribution's own tail (scipy's stdtr;
    relative where p <= 1/2, absolute above, where stdtr itself is only
    good to ~1e-9 at df = 1) and against the host p (scipy's betainc at
    the rounded x = df/(df+t^2)), over |t| from 0 to 80."""
    import torch
    from scipy import special

    from janusx_tpu_torch.ops.kernels import student_t_p

    rng = np.random.default_rng(df)
    t = np.concatenate([rng.normal(0, 2, 20000), rng.normal(0, 20, 2000),
                        np.linspace(-80, 80, 801), 10.0 ** -np.arange(1, 12)])
    p = student_t_p(torch.from_numpy(t), df).numpy()
    tail = np.clip(2 * special.stdtr(df, -np.abs(t)), _DBL_MIN, 1.0)
    big, tiny = tail > 0.5, tail <= 1e-290
    assert np.max(np.abs(p[big] - tail[big])) <= 1e-8
    mid = ~big & ~tiny
    assert np.max(np.abs(p[mid] / tail[mid] - 1)) <= 1e-9
    assert np.all(p[tiny] <= 1e-285)
    host = tlm.student_t_p_two_sided(t, df)
    assert np.max(np.abs(np.log10(p) - np.log10(host))) <= 1e-6


def test_student_t_p_sanitizes_as_the_host():
    import torch

    from janusx_tpu_torch.ops.kernels import student_t_p

    t = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e300, -1e300, 1e-300, 40.0])
    for df in (3, 4930):
        p = student_t_p(torch.from_numpy(t), df).numpy()
        with np.errstate(over="ignore"):
            host = tlm.student_t_p_two_sided(t, df)
        np.testing.assert_array_equal(np.isnan(p), np.isnan(host))
        np.testing.assert_allclose(p, host, rtol=1e-9)
    assert np.all(np.isnan(student_t_p(torch.from_numpy(t), 0).numpy()))


def test_lm_stats_are_the_host_epilogue():
    """beta bit for bit the f64 formula the host applied before the device
    took it over, se to an ulp (torch's vectorized sqrt on the CPU is not
    always correctly rounded); p within 1e-6 in log10 of the host's; a lane
    with g'M_X g ~0, a negative rss or a non-finite gram reads NaN and 1."""
    import torch

    rng = np.random.default_rng(3)
    T, m, df = 2, 4000, 4930
    gMY = rng.normal(0, 30, (T, m))
    gMg = rng.uniform(500, 5000, m)
    gMg[:4] = (0.0, 1e-13, np.nan, np.inf)
    gMY[:, 4] = (1e5, -1e5)  # rss < 0
    yMy = np.array([4950.0, 5100.0])
    beta, se, p = (x.numpy() for x in tlm._lm_stats(torch.from_numpy(gMY),
                                                     torch.from_numpy(gMg), yMy, df))
    for t in range(T):
        with np.errstate(divide="ignore", invalid="ignore"):
            b = gMY[t] / gMg
            s = np.sqrt((yMy[t] - gMY[t] * gMY[t] / gMg) / df / gMg)
        ok = np.isfinite(b) & np.isfinite(s) & (s > 0) & (gMg > 1e-12)
        assert not ok[:5].any() and ok[5:].all()
        np.testing.assert_array_equal(beta[t], np.where(ok, b, np.nan))
        np.testing.assert_array_equal(np.isnan(se[t]), ~ok)
        np.testing.assert_allclose(se[t][ok], s[ok], rtol=4.5e-16, atol=0)
        host = np.where(ok, tlm.student_t_p_two_sided(np.where(ok, b / s, 0.0), df), 1.0)
        assert np.max(np.abs(np.log10(p[t]) - np.log10(host))) <= 1e-6


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
