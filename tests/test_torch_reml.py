"""Port parity: janusx_tpu_torch.core.{reml,stats} vs janusx_tpu.core.

Bounds: make_rotated / grid_shared f64 fields rtol 1e-10 and f32 fields
rtol 1e-6 (f64 matmuls in another summation order, then an f32 cast);
argmin_parabolic exact on identical input; final grams + f64 epilogue
rtol 1e-5 (f32 grams); null REML fit log10 λ atol 1e-6 (the Brent
tolerance); device Wald p rtol 1e-6 down to p = 1e-8 and 5e-6 down to
the 1e-30 host-recompute floor (two f32 erfc implementations: the relative
error of an f32 tail grows like 2 z^2 eps32, and each is within ~1e-5 of
the exact value there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janusx_tpu.core import reml as jreml
from janusx_tpu.core import stats as jstats
from janusx_tpu.core.spectral import eigh_grm
from janusx_tpu_torch import interop
from janusx_tpu_torch.core import reml as treml
from janusx_tpu_torch.core import stats as tstats


@pytest.fixture(scope="module", params=[1, 3], ids=["p1", "p3"])
def problem(request):
    p = request.param
    rng = np.random.default_rng(100 + p)
    n, m = 120, 300
    g = rng.binomial(2, rng.uniform(0.1, 0.5, m)[:, None], size=(m, n)).astype(np.float64)
    gc = g - g.mean(axis=1, keepdims=True)
    basis = eigh_grm(gc.T @ gc / m, diag_ridge=1e-6)
    cov = rng.normal(size=(n, p - 1)) if p > 1 else None
    # a large phenotype mean exercises the f64 span(X) residualization
    y = 25.0 + gc[:20].T @ rng.normal(0, 0.2, 20) + rng.normal(size=n)
    rot_j = jreml.make_rotated(basis, y, cov)
    rot_t = treml.make_rotated(interop.basis_from_numpy(basis), y, cov, device="cpu")
    Gr32 = (gc @ basis.U).astype(np.float32)
    return rot_j, rot_t, Gr32


def test_make_rotated_matches(problem):
    rot_j, rot_t, _ = problem
    for f in jreml.RotatedData._fields:
        got = getattr(rot_t, f)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(rot_j, f)),
                                   rtol=1e-10, atol=1e-12)


def test_grid_shared_matches(problem):
    rot_j, rot_t, _ = problem
    G = 256
    sh_j = jreml.grid_shared(rot_j, jnp.asarray(np.linspace(-5, 5, G), jnp.float64))
    sh_t = treml.grid_shared(rot_t, treml.make_grid(G, "cpu"))
    assert sh_t.grid_lg.dtype == torch.float64
    np.testing.assert_allclose(sh_t.grid_lg.numpy(), np.asarray(sh_j.grid_lg),
                               rtol=1e-10)
    for f in jreml.GridShared._fields[1:]:
        got = getattr(sh_t, f)
        assert got.dtype == torch.float32, f
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(sh_j, f)),
                                   rtol=1e-6, atol=1e-30, err_msg=f)


def test_argmin_parabolic_exact():
    rng = np.random.default_rng(5)
    B, G = 64, 128
    grid = np.linspace(-5, 5, G)
    neg = rng.normal(size=(B, G)).astype(np.float32)
    neg[0] = np.inf                          # all-invalid row -> index 0
    neg[1, :] = np.arange(G, dtype=np.float32)  # minimum at the left edge
    neg[2, :] = -np.arange(G, dtype=np.float32)  # minimum at the right edge
    neg[3, 10:20] = np.inf
    neg[4, 5] = neg[4, 40] = -10.0           # tie: the first minimum wins
    ref = np.asarray(jreml.argmin_parabolic(jnp.asarray(neg), jnp.asarray(grid)))
    port = treml.argmin_parabolic(torch.from_numpy(neg),
                                  torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(port, ref)
    assert port[0] == grid[0]


def test_final_stats_match(problem):
    rot_j, rot_t, Gr32 = problem
    rng = np.random.default_rng(9)
    lg = rng.uniform(-2, 2, Gr32.shape[0])
    b_j, se_j, _ = jreml.final_stats_f32(rot_j, jnp.asarray(Gr32), jnp.asarray(lg), False)
    A1, A2, agg, ldV = treml.final_grams_f32(rot_t, torch.from_numpy(Gr32),
                                            torch.from_numpy(lg), False)
    assert A1.dtype == A2.dtype == agg.dtype == torch.float32
    b_t, se_t, _ = treml.final_stats_from_grams(rot_t.n, rot_t.p, A1, A2, agg,
                                                False, ldV)
    assert b_t.dtype == torch.float64
    # f32 gram rounding is relative to the grams, not to a beta that
    # cancels to ~0, so the absolute floor scales with the largest |beta|
    b_j = np.asarray(b_j)
    np.testing.assert_allclose(b_t.numpy(), b_j, rtol=1e-5,
                               atol=1e-5 * np.nanmax(np.abs(b_j)))
    np.testing.assert_allclose(se_t.numpy(), np.asarray(se_j), rtol=1e-5)


def test_grid_scan_with_matches(problem):
    """The p > 4 route's block step (K1 output -> lmm_grid_scan_with):
    λ* within the lattice bound of the reference's XLA grid scan."""
    rot_j, rot_t, Gr32 = problem
    G = 256
    sh_j = jreml.grid_shared(rot_j, jnp.asarray(np.linspace(-5, 5, G), jnp.float64))
    sh_t = treml.grid_shared(rot_t, treml.make_grid(G, "cpu"))
    lg_j = np.asarray(jreml.lmm_grid_scan_with(sh_j, rot_j, jnp.asarray(Gr32)))
    lg_t = treml.lmm_grid_scan_with(sh_t, rot_t, torch.from_numpy(Gr32)).numpy()
    np.testing.assert_allclose(lg_t, lg_j, atol=2.02 * 10.0 / (G - 1))
    assert np.mean(np.abs(lg_t - lg_j) < 1e-6) > 0.5


def test_fit_null_reml_matches(problem):
    rot_j, rot_t, _ = problem
    nj = jreml.fit_null_reml(rot_j)
    nt = treml.fit_null_reml(rot_t)
    assert abs(nt.log10_lbd - nj.log10_lbd) <= 1e-6
    assert nt.reml == pytest.approx(nj.reml, rel=1e-9)
    assert nt.ml == pytest.approx(nj.ml, rel=1e-9)
    # the host twin agrees too (the LMM->LM switch uses it)
    nh, _, _ = treml.fit_null_reml_host(rot_t.s.numpy(), rot_t.Xr.numpy(),
                                        rot_t.yr.numpy())
    assert abs(nh.log10_lbd - nj.log10_lbd) <= 1e-4


def test_brent_batched_matches_reference():
    """The lockstep Brent on lanes that converge after different numbers
    of steps (one has its minimum on a bound): each lane's optimum is the
    reference's to the tolerance, as the loop freezes finished lanes."""
    from janusx_tpu.ops.brent import brent_minimize_batched as j_brent
    from janusx_tpu_torch.ops.brent import brent_minimize_batched as t_brent

    c = np.array([-4.0, -1.3, 0.2, 2.9, 7.0])
    w = np.array([1.0, 0.3, 5.0, 0.05, 1.0])

    def f_j(x):
        return w * (x - c) ** 2 + 0.2 * jnp.sin(3.0 * x)

    def f_t(x):
        return torch.from_numpy(w) * (x - torch.from_numpy(c)) ** 2 + 0.2 * torch.sin(3.0 * x)

    xj, fj = j_brent(f_j, -5.0, 5.0, 1e-8, 100, batch_shape=(5,))
    xt, ft = t_brent(f_t, -5.0, 5.0, 1e-8, 100, batch_shape=(5,))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-7)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-12, atol=1e-12)
    assert xt[-1] > 4.99  # the bound lane


def test_null_fit_stats_matches(problem):
    rot_j, rot_t, _ = problem
    for lg in (-1.3, 0.0, 0.7):
        b_j, s2_j = jreml.null_fit_stats(rot_j, lg)
        b_t, s2_t = treml.null_fit_stats(rot_t, lg)
        # beta is fitted against the residualized yr: ~0, so the floor is absolute
        np.testing.assert_allclose(b_t, np.asarray(b_j), rtol=1e-10, atol=1e-12)
        assert s2_t == pytest.approx(float(s2_j), rel=1e-10)


def test_pwald_device_matches():
    rng = np.random.default_rng(3)
    beta = rng.normal(0, 1, 2000) * rng.choice([1e-3, 1, 4], 2000)
    se = rng.uniform(0.3, 1.0, 2000)
    beta[:5] = [np.nan, 1.0, np.inf, 0.0, -2.0]
    se[:5] = [1.0, 0.0, 1.0, 1.0, -1.0]
    ref = np.asarray(jstats.pwald_from_beta_se_device(jnp.asarray(beta), jnp.asarray(se)))
    port = tstats.pwald_from_beta_se_device(torch.from_numpy(beta),
                                            torch.from_numpy(se)).numpy()
    assert port.dtype == np.float64
    np.testing.assert_array_equal(port[:5] == 1.0, ref[:5] == 1.0)
    mid = ref >= 1e-8
    assert mid.sum() > 1500
    np.testing.assert_allclose(port[mid], ref[mid], rtol=1e-6)
    tail = (ref < 1e-8) & (ref > 1e-30)
    assert tail.sum() > 20
    np.testing.assert_allclose(port[tail], ref[tail], rtol=5e-6)
