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


def test_brent_init_x_matches_reference():
    """Warm starts (the scan starts every lane at λ_null): each lane's
    optimum and value are the reference's; a non-finite or out-of-range
    start runs from the midpoint, as in the reference
    (janusx_tpu/ops/brent.py:67-73)."""
    from janusx_tpu.ops.brent import brent_minimize_batched as j_brent
    from janusx_tpu_torch.ops.brent import brent_minimize_batched as t_brent

    c = np.array([-4.0, -1.3, 0.2, 2.9, 4.6, 1.0])
    w = np.array([1.0, 0.3, 5.0, 0.05, 1.0, 2.0])
    init = np.array([-3.5, 0.0, np.nan, 7.0, 4.5, -9.0])

    def f_j(x):
        return w * (x - c) ** 2 + 0.2 * jnp.sin(3.0 * x)

    def f_t(x):
        return torch.from_numpy(w) * (x - torch.from_numpy(c)) ** 2 + 0.2 * torch.sin(3.0 * x)

    xj, fj = j_brent(f_j, -5.0, 5.0, 1e-2, 50, init_x=jnp.asarray(init))
    xt, ft = t_brent(f_t, -5.0, 5.0, 1e-2, 50, init_x=torch.from_numpy(init))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-12, atol=1e-12)
    # the invalid starts (nan, 7.0, -9.0) equal a run from the midpoint
    xm, _ = t_brent(f_t, -5.0, 5.0, 1e-2, 50, init_x=torch.zeros(6, dtype=torch.float64))
    np.testing.assert_array_equal(xt.numpy()[[2, 3, 5]], xm.numpy()[[2, 3, 5]])
    with pytest.raises(ValueError, match="init_x or batch_shape"):
        t_brent(f_t, -5.0, 5.0, 1e-2, 50)


def test_snp_objective_pieces_match(problem):
    """The brent route's per-SNP f64 objective (janusx_tpu/core/reml.py:
    106-216) on the same rotated rows at per-lane λ: -REML, ML and beta/se
    rtol 1e-9 (f64 matmuls in another summation order), the same invalid
    lanes; and lmm_grid_scan's λ* within the lattice bound."""
    rot_j, rot_t, Gr32 = problem
    Gr = Gr32.astype(np.float64)
    Gr[5] = 0.0  # a monomorphic lane: only the ridge keeps the design regular
    lg = np.random.default_rng(2).uniform(-3, 3, Gr.shape[0])
    Gj, Gt, lj, lt = jnp.asarray(Gr), torch.from_numpy(Gr), jnp.asarray(lg), torch.from_numpy(lg)
    for fj, ft in ((jreml.neg_reml_snp_batch, treml.neg_reml_snp_batch),
                   (jreml.ml_snp_batch, treml.ml_snp_batch)):
        np.testing.assert_allclose(ft(lt, rot_t, Gt).numpy(), np.asarray(fj(lj, rot_j, Gj)),
                                   rtol=1e-9)
    bj, sj = (np.asarray(a) for a in jreml.beta_se_snp_batch(lj, rot_j, Gj))
    bt, st = (a.numpy() for a in treml.beta_se_snp_batch(lt, rot_t, Gt))
    np.testing.assert_array_equal(np.isnan(bt), np.isnan(bj))
    assert bt[5] == bj[5] == 0.0
    ok = ~np.isnan(bj)
    np.testing.assert_allclose(bt[ok], bj[ok], rtol=1e-9, atol=1e-12 * np.abs(bj[ok]).max())
    np.testing.assert_allclose(st[ok], sj[ok], rtol=1e-9)
    G = 256
    grid_j = jnp.asarray(np.linspace(-5, 5, G), jnp.float64)
    lg_j = np.asarray(jreml.lmm_grid_scan(rot_j, jnp.asarray(Gr32), grid_j))
    lg_t = treml.lmm_grid_scan(rot_t, torch.from_numpy(Gr32), treml.make_grid(G, "cpu")).numpy()
    np.testing.assert_allclose(lg_t, lg_j, atol=2.02 * 10.0 / (G - 1))
    assert np.mean(np.abs(lg_t - lg_j) < 1e-6) > 0.5


# ------------------------------------- the null fit's kernel (null_reml_brent)
def _shared_states(p, T=3, n=120, seed=11):
    """T traits on one basis and one covariate set: rotated states that
    share s and PXX, as lmm_scan_multi's traits do."""
    rng = np.random.default_rng(seed)
    g = rng.binomial(2, 0.3, size=(400, n)).astype(np.float64)
    gc = g - g.mean(axis=1, keepdims=True)
    basis = interop.basis_from_numpy(eigh_grm(gc.T @ gc / 400, diag_ridge=1e-6))
    cov = rng.normal(size=(n, p - 1)) if p > 1 else None
    Y = 2.0 + gc[:30].T @ rng.normal(0, 0.2, (30, T)) + rng.normal(size=(n, T))
    return [treml.make_rotated(basis, Y[:, t], cov, device="cpu") for t in range(T)]


def _operands(rot, T):
    return rot.s, rot.PXX, torch.stack([rot.PXy] * T), torch.stack([rot.Pyy] * T)


def test_fit_null_reml_on_cpu_is_the_plain_version(problem):
    """CPU tensors take the torch Brent, bit for bit, counted under
    null_fit.plain and never under null_fit.card."""
    from janusx_tpu_torch.ops import kernels
    from janusx_tpu_torch.utils import trace

    _, rot_t, _ = problem
    trace.reset("null_fit.")
    kernels.reset_launches()
    got = treml.fit_null_reml(rot_t)
    assert trace.counts()["null_fit.plain"] == 1
    assert "null_fit.card" not in trace.counts()
    assert kernels.launch_counts()["null_reml_brent"] == 0
    assert got == treml.fit_null_reml_plain(rot_t)


@pytest.mark.parametrize("p", [1, 3])
def test_fit_null_reml_multi_equals_per_trait_fits(p):
    rots = _shared_states(p)
    assert treml.fit_null_reml_multi(rots) == [treml.fit_null_reml(r) for r in rots]
    assert treml.fit_null_reml_multi([]) == []


@pytest.mark.parametrize("odd", ["s", "PXX", "n", "dtype"])
def test_fit_null_reml_multi_rejects_states_that_do_not_share_s_and_pxx(odd):
    """fit_null_reml_multi holds every state to the first one's s and PXX
    (its launch on a card reads only the first's), on any device."""
    from janusx_tpu_torch.utils import trace

    rots = _shared_states(3)
    r = rots[1]
    if odd == "s":
        r = r._replace(s=r.s * (1.0 + 1e-12))
    elif odd == "PXX":
        r = r._replace(PXX=r.PXX.clone().index_fill_(0, torch.tensor([5]), 0.0))
    elif odd == "n":
        r = _shared_states(3, n=119)[1]
    else:
        r = r._replace(s=r.s.float())
    trace.reset("null_fit.")
    with pytest.raises(ValueError, match="do not share s and PXX"):
        treml.fit_null_reml_multi([rots[0], r, rots[2]])
    assert "null_fit.plain" not in trace.counts()


@pytest.mark.parametrize("case", ["n", "p", "lanes", "n_le_p", "dtype", "device", "layout",
                                  "cpu"])
def test_null_reml_brent_rejects_operands_before_any_launch(problem, case):
    """Operands that do not fit together raise before any launch, and so
    do CPU tensors, whose plain fit core.reml.fit_null_reml takes."""
    from janusx_tpu_torch.ops import kernels

    _, rot_t, _ = problem
    s, PXX, PXy, Pyy = _operands(rot_t, 2)
    T, n, p = PXy.shape
    if case == "n":
        s = s[:-1]
    elif case == "p":
        PXX = torch.zeros((n, p * p + 1), dtype=torch.float64)
    elif case == "lanes":
        Pyy = Pyy[:1]
    elif case == "n_le_p":
        s, PXX, PXy, Pyy = s[:p], PXX[:p], PXy[:, :p].contiguous(), Pyy[:, :p].contiguous()
    elif case == "dtype":
        Pyy = Pyy.float()
    elif case == "device":
        PXy = torch.empty(PXy.shape, dtype=torch.float64, device="meta")
    elif case == "layout":
        PXy = torch.zeros((T, n, 2 * p), dtype=torch.float64)[:, :, ::2]
    kernels.reset_launches()
    with pytest.raises(ValueError) as err:
        kernels.null_reml_brent(s, PXX, PXy, Pyy)
    assert ("takes CUDA tensors" in str(err.value)) == (case == "cpu"), err.value
    assert kernels.launch_counts()["null_reml_brent"] == 0


def test_lmm_scan_multi_on_cpu_gives_the_per_trait_nulls():
    """lmm_scan_multi's null fits on the CPU: each trait's plain fit of
    its own rotated state, as before the fits of a step became one call."""
    from janusx_tpu_torch.core.spectral import eigh_grm as t_eigh
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes
    from janusx_tpu_torch.models import lmm
    from janusx_tpu_torch.utils import trace

    rng = np.random.default_rng(21)
    m, n, T = 600, 150, 3
    g = rng.binomial(2, rng.uniform(0.05, 0.5, m)[:, None], size=(m, n)).astype(np.int8)
    site = dict(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                snp=np.array([f"rs{i}" for i in range(m)], object),
                allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    pg = pack_genotypes(GenotypeData(g, SiteInfo(**site), np.array(
        [f"i{j}" for j in range(n)], object)), QcParams())
    gc = pg.centered()
    basis = t_eigh(gc.T @ gc / pg.m, diag_ridge=1e-6)
    Y = 1.0 + gc.T @ rng.normal(0, 0.03, (pg.m, T)) + rng.normal(size=(n, T))
    cov = rng.normal(size=(n, 2))
    trace.reset("null_fit.")
    _, nulls = lmm.lmm_scan_multi(pg, basis, Y, cov, block=256, device="cpu")
    assert trace.counts()["null_fit.plain"] == T
    want = [treml.fit_null_reml_plain(treml.make_rotated(basis, Y[:, t], cov, device="cpu"))
            for t in range(T)]
    assert nulls == want


# ------------------------------------- the design: what no trait changes
class CountingU(np.ndarray):
    """An eigenvector matrix that counts its products with a 2-D right
    operand: the host U'X of a design (U'y, one trait's, is 1-D)."""

    products = 0

    def __array_ufunc__(self, ufunc, method, *inputs, **kw):
        if ufunc is np.matmul and np.ndim(inputs[1]) == 2:
            CountingU.products += 1
        args = [np.asarray(a) if isinstance(a, CountingU) else a for a in inputs]
        return getattr(ufunc, method)(*args, **kw)


def _design_problem(p, T=4, n=120, seed=23):
    """The reference's basis and the port's copy of it, covariates (p - 1
    columns, None at p = 1) and T traits."""
    rng = np.random.default_rng(seed)
    g = rng.binomial(2, 0.3, size=(400, n)).astype(np.float64)
    gc = g - g.mean(axis=1, keepdims=True)
    basis_j = eigh_grm(gc.T @ gc / 400, diag_ridge=1e-6)
    cov = rng.normal(size=(n, p - 1)) if p > 1 else None
    Y = 4.0 + gc[:30].T @ rng.normal(0, 0.2, (30, T)) + rng.normal(size=(n, T))
    return basis_j, interop.basis_from_numpy(basis_j), cov, Y


@pytest.mark.parametrize("p", [1, 3])
def test_traits_of_one_design_share_its_rotation(p):
    """Four traits on one basis and covariates hold the same s, Xr and PXX
    objects, and each state is the reference's make_rotated of its trait."""
    basis_j, basis, cov, Y = _design_problem(p)
    rots = [treml.make_rotated(basis, Y[:, t], cov, device="cpu") for t in range(4)]
    for r in rots[1:]:
        assert r.s is rots[0].s and r.Xr is rots[0].Xr and r.PXX is rots[0].PXX
        assert r.yr is not rots[0].yr and r.PXy is not rots[0].PXy
    for t, rot_t in enumerate(rots):
        rot_j = jreml.make_rotated(basis_j, Y[:, t], cov)
        for f in jreml.RotatedData._fields:
            np.testing.assert_allclose(getattr(rot_t, f).numpy(), np.asarray(getattr(rot_j, f)),
                                       rtol=1e-10, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("p", [1, 3])
def test_traits_of_one_design_share_its_grid_pieces(p):
    """grid_shared of four traits, each with its own grid tensor of the
    same values: the design's fields are one set of objects, the trait's
    are its own, and every field is the reference's grid_shared of that
    trait."""
    G = 256
    basis_j, basis, cov, Y = _design_problem(p)
    rots = [treml.make_rotated(basis, Y[:, t], cov, device="cpu") for t in range(4)]
    shs = [treml.grid_shared(r, treml.make_grid(G, "cpu")) for r in rots]
    for sh in shs[1:]:
        for f in ("w32", "logdetV32", "Axx32", "Ar_inv32", "logdetAr32"):
            assert getattr(sh, f) is getattr(shs[0], f), f
        for f in ("axy32", "ayy32", "Ainv_axy32"):
            assert getattr(sh, f) is not getattr(shs[0], f), f
    grid_j = jnp.asarray(np.linspace(-5, 5, G), jnp.float64)
    for t, sh_t in enumerate(shs):
        sh_j = jreml.grid_shared(jreml.make_rotated(basis_j, Y[:, t], cov), grid_j)
        np.testing.assert_allclose(sh_t.grid_lg.numpy(), np.asarray(sh_j.grid_lg), rtol=1e-10)
        for f in jreml.GridShared._fields[1:]:
            np.testing.assert_allclose(getattr(sh_t, f).numpy(), np.asarray(getattr(sh_j, f)),
                                       rtol=1e-6, atol=1e-30, err_msg=f)


@pytest.mark.parametrize("other", ["equal_covariates", "covariates", "no_covariates",
                                   "basis", "grid"])
def test_a_design_is_found_by_its_basis_covariates_and_grid(other):
    """Covariates equal in content find the design; other covariates, or
    another basis (equal in value), get a new one; another grid, the
    design's rotation but new grid pieces."""
    G = 64
    _, basis, cov, Y = _design_problem(3)
    r0 = treml.make_rotated(basis, Y[:, 0], cov, device="cpu")
    sh0 = treml.grid_shared(r0, treml.make_grid(G, "cpu"))
    if other == "equal_covariates":
        r1 = treml.make_rotated(basis, Y[:, 1], np.asfortranarray(cov), device="cpu")
    elif other == "covariates":
        r1 = treml.make_rotated(basis, Y[:, 1], cov * 2.0, device="cpu")
    elif other == "no_covariates":
        r1 = treml.make_rotated(basis, Y[:, 1], None, device="cpu")
    elif other == "basis":
        twin = treml.SpectralBasis(basis.S.copy(), basis.U.copy())
        r1 = treml.make_rotated(twin, Y[:, 1], cov, device="cpu")
    else:
        r1 = treml.make_rotated(basis, Y[:, 1], cov.copy(), device="cpu")
    sh1 = treml.grid_shared(r1, treml.make_grid(G + (other == "grid"), "cpu"))
    same = other in ("equal_covariates", "grid")
    assert (r1.PXX is r0.PXX) == same and (r1.Xr is r0.Xr) == same
    assert (sh1.w32 is sh0.w32) == (other == "equal_covariates")
    if other == "basis":
        np.testing.assert_allclose(r1.PXX.numpy(), r0.PXX.numpy(), rtol=1e-10, atol=1e-12)


def test_a_design_dies_with_its_basis():
    """The design and its grid pieces are cached on basis.U: once the
    basis is collected, so are they."""
    import gc
    import weakref

    _, basis, cov, Y = _design_problem(3)
    basis = treml.SpectralBasis(basis.S.copy(), basis.U.copy())
    rot = treml.make_rotated(basis, Y[:, 0], cov, device="cpu")
    sh = treml.grid_shared(rot, treml.make_grid(32, "cpu"))
    refs = [weakref.ref(t) for t in (rot.s, rot.PXX, rot.Xr, sh.w32, sh.Ar_inv32)]
    assert treml.make_rotated(basis, Y[:, 1], cov, device="cpu").PXX is rot.PXX
    del basis, rot, sh
    gc.collect()
    assert [r() is None for r in refs] == [True] * 5


@pytest.mark.parametrize("other", ["covariates", "basis"])
def test_fit_null_reml_multi_rejects_states_of_two_designs(other):
    """States of two designs do not share s and PXX: ValueError on the
    CPU too, before any fit."""
    from janusx_tpu_torch.utils import trace

    _, basis, cov, Y = _design_problem(3)
    if other == "covariates":
        b, c = basis, cov[:, ::-1].copy()
    else:
        _, b, _, _ = _design_problem(3, seed=24)
        c = cov
    rots = [treml.make_rotated(basis, Y[:, 0], cov, device="cpu"),
            treml.make_rotated(b, Y[:, 1], c, device="cpu")]
    trace.reset("null_fit.")
    with pytest.raises(ValueError, match="do not share s and PXX"):
        treml.fit_null_reml_multi(rots)
    assert "null_fit.plain" not in trace.counts()


def _lmm_panel(seed=31, m=700, n=150):
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes

    rng = np.random.default_rng(seed)
    g = rng.binomial(2, rng.uniform(0.05, 0.5, m)[:, None], size=(m, n)).astype(np.int8)
    site = dict(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                snp=np.array([f"rs{i}" for i in range(m)], object),
                allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    pg = pack_genotypes(GenotypeData(g, SiteInfo(**site), np.array(
        [f"i{j}" for j in range(n)], object)), QcParams())
    gc = pg.centered()
    Y = 1.0 + gc.T @ rng.normal(0, 0.03, (pg.m, 4)) + rng.normal(size=(n, 4))
    return pg, gc, Y, rng.normal(size=(n, 2))


def test_lmm_scan_multi_rotates_the_covariates_once():
    """T = 4 traits of one step: one host U'X for the step, one state per
    trait on the one design, and the per-trait scans' results."""
    from janusx_tpu_torch.core.spectral import eigh_grm as t_eigh
    from janusx_tpu_torch.models import lmm

    pg, gc, Y, cov = _lmm_panel()
    basis = t_eigh(gc.T @ gc / pg.m, diag_ridge=1e-6)
    counted = treml.SpectralBasis(basis.S, basis.U.view(CountingU))
    CountingU.products = 0
    res, nulls = lmm.lmm_scan_multi(pg, counted, Y, cov, block=256, device="cpu")
    assert CountingU.products == 1
    states = [lmm._scan_state(counted, Y[:, t].copy(), cov, 256, torch.device("cpu"))
              for t in range(4)]
    assert CountingU.products == 1
    assert all(s[0].PXX is states[0][0].PXX and s[2].w32 is states[0][2].w32 for s in states)
    one, null = lmm.lmm_scan(pg, basis, Y[:, 2], cov, block=256, device="cpu")
    np.testing.assert_array_equal(res[2].pwald, one.pwald)
    assert nulls[2] == null


def test_split_w_runs_once_per_design_and_grid(monkeypatch):
    """K2's split W belongs to the design: a second lmm_scan of a new trait
    on the same basis and covariates, and a two-trait step on them, do not
    split it again; another grid does."""
    from janusx_tpu_torch.core.spectral import eigh_grm as t_eigh
    from janusx_tpu_torch.models import lmm
    from janusx_tpu_torch.ops import kernels

    pg, gc, Y, cov = _lmm_panel(seed=32)
    basis = t_eigh(gc.T @ gc / pg.m, diag_ridge=1e-6)
    calls = []
    split = kernels.split_w
    monkeypatch.setattr(kernels, "split_w", lambda W: calls.append(W.shape) or split(W))
    lmm.lmm_scan(pg, basis, Y[:, 0], cov, block=256, device="cpu")
    assert len(calls) == 1
    lmm.lmm_scan(pg, basis, Y[:, 1], cov, block=256, device="cpu")
    lmm.lmm_scan_multi(pg, basis, Y[:, 2:], cov, block=256, device="cpu")
    assert len(calls) == 1
    lmm.lmm_scan(pg, basis, Y[:, 1], cov, block=256, grid_points=128, device="cpu")
    assert calls == [(256, pg.n), (128, pg.n)]
