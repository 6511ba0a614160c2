"""Port parity of the rest of the LMM family: ``lmm2``, ``method="brent"``
and the multi-trait scan ``lmm_scan_multi``, janusx_tpu_torch against
janusx_tpu on the panel of tests/test_torch_lmm.py (n = 200, m = 1,500).

The reference runs its CPU routes (the XLA grid; the lockstep Brent); the
port runs its lattice route with the kernels' plain versions on CPU
tensors. Bounds, and why:
- pwald: Δ(-log10 p) <= 5e-3 (tests/test_scans.py:155, :229).
- λ*: two f32 lattices that sum in another order pick the same argmin
  cell on most lanes and the parabolic step then moves with the last f32
  bits (ROADMAP queue 3), so λ* is held to 2.02 grid spacings with more
  than half of the lanes within half a spacing (tests/test_pallas.py:
  102-110) — except on lanes where the f64 -REML at both λ* agrees to
  1e-4: there the profile is flat to f32 resolution and any cell of the
  flat stretch is an optimum.
- ml: the reference has no bound. The port's ml is held to the reference's
  f64 ML objective (core/reml.py:ml_snp_batch) at the port's own λ*,
  within 1e-5 relative: the f32 final grams' accuracy at |ml| ~ 300. The
  ML is not stationary at the REML optimum, so ml moves with λ*'s
  jitter: against the reference's ml the bound is 1e-3 where both λ*
  agree to 1e-6, and plrt then within Δ(-log10 p) 5e-3; on every lane
  plrt is in (0, 1] (tests/test_scans.py:117).
- brent: the port's Brent against the reference's, λ* within 1e-4 in
  log10 (Brent's tolerance is 1e-2; both step through the same f64
  objective, whose matmuls sum in another order); beta/se at the port's
  λ* against the reference's f64 beta_se_snp_batch there, rel 1e-5 (the
  f32 rotation, tests/test_scans.py:108); the port's grid against its
  Brent, Δ(-log10 p) <= 5e-3 (tests/test_scans.py:155).
- multi: each trait of lmm_scan_multi equals lmm_scan on that trait
  (bit for bit here; bound 5e-3, tests/test_scans.py:229), and agrees
  with the reference's lmm_scan_multi fed the same per-trait state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janusx_tpu.core import reml as jreml
from janusx_tpu.models import lmm as jlmm
from janusx_tpu_torch import interop
from janusx_tpu_torch.models import lmm as tlmm
from janusx_tpu_torch.ops import kernels

from test_torch_lmm import panel  # noqa: F401  (module fixture)

H = 10.0 / 255  # grid spacing in log10 λ at G = 256


def _dl(a, b):
    return np.abs(np.log10(a) - np.log10(b))


def _cov(cov, p):
    return cov[:, : p - 1] if p > 1 else None


def _f64_objective(pj, basis, y, c, lg):
    """The reference's f64 per-SNP -REML and ML at per-lane log10 λ, on the
    f64 rotation of the panel."""
    rot = jreml.make_rotated(basis, np.asarray(y, float), c)
    Gr = jnp.asarray(pj.centered() @ basis.U)
    lg = jnp.asarray(lg)
    return (np.asarray(jreml.neg_reml_snp_batch(lg, rot, Gr)),
            np.asarray(jreml.ml_snp_batch(lg, rot, Gr)))


@pytest.mark.parametrize("p", [1, 3])
def test_lmm2_matches_reference(panel, p):  # noqa: F811
    pj, pt, basis, y, cov = panel
    c = _cov(cov, p)
    rj, nj = jlmm.lmm_scan(pj, basis, y, c, block=512, lmm2=True)
    rt, nt = tlmm.lmm_scan(pt, interop.basis_from_numpy(basis), y, c, block=512,
                           lmm2=True, device="cpu")
    assert rt.plrt is not None and rt.ml is not None
    assert rt.extras == {"lambda_null": nt.lbd, "ml_null": nt.ml}
    assert nt.ml == pytest.approx(nj.ml, rel=1e-7)  # λ_null to its Brent tolerance
    np.testing.assert_array_equal(np.isnan(rt.beta), np.isnan(rj.beta))
    assert _dl(rt.pwald, rj.pwald).max() <= 5e-3
    # λ*
    lg_j, lg_t = np.log10(rj.lbd), np.log10(rt.lbd)
    d = np.abs(lg_t - lg_j)
    neg_j, _ = _f64_objective(pj, basis, y, c, lg_j)
    neg_t, ml64_t = _f64_objective(pj, basis, y, c, lg_t)
    flat = np.abs(neg_t - neg_j) <= 1e-4
    assert np.all((d <= 2.02 * H) | flat), d[~flat].max()
    assert np.mean(d < 0.5 * H) > 0.5
    # ml against the f64 objective at the port's own λ*, then the reference
    np.testing.assert_allclose(rt.ml, ml64_t, rtol=1e-5)
    same = d < 1e-6
    assert same.mean() > 0.2
    np.testing.assert_allclose(rt.ml[same], rj.ml[same], rtol=0, atol=1e-3)
    assert _dl(rt.plrt[same], rj.plrt[same]).max() <= 5e-3
    assert np.all((rt.plrt > 0) & (rt.plrt <= 1))


@pytest.mark.parametrize("p", [1, 3])
def test_brent_matches_reference_brent(panel, p):  # noqa: F811
    pj, pt, basis, y, cov = panel
    c = _cov(cov, p)
    _, nj = jlmm.lmm_scan(pj, basis, y, c, block=512)
    rj, _ = jlmm.lmm_scan(pj, basis, y, c, block=512, method="brent", lmm2=True, null=nj)
    tb = interop.basis_from_numpy(basis)
    kernels.reset_launches()
    rt, nt = tlmm.lmm_scan(pt, tb, y, c, block=512, method="brent", lmm2=True,
                           null=interop.null_from_numpy(nj), device="cpu")
    assert nt.lbd == nj.lbd
    np.testing.assert_array_equal(np.isnan(rt.beta), np.isnan(rj.beta))
    ok = np.isfinite(rj.beta)
    assert ok.mean() > 0.95
    np.testing.assert_allclose(np.log10(rt.lbd), np.log10(rj.lbd), rtol=0, atol=1e-4)
    assert _dl(rt.pwald, rj.pwald).max() <= 5e-3
    # beta/se at the port's λ* against the reference's f64 formula there
    rot = jreml.make_rotated(basis, np.asarray(y, float), c)
    bj, sj = (np.asarray(a) for a in jreml.beta_se_snp_batch(
        jnp.asarray(np.log10(rt.lbd)), rot, jnp.asarray(pj.centered() @ basis.U)))
    # a beta of ~0 against its standard error gets the floor 1e-5 se
    assert np.all(np.abs(rt.beta[ok] - bj[ok]) <= 1e-5 * (np.abs(bj[ok]) + sj[ok]))
    np.testing.assert_allclose(rt.se[ok], sj[ok], rtol=1e-5)
    np.testing.assert_allclose(rt.ml, rj.ml, rtol=1e-6)
    assert np.all((rt.plrt > 0) & (rt.plrt <= 1))
    # the grid scan against the Brent scan, both the port's
    rg, _ = tlmm.lmm_scan(pt, tb, y, c, block=512, null=nt, device="cpu")
    assert _dl(rg.pwald, rt.pwald).max() <= 5e-3


def test_brent_streams_superblocks(panel):  # noqa: F811
    """Brent over superblock chunks (and a ragged last block) is the
    resident Brent, lane for lane."""
    pj, pt, basis, y, cov = panel
    tb = interop.basis_from_numpy(basis)
    a, null = tlmm.lmm_scan(pt, tb, y, cov[:, :1], block=512, method="brent", device="cpu")
    b, _ = tlmm.lmm_scan(pt, tb, y, cov[:, :1], block=512, method="brent", null=null,
                         superblock=1024, device="cpu")
    np.testing.assert_array_equal(a.pwald, b.pwald)
    with pytest.raises(ValueError, match="unknown lmm scan method"):
        tlmm.lmm_scan(pt, tb, y, method="Grid", device="cpu")


def _traits(pj, y, T, seed=3):
    """T traits on the panel: y and T - 1 more polygenic draws."""
    rng = np.random.default_rng(seed)
    gc = pj.centered()
    Y = [y] + [1.0 + gc.T @ rng.normal(0, 0.04, pj.m) + rng.normal(size=pj.n)
               for _ in range(T - 1)]
    return np.stack(Y, axis=1)


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("p", [1, 3])
def test_multi_matches_single_trait(panel, p, T):  # noqa: F811
    pj, pt, basis, y, cov = panel
    c = _cov(cov, p)
    Y = _traits(pj, y, T)
    tb = interop.basis_from_numpy(basis)
    res, nulls = tlmm.lmm_scan_multi(pt, tb, Y, c, block=512, superblock=1024,
                                     device="cpu")
    assert len(res) == len(nulls) == T
    for t in range(T):
        one, null = tlmm.lmm_scan(pt, tb, Y[:, t], c, block=512, device="cpu")
        assert null == nulls[t]
        np.testing.assert_array_equal(np.isnan(res[t].beta), np.isnan(one.beta))
        assert np.nanmax(_dl(res[t].pwald, one.pwald)) <= 5e-3
        np.testing.assert_array_equal(res[t].pwald, one.pwald)


def test_multi_lmm2_matches_single_trait(panel):  # noqa: F811
    pj, pt, basis, y, cov = panel
    Y = _traits(pj, y, 3)
    tb = interop.basis_from_numpy(basis)
    res, nulls = tlmm.lmm_scan_multi(pt, tb, Y, cov[:, :2], block=512, lmm2=True,
                                     device="cpu")
    for t in range(3):
        one, _ = tlmm.lmm_scan(pt, tb, Y[:, t], cov[:, :2], block=512, lmm2=True,
                               device="cpu")
        for f in ("pwald", "plrt", "lbd", "ml", "beta", "se"):
            np.testing.assert_array_equal(getattr(res[t], f), getattr(one, f))
        assert res[t].extras == {"lambda_null": nulls[t].lbd, "ml_null": nulls[t].ml}


def test_multi_matches_reference_multi_on_its_state(panel):  # noqa: F811
    """The reference's lmm_scan_multi and the port's fed the reference's
    per-trait state (rotations, grid pieces, null fits) carried across by
    interop: the stacked trait axis comes across as per-trait lists."""
    pj, pt, basis, y, cov = panel
    Y = _traits(pj, y, 3)
    c = cov[:, :2]
    states = [jlmm._scan_state(basis, Y[:, t].copy(), c, 256) for t in range(3)]
    nulls = [jreml.fit_null_reml(s[0]) for s in states]
    rj, _ = jlmm.lmm_scan_multi(pj, basis, Y, c, block=512, _prepared=(states, nulls))
    rots = jax.tree.map(lambda *xs: jnp.stack(xs), *[s[0] for s in states])
    shs = jax.tree.map(lambda *xs: jnp.stack(xs), *[s[2] for s in states])
    rots_t = interop.unstack_from_numpy(rots, interop.rotated_from_numpy, "cpu")
    shs_t = interop.unstack_from_numpy(shs, interop.grid_shared_from_numpy, "cpu")
    np.testing.assert_array_equal(rots_t[1].yr.numpy(), np.asarray(states[1][0].yr))
    assert torch.equal(shs_t[2].w32, torch.tensor(np.asarray(states[2][2].w32)))
    nulls_t = [interop.null_from_numpy(nl) for nl in nulls]
    prepared = ([(r, s.grid_lg, s) for r, s in zip(rots_t, shs_t)], nulls_t)
    rt, nt = tlmm.lmm_scan_multi(pt, interop.basis_from_numpy(basis), Y, c, block=512,
                                 _prepared=prepared, device="cpu")
    assert nt == nulls_t
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(np.isnan(a.beta), np.isnan(b.beta))
        assert np.nanmax(_dl(a.pwald, b.pwald)) <= 5e-3


def test_lattice_superblock_counts_the_trait_lattices():
    """~2 GiB / ((N2 + T G) 4) bytes per row: at n = 1,410, G = 256 and
    T = 4 that is 208,896 SNPs of 2048-row blocks."""
    assert tlmm.lattice_superblock(1410, 256, 2048, traits=4) == 208_896
    assert tlmm.lattice_superblock(1410, 256, 2048) == 299_008
    assert tlmm.lattice_superblock(1410, 256, 2048, 1024) == 2048
