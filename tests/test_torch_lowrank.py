"""Port parity of ``-lowrank`` (FaST-LMM) and its LD prune:
janusx_tpu_torch.models.fastlmm / ldprune against janusx_tpu's on one
seeded family panel (sibships of 4, 2 % missing genotypes), the port on
the CPU (plain torch; K1's plain version for the ``add`` rotation).

Bounds: the basis, the rotated design, the null fit and the switch test
are host f64 copies of the reference's (rtol 1e-12). The scan: for all
four genetic models λ* within 2.02 grid spacings except on lanes where
the f64 −REML at both λ* agrees within 1e-4 (the lmm2 bound of
tests/test_torch_lmm_family.py: there the profile is flat to f32
resolution), and Δ(−log10 p) ≤ 5e-3 (tests/test_scans.py:155). The ``add``
rotation goes through K1 (ops.kernels.decode_rotate): within K1's bound
(rtol 1e-5, atol 1e-4; tests/test_pallas.py:29) of the reference's
decode-then-matmul. The LD prune keeps the reference's SNPs exactly.
"""

import math

import numpy as np
import pytest
import torch

from janusx_tpu.io.gdata import GenotypeData as JGenotypeData, SiteInfo as JSiteInfo
from janusx_tpu.io.packed import QcParams as JQc, pack_genotypes as j_pack
from janusx_tpu.models import fastlmm as jfl
from janusx_tpu.models import ldprune as jld
from janusx_tpu_torch.io.gdata import GenotypeData as TGenotypeData, SiteInfo as TSiteInfo
from janusx_tpu_torch.io.packed import QcParams as TQc, pack_genotypes as t_pack
from janusx_tpu_torch.models import fastlmm as tfl
from janusx_tpu_torch.models import ldprune as tld
from janusx_tpu_torch.ops import decode, kernels

H = 10.0 / 255  # grid spacing in log10 λ at G = 256


@pytest.fixture(scope="module")
def family_panel():
    """240 samples in 60 sibships of 4 (two unrelated parents each, a
    recombination every 50 SNPs), 1,500 SNPs, 2 % missing; a trait with a
    polygenic background, three QTLs and a shift of 3, and four
    covariates. Returns (reference packed, port packed, y, cov)."""
    rng = np.random.default_rng(2027)
    fams, kids, m = 60, 4, 1500
    n = fams * kids
    fam = np.repeat(np.arange(fams), kids)
    p = rng.uniform(0.05, 0.5, m)
    haps = (rng.random((m, 4 * fams)) < p[:, None]).astype(np.int8)
    g = np.empty((m, n), np.int8)
    for r0 in range(0, m, 50):
        pat = 4 * fam + rng.integers(0, 2, n)
        mat = 4 * fam + 2 + rng.integers(0, 2, n)
        g[r0:r0 + 50] = haps[r0:r0 + 50, pat] + haps[r0:r0 + 50, mat]
    g[rng.random((m, n)) < 0.02] = -1
    site = dict(chrom=np.array(["1"] * (m // 2) + ["2"] * (m - m // 2), object),
                pos=np.arange(1, m + 1) * 1000,
                snp=np.array([f"rs{i}" for i in range(m)], object),
                allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    samples = np.array([f"i{j}" for j in range(n)], object)
    pj = j_pack(JGenotypeData(g, JSiteInfo(**site), samples), JQc())
    pt = t_pack(TGenotypeData(g, TSiteInfo(**site), samples), TQc())
    gc = pj.centered()
    h = rng.normal(0, 0.05, pj.m)
    h[[30, 700, 1200]] = [0.9, -0.8, 0.7]
    y = 3.0 + gc.T @ h + rng.normal(size=n)
    return pj, pt, y, rng.normal(size=(n, 4))


@pytest.fixture(scope="module")
def bases(family_panel):
    pj, pt = family_panel[:2]
    return (jfl.lowrank_basis_from_snps(pj, q=120),
            tfl.lowrank_basis_from_snps(pt, q=120, device="cpu"))


def test_basis_rotation_and_null_match_reference(family_panel, bases):
    pj, pt, y, cov = family_panel
    lj, lt = bases
    assert lt.k == lj.k and lt.n == lj.n and lt.k < pt.n
    np.testing.assert_array_equal(lt.snp_idx, lj.snp_idx)
    np.testing.assert_allclose(lt.S, lj.S, rtol=1e-12)
    np.testing.assert_allclose(np.abs(lt.U), np.abs(lj.U), rtol=1e-10, atol=1e-12)
    for c in (None, cov[:, :2]):
        rj, rt = jfl.make_rotated_lr(lj, y, c), tfl.make_rotated_lr(lt, y, c)
        nj, bj, vj = jfl.fit_null_reml_lr(rj)
        nt, bt, vt = tfl.fit_null_reml_lr(rt)
        assert abs(nt.log10_lbd - nj.log10_lbd) <= 1e-6  # the null Brent's tolerance
        assert nt.reml == pytest.approx(nj.reml, rel=1e-10)
        assert nt.ml == pytest.approx(nj.ml, rel=1e-10)
        assert vt == pytest.approx(vj, rel=1e-6)
        pj_, _ = jfl.lowrank_switch_p(rj)
        pt_, null_t = tfl.lowrank_switch_p(rt)
        assert pt_ == pytest.approx(pj_, rel=1e-6) and pt_ < 0.05
        assert null_t.lbd == nt.lbd


def test_switch_p_of_a_trait_without_kinship_signal(family_panel, bases):
    pj, pt, _, _ = family_panel
    lj, lt = bases
    flat = np.random.default_rng(4).normal(size=pt.n)
    pj_, _ = jfl.lowrank_switch_p(jfl.make_rotated_lr(lj, flat, None))
    pt_, _ = tfl.lowrank_switch_p(tfl.make_rotated_lr(lt, flat, None))
    assert pt_ == pytest.approx(pj_, rel=1e-6) and pt_ >= 0.05


def _f64_neg_reml(rot, G, lg):
    """The low-rank per-SNP -REML in f64 at per-lane log10 λ, G = (rows
    (B, n), their rotation (B, k)): the design
    [X, g] with the rotated part over the k eigenvalues and the raw-minus-
    rotated complement at weight 1/(ridge + λ)."""
    n, p1 = rot.n, rot.p + 1
    out = []
    for g, gr, l10 in zip(*G, lg):
        lbd = 10.0 ** l10
        w, w0 = 1.0 / (rot.S + lbd), 1.0 / (rot.ridge + lbd)
        Xr = np.concatenate([rot.Xr, gr[:, None]], axis=1)
        Xf = np.concatenate([rot.X, g[:, None]], axis=1)
        M = (Xr * w[:, None]).T @ Xr + w0 * (Xf.T @ Xf - Xr.T @ Xr)
        rhs = Xr.T @ (w * rot.yr) + w0 * (Xf.T @ rot.y - Xr.T @ rot.yr)
        ayy = (w * rot.yr) @ rot.yr + w0 * rot.cyy
        A = M + 1e-6 * np.eye(p1)
        beta = np.linalg.solve(A, rhs)
        rtwr = ayy - 2 * beta @ rhs + beta @ M @ beta
        logdetV = np.sum(np.log(rot.S + lbd)) + (n - rot.k) * math.log(rot.ridge + lbd)
        c = (n - p1) * (math.log(n - p1) - 1.0 - math.log(2.0 * math.pi)) / 2.0
        out.append(-(c - 0.5 * ((n - p1) * math.log(rtwr) + logdetV
                                + np.linalg.slogdet(A)[1])))
    return np.array(out)


@pytest.mark.parametrize("model", tfl.GENETIC_MODELS)
@pytest.mark.parametrize("ncov", [0, 2])
def test_fastlmm_scan_matches_reference(family_panel, bases, model, ncov):
    pj, pt, y, cov = family_panel
    lj, lt = bases
    c = cov[:, :ncov] if ncov else None
    rj, nj = jfl.fastlmm_scan(pj, lj, y, c, block=256, model=model, lmm2=True)
    kernels.reset_launches()
    rt, nt = tfl.fastlmm_scan(pt, lt, y, c, block=256, model=model, lmm2=True,
                              superblock=512, device="cpu")
    assert kernels.launch_counts()["decode_rotate"] == 0  # CPU tensors: the plain version
    assert abs(nt.log10_lbd - nj.log10_lbd) <= 1e-6
    assert rt.extras == {"lambda_null": nt.lbd, "ml_null": nt.ml, "rank": lt.k}
    assert rt.m == rj.m == pt.m
    np.testing.assert_array_equal(np.isnan(rt.beta), np.isnan(rj.beta))
    assert np.isfinite(rt.pwald).all()
    dl = np.abs(np.log10(rt.pwald) - np.log10(rj.pwald))
    assert dl.max() <= 5e-3, dl.max()
    lg_j, lg_t = np.log10(rj.lbd), np.log10(rt.lbd)
    far = np.nonzero(np.abs(lg_t - lg_j) > 2.02 * H)[0]
    if far.size:
        rot = tfl.make_rotated_lr(lt, y, c)
        pk = torch.from_numpy(decode.pad_packed_cols(pt.packed[far], 4))
        G = tfl._decode_transformed_centered(pk, pt.n, model).double().numpy()
        Gs = (G, G @ lt.U)
        assert np.all(np.abs(_f64_neg_reml(rot, Gs, lg_t[far])
                             - _f64_neg_reml(rot, Gs, lg_j[far])) <= 1e-4)
    assert np.mean(np.abs(lg_t - lg_j) < 0.5 * H) > 0.5


def test_fastlmm_wald_route_matches_lmm2_columns(family_panel, bases):
    """lmm2=False gives the lmm2 scan's beta/se/pwald and no LRT columns."""
    pj, pt, y, cov = family_panel
    lt = bases[1]
    r2, _ = tfl.fastlmm_scan(pt, lt, y, cov[:, :1], lmm2=True, device="cpu")
    r1, n1 = tfl.fastlmm_scan(pt, lt, y, cov[:, :1], device="cpu")
    assert r1.plrt is None and r1.extras == {"lambda_null": n1.lbd, "rank": lt.k}
    np.testing.assert_array_equal(r1.beta, r2.beta)
    np.testing.assert_array_equal(r1.pwald, r2.pwald)
    with pytest.raises(ValueError, match="genetic model"):
        tfl.fastlmm_scan(pt, lt, y, model="codominant", device="cpu")


def test_add_rotation_through_k1_matches_reference_decode(family_panel, bases):
    """The premise of the ``add`` route: with missing genotypes, K1 at
    N = k with the observed-code mean (what the scan passes) is within K1's
    bound of the reference's transformed-centered decode @ Uk; the QC
    mean pg.mean centers as the reference's f32 mean does; and the torch
    transformed decode equals the reference's bit for bit in every model."""
    import jax.numpy as jnp

    pj, pt = family_panel[:2]
    lt = bases[1]
    packed = decode.pad_packed_cols(pt.packed, 4)
    assert (pt.miss > 0).mean() > 0.9
    pk = torch.from_numpy(packed)
    for model in tfl.GENETIC_MODELS:
        want = np.asarray(jfl._decode_transformed_centered(jnp.asarray(packed), pt.n, model))
        got = tfl._decode_transformed_centered(pk, pt.n, model).numpy()
        np.testing.assert_array_equal(got, want)
    ref_add = np.asarray(jfl._decode_transformed_centered(jnp.asarray(packed), pt.n, "add"))
    tm = tfl._transformed(pk, pt.n, "add")[2][:, 0]
    Uk = torch.as_tensor(lt.U, dtype=torch.float32)
    Gr = kernels.decode_rotate(pk, tm, Uk, U_split=kernels.split_u(Uk))
    assert Gr.shape == (pt.m, lt.k) and lt.k % 64
    np.testing.assert_allclose(Gr.numpy(), ref_add @ lt.U.astype(np.float32),
                               rtol=1e-5, atol=1e-4)
    qc_mean = decode.decode_centered(pk, torch.as_tensor(pt.mean, dtype=torch.float32))
    np.testing.assert_allclose(qc_mean[:, :pt.n].numpy(), ref_add, rtol=1e-5, atol=1e-4)


def test_ld_prune_keeps_the_reference_snps(family_panel):
    """-lowrank-prune's picks, both r² routes (pairwise-complete with
    missing calls, Pearson without) and a physical window."""
    pj, pt = family_panel[:2]
    np.testing.assert_array_equal(tld.ld_prune(pt, device="cpu"), jld.ld_prune(pj))
    np.testing.assert_array_equal(tld.ld_prune(pt, window_bp=40_000, chunk=300, device="cpu"),
                                  jld.ld_prune(pj, window_bp=40_000, chunk=300))
    full = np.nonzero(pt.miss == 0)[0]
    assert 5 < full.size
    sub_j, sub_t = pj.take_snps(full), pt.take_snps(full)
    np.testing.assert_allclose(tld.r2_matrix(sub_t, device="cpu"), jld.r2_matrix(sub_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tld.r2_matrix(pt.take_snps(np.arange(200)), device="cpu"),
                               jld.r2_matrix(pj.take_snps(np.arange(200))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tfl.select_kinship_snps_ld(pt, 48, device="cpu"),
                                  jfl.select_kinship_snps_ld(pj, 48))
    lj = jfl.lowrank_basis_from_snps(pj, q=48, ld_prune=True)
    lt = tfl.lowrank_basis_from_snps(pt, q=48, ld_prune=True, device="cpu")
    np.testing.assert_array_equal(lt.snp_idx, lj.snp_idx)
    np.testing.assert_allclose(lt.S, lj.S, rtol=1e-12)


def test_ld_clump_matches_reference(family_panel):
    pj, pt, y, _ = family_panel
    rng = np.random.default_rng(3)
    pv = rng.uniform(size=pt.m) ** 4
    args = (np.asarray(pt.sites.chrom), np.asarray(pt.sites.pos), pv, 1e-2)
    assert tld.ld_clump(pt, *args, window_bp=20_000) == jld.ld_clump(pj, *args,
                                                                    window_bp=20_000)


# ------------------------------------- the design: what no trait changes
_LR_DESIGN = ("S", "Xr", "PXX", "cXX", "X")
_LR_GRID_DESIGN = ("grid_lg", "w32", "Axx32", "Ar_inv32", "logdetAr32")


def _design_traits(family_panel, bases, T=4):
    """The port's basis, the reference's LowRankBasis of the same arrays
    (an SVD's signs aside), two covariates and T traits."""
    _, pt, y, cov = family_panel
    lt = bases[1]
    lj = jfl.LowRankBasis(U=lt.U, S=lt.S, n=lt.n, ridge=lt.ridge)
    rng = np.random.default_rng(8)
    Y = y[:, None] + rng.normal(0.0, 0.5, (pt.n, T)) * np.arange(T)
    return lt, lj, cov[:, :2], Y


def test_traits_of_one_design_share_the_lowrank_rotation(family_panel, bases):
    """Four traits hold the same S, Xr, PXX, cXX and X arrays, and each
    RotatedLR is the reference's make_rotated_lr of its trait."""
    lt, lj, c, Y = _design_traits(family_panel, bases)
    rots = [tfl.make_rotated_lr(lt, Y[:, t], c) for t in range(4)]
    for r in rots[1:]:
        assert all(getattr(r, f) is getattr(rots[0], f) for f in _LR_DESIGN)
        assert r.yr is not rots[0].yr and r.cXy is not rots[0].cXy
    for t, rt in enumerate(rots):
        rj = jfl.make_rotated_lr(lj, Y[:, t], c)
        for f in tfl.RotatedLR._fields:
            np.testing.assert_allclose(np.asarray(getattr(rt, f)), np.asarray(getattr(rj, f)),
                                       rtol=1e-12, atol=1e-12, err_msg=f)


def test_traits_of_one_design_share_the_lowrank_grid_and_constants(family_panel, bases):
    """_grid_shared_lr and _lr_consts of four traits: the design's fields
    are one set of objects; every field is what a state of a design not
    yet seen gets, bit for bit; the design's grid pieces and every constant
    are the reference's, and y's side is the reference's scaled by ysc."""
    lt, lj, c, Y = _design_traits(family_panel, bases)
    grid = np.linspace(-5.0, 5.0, 256)
    Uk = torch.as_tensor(lt.U, dtype=torch.float32)
    rots = [tfl.make_rotated_lr(lt, Y[:, t], c) for t in range(4)]
    outs = [(tfl._grid_shared_lr(r, grid, "cpu"), tfl._lr_consts(r, Uk, "cpu")) for r in rots]
    (sh0, _), cs0 = outs[0]
    for (sh, ysc), cs in outs[1:]:
        assert all(getattr(sh, f) is getattr(sh0, f) for f in _LR_GRID_DESIGN)
        assert sh.axy32 is not sh0.axy32 and sh.logdetV32 is not sh0.logdetV32
        assert all(getattr(cs, f) is getattr(cs0, f) for f in ("X", "Xr", "S64", "PXX64",
                                                              "cXX64"))
        assert cs.yr is not cs0.yr
    for t, (rot, ((sh, ysc), cs)) in enumerate(zip(rots, outs)):
        # another design's arrays, equal in value
        alone = rot._replace(PXX=rot.PXX.copy(), X=rot.X.copy())
        (sh1, ysc1), cs1 = tfl._grid_shared_lr(alone, grid, "cpu"), tfl._lr_consts(alone, Uk,
                                                                                    "cpu")
        assert sh1.w32 is not sh.w32 and cs1.PXX64 is not cs.PXX64
        assert torch.equal(ysc1, ysc) and all(torch.equal(a, b) for a, b in zip(sh1, sh))
        assert all(torch.equal(a, b) if torch.is_tensor(a) else a == b for a, b in zip(cs1, cs))
        rj = jfl.make_rotated_lr(lj, Y[:, t], c)
        shj, csj = jfl._grid_shared_lr(rj, grid), jfl._lr_consts(rj)
        for f in _LR_GRID_DESIGN:
            np.testing.assert_allclose(getattr(sh, f).numpy(), np.asarray(getattr(shj, f)),
                                       rtol=1e-6, err_msg=f)
        ys = ysc.double().numpy()
        for f in ("axy32", "Ainv_axy32"):
            np.testing.assert_allclose(getattr(sh, f).numpy(),
                                       np.asarray(getattr(shj, f)) * ys[:, None], rtol=1e-6)
        np.testing.assert_allclose(ys, np.asarray(shj.ayy32, np.float64) ** -0.5, rtol=1e-6)
        for f in tfl._LrConsts._fields[1:]:
            np.testing.assert_allclose(np.asarray(getattr(cs, f)), np.asarray(getattr(csj, f)),
                                       rtol=1e-12, err_msg=f)


@pytest.mark.parametrize("other", ["equal_covariates", "covariates", "basis", "grid"])
def test_a_lowrank_design_is_found_by_its_basis_covariates_and_grid(family_panel, bases,
                                                                   other):
    """Covariates equal in content find the design; other covariates or
    another basis get a new one; another grid, the design's rotation but new
    grid pieces. Two traits on one design: one host U'X."""
    from tests.test_torch_reml import CountingU

    lt, _, c, Y = _design_traits(family_panel, bases, T=2)
    lt = lt._replace(U=lt.U.copy().view(CountingU))
    CountingU.products = 0
    r0 = tfl.make_rotated_lr(lt, Y[:, 0], c)
    sh0, _ = tfl._grid_shared_lr(r0, np.linspace(-5.0, 5.0, 64), "cpu")
    lrb, cov, G = lt, np.asfortranarray(c), 64
    if other == "covariates":
        cov = c[:, ::-1]
    elif other == "basis":
        lrb = lt._replace(U=np.array(lt.U).view(CountingU))
    elif other == "grid":
        G = 65
    r1 = tfl.make_rotated_lr(lrb, Y[:, 1], cov)
    sh1, _ = tfl._grid_shared_lr(r1, np.linspace(-5.0, 5.0, G), "cpu")
    same = other in ("equal_covariates", "grid")
    assert CountingU.products == (1 if same else 2)
    assert all((getattr(r1, f) is getattr(r0, f)) == same for f in _LR_DESIGN[1:])
    assert (sh1.w32 is sh0.w32) == (other == "equal_covariates")


def test_a_lowrank_design_dies_with_its_basis(family_panel, bases):
    import gc
    import weakref

    lt, _, c, Y = _design_traits(family_panel, bases, T=2)
    lrb = lt._replace(U=lt.U.copy())
    rot = tfl.make_rotated_lr(lrb, Y[:, 0], c)
    sh, _ = tfl._grid_shared_lr(rot, np.linspace(-5.0, 5.0, 32), "cpu")
    cs = tfl._lr_consts(rot, torch.as_tensor(lrb.U, dtype=torch.float32), "cpu")
    refs = [weakref.ref(a) for a in (rot.PXX, rot.cXX, sh.w32, cs.PXX64)]
    assert tfl.make_rotated_lr(lrb, Y[:, 1], c).PXX is rot.PXX
    del lrb, rot, sh, cs
    gc.collect()
    assert [r() is None for r in refs] == [True] * 4
