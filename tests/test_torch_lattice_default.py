"""K2's one-pass mode (JX_TPU_GRID_MXU_PREC=default, the reference's own
default) on the CPU: the plain version, which rounds the products Gr*Gr,
Gr*y_t, Gr*X_q and the weights W to bf16 before f32 matmuls, against the
reference's Pallas lattice at its default precision in interpret mode, and
against the port's f32 ("highest") lattice; the whole scan in that mode
against the reference's scan; the knob.

The reference's kernel in interpret mode on the CPU multiplies in f32 (XLA's
CPU dot ignores Precision.DEFAULT), so these tests measure what one bf16
pass costs. Bounds are K2's (tests/test_pallas.py:102-110): λ* within 2.02
grid spacings, > 50 % in the same argmin grid cell, beta/se at each λ*
within rtol 2e-3 (beta's absolute floor 2e-3 se, as chip_smoke.py), and the
same finite/inf pattern. On the reference's own fixture (n = 96, a trait
with little polygenic signal) the REML profile is flat, and one bf16 pass
moves λ* along it: 116 of 256 lanes moved more than 2.02 spacings and 28 %
kept their argmin cell, while the f64 -REML at the two λ* agreed within
9.3e-4 and beta/se stayed within 1.7e-3 and 1.7e-4. There λ* is held to
2.02 spacings except where the f64 -REML at both λ* agrees within 2e-3 (a
likelihood ratio of 1.002). On a polygenic trait at the scan's n = 1,410
every K2 bound holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janusx_tpu import config as jconfig
from janusx_tpu.core import reml as jreml
from janusx_tpu.core.spectral import eigh_grm
from janusx_tpu.models.lmm import _lattice_operands as j_lattice_operands
from janusx_tpu.models.lmm import lmm_scan as j_lmm_scan
from janusx_tpu.ops.pallas_kernels import grid_neg_reml_lattice as j_lattice
from janusx_tpu_torch import config, interop
from janusx_tpu_torch.core import reml as treml
from janusx_tpu_torch.models import lmm as tlmm
from janusx_tpu_torch.models.lmm import _lattice_operands as t_lattice_operands
from janusx_tpu_torch.ops import kernels


def _problem(n, m_grm, G, p, polygenic, seed):
    """The reference's lattice fixture (tests/test_pallas.py:47-58) with
    ``polygenic`` False; with it True, a trait with a polygenic component
    on the GRM's SNPs (an interior REML optimum, as real traits have).
    Gr holds the first 256 SNPs' rotated rows."""
    rng = np.random.default_rng(seed)
    if polygenic:
        g = rng.binomial(2, rng.uniform(0.05, 0.5, m_grm)[:, None],
                         size=(m_grm, n)).astype(np.float64)
    else:
        g = rng.binomial(2, 0.3, size=(m_grm, n)).astype(np.float64)
    gc = g - g.mean(axis=1, keepdims=True)
    basis = eigh_grm(gc.T @ gc / m_grm, diag_ridge=1e-6)
    cov = rng.normal(size=(n, p - 1))
    y = (3.0 + gc.T @ rng.normal(0.0, 0.02, m_grm) + rng.normal(size=n) if polygenic
         else rng.normal(size=n) + gc[3] * 0.5)
    rot = jreml.make_rotated(basis, y, cov)
    sh = jreml.grid_shared(rot, jnp.asarray(np.linspace(-5, 5, G)))
    return rot, sh, (gc[:256] @ basis.U).astype(np.float32)


def _reference_default(rot, sh, Gr32):
    n, p = rot.n, rot.p
    N2 = -(-n // 128) * 128
    Wp, YX, SH = j_lattice_operands(sh, rot, n, N2, p)
    GrF = jnp.zeros((Gr32.shape[0], N2), jnp.float32).at[:, :n].set(Gr32)
    return np.asarray(j_lattice(GrF, Wp, YX, SH, p=p, ridge=float(jconfig.GRAM_RIDGE),
                                nf=float(n), prec="default", bm=128, bg=128,
                                interpret=True)).copy()


def _port(rot, sh, Gr32, prec):
    rot_t = interop.rotated_from_numpy(rot, device="cpu")
    sh_t = interop.grid_shared_from_numpy(sh, device="cpu")
    W, YX, SH = t_lattice_operands(sh_t, rot_t)
    neg = kernels.grid_neg_reml_lattice(torch.from_numpy(Gr32), W, YX, SH, p=rot.p,
                                        ridge=jconfig.GRAM_RIDGE, nf=float(rot.n),
                                        prec=prec).numpy()
    return neg, rot_t, sh_t


def _check_k2_bounds(neg, want, rot_t, grid_lg, Gr32, flat_ok: float | None = None):
    """K2's bounds of the lattice ``neg`` against ``want``; with
    ``flat_ok``, λ* may move further where the f64 -REML at both λ* agrees
    within ``flat_ok`` (and the same-cell share is not held)."""
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(neg), fin)
    lg = treml.argmin_parabolic(torch.from_numpy(neg), grid_lg)
    lg_w = treml.argmin_parabolic(torch.from_numpy(want), grid_lg)
    h = float(grid_lg[1] - grid_lg[0])
    far = (lg - lg_w).abs() > 2.02 * h
    if flat_ok is None:
        assert not bool(far.any())
        assert np.mean(neg.argmin(-1) == want.argmin(-1)) > 0.5
    else:
        Gr64 = torch.from_numpy(Gr32.astype(np.float64))
        f = treml.neg_reml_snp_batch(lg.double(), rot_t, Gr64)
        f_w = treml.neg_reml_snp_batch(lg_w.double(), rot_t, Gr64)
        moved = (f - f_w)[far].abs()
        assert moved.numel() == 0 or float(moved.max()) <= flat_ok
    Gr = torch.from_numpy(Gr32)
    b, se, _ = treml.final_stats_f32(rot_t, Gr, lg, False)
    b_w, se_w, _ = treml.final_stats_f32(rot_t, Gr, lg_w, False)
    assert bool(((b - b_w).abs() <= 2e-3 * (se_w + b_w.abs())).all())
    torch.testing.assert_close(se, se_w, rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("case", ["reference_fixture", "polygenic_n1410"])
def test_plain_default_matches_reference_default(case):
    """The plain "default" lattice against the reference's kernel at its own
    default (the fixture of tests/test_torch_kernels.py:151-199, and a
    polygenic trait at n = 1,410), and against the port's "highest"."""
    if case == "reference_fixture":
        rot, sh, Gr32 = _problem(96, 256, 128, 2, polygenic=False, seed=4)
        flat_ok = 2e-3
    else:
        rot, sh, Gr32 = _problem(1410, 3000, 256, 2, polygenic=True, seed=6)
        flat_ok = None
    ref = _reference_default(rot, sh, Gr32)
    neg, rot_t, sh_t = _port(rot, sh, Gr32, "default")
    _check_k2_bounds(neg, ref, rot_t, sh_t.grid_lg, Gr32, flat_ok)
    highest, _, _ = _port(rot, sh, Gr32, "highest")
    _check_k2_bounds(neg, highest, rot_t, sh_t.grid_lg, Gr32, flat_ok)


def test_plain_default_is_highest_where_bf16_is_exact():
    """With integer Gr, y and X (|products| <= 225) and W a power of two,
    every operand is exact in bf16: the two modes' plain versions are the
    same f32 matmuls and agree bit for bit."""
    rng = np.random.default_rng(12)
    B, G, n, p, T = 64, 24, 80, 2, 3
    Gr = torch.from_numpy(rng.integers(-15, 16, size=(B, n)).astype(np.float32))
    W = torch.from_numpy((2.0 ** rng.integers(-12, 4, size=(G, n))).astype(np.float32))
    YX = torch.from_numpy(rng.integers(-15, 16, size=(T + p, n)).astype(np.float32))
    Ar_inv = torch.eye(p).expand(G, p, p) * 1e-3
    SH = torch.stack([kernels.pack_sh(Ar_inv, torch.ones(G, p), torch.eye(p).expand(G, p, p),
                                      torch.ones(G, p), torch.full((G,), 1e6 * (t + 1)),
                                      torch.zeros(G), torch.zeros(G)) for t in range(T)])
    args = (Gr, W, YX, SH, p, config.GRAM_RIDGE, float(n))
    hi = kernels.grid_neg_reml_lattice(*args)
    de = kernels.grid_neg_reml_lattice(*args, prec="default")
    assert torch.isfinite(hi).float().mean() > 0.5
    assert torch.equal(hi, de)
    assert not torch.equal(kernels.grid_neg_reml_lattice(Gr * 1.001, *args[1:]),
                           kernels.grid_neg_reml_lattice(Gr * 1.001, *args[1:],
                                                         prec="default"))


def test_split_w_pieces_sum_to_w_in_the_kernels_sample_order():
    """K2's B operand: three bf16 pieces that sum back to W exactly, G and
    n zero-padded to 32 and 64, each 16-sample step in _LAT_KPERM's order
    (the first piece is W rounded to bf16, what "default" reads)."""
    rng = np.random.default_rng(8)
    G, n = 70, 141
    W = torch.from_numpy((1.0 / (rng.uniform(1e-6, 2.0, (G, n))
                                 + 10.0 ** rng.uniform(-5, 5, (G, 1)))).astype(np.float32))
    S = kernels.split_w(W)
    assert S.dtype == torch.bfloat16 and S.shape == (3, 96, 192)
    inv = np.argsort(kernels._LAT_KPERM)
    pieces = S.to(torch.float32).view(3, 96, 12, 16)[..., inv].reshape(3, 96, 192)
    assert torch.equal(pieces.sum(0)[:G, :n], W)
    assert not pieces[:, G:].any() and not pieces[:, :, n:].any()
    torch.testing.assert_close(pieces[0, :G, :n], W.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def panel():
    """tests/test_torch_lmm.py's panel: n = 200, m = 1,500, four covariates."""
    from janusx_tpu.io.gdata import GenotypeData as JGenotypeData, SiteInfo as JSiteInfo
    from janusx_tpu.io.packed import QcParams as JQc, pack_genotypes as j_pack
    from janusx_tpu.models.grm import grm_from_packed as j_grm
    from janusx_tpu_torch.io.gdata import GenotypeData as TGenotypeData, SiteInfo as TSiteInfo
    from janusx_tpu_torch.io.packed import QcParams as TQc, pack_genotypes as t_pack

    rng = np.random.default_rng(2026)
    m, n = 1500, 200
    g = rng.binomial(2, rng.uniform(0.05, 0.5, m)[:, None], size=(m, n)).astype(np.int8)
    g[rng.random((m, n)) < 0.02] = -1
    site = dict(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                snp=np.array([f"rs{i}" for i in range(m)], object),
                allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    samples = np.array([f"i{j}" for j in range(n)], object)
    pj = j_pack(JGenotypeData(g, JSiteInfo(**site), samples), JQc())
    pt = t_pack(TGenotypeData(g, TSiteInfo(**site), samples), TQc())
    basis = eigh_grm(j_grm(pj), diag_ridge=1e-6)
    h = rng.normal(0, 0.03, pj.m)
    h[[10, 400, 900]] = [0.8, -0.6, 0.7]  # planted QTLs
    y = 3.0 + pj.centered().T @ h + rng.normal(size=n)
    return pj, pt, basis, y, rng.normal(size=(n, 4))


@pytest.mark.parametrize("p", [1, 3])
def test_lmm_scan_default_matches_reference(panel, monkeypatch, p):
    """The whole scan on the CPU with JX_TPU_GRID_MXU_PREC=default against
    the reference's scan: max Δ(-log10 p) <= 0.05 and the same top 5 (the
    port-vs-reference TSV bound, tests/test_golden_mouse.py:57-68; the
    reference measured 0.016 for its one-pass lattice on the mouse data,
    BENCH_NOTES.md:110-120); measured 0.025 at p = 1 and 0.018 at p = 3."""
    pj, pt, basis, y, cov = panel
    c = cov[:, : p - 1] if p > 1 else None
    rj, _ = j_lmm_scan(pj, basis, y, c, block=512)
    monkeypatch.setenv("JX_TPU_GRID_MXU_PREC", "default")
    rt, _ = tlmm.lmm_scan(pt, interop.basis_from_numpy(basis), y, c, block=512,
                          device="cpu")
    np.testing.assert_array_equal(np.isnan(rt.pwald), np.isnan(rj.pwald))
    ok = np.isfinite(rj.pwald)
    assert np.max(np.abs(np.log10(rt.pwald[ok]) - np.log10(rj.pwald[ok]))) <= 0.05
    top = lambda pw: set(np.argsort(np.where(ok, pw, 1.0), kind="stable")[:5])
    assert top(rt.pwald) == top(rj.pwald)


def test_grid_precision_knob(monkeypatch):
    """JX_TPU_GRID_MXU_PREC: highest by default, case-folded, and an
    unknown value raises (as tests/test_env_knobs.py:88-97 holds the
    reference's), in the knob and in the scan that reads it; the wrapper
    refuses an unknown mode."""
    monkeypatch.delenv("JX_TPU_GRID_MXU_PREC", raising=False)
    assert config.choice_knob("JX_TPU_GRID_MXU_PREC", kernels.GRID_PRECS) == "highest"
    monkeypatch.setenv("JX_TPU_GRID_MXU_PREC", "DEFAULT")
    assert config.choice_knob("JX_TPU_GRID_MXU_PREC", kernels.GRID_PRECS) == "default"
    monkeypatch.setenv("JX_TPU_GRID_MXU_PREC", "higest")
    with pytest.raises(ValueError, match="JX_TPU_GRID_MXU_PREC"):
        config.choice_knob("JX_TPU_GRID_MXU_PREC", kernels.GRID_PRECS)
    with pytest.raises(ValueError, match="prec"):
        kernels.grid_neg_reml_lattice(torch.zeros((4, 8)), torch.zeros((3, 8)),
                                      torch.zeros((2, 8)), torch.zeros((7, 3)), p=1,
                                      ridge=1e-6, nf=8.0, prec="tf32")
