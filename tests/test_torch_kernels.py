"""Port parity for the modules that hold the two kernels (ops.kernels):
the plain-PyTorch versions — what the wrappers run on CPU tensors —
against the JAX package's Pallas kernels in interpret mode.

Bounds (the reference's own, tests/test_pallas.py):
- K1 decode+rotate: rtol 1e-5, atol 1e-4 (f32 sums in another order);
  its "high" (bf16x3) mode within matrix-relative 1e-5 of "highest";
- K2 λ-lattice: the same finite/inf pattern, finite cells rtol 1e-4; λ*
  within 2.02 grid spacings with > 50 % identical (near-tie argmin flips
  on flat optima), beta/se at each λ* within rtol 2e-3.
The CUDA kernels themselves are held to the same bounds on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janusx_tpu import config as jconfig
from janusx_tpu.core import reml as jreml
from janusx_tpu.core.spectral import eigh_grm
from janusx_tpu.io import bitcodec
from janusx_tpu.models.lmm import _lattice_operands as j_lattice_operands
from janusx_tpu.ops.pallas_kernels import grid_neg_reml_lattice as j_lattice
from janusx_tpu.ops.pallas_kernels import (decode_rotate_planar, plane_permutation,
                                           rotate_block_pallas)
from janusx_tpu_torch import interop
from janusx_tpu_torch.core import reml as treml
from janusx_tpu_torch.core.spectral import eigh_grm as t_eigh
from janusx_tpu_torch.io.gdata import GenotypeData as TGenotypeData, SiteInfo as TSiteInfo
from janusx_tpu_torch.io.packed import QcParams as TQc, pack_genotypes as t_pack
from janusx_tpu_torch.models.lmm import _lattice_operands as t_lattice_operands
from janusx_tpu_torch.models.lmm import lmm_scan as t_lmm_scan
from janusx_tpu_torch.ops import kernels
from janusx_tpu_torch.ops.decode import decode_centered


@pytest.mark.parametrize("M,n,N", [(100, 301, 64), (300, 160, 200)])
def test_decode_rotate_plain_matches_pallas(M, n, N):
    rng = np.random.default_rng(M + n)
    codes = rng.integers(0, 4, size=(M, n)).astype(np.uint8)
    packed = bitcodec.pack_codes(codes)  # ragged tail -> code 3
    mean = rng.uniform(0, 2, M).astype(np.float32)
    U = rng.normal(size=(n, N)).astype(np.float32)
    Upad = np.zeros((packed.shape[1] * 4, N), np.float32)
    Upad[:n] = U
    ref = np.asarray(rotate_block_pallas(packed, mean, Upad, interpret=True))
    port = kernels.decode_rotate(torch.from_numpy(packed), torch.from_numpy(mean),
                                 torch.from_numpy(U)).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-4)
    x = codes.astype(np.float32) - mean[:, None]
    x[codes == 3] = 0.0
    np.testing.assert_allclose(port, x @ U, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("M,n,N,bk", [(96, 301, 64, 16), (64, 510, 128, 128)])
def test_decode_rotate_high_matches_pallas(M, n, N, bk):
    """prec="high" (the reference's bf16x3) against the JAX kernel's own
    "high" mode in interpret mode (tests/test_pallas.py:113-134), with a
    ragged sample tail: elementwise rtol 1e-5 / atol 1e-4 against it (the
    same products, summed in another order), and matrix-relative 1e-5
    against "highest"."""
    rng = np.random.default_rng(M * n)
    codes = rng.integers(0, 4, size=(M, n)).astype(np.uint8)
    packed = bitcodec.pack_codes(codes)  # ragged tail -> code 3
    mean = rng.uniform(0, 2, M).astype(np.float32)
    U = rng.normal(size=(n, N)).astype(np.float32)
    K = packed.shape[1] * 4
    Upad = np.zeros((K, N), np.float32)
    Upad[:n] = U
    ref = np.asarray(decode_rotate_planar(
        packed, mean[:, None], Upad[plane_permutation(K, bk)], bm=32, bk=bk,
        bn=N, interpret=True, prec="high"))
    args = (torch.from_numpy(packed), torch.from_numpy(mean), torch.from_numpy(U))
    high = kernels.decode_rotate(*args, prec="high").numpy()
    np.testing.assert_allclose(high, ref, rtol=1e-5, atol=1e-4)
    highest = kernels.decode_rotate(*args).numpy()
    assert np.max(np.abs(high - highest)) / np.max(np.abs(highest)) < 1e-5


def test_decode_rotate_rejects_unknown_precision():
    pk = torch.zeros((4, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="prec"):
        kernels.decode_rotate(pk, torch.zeros(4), torch.zeros((8, 8)), prec="tf32")


def test_rows16_pads_packed_rows_with_the_missing_code():
    """K1 reads packed rows 16 bytes at a time: rows of another length get
    a copy padded with 0xFF (code 3, decodes to 0); 16-byte rows pass
    through as they are."""
    rng = np.random.default_rng(5)
    packed = torch.from_numpy(rng.integers(0, 256, size=(7, 353), dtype=np.uint8))
    padded = kernels._rows16(packed)
    assert padded.shape == (7, 368)
    assert torch.equal(padded[:, :353], packed) and bool((padded[:, 353:] == 0xFF).all())
    assert kernels._rows16(padded) is padded
    mean = torch.from_numpy(rng.uniform(0, 2, 7).astype(np.float32))
    U = torch.from_numpy(rng.normal(size=(1410, 16)).astype(np.float32))
    torch.testing.assert_close(kernels.decode_rotate(padded, mean, U),
                               kernels.decode_rotate(packed, mean, U), rtol=0, atol=0)


def test_split_u_pieces_are_exact_bf16_and_zero_padded():
    """K1's B operand: three bf16 pieces per entry, K-major, that sum back
    to U within 2^-22 relative (exactly, in fact), zero past (N, K)."""
    rng = np.random.default_rng(3)
    K, N = 130, 257
    U = (rng.normal(size=(K, N)) * 10.0 ** rng.uniform(-6, 2, size=(K, N)))
    U = torch.from_numpy(U.astype(np.float32))
    S = kernels.split_u(U)
    assert S.dtype == torch.bfloat16 and S.shape == (3, 320, 192)
    pieces = S.to(torch.float32)
    back = (pieces[0] + pieces[1] + pieces[2])[:N, :K].T
    assert torch.all((back - U).abs() <= 2.0 ** -22 * U.abs())
    assert not pieces[:, N:].any() and not pieces[:, :, K:].any()
    # the first two pieces are the reference's hi/lo split of U
    hi, lo = kernels.split_bf16(U, 2)
    torch.testing.assert_close(pieces[0, :N, :K].T, hi, rtol=0, atol=0)
    torch.testing.assert_close(pieces[1, :N, :K].T, lo, rtol=0, atol=0)


def test_lmm_scan_high_precision_matches_highest(monkeypatch):
    """The whole scan with JX_TPU_ROTATE_PREC=high against "highest", on
    the CPU, within the scan bound Δ(-log10 p) 5e-3 (tests/test_scans.py:155)."""
    rng = np.random.default_rng(11)
    m, n = 600, 150
    g = rng.binomial(2, rng.uniform(0.05, 0.5, m)[:, None], size=(m, n)).astype(np.int8)
    g[rng.random((m, n)) < 0.02] = -1
    site = TSiteInfo(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                     snp=np.array([f"rs{i}" for i in range(m)], object),
                     allele0=np.array(["A"] * m, object),
                     allele1=np.array(["G"] * m, object))
    pg = t_pack(TGenotypeData(g, site, np.array([f"i{j}" for j in range(n)], object)),
                TQc())
    gc = decode_centered(torch.from_numpy(pg.packed), torch.from_numpy(
        pg.mean.astype(np.float32)), torch.float64)[:, :n].numpy()
    basis = t_eigh(gc.T @ gc / pg.m, diag_ridge=1e-6)
    y = 3.0 + gc.T @ rng.normal(0, 0.05, pg.m) + rng.normal(size=n)
    res = {}
    for prec in ("highest", "high"):
        monkeypatch.setenv("JX_TPU_ROTATE_PREC", prec)
        res[prec], _ = t_lmm_scan(pg, basis, y, block=256, device="cpu")
    a, b = res["highest"], res["high"]
    np.testing.assert_array_equal(np.isnan(a.pwald), np.isnan(b.pwald))
    ok = np.isfinite(a.pwald)
    assert ok.mean() > 0.9
    assert np.max(np.abs(np.log10(a.pwald[ok]) - np.log10(b.pwald[ok]))) <= 5e-3


@pytest.fixture(scope="module")
def lattice_problem():
    """tests/test_pallas.py:47-58's fixture: n=96, m=256, G=128, p=2."""
    rng = np.random.default_rng(4)
    n, m, G, p_cov = 96, 256, 128, 2
    g = rng.binomial(2, 0.3, size=(m, n)).astype(np.float64)
    gc = g - g.mean(axis=1, keepdims=True)
    K = gc.T @ gc / m
    basis = eigh_grm(K, diag_ridge=1e-6)
    cov = rng.normal(size=(n, p_cov - 1))
    y = rng.normal(size=n) + gc[3] * 0.5
    rot = jreml.make_rotated(basis, y, cov)
    grid_lg = jnp.asarray(np.linspace(-5, 5, G))
    sh = jreml.grid_shared(rot, grid_lg)
    Gr32 = (gc @ basis.U).astype(np.float32)
    return n, rot, sh, Gr32


def test_grid_lattice_plain_matches_pallas(lattice_problem):
    n, rot, sh, Gr32 = lattice_problem
    p, G = rot.p, sh.grid_lg.shape[0]
    N2 = 128
    Wp, YX, SH = j_lattice_operands(sh, rot, n, N2, p)
    GrF = jnp.zeros((Gr32.shape[0], N2), jnp.float32).at[:, :n].set(Gr32)
    neg_ref = np.asarray(j_lattice(
        GrF, Wp, YX, SH, p=p, ridge=float(jconfig.GRAM_RIDGE), nf=float(n),
        bm=128, bg=128, interpret=True))

    rot_t = interop.rotated_from_numpy(rot, device="cpu")
    sh_t = interop.grid_shared_from_numpy(sh, device="cpu")
    W_t, YX_t, SH_t = t_lattice_operands(sh_t, rot_t)
    neg_t = kernels.grid_neg_reml_lattice(
        torch.from_numpy(Gr32), W_t, YX_t, SH_t, p=p,
        ridge=jconfig.GRAM_RIDGE, nf=float(n)).numpy()

    fin = np.isfinite(neg_ref)
    np.testing.assert_array_equal(np.isfinite(neg_t), fin)
    assert np.all(np.isinf(neg_t[~fin]) & (neg_t[~fin] > 0))
    np.testing.assert_allclose(neg_t[fin], neg_ref[fin], rtol=1e-4)

    lg_ref = np.asarray(jreml.argmin_parabolic(jnp.asarray(neg_ref), sh.grid_lg))
    lg_t = treml.argmin_parabolic(torch.from_numpy(neg_t), sh_t.grid_lg).numpy()
    np.testing.assert_allclose(lg_t, lg_ref, atol=2.02 * 10.0 / (G - 1))
    assert np.mean(np.abs(lg_t - lg_ref) < 1e-6) > 0.5
    b_ref, se_ref, _ = jreml.final_stats_f32(rot, jnp.asarray(Gr32),
                                             jnp.asarray(lg_ref), False)
    b_t, se_t, _ = treml.final_stats_f32(rot_t, torch.from_numpy(Gr32),
                                         torch.from_numpy(lg_t), False)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_ref), rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(se_t.numpy(), np.asarray(se_ref), rtol=2e-3, atol=1e-6)


def test_sh_layout_round_trip(lattice_problem):
    """The port's operand packer reproduces the reference's (W, YX, SH)
    exactly from interop-converted state, and unpack_sh inverts pack_sh."""
    n, rot, sh, _ = lattice_problem
    p = rot.p
    Wp, YX, SH = (np.asarray(a) for a in j_lattice_operands(sh, rot, n, 128, p))
    sh_t = interop.grid_shared_from_numpy(sh, device="cpu")
    W_t, YX_t, SH_t = t_lattice_operands(
        sh_t, interop.rotated_from_numpy(rot, device="cpu"))
    assert SH_t.shape == (kernels.sh_rows(p), sh.grid_lg.shape[0])
    np.testing.assert_array_equal(SH_t.numpy(), SH)
    np.testing.assert_array_equal(W_t.numpy(), Wp[:, :n])
    np.testing.assert_array_equal(YX_t.numpy(), YX[:, :n])
    fields = (sh_t.Ar_inv32, sh_t.Ainv_axy32, sh_t.Axx32, sh_t.axy32,
              sh_t.ayy32, sh_t.logdetAr32, sh_t.logdetV32)
    for got, want in zip(kernels.unpack_sh(SH_t, p), fields):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_grid_lattice_rejects_bad_operands(lattice_problem):
    n, rot, sh, Gr32 = lattice_problem
    W, YX, SH = t_lattice_operands(interop.grid_shared_from_numpy(sh, device="cpu"),
                                   interop.rotated_from_numpy(rot, device="cpu"))
    Gr = torch.from_numpy(Gr32)
    with pytest.raises(ValueError, match="p <= 4"):
        kernels.grid_neg_reml_lattice(Gr, W, YX, SH, p=5, ridge=1e-6, nf=n)
    with pytest.raises(ValueError):
        kernels.grid_neg_reml_lattice(Gr, W, YX, SH[:-1], p=rot.p, ridge=1e-6, nf=n)
