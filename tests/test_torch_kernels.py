"""Port parity for the modules that hold the two kernels (ops.kernels):
the plain-PyTorch versions — what the wrappers run on CPU tensors —
against the JAX package's Pallas kernels in interpret mode.

Bounds (the reference's own, tests/test_pallas.py):
- K1 decode+rotate: rtol 1e-5, atol 1e-4 (f32 sums in another order);
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
from janusx_tpu.ops.pallas_kernels import rotate_block_pallas
from janusx_tpu_torch import interop
from janusx_tpu_torch.core import reml as treml
from janusx_tpu_torch.models.lmm import _lattice_operands as t_lattice_operands
from janusx_tpu_torch.ops import kernels


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


def test_decode_rotate_high_precision_not_ported():
    pk = torch.zeros((4, 2), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.decode_rotate(pk, torch.zeros(4), torch.zeros((8, 8)), prec="high")


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
