"""K2's trait axis on the CPU: the plain version of the (T, B, G) lattice
against the reference's per-trait kernel calls (janusx_tpu/models/lmm.py:
578-591, the Pallas lattice in interpret mode once per trait), and against
T single-trait calls of the port, which it must equal exactly.

Fixture: tests/test_pallas.py:47-58's (n = 96, m = 256, G = 128), with T
traits sharing the basis, the covariates and the grid. Bounds are K2's
(tests/test_pallas.py): the same finite/inf pattern, finite cells rtol
1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janusx_tpu import config as jconfig
from janusx_tpu.core import reml as jreml
from janusx_tpu.core.spectral import eigh_grm
from janusx_tpu.models.lmm import _lattice_operands as j_lattice_operands
from janusx_tpu.ops.pallas_kernels import grid_neg_reml_lattice as j_lattice
from janusx_tpu_torch import interop
from janusx_tpu_torch.models.lmm import _lattice_operands, _lattice_operands_multi
from janusx_tpu_torch.ops import kernels

N, M, G = 96, 256, 128


def _problem(p: int, T: int):
    rng = np.random.default_rng(40 + 10 * p + T)
    g = rng.binomial(2, 0.3, size=(M, N)).astype(np.float64)
    gc = g - g.mean(axis=1, keepdims=True)
    basis = eigh_grm(gc.T @ gc / M, diag_ridge=1e-6)
    cov = rng.normal(size=(N, p - 1)) if p > 1 else None
    grid = jnp.asarray(np.linspace(-5, 5, G))
    rots, shs = [], []
    for t in range(T):
        y = rng.normal(size=N) + gc[3 + t] * 0.5
        rots.append(jreml.make_rotated(basis, y, cov))
        shs.append(jreml.grid_shared(rots[-1], grid))
    return rots, shs, (gc @ basis.U).astype(np.float32)


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("p", [1, 3])
def test_trait_axis_plain_matches_reference_per_trait(p, T):
    rots, shs, Gr32 = _problem(p, T)
    rots_t = [interop.rotated_from_numpy(r, device="cpu") for r in rots]
    shs_t = [interop.grid_shared_from_numpy(s, device="cpu") for s in shs]
    W, YX, SH = _lattice_operands_multi(shs_t, rots_t)
    assert YX.shape == (T + p, N) and SH.shape == (T, kernels.sh_rows(p), G)
    Gr = torch.from_numpy(Gr32)
    neg = kernels.grid_neg_reml_lattice(Gr, W, YX, SH, p=p, ridge=jconfig.GRAM_RIDGE,
                                        nf=float(N)).numpy()
    assert neg.shape == (T, M, G)
    GrF = jnp.zeros((M, 128), jnp.float32).at[:, :N].set(Gr32)
    for t in range(T):
        Wp, YXj, SHj = j_lattice_operands(shs[t], rots[t], N, 128, p)
        ref = np.asarray(j_lattice(GrF, Wp, YXj, SHj, p=p, ridge=float(jconfig.GRAM_RIDGE),
                                   nf=float(N), bm=128, bg=128, interpret=True))
        fin = np.isfinite(ref)
        np.testing.assert_array_equal(np.isfinite(neg[t]), fin)
        np.testing.assert_allclose(neg[t][fin], ref[fin], rtol=1e-4)
        # exactly the single-trait call on this trait's operands
        W1, YX1, SH1 = _lattice_operands(shs_t[t], rots_t[t])
        one = kernels.grid_neg_reml_lattice(Gr, W1, YX1, SH1, p=p,
                                            ridge=jconfig.GRAM_RIDGE, nf=float(N))
        assert torch.equal(torch.from_numpy(neg[t]), one)
        assert torch.equal(W, W1) and torch.equal(YX[T:], YX1[1:])


def test_trait_axis_rejects_mismatched_operands():
    rots, shs, Gr32 = _problem(2, 3)
    W, YX, SH = _lattice_operands_multi(
        [interop.grid_shared_from_numpy(s, device="cpu") for s in shs],
        [interop.rotated_from_numpy(r, device="cpu") for r in rots])
    Gr = torch.from_numpy(Gr32)
    for bad in ((W, YX[1:], SH), (W, YX, SH[:, :-1]), (W, YX, SH[None])):
        with pytest.raises(ValueError):
            kernels.grid_neg_reml_lattice(Gr, *bad, p=2, ridge=1e-6, nf=float(N))
