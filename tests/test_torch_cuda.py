"""The port's CUDA kernels on the card against their plain PyTorch versions.

These need an NVIDIA GPU and nvcc; they skip without a card. The file
imports nothing of JAX, so on a machine with a card but no JAX it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

Bounds: K1 rtol 1e-5 / atol 1e-4 (tests/test_pallas.py:29); K2 the same
finite/inf pattern and finite cells rtol 1e-4 against the plain version
on the same device.
"""

import numpy as np
import pytest
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.io import bitcodec
from janusx_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config.set_full_f32_matmul()
    return torch.device("cuda", 0)


def _block(rng, M, n):
    codes = rng.integers(0, 4, size=(M, n)).astype(np.uint8)
    return bitcodec.pack_codes(codes), rng.uniform(0, 2, M).astype(np.float32)


@pytest.mark.parametrize("M,n,N", [(2048, 1410, 1410), (1000, 997, 997),
                                   (5, 9, 3), (130, 257, 129)])
def test_decode_rotate_kernel_matches_plain(dev, M, n, N):
    rng = np.random.default_rng(M * n)
    packed, mean = _block(rng, M, n)
    pk, mn = torch.from_numpy(packed).to(dev), torch.from_numpy(mean).to(dev)
    U = torch.randn((n, N), generator=torch.Generator().manual_seed(n)).to(dev)
    before = kernels.decode_rotate.launches
    got = kernels.decode_rotate(pk, mn, U)
    want = kernels.decode_rotate_plain(pk, mn, U)
    torch.cuda.synchronize()
    assert kernels.decode_rotate.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def _lattice_args(rng, Gr, G, p, dev):
    """K2 operands for rotated rows Gr (B, n): grid weights of random
    eigenvalues, a design of an intercept + p - 1 covariates, and SH built
    from them as the scan builds it."""
    n = Gr.shape[1]
    s = rng.uniform(0.01, 5.0, n)
    lam = 10.0 ** np.linspace(-5, 5, G)
    w = 1.0 / (s[None, :] + lam[:, None])
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, p - 1))], axis=1)
    y = rng.normal(size=n)
    YX = torch.as_tensor(np.ascontiguousarray(np.concatenate([y[None], X.T])),
                         dtype=torch.float32, device=dev)
    Axx = np.einsum("gk,ka,kb->gab", w, X, X)
    axy = np.einsum("gk,ka,k->ga", w, X, y)
    Ar_inv = np.linalg.inv(Axx + config.GRAM_RIDGE * np.eye(p))
    SH = kernels.pack_sh(*(torch.as_tensor(a, device=dev) for a in (
        Ar_inv, np.einsum("gab,gb->ga", Ar_inv, axy), Axx, axy, w @ (y * y),
        np.linalg.slogdet(Axx + config.GRAM_RIDGE * np.eye(p))[1],
        np.log(s[None, :] + lam[:, None]).sum(1))))
    W = torch.as_tensor(w, dtype=torch.float32, device=dev)
    return (Gr, W, YX, SH, p, config.GRAM_RIDGE, float(n))


def _check_lattice(args):
    got = kernels.grid_neg_reml_lattice(*args)
    want = kernels.grid_neg_reml_lattice_plain(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert fin.float().mean() > 0.5
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("B,G,n", [(2048, 256, 1410), (37, 70, 45)])
def test_grid_lattice_kernel_matches_plain(dev, p, B, G, n):
    rng = np.random.default_rng(p * 1000 + n)
    Gr = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32, device=dev)
    _check_lattice(_lattice_args(rng, Gr, G, p, dev))


def test_kernels_take_rows_beyond_one_grid_axis_of_65535_blocks(dev):
    """SNP rows map to the grid's x axis, so one launch covers a whole
    resident superblock whatever its size (narrow n keeps this small)."""
    rng = np.random.default_rng(7)
    M, n = 65_536 * 128 + 5, 9
    packed, mean = _block(rng, M, n)
    pk, mn = torch.from_numpy(packed).to(dev), torch.from_numpy(mean).to(dev)
    U = torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32, device=dev)
    Gr = kernels.decode_rotate(pk, mn, U)
    torch.testing.assert_close(Gr, kernels.decode_rotate_plain(pk, mn, U),
                               rtol=1e-5, atol=1e-4)
    _check_lattice(_lattice_args(rng, Gr[: 65_536 * 32 + 3], 5, 2, dev))


def test_wrapper_checks_operands(dev):
    pk = torch.zeros((8, 4), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        kernels.decode_rotate(pk, torch.zeros(8, device=dev),
                              torch.zeros((16, 4), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):  # operands on two devices
        kernels.decode_rotate(pk, torch.zeros(8), torch.zeros((16, 4), device=dev))
