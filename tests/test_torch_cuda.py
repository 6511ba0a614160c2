"""The port's CUDA kernels on the card against their plain PyTorch versions.

These need an NVIDIA GPU and nvcc; they skip without a card. The file
imports nothing of JAX, so on a machine with a card but no JAX it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

Bounds: K1 rtol 1e-5 / atol 1e-4 (tests/test_pallas.py:29) in each mode
against its own plain version, "high" also within matrix-relative 1e-5 of
"highest" (tests/test_pallas.py:134); K2 the same
finite/inf pattern and finite cells rtol 1e-4 against the plain version
on the same device.
"""

import numpy as np
import pytest
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.io import bitcodec
from janusx_tpu_torch.ops import decode, kernels

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


_PLAIN = {"highest": kernels.decode_rotate_plain,
          "high": kernels.decode_rotate_high_plain}


def _operands(dev, M, n, N, align16, scale):
    """Packed rows at the packed stride ceil(n/4) (353 bytes at n = 1,410:
    not a multiple of 16) or padded to 16 bytes as the scan lays them out,
    and U = randn * scale."""
    rng = np.random.default_rng(M * n)
    packed, mean = _block(rng, M, n)
    if align16:
        packed = decode.pad_packed_cols(packed, 64)
    pk, mn = torch.from_numpy(packed).to(dev), torch.from_numpy(mean).to(dev)
    U = torch.randn((n, N), generator=torch.Generator().manual_seed(n)) * scale
    return pk, mn, U.to(dev)


@pytest.mark.parametrize("prec", ["highest", "high"])
@pytest.mark.parametrize("M,n,N,align16", [
    (2048, 1410, 1410, False), (2048, 1410, 1410, True), (1000, 997, 997, False),
    (5, 9, 3, False), (130, 257, 129, False)])
def test_decode_rotate_kernel_matches_plain(dev, prec, M, n, N, align16):
    """Each mode against its own plain version. U has columns of unit
    expected norm, as the eigenbasis the scan rotates by: at |U| ~ 1 and
    n = 1,410 the f32 plain version is itself 3.0e-4 from the exact
    product (H100), beyond the bound (see the f64 test below)."""
    pk, mn, U = _operands(dev, M, n, N, align16, n ** -0.5)
    before = kernels.decode_rotate.launches
    got = kernels.decode_rotate(pk, mn, U, prec=prec)
    want = _PLAIN[prec](pk, mn, U)
    torch.cuda.synchronize()
    assert kernels.decode_rotate.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    if prec == "high":
        highest = kernels.decode_rotate(pk, mn, U)
        assert float((got - highest).abs().max() / highest.abs().max()) < 1e-5


@pytest.mark.parametrize("align16", [False, True])
def test_decode_rotate_highest_is_f32_accurate(dev, align16):
    """At |U| ~ 1, n = 1,410, "highest" within rtol 1e-5 / atol 1e-4 of the
    exact (f64) product of the same decoded operand."""
    pk, mn, U = _operands(dev, 2048, 1410, 1410, align16, 1.0)
    got = kernels.decode_rotate(pk, mn, U)
    exact = decode.decode_centered(pk, mn, torch.float64)[:, :1410] @ U.double()
    torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=1e-4)


def _lattice_args(rng, Gr, G, p, dev, T=None):
    """K2 operands for rotated rows Gr (B, n): grid weights of random
    eigenvalues, a design of an intercept + p - 1 covariates, and SH built
    from them as the scan builds it. With ``T`` traits share the weights
    and the design: YX is (T + p, n) and SH (T, R, G)."""
    n = Gr.shape[1]
    s = rng.uniform(0.01, 5.0, n)
    lam = 10.0 ** np.linspace(-5, 5, G)
    w = 1.0 / (s[None, :] + lam[:, None])
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, p - 1))], axis=1)
    ys = rng.normal(size=(1 if T is None else T, n))
    YX = torch.as_tensor(np.ascontiguousarray(np.concatenate([ys, X.T])),
                         dtype=torch.float32, device=dev)
    Axx = np.einsum("gk,ka,kb->gab", w, X, X)
    Ar_inv = np.linalg.inv(Axx + config.GRAM_RIDGE * np.eye(p))
    SHs = []
    for y in ys:
        axy = np.einsum("gk,ka,k->ga", w, X, y)
        SHs.append(kernels.pack_sh(*(torch.as_tensor(a, device=dev) for a in (
            Ar_inv, np.einsum("gab,gb->ga", Ar_inv, axy), Axx, axy, w @ (y * y),
            np.linalg.slogdet(Axx + config.GRAM_RIDGE * np.eye(p))[1],
            np.log(s[None, :] + lam[:, None]).sum(1)))))
    SH = SHs[0] if T is None else torch.stack(SHs).contiguous()
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


@pytest.mark.parametrize("T", [1, 3, 4, 6])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("B,G,n", [(2048, 256, 1410), (37, 70, 45)])
def test_grid_lattice_trait_axis_matches_plain(dev, p, T, B, G, n):
    """The trait axis (T traits in one launch; 6 spans two trait chunks)
    against the plain version, the reference's loop over traits."""
    rng = np.random.default_rng(p * 1000 + n + 17 * T)
    Gr = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32, device=dev)
    args = _lattice_args(rng, Gr, G, p, dev, T=T)
    before = kernels.grid_neg_reml_lattice.launches
    _check_lattice(args)
    assert kernels.grid_neg_reml_lattice.launches == before + 1
    assert kernels.grid_neg_reml_lattice(*args).shape == (T, B, G)


@pytest.mark.parametrize("p", [1, 4])
def test_grid_lattice_traits_equal_single_trait_launches(dev, p):
    """Each trait of a T = 3 launch equals the single-trait launch on that
    trait's rows bit for bit (the same FMAs in the same order), and a
    (1, R, G) SH gives the (R, G) call's lattice."""
    rng = np.random.default_rng(90 + p)
    B, G, n = 300, 130, 333
    Gr = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32, device=dev)
    Gr_, W, YX, SH, p_, ridge, nf = _lattice_args(rng, Gr, G, p, dev, T=3)
    out = kernels.grid_neg_reml_lattice(Gr_, W, YX, SH, p_, ridge, nf)
    for t in range(3):
        YX1 = torch.cat([YX[t:t + 1], YX[3:]]).contiguous()
        one = kernels.grid_neg_reml_lattice(Gr, W, YX1, SH[t], p, ridge, nf)
        assert torch.equal(out[t], one)
        stacked = kernels.grid_neg_reml_lattice(Gr, W, YX1, SH[t:t + 1], p, ridge, nf)
        assert stacked.shape == (1, B, G) and torch.equal(stacked[0], one)


def test_lmm_scan_multi_on_card_matches_single_trait_scans(dev):
    """lmm_scan_multi on the card (one K1 and one K2 launch for all three
    traits) against three lmm_scan calls: Δ(-log10 p) <= 5e-3
    (tests/test_scans.py:229)."""
    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes
    from janusx_tpu_torch.models import lmm

    rng = np.random.default_rng(5)
    m, n, T = 3000, 300, 3
    g = rng.binomial(2, rng.uniform(0.05, 0.5, m)[:, None], size=(m, n)).astype(np.int8)
    site = dict(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                snp=np.array([f"rs{i}" for i in range(m)], object),
                allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    pg = pack_genotypes(GenotypeData(g, SiteInfo(**site), np.array(
        [f"i{j}" for j in range(n)], object)), QcParams())
    gc = pg.centered()
    basis = eigh_grm(gc.T @ gc / pg.m, diag_ridge=1e-6)
    Y = 1.0 + gc.T @ rng.normal(0, 0.03, (pg.m, T)) + rng.normal(size=(n, T))
    cov = rng.normal(size=(n, 2))
    kernels.reset_launches()
    res, nulls = lmm.lmm_scan_multi(pg, basis, Y, cov, block=512, device=dev)
    assert kernels.decode_rotate.launches == 1
    assert kernels.grid_neg_reml_lattice.launches == 1
    for t in range(T):
        one, null = lmm.lmm_scan(pg, basis, Y[:, t], cov, block=512, device=dev)
        assert null.lbd == nulls[t].lbd
        dl = np.abs(np.log10(res[t].pwald) - np.log10(one.pwald))
        assert np.nanmax(dl) <= 5e-3


@pytest.mark.parametrize("prec", ["highest", "high"])
def test_kernels_take_rows_beyond_one_grid_axis_of_65535_blocks(dev, prec):
    """SNP rows map to the grid's x axis, so one launch covers a whole
    resident superblock whatever its size (narrow n keeps this small)."""
    rng = np.random.default_rng(7)
    M, n = 65_536 * 128 + 5, 9
    packed, mean = _block(rng, M, n)
    pk, mn = torch.from_numpy(packed).to(dev), torch.from_numpy(mean).to(dev)
    U = torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32, device=dev)
    Gr = kernels.decode_rotate(pk, mn, U, prec=prec)
    torch.testing.assert_close(Gr, _PLAIN[prec](pk, mn, U), rtol=1e-5, atol=1e-4)
    _check_lattice(_lattice_args(rng, Gr[: 65_536 * 32 + 3], 5, 2, dev))


def test_wrapper_checks_operands(dev):
    pk = torch.zeros((8, 4), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        kernels.decode_rotate(pk, torch.zeros(8, device=dev),
                              torch.zeros((16, 4), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):  # operands on two devices
        kernels.decode_rotate(pk, torch.zeros(8), torch.zeros((16, 4), device=dev))
