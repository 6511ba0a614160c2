"""The port's CUDA kernels on the card against their plain PyTorch versions.

These need an NVIDIA GPU and nvcc; they skip without a card. The file
imports nothing of JAX, so on a machine with a card but no JAX it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

Bounds: K1 rtol 1e-5 / atol 1e-4 (tests/test_pallas.py:29) in each mode
against its own plain version, "high" also within matrix-relative 1e-5 of
"highest" (tests/test_pallas.py:134); K2 in each mode the same finite/inf
pattern and finite cells rtol 1e-4 / atol 1e-3 against its own plain
version on the same device (the "default" kernel and its plain version
multiply the same bf16 values exactly and differ in summation order only),
and "default" against the "highest" plain version on rotated genotypes
within K2's bounds (tests/test_pallas.py:102-110: the same finite/inf
pattern, λ* within 2.02 grid spacings, > 50 % in the same grid cell,
beta/se at λ* within rtol 2e-3). On random rows, whose REML profile is
flat, one bf16 pass moves λ* further: those hold "default" to its own
plain version only. The routes without a kernel of their own (-lowrank,
-splmm, -splmm-exact, -algwas) on the card against the same call on the
CPU: Δ(-log10 p) <= 5e-3 (tests/test_scans.py:155), the device quadratic
g'V^-1 g against the host f64 quad at rtol 2e-4
(tests/test_sparse_path.py:106). The device steps of ``jx gs`` (the HE
stream pass, marker effects, the PCG solve, the signed-hash accumulation,
the TOP loss with its gradient and Hessian, the GBLUPad AI-REML) and of
``jx grm``/``pca``/``gstats``/``fvlmm2 -i`` (a GRM strip, the RSVD pass,
KING's tile pair, the joint GLS of the combo scan) and of ``jx fastpop``
and ``jx tree`` (the admixture fit, the IBS distance) on the card against
the same call on the CPU, each at the bound stated at its test. The Gibbs
sweeps of ``jx gs -BayesA/B/Cpi`` (G1, G2) against their plain versions
with the same draws: δ identical, β within rtol 1e-4 (G1) and 1e-3 (G2),
on both of the serial pass's paths; G2's pre-pass against the
torch.linalg batch within 1e-4 of each block's largest entry.
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
    before = kernels.launch_counts()["decode_rotate"]
    got = kernels.decode_rotate(pk, mn, U, prec=prec)
    want = _PLAIN[prec](pk, mn, U)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_rotate"] == before + 1
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


GRID_PRECS = ("highest", "default")


def _check_lattice(args, prec="highest"):
    got = kernels.grid_neg_reml_lattice(*args, prec=prec)
    want = kernels.grid_neg_reml_lattice_plain(*args, prec=prec)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert fin.float().mean() > 0.5
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-3)
    return got


def _scan_problem(m, n, T):
    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes

    rng = np.random.default_rng(5)
    g = rng.binomial(2, rng.uniform(0.05, 0.5, m)[:, None], size=(m, n)).astype(np.int8)
    site = dict(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                snp=np.array([f"rs{i}" for i in range(m)], object),
                allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    pg = pack_genotypes(GenotypeData(g, SiteInfo(**site), np.array(
        [f"i{j}" for j in range(n)], object)), QcParams())
    gc = pg.centered()
    basis = eigh_grm(gc.T @ gc / pg.m, diag_ridge=1e-6)
    Y = 1.0 + gc.T @ rng.normal(0, 0.03, (pg.m, T)) + rng.normal(size=(n, T))
    return pg, basis, Y, rng.normal(size=(n, 2))


@pytest.mark.parametrize("p", [1, 3])
def test_grid_lattice_default_meets_k2_bounds_against_highest(dev, p):
    """The "default" kernel against the "highest" plain version on rotated
    genotypes of a trait with a polygenic component (an interior REML
    optimum, as on real data) at the scan's n = 1,410: the same finite/inf
    pattern, λ* within 2.02 grid spacings, > 50 % in the same grid cell,
    beta/se at each λ* within rtol 2e-3 (beta's absolute floor 2e-3 se).
    At n = 300 one bf16 pass moves beta up to 0.7 % of |beta| + se (the
    plain versions on the CPU), beyond that bound."""
    from janusx_tpu_torch.core.reml import (argmin_parabolic, final_stats_f32,
                                            grid_shared, make_grid, make_rotated)
    from janusx_tpu_torch.models.lmm import _lattice_operands

    pg, basis, Y, cov = _scan_problem(3000, 1410, 1)
    rot = make_rotated(basis, Y[:, 0], cov[:, :p - 1] if p > 1 else None, device=dev)
    grid = make_grid(256, dev)
    W, YX, SH = _lattice_operands(grid_shared(rot, grid), rot)
    Gr = torch.as_tensor(pg.centered() @ basis.U, dtype=torch.float32, device=dev)
    args = (Gr, W, YX, SH, p, config.GRAM_RIDGE, float(pg.n))
    got = kernels.grid_neg_reml_lattice(*args, prec="default")
    want = kernels.grid_neg_reml_lattice_plain(*args)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    lg_k, lg_p = argmin_parabolic(got, grid), argmin_parabolic(want, grid)
    assert float((lg_k - lg_p).abs().max()) <= 2.02 * float(grid[1] - grid[0])
    assert float((torch.argmin(got, -1) == torch.argmin(want, -1)).double().mean()) > 0.5
    b_k, se_k, _ = final_stats_f32(rot, Gr, lg_k, False)
    b_p, se_p, _ = final_stats_f32(rot, Gr, lg_p, False)
    assert bool(((b_k - b_p).abs() <= 2e-3 * (se_p + b_p.abs())).all())
    torch.testing.assert_close(se_k, se_p, rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("prec", GRID_PRECS)
@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("B,G,n", [(2048, 256, 1410), (37, 70, 45)])
def test_grid_lattice_kernel_matches_plain(dev, prec, p, B, G, n):
    rng = np.random.default_rng(p * 1000 + n)
    Gr = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32, device=dev)
    _check_lattice(_lattice_args(rng, Gr, G, p, dev), prec)


@pytest.mark.parametrize("prec", GRID_PRECS)
@pytest.mark.parametrize("T", [1, 3, 4, 6])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("B,G,n", [(2048, 256, 1410), (37, 70, 45)])
def test_grid_lattice_trait_axis_matches_plain(dev, prec, p, T, B, G, n):
    """The trait axis (T traits in one launch; 6 spans two trait chunks)
    against the plain version, the reference's loop over traits."""
    rng = np.random.default_rng(p * 1000 + n + 17 * T)
    Gr = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32, device=dev)
    args = _lattice_args(rng, Gr, G, p, dev, T=T)
    before = kernels.launch_counts()["grid_neg_reml_lattice"]
    got = _check_lattice(args, prec)
    assert kernels.launch_counts()["grid_neg_reml_lattice"] == before + 1
    assert got.shape == (T, B, G)


@pytest.mark.parametrize("prec", GRID_PRECS)
@pytest.mark.parametrize("p", [1, 4])
def test_grid_lattice_traits_equal_single_trait_launches(dev, prec, p):
    """Each trait of a T = 3 launch equals the single-trait launch on that
    trait's rows bit for bit (the same instructions in the same order), and
    a (1, R, G) SH gives the (R, G) call's lattice."""
    rng = np.random.default_rng(90 + p)
    B, G, n = 300, 130, 333
    Gr = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32, device=dev)
    Gr_, W, YX, SH, p_, ridge, nf = _lattice_args(rng, Gr, G, p, dev, T=3)
    out = kernels.grid_neg_reml_lattice(Gr_, W, YX, SH, p_, ridge, nf, prec=prec)
    for t in range(3):
        YX1 = torch.cat([YX[t:t + 1], YX[3:]]).contiguous()
        one = kernels.grid_neg_reml_lattice(Gr, W, YX1, SH[t], p, ridge, nf, prec=prec)
        assert torch.equal(out[t], one)
        stacked = kernels.grid_neg_reml_lattice(Gr, W, YX1, SH[t:t + 1], p, ridge, nf,
                                                prec=prec)
        assert stacked.shape == (1, B, G) and torch.equal(stacked[0], one)


@pytest.mark.parametrize("prec", GRID_PRECS)
def test_grid_lattice_reads_padded_rows_and_a_given_split(dev, prec):
    """Gr as a view of rows padded to 16 bytes (K1's row_align=4 output,
    read with 16-byte loads) and W's pieces made beforehand give the
    lattice of a contiguous Gr and a per-call split bit for bit."""
    rng = np.random.default_rng(31)
    B, G, n = 500, 256, 1410
    Gr = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32, device=dev)
    pad = torch.zeros((B, n + 2), dtype=torch.float32, device=dev)[:, :n]
    pad.copy_(Gr)
    args = _lattice_args(rng, Gr, G, 2, dev)
    want = kernels.grid_neg_reml_lattice(*args, prec=prec)
    got = kernels.grid_neg_reml_lattice(pad, *args[1:], prec=prec,
                                        W_split=kernels.split_w(args[1]))
    assert torch.equal(got, want)


def test_decode_rotate_row_align_pads_rows(dev):
    pk, mn, U = _operands(dev, 1000, 1410, 1410, False, 1410 ** -0.5)
    got = kernels.decode_rotate(pk, mn, U, row_align=4)
    assert got.shape == (1000, 1410) and got.stride(0) == 1412
    assert torch.equal(got, kernels.decode_rotate(pk, mn, U))


def test_lmm_scan_splits_w_once_per_scan(dev, monkeypatch):
    """W's bf16 pieces are made once per scan, not once per superblock or
    launch: three superblocks, three K2 launches, one split."""
    from janusx_tpu_torch.models import lmm

    pg, basis, Y, cov = _scan_problem(3000, 300, 3)
    calls = []
    split = kernels.split_w
    monkeypatch.setattr(kernels, "split_w", lambda W: calls.append(W.shape) or split(W))
    kernels.reset_launches()
    lmm.lmm_scan_multi(pg, basis, Y, cov, block=512, superblock=1024, device=dev)
    assert kernels.launch_counts()["grid_neg_reml_lattice"] == 3
    assert len(calls) == 1


def _fresh_panel(pg):
    """``pg`` under a new identity: its codes and means new host arrays."""
    import dataclasses

    return dataclasses.replace(pg, packed=pg.packed.copy(), mean=pg.mean.copy())


def test_lmm_scan_counts_its_uploads(dev, monkeypatch):
    """utils.trace's h2d_bytes over lmm_scan, the trait's rotated data and
    U already on the card. Two superblocks of an in-memory panel: the
    first scan uploads the whole panel (padded rows and f32 means) once,
    a second scan 0 more, and so does a scan of it in one superblock,
    which shares that copy. With no room on the card
    (``devcache.room`` 0) a panel streams: each superblock's padded rows
    and means on every call, the same bytes in all."""
    from janusx_tpu_torch.models import lmm
    from janusx_tpu_torch.utils import devcache, trace

    pg, basis, Y, _ = _scan_problem(3000, 300, 1)
    y = Y[:, 0]
    h2d = lambda: trace.counts().get(trace.H2D, 0)
    row = decode.pad_packed_cols(pg.packed[:1], 4).shape[1] + 4  # packed bytes + f32 mean
    sb = lmm.lattice_superblock(pg.n, 256, 512, 2048)
    chunks = [min(sb, pg.m - s) for s in range(0, pg.m, sb)]
    assert len(chunks) == 2
    streamed = sum(-(-c // 512) * 512 * row for c in chunks)
    lmm.lmm_scan(pg, basis, y, block=512, superblock=2048, device=dev)
    panel = _fresh_panel(pg)
    before = h2d()
    lmm.lmm_scan(panel, basis, y, block=512, superblock=2048, device=dev)
    assert h2d() - before == -(-pg.m // 512) * 512 * row
    for kw in ({"superblock": 2048}, {}):
        before = h2d()
        lmm.lmm_scan(panel, basis, y, block=512, device=dev, **kw)
        assert h2d() == before
    monkeypatch.setattr(devcache, "room", lambda device: 0)
    other = _fresh_panel(pg)
    for _ in range(2):
        before = h2d()
        lmm.lmm_scan(other, basis, y, block=512, superblock=2048, device=dev)
        assert h2d() - before == streamed


def test_lmm_scan_holds_a_split_panel_across_traits(dev, monkeypatch):
    """Two traits of lmm_scan on one panel in three superblocks: the second
    trait uploads the panel's bytes fewer than the same trait on a copy
    that streams (``devcache.room`` 0), and its results equal that
    streamed path's bit for bit; once the panel is released the card's
    allocated memory is back at its level before the panel's first
    scan."""
    import gc

    from janusx_tpu_torch.models import lmm
    from janusx_tpu_torch.utils import devcache, trace

    pg0, basis, Y, _ = _scan_problem(3000, 300, 2)
    h2d = lambda: trace.counts().get(trace.H2D, 0)
    kw = dict(block=512, superblock=1024, device=dev)
    row = decode.pad_packed_cols(pg0.packed[:1], 4).shape[1] + 4
    panel_bytes = -(-pg0.m // 512) * 512 * row
    with monkeypatch.context() as mp:
        mp.setattr(devcache, "room", lambda device: 0)
        copy = _fresh_panel(pg0)
        for t in (0, 1):  # the traits' states on the card
            lmm.lmm_scan(copy, basis, Y[:, t], **kw)
        before = h2d()
        ref = lmm.lmm_scan(copy, basis, Y[:, 1], **kw)[0]
        streamed = h2d() - before
        del copy
    gc.collect()
    torch.cuda.synchronize()
    level = torch.cuda.memory_allocated(dev)
    pg = _fresh_panel(pg0)
    lmm.lmm_scan(pg, basis, Y[:, 0], **kw)
    before = h2d()
    got = lmm.lmm_scan(pg, basis, Y[:, 1], **kw)[0]
    assert streamed - (h2d() - before) == panel_bytes
    for a, b in ((got.beta, ref.beta), (got.se, ref.se), (got.pwald, ref.pwald)):
        np.testing.assert_array_equal(a, b)
    assert torch.cuda.memory_allocated(dev) > level
    del pg
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == level


def test_lmm_scan_multi_on_card_matches_single_trait_scans(dev):
    """lmm_scan_multi on the card (one K1 and one K2 launch for all three
    traits) against three lmm_scan calls: Δ(-log10 p) <= 5e-3
    (tests/test_scans.py:229)."""
    from janusx_tpu_torch.models import lmm

    T = 3
    pg, basis, Y, cov = _scan_problem(3000, 300, T)
    kernels.reset_launches()
    res, nulls = lmm.lmm_scan_multi(pg, basis, Y, cov, block=512, device=dev)
    assert kernels.launch_counts()["decode_rotate"] == 1
    assert kernels.launch_counts()["grid_neg_reml_lattice"] == 1
    for t in range(T):
        one, null = lmm.lmm_scan(pg, basis, Y[:, t], cov, block=512, device=dev)
        assert null.lbd == nulls[t].lbd
        dl = np.abs(np.log10(res[t].pwald) - np.log10(one.pwald))
        assert np.nanmax(dl) <= 5e-3


# ------------------------------------------ N1 null_reml_brent (csrc/nullfit.cu)
def _null_states(dev, n, p, T, kind="interior"):
    """T rotated states sharing s and PXX on ``dev``: a GRM-like spectrum s,
    a design Xr of an intercept-like column and p - 1 covariates, and each
    lane's yr drawn with variance h² s + (1 - h²) ("interior"); s less
    0.999e-3, a negative λ (the optimum at the interval's low end, "low");
    |s| with the spectrum's three last eigenvalues negative, so that v <= 0
    below λ = 1e-3 and the optimum sits just above it ("negative"); falling
    with s (at the high end, "high"); or 0 (r'Wr = 0 at every λ,
    "degenerate")."""
    from janusx_tpu_torch.core.reml import RotatedData

    rng = np.random.default_rng(10 * n + p)
    s = np.sort(rng.gamma(0.6, 1.7, n))[::-1].copy() + 1e-3
    if kind == "negative":
        s[-3:] = [-1e-3, -2e-4, -5e-5]
    Xr = rng.normal(size=(n, p))
    Xr[:, 0] = 1.0 + 0.1 * Xr[:, 0]
    h2 = rng.uniform(0.2, 0.8, T)
    var = {"interior": lambda t: h2[t] * np.abs(s) + 1.0 - h2[t],
           "negative": lambda t: np.abs(s),
           "low": lambda t: s - 0.999e-3,
           "high": lambda t: 2.0 - s / s.max(),
           "degenerate": lambda t: np.zeros(n)}[kind]
    PXX = (Xr[:, :, None] * Xr[:, None, :]).reshape(n, -1)
    t64 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=dev)
    rots = []
    for t in range(T):
        yr = rng.normal(size=n) * np.sqrt(var(t))
        rots.append(RotatedData(s=t64(s), Xr=t64(Xr), yr=t64(yr), PXX=t64(PXX),
                                PXy=t64(Xr * yr[:, None]), Pyy=t64(yr * yr)))
    return rots


def _close_to_plain(got, rots):
    """Each fit against the plain version's on the same device, which
    differs from it only in the order of the f64 sums: at the kernel's log10
    λ its -REML and ML within rel 1e-10 of the plain objective's there, its
    -REML within rel 1e-10 of the plain fit's optimum, the 1e8 sentinel and
    its -1e8 ML exactly; and log10 λ within 1e-6, the Brent's tolerance
    (NULL_BRENT_TOL). Near the optimum -REML (~1e4 at n = 5,000) moves by
    less than its f64 rounding (~1e-11) over ~1e-6 of log10 λ, so two sum
    orders stop the Brent at two points of that flat stretch: the plain
    version on the CPU and on the card differ by as much (up to 3e-7 on
    these states, H100), and tests/test_torch_lmm.py holds the port to the
    reference at the same 1e-6. ML, not flat there, is compared at the
    kernel's own λ. Returns the plain fits."""
    from janusx_tpu_torch.core import reml

    want = [reml.fit_null_reml_plain(r) for r in rots]
    for g, w, r in zip(got, want, rots):
        assert abs(g.log10_lbd - w.log10_lbd) <= 1e-6, (g, w)
        x = torch.tensor([g.log10_lbd], dtype=torch.float64, device=r.s.device)
        at = (-float(reml.neg_reml_null(x, r)[0]), float(reml.ml_null(x, r)[0]))
        if w.reml == -1e8:
            assert (g.reml, g.ml) == (w.reml, w.ml) == at
        else:
            assert g.reml == pytest.approx(at[0], rel=1e-10)
            assert g.ml == pytest.approx(at[1], rel=1e-10)
            assert g.reml == pytest.approx(w.reml, rel=1e-10)
    return want


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("n", [96, 1410, 5000])
@pytest.mark.parametrize("p", [1, 3, 12])
def test_null_reml_brent_matches_plain(dev, p, n, lanes):
    from janusx_tpu_torch.core import reml

    rots = _null_states(dev, n, p, lanes)
    got = reml.fit_null_reml_multi(rots) if lanes > 1 else [reml.fit_null_reml(rots[0])]
    want = _close_to_plain(got, rots)
    assert all(-5.0 < w.log10_lbd < 5.0 for w in want)


@pytest.mark.parametrize("kind", ["negative", "low", "high", "degenerate"])
def test_null_reml_brent_edge_cases_match_plain(dev, kind):
    """v <= 0 below λ = 1e-3; the optimum at each end of [-5, 5]; r'Wr =
    0, where every evaluation is the sentinel, as in the plain version."""
    from janusx_tpu_torch.core import reml

    rots = _null_states(dev, 1410, 3, 4, kind)
    want = _close_to_plain(reml.fit_null_reml_multi(rots), rots)
    x = [w.log10_lbd for w in want]
    if kind == "negative":
        assert all(-3.0 < v < -2.8 for v in x)
    elif kind == "low":
        assert all(v < -4.99 for v in x)
    elif kind == "high":
        assert all(v > 4.99 for v in x)
    else:
        assert all(w.reml == -1e8 and w.ml == -1e8 for w in want)


@pytest.mark.parametrize("p", [1, 3])
def test_null_reml_brent_lane_equals_its_single_launch(dev, p):
    """A lane's fit does not depend on the other lanes of its launch."""
    from janusx_tpu_torch.core import reml

    rots = _null_states(dev, 1410, p, 4)
    assert reml.fit_null_reml_multi(rots) == [reml.fit_null_reml(r) for r in rots]


def test_null_reml_brent_one_launch_per_fit(dev):
    """One launch per fit_null_reml or fit_null_reml_multi call, its
    traits counted under null_fit.card and none under null_fit.plain."""
    from janusx_tpu_torch.core import reml
    from janusx_tpu_torch.utils import trace

    rots = _null_states(dev, 1410, 1, 4)
    kernels.reset_launches()
    trace.reset("null_fit.")
    reml.fit_null_reml(rots[0])
    assert kernels.launch_counts()["null_reml_brent"] == 1
    reml.fit_null_reml_multi(rots)
    assert kernels.launch_counts()["null_reml_brent"] == 2
    assert trace.counts().get("null_fit.card") == 5
    assert "null_fit.plain" not in trace.counts()


@pytest.mark.parametrize("p", [119, 120])
def test_null_reml_brent_past_shared_memory(dev, p):
    """At p = 119 a lane's sums, Cholesky factor and solve fill the block's
    shared memory; from p = 120 they lie in a global workspace of the
    lane's own. Either way one launch fits both lanes, as close to the
    plain version as at small p."""
    from janusx_tpu_torch.core import reml
    from janusx_tpu_torch.utils import trace

    assert (kernels._lib().jx_null_reml_workspace(p) > 0) == (p > 119)
    rots = _null_states(dev, 400, p, 2)
    kernels.reset_launches()
    trace.reset("null_fit.")
    got = reml.fit_null_reml_multi(rots)
    assert kernels.launch_counts()["null_reml_brent"] == 1
    assert trace.counts().get("null_fit.card") == 2
    want = _close_to_plain(got, rots)
    assert all(-5.0 < w.log10_lbd < 5.0 for w in want)


def test_null_reml_brent_states_not_shared_raise_before_any_launch(dev):
    """fit_null_reml_multi on states whose s differ: ValueError, no launch."""
    from janusx_tpu_torch.core import reml

    rots = _null_states(dev, 1410, 1, 2)
    odd = rots[1]._replace(s=rots[1].s.clone().index_fill_(0, torch.tensor([7], device=dev),
                                                           2.0))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="do not share s and PXX"):
        reml.fit_null_reml_multi([rots[0], odd])
    assert kernels.launch_counts()["null_reml_brent"] == 0


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


def test_decode_rotate_at_the_lowrank_width(dev):
    """K1 at the -lowrank shape: N = k = 1000 columns (not a multiple of
    64) of an orthonormal basis, in both modes against the plain versions."""
    rng = np.random.default_rng(41)
    packed, mean = _block(rng, 2048, 1410)
    pk, mn = torch.from_numpy(packed).to(dev), torch.from_numpy(mean).to(dev)
    U = torch.as_tensor(np.linalg.qr(rng.normal(size=(1410, 1000)))[0],
                        dtype=torch.float32, device=dev)
    for prec in ("highest", "high"):
        got = kernels.decode_rotate(pk, mn, U, prec=prec, U_split=kernels.split_u(U))
        assert got.shape == (2048, 1000)
        torch.testing.assert_close(got, _PLAIN[prec](pk, mn, U), rtol=1e-5, atol=1e-4)


def test_decode_rotate_at_the_lowrank_benchmark_shape(dev):
    """K1 at the low-rank benchmark cell's shape: a reduction over n =
    60,000 samples into N = k = 4,096 columns of an orthonormal basis,
    4,096 rows, in both modes against the plain versions."""
    rng = np.random.default_rng(60)
    n, N = 60_000, 4096
    packed, mean = _block(rng, 4096, n)
    pk, mn = torch.from_numpy(packed).to(dev), torch.from_numpy(mean).to(dev)
    gen = torch.Generator(device=dev).manual_seed(60)
    U = torch.linalg.qr(torch.randn((n, N), generator=gen, device=dev))[0].contiguous()
    U_split = kernels.split_u(U)
    for prec in ("highest", "high"):
        got = kernels.decode_rotate(pk, mn, U, prec=prec, U_split=U_split)
        assert got.shape == (4096, N)
        torch.testing.assert_close(got, _PLAIN[prec](pk, mn, U), rtol=1e-5, atol=1e-4)


def _dlogp(a, b):
    return float(np.max(np.abs(np.log10(a) - np.log10(b))))


@pytest.mark.parametrize("model", ["add", "dom", "rec", "het"])
def test_fastlmm_scan_on_card_matches_cpu(dev, model):
    """-lowrank on the card against the CPU (K1's plain version for add):
    Δ(-log10 p) <= 5e-3, the same λ_null; K1 launched once per resident
    superblock on the add route, never on the others."""
    from janusx_tpu_torch.models import fastlmm
    from janusx_tpu_torch.models.lmm import lattice_superblock

    pg, _, Y, cov = _scan_problem(3000, 300, 1)
    lrb = fastlmm.lowrank_basis_from_snps(pg, q=100)
    kernels.reset_launches()
    card, null = fastlmm.fastlmm_scan(pg, lrb, Y[:, 0], cov, block=512, superblock=1024,
                                      model=model, device=dev)
    supers = -(-pg.m // lattice_superblock(pg.n, 256, 512, 1024))
    assert supers == 3
    assert kernels.launch_counts()["decode_rotate"] == (supers if model == "add" else 0)
    cpu, null_c = fastlmm.fastlmm_scan(pg, lrb, Y[:, 0], cov, block=512, model=model,
                                       device="cpu")
    assert null.lbd == null_c.lbd
    np.testing.assert_array_equal(np.isnan(card.beta), np.isnan(cpu.beta))
    assert _dlogp(card.pwald, cpu.pwald) <= 5e-3


def test_fastlmm_scan_at_8000_samples_on_card_matches_cpu(dev):
    """-lowrank add at n = 8,000 with a kinship of q = 1,024 SNPs, over two
    resident superblocks, on the card against the CPU: Δ(-log10 p) <= 5e-3
    (tests/test_scans.py:155), the same valid SNPs and the same λ_null
    (host f64 on both), K1 launched once a superblock."""
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes
    from janusx_tpu_torch.models import fastlmm

    rng = np.random.default_rng(8000)
    m, n = 6000, 8000
    g = rng.binomial(2, rng.uniform(0.05, 0.5, m)[:, None], size=(m, n)).astype(np.int8)
    g[rng.random((m, n)) < 0.02] = -1
    site = dict(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                snp=np.array([f"rs{i}" for i in range(m)], object),
                allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    pg = pack_genotypes(GenotypeData(g, SiteInfo(**site), np.array(
        [f"i{j}" for j in range(n)], object)), QcParams())
    lrb = fastlmm.lowrank_basis_from_snps(pg, q=1024)
    assert lrb.k == 1024
    gc = pg.take_snps(np.arange(0, pg.m, 7)).centered()
    y = 1.0 + gc.T @ rng.normal(0, 0.03, gc.shape[0]) + rng.normal(size=n)
    runs = {}
    for d in (dev, "cpu"):
        rot = fastlmm.make_rotated_lr(lrb, y, None)
        _, null = fastlmm.lowrank_switch_p(rot)
        kernels.reset_launches()
        runs[str(d)] = fastlmm.fastlmm_scan(pg, lrb, y, rot=rot, null=null, block=2048,
                                            superblock=4096, device=d)
        if d == dev:
            assert kernels.launch_counts()["decode_rotate"] == -(-pg.m // 4096) == 2
    (card, null), (cpu, null_c) = runs[str(dev)], runs["cpu"]
    assert null.lbd == null_c.lbd
    np.testing.assert_array_equal(np.isnan(card.beta), np.isnan(cpu.beta))
    assert _dlogp(card.pwald, cpu.pwald) <= 5e-3


def test_sparse_scans_on_card_match_cpu(dev):
    """The band-streamed sparse GRM, the device quadratic and -splmm /
    -splmm-exact on the card against the CPU; -splmm's γ (f64 on either
    device) at rtol 1e-12 over the same markers."""
    from janusx_tpu_torch.models import splmm

    pg, _, Y, cov = _scan_problem(3000, 300, 1)
    Kc = splmm.build_sparse_grm(pg, cutoff=0.05, row_band=128, device="cpu")
    Kd = splmm.build_sparse_grm(pg, cutoff=0.05, row_band=128, device=dev).toarray()
    both = (Kd != 0) & (Kc.toarray() != 0)
    assert abs(int((Kd != 0).sum()) - Kc.nnz) <= 4  # entries at the cutoff may flip
    np.testing.assert_allclose(Kd[both], Kc.toarray()[both], rtol=1e-5, atol=1e-7)
    null = splmm.fit_sparse_null(Kc, Y[:, 0] - Y[:, 0].mean(), pg.n - 1)
    bs = null.factor.bs
    G = pg.centered()[:64].astype(np.float32)
    got = bs.device_quad_fn(0.7, dev)(torch.as_tensor(G, device=dev)).cpu().numpy()
    np.testing.assert_allclose(got, bs.quad(0.7, G.T.astype(np.float64)), rtol=2e-4)
    for scan in (splmm.splmm_grammar_scan, splmm.splmm_exact_scan):
        card, info = scan(pg, Kc, Y[:, 0], cov, block=512, superblock=1024, device=dev)
        cpu, info_c = scan(pg, Kc, Y[:, 0], cov, block=512, device="cpu")
        assert info["lambda_null"] == info_c["lambda_null"]
        if scan is splmm.splmm_grammar_scan:  # γ's f64 statistics on the card
            assert info["gamma"] == pytest.approx(info_c["gamma"], rel=1e-12)
            assert info["n_gamma_markers"] == info_c["n_gamma_markers"]
        np.testing.assert_array_equal(np.isnan(card.beta), np.isnan(cpu.beta))
        assert _dlogp(card.pwald, cpu.pwald) <= 5e-3


def test_algwas_on_card_matches_cpu(dev):
    from janusx_tpu_torch.models import algwas

    pg, _, Y, cov = _scan_problem(600, 400, 1)
    card = algwas.algwas_scan(pg, Y[:, 0], cov, device=dev)
    cpu = algwas.algwas_scan(pg, Y[:, 0], cov, device="cpu")
    np.testing.assert_array_equal(card.selected, cpu.selected)
    np.testing.assert_allclose(card.ebic_path, cpu.ebic_path, rtol=1e-4)
    assert _dlogp(card.result.pwald, cpu.result.pwald) <= 5e-3


# ------------------------------------------------------------ jx gs
def test_he_stream_pass_on_card_matches_cpu(dev):
    """The streamed HE pass (decode, C V, Cᵀ(C V) and the column sums)
    and he_streamed on the card against the CPU: trace_k rel 1e-6,
    trace_k2 rel 1e-5, h2 abs 1e-5, with the same probes."""
    from janusx_tpu_torch.models import he

    pg, _, Y, cov = _scan_problem(3000, 300, 1)
    idx = np.arange(0, pg.n, 3)
    fits = [he.he_streamed(pg, Y[:, 0], covariates=cov, probes=16, seed=4, sample_idx=idx,
                           block=1024, device=d) for d in (dev, "cpu")]
    assert fits[0].boundary == fits[1].boundary
    assert fits[0].trace_k == pytest.approx(fits[1].trace_k, rel=1e-6)
    assert fits[0].trace_k2 == pytest.approx(fits[1].trace_k2, rel=1e-5)
    assert fits[0].h2 == pytest.approx(fits[1].h2, abs=1e-5)


def test_marker_effects_on_card_match_cpu(dev):
    """a = Z'α / denom on the card against the CPU: rtol 1e-4, atol 1e-6
    (tests/test_gs.py:78)."""
    from janusx_tpu_torch.gs.blup import marker_effects
    from janusx_tpu_torch.models.grm import grm_denominator

    pg, _, _, _ = _scan_problem(3000, 300, 1)
    alpha = np.random.default_rng(3).normal(size=pg.n)
    den = grm_denominator(pg)
    got = marker_effects(pg, alpha, den, block=1024, device=dev)
    np.testing.assert_allclose(got, marker_effects(pg, alpha, den, block=1024, device="cpu"),
                               rtol=1e-4, atol=1e-6)


def test_cg_solve_on_card_matches_cpu(dev):
    """Jacobi-PCG of (K + λI) on the card against the CPU at a reachable
    tol (1e-4): iterations within 1, x within 1e-4 ||x||; and the GS
    route's solve at the default tol and iteration cap."""
    from janusx_tpu_torch.gs.blup import fit_gblup_cg
    from janusx_tpu_torch.ops.cg import cg_solve

    pg, basis, Y, _ = _scan_problem(3000, 300, 1)
    K = (basis.U * basis.S) @ basis.U.T
    b = torch.as_tensor(Y[:, 0] - Y[:, 0].mean(), dtype=torch.float32)
    res = {}
    for d in (dev, "cpu"):
        A = torch.as_tensor(K, dtype=torch.float32, device=d) + 0.5 * torch.eye(pg.n, device=d)
        res[str(d)] = cg_solve(lambda v: A @ v, b.to(d), diag_precond=torch.diagonal(A),
                               tol=1e-4, max_iter=500)
    card, cpu = res[str(dev)], res["cpu"]
    assert abs(int(card.iters) - int(cpu.iters)) <= 1 and int(cpu.iters) < 500
    assert float(torch.linalg.norm(card.x.cpu() - cpu.x)) <= 1e-4 * float(torch.linalg.norm(cpu.x))
    train = np.arange(pg.n - 50)
    a_card, _ = fit_gblup_cg(K, Y[:, 0], train, 0.8, device=dev)
    a_cpu, _ = fit_gblup_cg(K, Y[:, 0], train, 0.8, device="cpu")
    assert np.linalg.norm(a_card - a_cpu) <= 1e-4 * np.linalg.norm(a_cpu)


@pytest.mark.parametrize("standardize", [True, False])
def test_hash_accumulation_on_card_matches_cpu(dev, standardize):
    """The signed-hash sketch (index_add_ of signed rows into bucket rows;
    atomics on the card) against the CPU: rtol 2e-4 / atol 2e-4
    (tests/test_hashing.py:133), scale rel 1e-5, the same kept count."""
    from janusx_tpu_torch.models.hashing import signed_hash_features

    pg, _, _, _ = _scan_problem(3000, 300, 1)
    kw = dict(n_buckets=512, standardize=standardize, block=1024)
    Hd, sd, kd = signed_hash_features(pg, device=dev, **kw)
    Hc, sc, kc = signed_hash_features(pg, device="cpu", **kw)
    assert kd == kc and sd == pytest.approx(sc, rel=1e-5)
    np.testing.assert_allclose(Hd, Hc, rtol=2e-4, atol=2e-4)


def test_top_loss_grad_hess_on_card_match_cpu(dev):
    """The TOP listwise loss, its gradient and Hessian (torch.func) in f64
    on the card against the CPU, and the fitted weights (atol 1e-8, the
    same iterations)."""
    from janusx_tpu_torch.gs.top import _loss_grad_hess, top_fit

    rng = np.random.default_rng(6)
    P, T = rng.normal(size=(400, 5)), rng.normal(size=(400, 5))
    w = rng.uniform(0.1, 1.0, 5)
    card = _loss_grad_hess(*(torch.as_tensor(a, device=dev) for a in (w, P, T)), 1e-3)
    cpu = _loss_grad_hess(*(torch.as_tensor(a) for a in (w, P, T)), 1e-3)
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-10, atol=1e-10)
    T[::5, 2] = np.nan
    fits = [top_fit(T, T + 0.5 * P, device=d) for d in (dev, "cpu")]
    assert (fits[0].n_iter, fits[0].converged) == (fits[1].n_iter, fits[1].converged)
    np.testing.assert_allclose(fits[0].weights, fits[1].weights, rtol=0, atol=1e-8)


def test_gblup_kernels_ai_reml_on_card_matches_cpu(dev):
    """GBLUPad's AI-REML (f64, sample space) on the card against the CPU:
    sigma2, Py and the test predictions rtol 1e-5."""
    from janusx_tpu_torch.gs.blup import fit_gblup_kernels, predict_gblup_kernels
    from janusx_tpu_torch.models.grm import grm_from_packed

    pg, _, Y, _ = _scan_problem(3000, 300, 1)
    Ks = {"add": grm_from_packed(pg, device="cpu"), "dom": grm_from_packed(pg, method=3, device="cpu")}
    train, test = np.arange(240), np.arange(240, 300)
    card, cpu = (fit_gblup_kernels(Ks, Y[:, 0], train, device=d) for d in (dev, "cpu"))
    for k in cpu.sigma2:
        assert card.sigma2[k] == pytest.approx(cpu.sigma2[k], rel=1e-5)
    np.testing.assert_allclose(card.Py, cpu.Py, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(predict_gblup_kernels(card, Ks, test),
                               predict_gblup_kernels(cpu, Ks, test), rtol=1e-5)


@pytest.mark.parametrize("method", [1, 2, 3])
def test_grm_strip_on_card_matches_cpu(dev, method):
    """A -part strip of the GRM on the card against the CPU: rtol 1e-6 with
    the floor 1e-6 x max|K| (tests/test_torch_grm.py)."""
    from janusx_tpu_torch.models.grm import grm_strip_from_packed

    pg, _, _, _ = _scan_problem(3000, 300, 1)
    rows = np.arange(40, 170)
    card, cpu = (grm_strip_from_packed(pg, rows, method=method, block=512, device=d)
                 for d in (dev, "cpu"))
    np.testing.assert_allclose(card, cpu, rtol=1e-6, atol=1e-6 * np.abs(cpu).max())


def test_rsvd_pass_and_pca_on_card_match_cpu(dev):
    """One RSVD pass A'(A V) on the card against the CPU (f32 sums in two
    orders: rtol 1e-4 with the floor 1e-4 x max), and rsvd_pca's
    eigenvalues rtol 1e-4 with the same seed."""
    from janusx_tpu_torch.models.grm import _snp_scales
    from janusx_tpu_torch.models.pca import _rsvd_av, rsvd_pca
    from janusx_tpu_torch.utils import devcache

    pg, _, _, _ = _scan_problem(3000, 300, 1)
    _, inv_sd, _ = _snp_scales(pg, 2)
    shape = (-(-pg.m // 512), 512)
    V = np.random.default_rng(1).normal(size=(384, 12)).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        pk = devcache.device_packed_blocks(pg, shape, d, lane_align=128)
        mn = devcache.to_device_blocks(pg.mean, shape, 0.0, torch.float32, d)
        iv = devcache.to_device_blocks(inv_sd, shape, 0.0, torch.float32, d)
        out[d.type] = _rsvd_av(pk, mn, iv, torch.as_tensor(V, device=d)).cpu().numpy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4,
                               atol=1e-4 * np.abs(out["cpu"]).max())
    (vc, _), (vh, _) = (rsvd_pca(pg, n_pc=5, seed=2, block=512, device=d) for d in (dev, "cpu"))
    np.testing.assert_allclose(vc, vh, rtol=1e-4)


def test_king_tile_pair_on_card_matches_cpu(dev):
    """KING's tile pair on the card: the indicator products are exact
    integer counts in f32 with TF32 off, so φ and the thresholded pairs
    equal the CPU's exactly; the dense kinship too."""
    from janusx_tpu_torch.models.king import king_kinship, king_related_pairs

    pg, _, _, _ = _scan_problem(3000, 300, 1)
    pg.packed[:, 1] = pg.packed[:, 0]  # samples 4-7 duplicate samples 0-3
    card, cpu = (king_related_pairs(pg, tile=128, block=512, device=d) for d in (dev, "cpu"))
    assert len(cpu[0]) >= 4
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(king_kinship(pg, block=512, device=dev),
                                  king_kinship(pg, block=512, device="cpu"))


def test_joint_chunk_and_combo_scan_on_card_match_cpu(dev, monkeypatch):
    """The batched joint GLS of ``jx fvlmm2 -i`` in f64 on the card
    against the CPU (rtol 1e-10), and the combo scan at the same basis
    and null λ: beta, se and p rtol 1e-6."""
    from janusx_tpu_torch.core import reml
    from janusx_tpu_torch.models import combo

    rng = np.random.default_rng(4)
    n, p, B = 300, 3, 64
    args = [rng.normal(size=(B, 3, n)), np.column_stack([np.ones(n), rng.normal(size=(n, 2))]),
            rng.normal(size=n), rng.uniform(0.5, 2.0, n)]
    card, cpu = (combo._joint_chunk(*(torch.as_tensor(a, device=d) for a in args), n, p)
                 for d in (dev, "cpu"))
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=1e-10)

    pg, basis, Y, cov = _scan_problem(3000, 300, 1)
    specs = [combo.ComboSpec(f"rs{i}{op}rs{i + 7}", f"rs{i}", op, f"rs{i + 7}", i, i + 7,
                             i % 3 == 0 and op != "*", i % 5 == 0 and op != "*")
             for i, op in zip(range(0, 40), "&|*^" * 10)]
    got, null = combo.fvlmm_joint_combo_scan(pg, basis, Y[:, 0], cov, specs, batch_size=16,
                                             device=dev)
    monkeypatch.setattr(reml, "fit_null_reml", lambda rot, *a, **k: null)
    want, _ = combo.fvlmm_joint_combo_scan(pg, basis, Y[:, 0], cov, specs, batch_size=16,
                                           device="cpu")
    for a, b in zip(got, want):
        for k in ("beta_combo_joint", "se_combo_joint", "p_combo_joint", "p_lit1_joint",
                  "p_lit2_joint"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)


def _gibbs_problem(dev, m=2048, n=1410, seed=5, C=128):
    """A sweep's operands as gs/bayes.py builds them, on the card: Zb, Gb,
    x2 of a standardized random panel (m SNPs, n samples) with a polygenic
    trait's residual r, and the chain's starting state and scalars
    (var_e, var_slab, pi, s0_b, vb_fill)."""
    rng = np.random.default_rng(seed)
    g = rng.binomial(2, rng.uniform(0.05, 0.5, m)[:, None], size=(m, n)).astype(np.float32)
    Z = (g - g.mean(1, keepdims=True)) / g.std(1, keepdims=True)
    y = Z.T @ rng.normal(0, 0.02, m) + rng.normal(size=n)
    nb = -(-m // C)
    Zt = torch.zeros((nb * C, n), device=dev)
    Zt[:m] = torch.as_tensor(Z, device=dev)
    Zb = Zt.view(nb, C, n)
    Gb = torch.bmm(Zb, Zb.transpose(1, 2))
    x2 = (Zb * Zb).sum(2)
    r = torch.as_tensor(y - y.mean(), dtype=torch.float32, device=dev)
    s0_b = 0.5 * float(y.var()) / float(x2.sum() / n) * 7.0
    scal = torch.tensor([0.5 * y.var(), s0_b / 7.0, 0.5, s0_b, s0_b / 7.0],
                        dtype=torch.float32, device=dev)
    return Zb, Gb, x2, r, scal


def _gibbs_draws(dev, shape, seed):
    g = torch.Generator().manual_seed(seed)
    rn, ru = torch.randn(shape, generator=g), torch.rand(shape, generator=g)
    rca = 2.0 * torch._standard_gamma(torch.full(shape, 3.0), generator=g)
    rci = 2.0 * torch._standard_gamma(torch.full(shape, 2.5), generator=g)
    return [t.to(dev) for t in (rn, ru, rca, rci)]


@pytest.mark.parametrize("method", ["B", "Cpi"])
def test_gibbs_sweep_marker_matches_plain(dev, method):
    """G1 against its plain version (the reference's per-marker loop) over
    3 sweeps with the same draws at m = 2,048, n = 1,410, each side carrying
    its own state: δ identical, β within rtol 1e-4 (floor 1e-4 x max|β|:
    the kernel sums Z1 r over the sample split and keeps the right-hand
    sides current marker by marker, so f32 sums run in other orders), the
    residual and var_b likewise; one launch per sweep."""
    Zb, Gb, x2, r, scal = _gibbs_problem(dev)
    nb, C, _ = Zb.shape
    beta = torch.zeros((nb, C), device=dev)
    var_b = torch.full((nb, C), float(scal[4]), device=dev)
    state = {"kernel": [beta, var_b, r], "plain": [beta.clone(), var_b.clone(), r.clone()]}
    kernels.reset_launches()
    for sweep in range(3):
        rn, ru, rca, rci = _gibbs_draws(dev, (nb, C), sweep)
        dk = kernels.gibbs_sweep_marker(Zb, Gb, x2, *state["kernel"][:2], rn, ru, rca, rci,
                                        state["kernel"][2], scal, method)
        dp = kernels.gibbs_sweep_marker_plain(Zb, Gb, x2, *state["plain"][:2], rn, ru, rca,
                                              rci, state["plain"][2], scal, method)
        torch.cuda.synchronize()
        assert torch.equal(dk, dp), f"sweep {sweep}: {int((dk != dp).sum())} δ differ"
        for got, want in zip(state["kernel"], state["plain"]):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    assert 0 < int(dk.sum()) < dk.numel()
    assert kernels.launch_counts()["gibbs_sweep_marker"] == 3
    assert kernels.launch_counts()["gibbs_sweep_block_mvn"] == 0


def test_gibbs_sweep_block_mvn_matches_plain(dev):
    """G2 against its plain version (torch.linalg.cholesky and three
    triangular solves per block, as the reference) over 3 sweeps with the
    same draws at m = 2,048, n = 1,410: β, var_b and the residual within
    rtol 1e-3 (floor 1e-3 x max: the kernel's Cholesky and its two fused
    solves round in another order); one launch per sweep."""
    Zb, Gb, x2, r, scal = _gibbs_problem(dev)
    nb, C, _ = Zb.shape
    beta = torch.zeros((nb, C), device=dev)
    var_b = torch.full((nb, C), float(scal[4]), device=dev)
    state = {"kernel": [beta, var_b, r], "plain": [beta.clone(), var_b.clone(), r.clone()]}
    kernels.reset_launches()
    for sweep in range(3):
        z, _, rchi, _ = _gibbs_draws(dev, (nb, C), sweep)
        kernels.gibbs_sweep_block_mvn(Zb, Gb, x2, *state["kernel"][:2], z, rchi,
                                      state["kernel"][2], scal)
        kernels.gibbs_sweep_block_mvn_plain(Zb, Gb, x2, *state["plain"][:2], z, rchi,
                                            state["plain"][2], scal)
        torch.cuda.synchronize()
        for got, want in zip(state["kernel"], state["plain"]):
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * float(want.abs().max()))
    assert kernels.launch_counts()["gibbs_sweep_block_mvn"] == 3
    assert kernels.launch_counts()["gibbs_sweep_marker"] == 0


@pytest.mark.parametrize("m,n,C", [(300, 97, 128), (40, 1410, 8), (1000, 5000, 128),
                                   (256, 41_000, 128), (130, 200_000, 128)])
def test_gibbs_sweeps_ragged_shapes(dev, m, n, C):
    """Both kernels at ragged shapes (a last block of padding markers, a
    last CTA with fewer samples, C < 128, more than one sample per thread
    of a CTA's slice), on each path of the serial pass (the cluster at n
    <= 1,936, the grid with the rows double buffered at n = 5,000) and past
    the samples whose slice fits in shared memory (on 132 SMs: G1's slice
    streamed in two chunks a CTA at n = 41,000, and both kernels' in four
    to six at n = 200,000): δ identical, values within their bounds."""
    Zb, Gb, x2, r, scal = _gibbs_problem(dev, m=m, n=n, seed=m, C=C)
    nb = Zb.shape[0]
    rn, ru, rca, rci = _gibbs_draws(dev, (nb, C), 1)
    out = {}
    for name, sweep in (("kernel", kernels.gibbs_sweep_marker),
                        ("plain", kernels.gibbs_sweep_marker_plain)):
        st = [torch.full((nb, C), 0.01, device=dev), torch.full((nb, C), float(scal[4]),
                                                                 device=dev), r.clone()]
        d = sweep(Zb, Gb, x2, st[0], st[1], rn, ru, rca, rci, st[2], scal, "B")
        mvn = [torch.zeros((nb, C), device=dev), st[1].clone(), r.clone()]
        (kernels.gibbs_sweep_block_mvn if name == "kernel"
         else kernels.gibbs_sweep_block_mvn_plain)(Zb, Gb, x2, mvn[0], mvn[1], rn, rca,
                                                    mvn[2], scal)
        out[name] = (d, st, mvn)
    torch.cuda.synchronize()
    assert torch.equal(out["kernel"][0], out["plain"][0])
    for got, want in zip(out["kernel"][1], out["plain"][1]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    for got, want in zip(out["kernel"][2], out["plain"][2]):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * float(want.abs().max()))


@pytest.mark.parametrize("m", [2048, 300])
def test_gibbs_mvn_prepass_matches_linalg(dev, m):
    """G2's pre-pass alone (phases=1) against the torch.linalg batch: each
    block's M = Cb⁻¹ within 1e-4 of torch.cholesky_inverse(cholesky(Cb))'s
    largest entry (f32 inverses of a well-conditioned Cb, ~1e-6 apart),
    padded to 128 x 128 with the identity's inverse; w = Cb⁻¹ G1 b_old +
    √σe² L⁻ᵀ z and the record's b_old, x2 and χ² draws against the plain
    mirror of the pre-pass, w within 1e-4 of its largest entry. At m = 300
    the last block is padding past marker 44."""
    Zb, Gb, x2, r, scal = _gibbs_problem(dev, m=m, seed=m)
    nb, C, _ = Zb.shape
    z, _, rchi, _ = _gibbs_draws(dev, (nb, C), 3)
    g = torch.Generator().manual_seed(m)
    beta = (0.01 * torch.randn((nb, C), generator=g)).to(dev) * (x2 > 0)
    var_b = (float(scal[4]) * (0.5 + torch.rand((nb, C), generator=g))).to(dev)
    sc = kernels.gibbs_scratch("mvn", nb, C, dev)
    kernels.gibbs_sweep_block_mvn(Zb, Gb, x2, beta, var_b, z, rchi, r, scal, phases=1,
                                  scratch=sc)
    torch.cuda.synchronize()
    rec = sc["rec"].view(nb, kernels.gibbs_record_floats("mvn"))
    K = kernels.GIBBS_CMAX
    M, w, bo, xx, chi = (rec[:, :K * K].view(nb, K, K), *rec[:, K * K:].view(nb, 4, K).unbind(1))
    dinv = torch.where(x2 > 0, scal[0] / var_b.clamp_min(1e-12), 1.0)
    Cb = Gb + torch.diag_embed(dinv) + 1e-4 * torch.eye(C, device=dev)
    want = torch.cholesky_inverse(torch.linalg.cholesky(Cb))
    for b in range(nb):
        err = float((M[b] - want[b]).abs().max())
        assert err <= 1e-4 * float(want[b].abs().max()), f"block {b}: M off by {err:.3g}"
    _, w_ref = kernels.gibbs_block_mvn_prepass_plain(Gb, x2, beta, var_b, z, scal)
    torch.testing.assert_close(w, w_ref, rtol=1e-4, atol=1e-4 * float(w_ref.abs().max()))
    assert torch.equal(bo, beta) and torch.equal(xx, x2) and torch.equal(chi, rchi)


def _gibbs_start(dev, n, m, seed=2):
    """A sweep's problem of n samples and m markers, its draws and a fixed
    start [β, var_b, r]."""
    Zb, Gb, x2, r, scal = _gibbs_problem(dev, m=m, n=n, seed=n)
    nb, C, _ = Zb.shape
    start = [torch.full((nb, C), 0.01, device=dev),
             torch.full((nb, C), float(scal[4]), device=dev), r]
    return (Zb, Gb, x2, scal), _gibbs_draws(dev, (nb, C), seed), start


def _gibbs_sweep_from(kind, fn, problem, draws, start):
    """One sweep of ``fn`` (the kernel or its plain version) from a copy of
    ``start``: (δ or None, [β, var_b, r])."""
    Zb, Gb, x2, scal = problem
    rn, ru, rca, rci = draws
    st = [t.clone() for t in start]
    if kind == "marker":
        return fn(Zb, Gb, x2, st[0], st[1], rn, ru, rca, rci, st[2], scal, "B"), st
    fn(Zb, Gb, x2, st[0], st[1], rn, rca, st[2], scal)
    return None, st


_GIBBS_FNS = {"marker": (kernels.gibbs_sweep_marker, kernels.gibbs_sweep_marker_plain),
              "mvn": (kernels.gibbs_sweep_block_mvn, kernels.gibbs_sweep_block_mvn_plain)}


@pytest.mark.parametrize("kind", ["marker", "mvn"])
def test_gibbs_cluster_path_matches_grid_path(dev, kind):
    """Both paths of the serial pass at the crossover: one sweep at n_c
    (the largest n on the cluster path, a non-portable cluster of more
    than 8 CTAs) and one at n_c + 1 (the cooperative grid), each against
    the plain version from the same state and draws: δ identical, values
    within rtol 1e-4 (G1) / 1e-3 (G2) as the other sweep tests."""
    n_c = kernels.gibbs_cluster_limit(kind)
    assert kernels.gibbs_plan(kind, n_c, 128)["path"] == "cluster"
    assert kernels.gibbs_plan(kind, n_c, 128)["P"] > 8
    assert kernels.gibbs_plan(kind, n_c + 1, 128)["path"] == "grid"
    rtol = 1e-4 if kind == "marker" else 1e-3
    kernel, plain = _GIBBS_FNS[kind]
    for n in (n_c, n_c + 1):
        prob = _gibbs_start(dev, n, 640)
        dk, got = _gibbs_sweep_from(kind, kernel, *prob)
        dp, want = _gibbs_sweep_from(kind, plain, *prob)
        torch.cuda.synchronize()
        if kind == "marker":
            assert torch.equal(dk, dp), f"n = {n}: δ differ"
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=rtol, atol=rtol * float(w.abs().max()))


@pytest.mark.parametrize("kind", ["marker", "mvn"])
def test_gibbs_sweeps_repeat_bit_for_bit(dev, kind):
    """Every CTA sums the partials in one fixed order, so a sweep is a
    function of its inputs: 100 sweeps from the same state and draws on
    each path (the cluster at n_c, the grid at n_c + 1; 50 blocks) give
    the same δ, β, var_b and r to the last bit. A race between a block's
    exchange, its copies of the next block's rows and record and the
    reads of them would show here."""
    n_c = kernels.gibbs_cluster_limit(kind)
    kernel = _GIBBS_FNS[kind][0]
    for n in (n_c, n_c + 1):
        prob = _gibbs_start(dev, n, 6400)
        d0, first = _gibbs_sweep_from(kind, kernel, *prob)
        for i in range(100):
            d, st = _gibbs_sweep_from(kind, kernel, *prob)
            same = all(torch.equal(a, b) for a, b in zip(st, first))
            assert same and (d0 is None or torch.equal(d, d0)), f"n = {n}: repeat {i} differs"


def test_gibbs_wrapper_raises_when_the_build_fails(dev, monkeypatch):
    """A CUDA tensor never takes the plain version: with no library to
    load, the wrapper raises."""
    Zb, Gb, x2, r, scal = _gibbs_problem(dev, m=64, n=100)
    nb, C, _ = Zb.shape
    draws = _gibbs_draws(dev, (nb, C), 0)
    state = [torch.zeros((nb, C), device=dev), torch.ones((nb, C), device=dev)]

    def no_nvcc():
        raise RuntimeError("nvcc failed")

    kernels._lib.cache_clear()
    monkeypatch.setattr(kernels, "build", no_nvcc)
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            kernels.gibbs_sweep_marker(Zb, Gb, x2, *state, *draws, r, scal, "B")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            kernels.gibbs_sweep_block_mvn(Zb, Gb, x2, *state, draws[0], draws[2], r, scal)
    finally:
        kernels._lib.cache_clear()


def test_bayes_fit_on_card(dev):
    """bayes_fit on the card: every sweep through G1 or G2 (launches equal
    the iterations), finite effects, and the generator's draws repeat with
    the seed."""
    from janusx_tpu_torch.gs.bayes import bayes_fit

    rng = np.random.default_rng(8)
    n, m = 300, 700
    Z = rng.normal(size=(n, m)).astype(np.float32)
    y = Z @ rng.normal(0, 0.05, m) + rng.normal(size=n)
    for method, wrapper in (("BayesA", kernels.gibbs_sweep_block_mvn),
                            ("BayesB", kernels.gibbs_sweep_marker),
                            ("BayesCpi", kernels.gibbs_sweep_marker)):
        kernels.reset_launches()
        b1, mu1, tr = bayes_fit(Z, y, method, n_iter=30, burnin=10, seed=4, device=dev,
                                return_trace=True)
        counts = kernels.launch_counts()
        assert counts[wrapper.__name__] == 30 and sum(counts.values()) == 30
        b2, mu2 = bayes_fit(Z, y, method, n_iter=30, burnin=10, seed=4, device=dev)
        assert np.isfinite(b1).all() and np.isfinite(tr).all() and tr.shape == (30, 2)
        np.testing.assert_array_equal(b1, b2)
        assert mu1 == mu2


@pytest.mark.parametrize("solver", ["adam-em", "adam"])
def test_train_admixture_on_card_matches_cpu(dev, solver):
    """``jx fastpop``'s fit on the card against the CPU with the same seed:
    Q and P within atol 1e-4 after 10 iterations (f32 sums in another
    order; the CPU tests hold the CPU to the reference at the same bound)."""
    from janusx_tpu_torch.models.fastpop import train_admixture

    pg, _, _, _ = _scan_problem(3000, 300, 1)
    card, cpu = (train_admixture(pg, 3, n_iter=10, solver=solver, seed=2, block=512, device=d)
                 for d in (dev, "cpu"))
    assert card.n_iter == cpu.n_iter == 10
    np.testing.assert_allclose(card.Q, cpu.Q, rtol=0, atol=1e-4)
    np.testing.assert_allclose(card.P, cpu.P, rtol=0, atol=1e-4)


def test_ibs_distance_on_card_is_the_cpu_to_the_last_bit(dev):
    """``jx tree``'s IBS distance: integer counts, exact in f32 with TF32
    off, so the card equals the CPU bit for bit."""
    from janusx_tpu_torch.models.tree import ibs_distance

    pg, _, _, _ = _scan_problem(3000, 300, 1)
    np.testing.assert_array_equal(ibs_distance(pg, block=512, device=dev),
                                  ibs_distance(pg, block=512, device="cpu"))


def _garfield_problem(m, n):
    """A packed panel with 2 % missing calls at an n that is not a multiple
    of 4, and a trait carrying an AND of two markers' hom-alt indicators."""
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes

    rng = np.random.default_rng(12)
    g = rng.binomial(2, rng.uniform(0.25, 0.6, m)[:, None], size=(m, n)).astype(np.int8)
    g[rng.random((m, n)) < 0.02] = -1
    site = dict(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1) * 10,
                snp=np.array([f"rs{i}" for i in range(m)], object),
                allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    pg = pack_genotypes(GenotypeData(g, SiteInfo(**site), np.array(
        [f"i{j}" for j in range(n)], object)), QcParams(maf=0.05, geno=0.1))
    d = pg.dosages()
    y = 2.0 * ((d[10] == 2) & (d[40] == 2)) + rng.normal(size=n) * 0.8
    return pg, y


def test_garfield_hom_alt_matrix_on_card(dev):
    """B built on the card from the packed codes equals the host decode."""
    from janusx_tpu_torch.models.garfield import hom_alt_matrix

    pg, _ = _garfield_problem(3000, 1410 - 3)
    B = hom_alt_matrix(pg, device=dev)
    assert B.device == torch.device(dev)
    np.testing.assert_array_equal(B.cpu().numpy(), (pg.dosages() == 2).astype(np.float32))


@pytest.mark.parametrize("mode", ["corr", "mcc"])
def test_garfield_extensions_on_card_match_cpu(dev, mode):
    """The extension scores and each (seed, op)'s top-k at m = 20,000 on the
    card against the same call on the CPU: supports exact, scores rtol 1e-5,
    the same top-k indices wherever the k-th and (k+1)-th scores are more
    than 1e-6 apart (relative)."""
    from janusx_tpu_torch.models import garfield as gf

    rng = np.random.default_rng(3)
    m, n, S, k = 20_000, 1410, 64, 4
    B = (rng.random((m, n)) < 0.2).astype(np.float32)
    seeds = (rng.random((S, n)) < 0.3).astype(np.float32)
    t = rng.normal(size=n) if mode == "corr" else (rng.random(n) < 0.3).astype(float)
    t2sum = float(t @ t) if mode == "corr" else float(t.sum())
    out = {}
    for d in (dev, "cpu"):
        Bd, td = torch.as_tensor(B, device=d), torch.as_tensor(t, dtype=torch.float32, device=d)
        sd = torch.as_tensor(seeds, device=d)
        mark = gf._marker_sums(Bd, td)
        ext = gf._extension_scores(sd, Bd, td, t2sum, float(n), mode, mark)
        top = gf._extension_top(sd, Bd, td, t2sum, float(n), mode, mark, 5, k + 1)
        out[str(d)] = ({op: (s.cpu().numpy(), c.cpu().numpy()) for op, (s, c) in ext.items()},
                       top)
    (ec, (sc, ic)), (eh, (sh, ih)) = out[str(dev)], out["cpu"]
    for op in gf._OPS:
        np.testing.assert_array_equal(ec[op][1], eh[op][1])
        np.testing.assert_allclose(ec[op][0], eh[op][0], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(sc, sh, rtol=1e-5)
    clear = np.abs(sh[..., k - 1] - sh[..., k]) > 1e-6 * np.abs(sh[..., k - 1])
    np.testing.assert_array_equal(np.sort(ic[..., :k], -1)[clear], np.sort(ih[..., :k], -1)[clear])
    assert clear.mean() > 0.5


def test_garfield_scan_on_card_matches_cpu(dev):
    """One ``garfield_scan`` (depth 2, beam 64, 10 permutations) on the card
    and on the CPU from the same seed: rule scores and permutation maxima
    rtol 1e-5, the same p-values, the same rules off ties (within 1e-6): the
    same indicator vector ("NOT a AND NOT b" is "NOT b AND NOT a"), or its
    complement for a literal or an XOR, which scores alike."""
    from janusx_tpu_torch.models.garfield import garfield_scan

    pg, y = _garfield_problem(3000, 1410 - 3)
    card, cpu = (garfield_scan(pg, y, depth=2, beam=64, n_perm=10, seed=1, device=d)
                 for d in (dev, "cpu"))
    sc, sh = (np.array([r.score for r in res.rules]) for res in (card, cpu))
    np.testing.assert_allclose(sc, sh, rtol=1e-5)
    np.testing.assert_allclose(card.perm_max_scores, cpu.perm_max_scores, rtol=1e-5)
    np.testing.assert_array_equal(card.pvalues, cpu.pvalues)
    H = (pg.dosages() == 2).astype(np.uint8)

    def vec(ru):
        v = 1 - H[ru.snps[0]] if ru.ops[0] == "NOT" else H[ru.snps[0]]
        for op, j in zip(ru.ops[1:], ru.snps[1:]):
            v = v & H[j] if op == "AND" else v & (1 - H[j]) if op == "ANDN" else v ^ H[j]
        return v

    n_off = 0
    for i, s in enumerate(sh):
        if np.all(np.abs(np.delete(sh, i) - s) > 1e-6 * s):
            a, b = vec(card.rules[i]), vec(cpu.rules[i])
            twin = all(op == "XOR" for op in cpu.rules[i].ops[1:])
            assert np.array_equal(a, b) or (twin and np.array_equal(a, 1 - b)), (
                card.rules[i], cpu.rules[i])
            n_off += 1
    assert n_off > 0 and {10, 40} == set(cpu.rules[0].snps)


def test_tom_on_card_matches_cpu(dev):
    """The WGCNA correlation and TOM on the card against the CPU: rtol 1e-5
    / atol 1e-6 at 2,000 genes."""
    from janusx_tpu_torch.gtools.wgcna import _device_corr, tom

    rng = np.random.default_rng(4)
    X = rng.normal(size=(400, 8))[:, rng.integers(0, 8, 2000)] + rng.normal(size=(400, 2000))
    C = {str(d): _device_corr(X, device=d) for d in (dev, "cpu")}
    np.testing.assert_allclose(C[str(dev)], C["cpu"], rtol=1e-5, atol=1e-6)
    A = np.abs(C["cpu"]) ** 6
    np.testing.assert_allclose(tom(A, device=dev), tom(A, device="cpu"), rtol=1e-5, atol=1e-6)


def test_assoc_lmm_on_card_matches_cpu(dev):
    """``ASSOC("lmm")._assoc_arrays`` on the card against the CPU: the null
    λ rtol 1e-6 and Δ(-log10 p) <= 5e-3 (tests/test_scans.py:155)."""
    from janusx_tpu_torch.api import ASSOC

    pg, basis, Y, _ = _scan_problem(3000, 300, 1)
    G = pg.dosages().T.astype(np.float64)
    G[G < 0] = np.nan
    K = basis.U @ np.diag(basis.S) @ basis.U.T
    card, cpu = (ASSOC("lmm", device=d).fit(Y[:, 0], K=K) for d in (dev, "cpu"))
    assert card.null_fit_["lambda"] == pytest.approx(cpu.null_fit_["lambda"], rel=1e-6)
    pc, ph = card._assoc_arrays(G)[2], cpu._assoc_arrays(G)[2]
    assert np.isfinite(pc).all()
    assert np.abs(np.log10(pc) - np.log10(ph)).max() <= 5e-3


@pytest.fixture
def sim_panel(tmp_path, monkeypatch):
    """``jx sim`` of the port: 150 samples (half in families) x 1,500 SNPs,
    2 % missing calls."""
    from janusx_tpu_torch.cli.main import main

    monkeypatch.setenv("JX_TPU_HISTORY_DB", "0")
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    assert main(["sim", "-nind", "150", "-nsnp", "1500", "-nchr", "2", "-structure", "mixed",
                 "-miss", "0.02", "-seed", "5", "-o", str(tmp_path), "-prefix", "sim"]) == 0
    return str(tmp_path / "sim")


def _on(monkeypatch, plat, argv):
    from janusx_tpu_torch.cli.main import main

    monkeypatch.setenv("JX_TPU_PLATFORM", plat)
    assert main(argv) == 0


def test_hybrid_predict_on_card_matches_cpu(dev, sim_panel, tmp_path, monkeypatch):
    """``jx hybrid`` predict (GRM, GBLUP fit and marker effects on the
    device) on the card against the CPU: every cross within rtol 1e-4 /
    atol 1e-6 of its printed value, one unit of the %.4f print apart at
    most."""
    got = {}
    for plat in ("cuda", "cpu"):
        _on(monkeypatch, plat, ["hybrid", "-bfile", sim_panel, "-p", sim_panel + ".pheno",
                                "-top", "0", "-o", str(tmp_path), "-prefix", plat])
        with open(tmp_path / f"{plat}.hybrid.tsv") as fh:
            next(fh)
            got[plat] = {(a, b): float(v) for a, b, v in (ln.split("\t") for ln in fh)}
    assert sorted(got["cuda"]) == sorted(got["cpu"]) and len(got["cpu"]) == 150 * 149 // 2
    a, b = (np.array([got[p][k] for k in sorted(got["cpu"])]) for p in ("cuda", "cpu"))
    units = np.abs(np.rint(a * 1e4) - np.rint(b * 1e4))  # in units of the print
    assert np.all(units <= np.maximum(1.0, 1e4 * (1e-6 + 1e-4 * np.abs(b))))


def test_gformat_prune_on_card_matches_cpu(dev, sim_panel, tmp_path, monkeypatch):
    """``jx gformat -prune`` (r² chunks on the device, the greedy walk on the
    host) keeps the same SNPs on the card as on the CPU, with a count and a
    kb window, at a threshold that drops SNPs."""
    for window in (("50", "5", "0.05"), ("300kb", "3", "0.05")):
        kept = {}
        for plat in ("cuda", "cpu"):
            _on(monkeypatch, plat, ["gformat", "-bfile", sim_panel, "-prune", *window, "-o",
                                    str(tmp_path), "-prefix", plat])
            kept[plat] = (tmp_path / f"{plat}.bim").read_text()
        assert kept["cuda"] == kept["cpu"]
        assert 0 < kept["cpu"].count("\n") < 1500


def test_ggval_gwas_on_card(dev, tmp_path, monkeypatch, capsys):
    """``jx ggval gwas gs`` on the card: every check PASS, with K1 and K2
    launched inside its ``jx gwas -lmm``."""
    from janusx_tpu_torch.cli.main import main

    monkeypatch.setenv("JX_TPU_PLATFORM", "cuda")
    monkeypatch.setenv("JX_TPU_HISTORY_DB", "0")
    kernels.reset_launches()
    assert main(["ggval", "gwas", "gs", "-nind", "120", "-nsnp", "300", "-o",
                 str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "12/12 checks passed" in out and "FAIL" not in out
    launches = kernels.launch_counts()
    assert launches["decode_rotate"] > 0 and launches["grid_neg_reml_lattice"] > 0


# ------------------------------------------------------------- the mesh
def _mesh_problem():
    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.models.grm import grm_from_packed

    pg, _, Y, cov = _scan_problem(5000, 300, 3)
    K = grm_from_packed(pg, device="cpu")
    return pg, eigh_grm(K, diag_ridge=1e-6), Y, cov, K


def test_mesh_two_shards_on_one_card(dev):
    """A mesh of two shards on the one card (Mesh([cuda:0, cuda:0])):
    lmm_scan and lmm_scan_multi launch K1 and K2 once per shard per
    superblock and agree with the single-device scans within beta rtol
    2e-3 / atol 1e-6 and Δ(-log10 p) < 5e-3 (tests/test_sharding.py:82-84);
    the sharded GRM within rtol 1e-5 / atol 1e-5 of one device's
    (tests/test_sharding.py:46)."""
    from janusx_tpu_torch.models import grm, lmm
    from janusx_tpu_torch.parallel.mesh import Mesh

    pg, basis, Y, cov, K = _mesh_problem()
    mesh = Mesh([dev, dev])
    np.testing.assert_allclose(grm.grm_from_packed(pg, mesh=mesh), K, rtol=1e-5, atol=1e-5)
    one, _ = lmm.lmm_scan(pg, basis, Y[:, 0], cov, block=512, superblock=2048, device=dev)
    kernels.reset_launches()
    two, _ = lmm.lmm_scan(pg, basis, Y[:, 0], cov, block=512, superblock=2048, mesh=mesh)
    sb = -(-pg.m // 2048)
    counts = kernels.launch_counts()
    assert counts["decode_rotate"] == counts["grid_neg_reml_lattice"] == 2 * sb
    _close_sharded(one, two)
    multi1, _ = lmm.lmm_scan_multi(pg, basis, Y, cov, block=512, device=dev)
    kernels.reset_launches()
    multi2, _ = lmm.lmm_scan_multi(pg, basis, Y, cov, block=512, mesh=mesh)
    counts = kernels.launch_counts()
    assert counts["decode_rotate"] == counts["grid_neg_reml_lattice"] == 2
    for a, b in zip(multi1, multi2):
        _close_sharded(a, b)


def _close_sharded(a, b):
    np.testing.assert_allclose(b.beta, a.beta, rtol=2e-3, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(b.se, a.se, rtol=2e-3, atol=1e-6, equal_nan=True)
    assert np.nanmax(np.abs(np.log10(b.pwald) - np.log10(a.pwald))) < 5e-3


def _all_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    from janusx_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(torch.cuda.device_count())


def test_mesh_over_every_card_matches_one_card(dev):
    """make_mesh over every card: each shard's K1/K2 launch on its own
    card, the scans within the two-shard test's bounds of one card's, the
    GRM within rtol 1e-5 / atol 1e-5."""
    from janusx_tpu_torch.models import grm, lmm

    mesh = _all_cards()
    pg, basis, Y, cov, K = _mesh_problem()
    np.testing.assert_allclose(grm.grm_from_packed(pg, mesh=mesh), K, rtol=1e-5, atol=1e-5)
    one, _ = lmm.lmm_scan(pg, basis, Y[:, 0], cov, block=512, device=dev)
    kernels.reset_launches()
    many, _ = lmm.lmm_scan(pg, basis, Y[:, 0], cov, block=512, mesh=mesh)
    assert kernels.launch_counts()["decode_rotate"] == mesh.size
    _close_sharded(one, many)


def test_run_gwas_over_every_card_matches_one_card(dev, tmp_path, monkeypatch):
    """``jx gwas -lm -lmm -fvlmm`` with JX_TPU_DEVICES unset (every card)
    against JX_TPU_DEVICES=1: Δ(-log10 p) <= 5e-3 (tests/test_sharding.py:145)."""
    from janusx_tpu_torch.io.plink import write_plink
    from janusx_tpu_torch.workflows.gwas import GwasConfig, run_gwas

    mesh = _all_cards()
    pg, _, Y, _, _ = _mesh_problem()
    geno = str(tmp_path / "toy")
    write_plink(geno, pg.packed, pg.n_samples, pg.sites, pg.samples)
    with open(tmp_path / "toy.pheno", "wt") as fh:
        fh.write("id\tt1\n" + "".join(f"{s}\t{v:.6f}\n" for s, v in zip(pg.samples, Y[:, 0])))
    monkeypatch.setenv("JX_TPU_PLATFORM", "cuda")
    monkeypatch.setenv("JX_TPU_HISTORY_DB", "0")
    common = dict(genotype=geno + ".bed", phenotype=str(tmp_path / "toy.pheno"),
                  models=("lm", "lmm", "fvlmm"), force_model=True, use_cache=False)
    monkeypatch.setenv("JX_TPU_DEVICES", "1")
    one = run_gwas(GwasConfig(out_prefix=str(tmp_path / "one"), **common))
    monkeypatch.delenv("JX_TPU_DEVICES")
    many = run_gwas(GwasConfig(out_prefix=str(tmp_path / "many"), **common))
    assert mesh.size >= 2
    for a, b in zip(one, many):
        dl = np.abs(np.log10(a.result.pwald) - np.log10(b.result.pwald))
        assert np.nanmax(dl) <= 5e-3, a.model
