"""Port parity of the multi-device path, case by case with the reference's
tests/test_sharding.py.

The port's mesh is ``Mesh([cpu] * 8)``: eight shards on the one CPU (the
twin of conftest's eight virtual CPU devices). Each case compares the
port's sharded result twice, at the reference test's own tolerances:
with the port's single-device result, and with the reference's sharded
result on its ``mesh8`` (eight virtual CPU devices) in the same process.
The run_gwas/run_gs cases patch ``parallel.mesh.visible_devices`` to
eight ``cpu`` devices, so the workflows build their mesh as on a host
with eight cards. Eight shards issue eight times as many small torch ops
as one device; beside the suite's other workers, torch's intra-op
threads then oversubscribe the CPU (the multilocus case ran 655 s instead
of 10), so this module runs torch on one thread.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from janusx_tpu.parallel.mesh import make_mesh as j_make_mesh
from janusx_tpu_torch import interop
from janusx_tpu_torch.parallel import mesh as tmesh_mod
from janusx_tpu_torch.parallel.mesh import Mesh


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return j_make_mesh(8)


@pytest.fixture(scope="module")
def tmesh8():
    return Mesh(["cpu"] * 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("JX_TPU_HISTORY_DB", "0")
    monkeypatch.delenv("JX_TPU_DEVICES", raising=False)


@pytest.fixture
def eight_devices(monkeypatch):
    """The port's workflows see eight devices (the seam a host with eight
    cards fills)."""
    monkeypatch.setattr(tmesh_mod, "visible_devices", lambda: [torch.device("cpu")] * 8)


def _close(a, b, rtol=2e-3, atol=1e-6, bound=5e-3, what=""):
    """beta within rtol/atol and Δ(-log10 p) < bound over the finite
    p-values (tests/test_sharding.py's ``close``)."""
    np.testing.assert_allclose(b.beta, a.beta, rtol=rtol, atol=atol, equal_nan=True,
                               err_msg=what)
    ok = np.isfinite(a.pwald) & np.isfinite(b.pwald) & (a.pwald > 0)
    dlogp = np.abs(np.log10(b.pwald[ok]) - np.log10(a.pwald[ok]))
    assert np.nanmax(dlogp) < bound, (what, np.nanmax(dlogp))


def _close_ref(ref, port, atol=1e-6, what="", beta=True):
    """The port's sharded result against the reference's sharded one:
    _close, at the reference test's tolerances. On the λ-grid LMM routes
    (``beta=False``) the two packages' f32 lattices sum in another order,
    so a near-tie lane's λ* may sit one grid cell apart and move a beta
    of ~0 by more than atol (ROADMAP queue 3): those are held to the
    reference test's p-parity contract, Δ(-log10 p) < 5e-3, with the same
    NaN lanes (test_production_scans_sharded also holds their λ* by the
    lattice bound of tests/test_pallas.py:102-110). FarmCPU's QTN
    lanes carry a beta of 0/0 in f32 (the QTN is its own covariate): with
    ``beta=None`` only their finite p-values are compared.
    (tests/test_torch_farmcpu.py)."""
    if beta:
        _close(ref, port, atol=atol, what=what)
        return
    if beta is not None:
        np.testing.assert_array_equal(np.isnan(port.beta), np.isnan(ref.beta), err_msg=what)
    ok = np.isfinite(ref.pwald) & np.isfinite(port.pwald) & (ref.pwald > 0)
    dlogp = np.abs(np.log10(port.pwald[ok]) - np.log10(ref.pwald[ok]))
    assert np.nanmax(dlogp) < 5e-3, (what, np.nanmax(dlogp))


def _toy_both(rng, m=500, n=96):
    """tests/test_sharding.py's _toy_pg, packed by both packages."""
    from janusx_tpu.io.gdata import GenotypeData as JG, SiteInfo as JS
    from janusx_tpu.io.packed import QcParams as JQ, pack_genotypes as j_pack
    from janusx_tpu_torch.io.gdata import GenotypeData as TG, SiteInfo as TS
    from janusx_tpu_torch.io.packed import QcParams as TQ, pack_genotypes as t_pack

    g = rng.binomial(2, rng.uniform(0.05, 0.5, size=(m, 1)), size=(m, n)).astype(np.int8)
    site = dict(chrom=np.array(["1"] * m, object), pos=np.arange(m, dtype=np.int64) + 1,
                snp=np.array([f"s{i}" for i in range(m)], object),
                allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    samples = np.array([f"i{j}" for j in range(n)], object)
    return (j_pack(JG(g, JS(**site), samples), JQ(maf=0.01)),
            t_pack(TG(g, TS(**site), samples), TQ(maf=0.01)))


# ---------------------------------------------------------------------------
# the sharding primitives
# ---------------------------------------------------------------------------
def test_sharded_grm_matches_single_device(mesh8, tmesh8, rng):
    from janusx_tpu.io import bitcodec
    from janusx_tpu.ops import decode
    from janusx_tpu_torch.ops import decode as tdecode
    from janusx_tpu_torch.parallel.mesh import shard_snp_block

    m, n = 256, 96
    codes = rng.integers(0, 3, size=(m, n)).astype(np.uint8)
    packed = decode.pad_packed_cols(bitcodec.pack_codes(codes))
    mean = codes.mean(axis=1).astype(np.float32)

    def kfn(pk, mn):
        c = tdecode.decode_centered(pk, mn, torch.float32)
        return c.T @ c

    K1 = kfn(torch.as_tensor(packed), torch.as_tensor(mean)).numpy()
    # SNP-sharded: each shard's partial product, summed
    K8 = sum(kfn(a, b) for a, b in zip(shard_snp_block(tmesh8, packed),
                                       shard_snp_block(tmesh8, mean))).numpy()
    np.testing.assert_allclose(K8, K1, rtol=1e-5, atol=1e-5)

    def jfn(pk, mn):
        c = decode.decode_centered(pk, mn, dtype=jnp.float32)
        return jnp.dot(c.T, c, precision=jax.lax.Precision.HIGHEST)

    Kj = np.asarray(jax.jit(jfn)(jax.device_put(packed, NamedSharding(mesh8, P("snp", None))),
                                 jax.device_put(mean, NamedSharding(mesh8, P("snp")))))
    np.testing.assert_allclose(K8[:n, :n], Kj[:n, :n], rtol=1e-5, atol=1e-5)


def test_sharded_lmm_scan_matches_single_device(mesh8, tmesh8):
    from janusx_tpu.core import reml as jreml
    from janusx_tpu.core.spectral import eigh_grm
    from janusx_tpu_torch.core import reml as treml
    from janusx_tpu_torch.parallel.mesh import shard_snp_block

    rng = np.random.default_rng(2)
    m, n = 64, 80
    G = rng.binomial(2, 0.3, size=(m, n)).astype(np.float64)
    Gc = G - G.mean(axis=1, keepdims=True)
    basis = eigh_grm(Gc.T @ Gc / m, diag_ridge=1e-6)
    y = rng.normal(size=n)
    Gr_host = (Gc @ basis.U).astype(np.float64)

    rot = treml.make_rotated(interop.basis_from_numpy(basis), y, None, device="cpu")
    grid = treml.make_grid(256, "cpu")

    def scan_fn(Gr):
        sh = treml.grid_shared(rot, grid)
        lgs = treml.lmm_grid_scan_with(sh, rot, Gr)
        beta, se = treml.beta_se_snp_batch(lgs, rot, Gr)
        return lgs, beta, se

    l1, b1, s1 = (x.numpy() for x in scan_fn(torch.as_tensor(Gr_host)))
    l8, b8, s8 = (torch.cat(x).numpy() for x in
                  zip(*(scan_fn(g) for g in shard_snp_block(tmesh8, Gr_host))))

    jrot = jreml.make_rotated(basis, y, None)
    jgrid = jnp.asarray(np.linspace(-5, 5, 256))

    def jscan(Gr):
        sh = jreml.grid_shared(jrot, jgrid)
        lgs = jreml.lmm_grid_scan_with(sh, jrot, Gr)
        beta, se = jreml.beta_se_snp_batch(lgs, jrot, Gr)
        return lgs, beta, se

    lj, bj, sj = (np.asarray(x) for x in jax.jit(jscan)(
        jax.device_put(Gr_host, NamedSharding(mesh8, P("snp", None)))))
    # f32 grid grams: lanes agree at f32-gram noise, λ* within a grid
    # spacing on near-tie cells (tests/test_sharding.py:77-84)
    for want_l, want_b, want_s in ((l1, b1, s1), (lj, bj, sj)):
        np.testing.assert_allclose(b8, want_b, rtol=2e-3, atol=1e-6)
        np.testing.assert_allclose(s8, want_s, rtol=2e-3, atol=1e-6)
        np.testing.assert_allclose(l8, want_l, atol=0.05)


def test_pad_to_multiple():
    from janusx_tpu.parallel.mesh import pad_to_multiple as j_pad
    from janusx_tpu_torch.parallel.mesh import pad_to_multiple

    x = np.arange(10)
    assert pad_to_multiple(x, 8).shape[0] == 16
    assert pad_to_multiple(x, 5).shape[0] == 10
    for mult in (3, 5, 8):
        np.testing.assert_array_equal(pad_to_multiple(x, mult, fill=-1), j_pad(x, mult, fill=-1))


def test_devcache_shards_a_repeated_device_mesh(tmesh8, rng):
    """Eight shards on one device: shard i holds rows i·w..(i+1)·w-1 of
    every block, never another shard's (a cache keyed by device alone
    would hand shard 0's rows to all eight)."""
    from janusx_tpu_torch.ops.decode import pad_packed_cols
    from janusx_tpu_torch.utils import devcache

    _, pt = _toy_both(rng, m=300, n=40)
    block = 64
    nblk = -(-pt.m // block)
    pk = devcache.device_packed_blocks(pt, (nblk, block), mesh=tmesh8, shard_axis=1)
    mn = devcache.to_device_blocks(pt.mean, (nblk, block), 0.0, torch.float32,
                                   mesh=tmesh8, shard_axis=1)
    w = block // 8
    host = pad_packed_cols(pt.packed, 4)
    pad = np.full((nblk * block - pt.m, host.shape[1]), 0xFF, np.uint8)
    host = np.concatenate([host, pad]).reshape(nblk, block, -1)
    mean = np.concatenate([pt.mean, np.zeros(nblk * block - pt.m)]).reshape(nblk, block)
    assert len(pk) == len(mn) == 8
    for i in range(8):
        np.testing.assert_array_equal(pk[i].numpy(), host[:, i * w:(i + 1) * w])
        np.testing.assert_array_equal(mn[i].numpy(), mean[:, i * w:(i + 1) * w].astype(np.float32))
    # one block: shard i is exactly source rows i·w..(i+1)·w-1
    head = pt.take_snps(np.arange(pt.m - pt.m % 8))
    w1 = head.m // 8
    one = devcache.device_packed_blocks(head, (1, head.m), mesh=tmesh8)
    for i in range(8):
        np.testing.assert_array_equal(one[i][0, :, :head.packed.shape[1]].numpy(),
                                      head.packed[i * w1:(i + 1) * w1])
    # a second call is the cached list; a single-device call is not it
    assert devcache.device_packed_blocks(pt, (nblk, block), mesh=tmesh8) is pk
    assert torch.is_tensor(devcache.device_packed_blocks(pt, (nblk, block), "cpu"))


# ---------------------------------------------------------------------------
# production paths with mesh=
# ---------------------------------------------------------------------------
def test_production_grm_sharded(mesh8, tmesh8, rng):
    from janusx_tpu.models.grm import grm_from_packed as j_grm
    from janusx_tpu_torch.models.grm import grm_from_packed

    pj, pt = _toy_both(rng)
    for method in (1, 2):
        K1 = grm_from_packed(pt, method=method, block=64)
        K8 = grm_from_packed(pt, method=method, block=64, mesh=tmesh8)
        np.testing.assert_allclose(K8, K1, rtol=2e-3, atol=1e-6)
        np.testing.assert_allclose(K8, j_grm(pj, method=method, block=64, mesh=mesh8),
                                   rtol=2e-3, atol=1e-6)


def test_grm_f32_accumulator_matches_reference(mesh8, tmesh8, rng):
    """``dtype=np.float32`` keeps the across-superblock accumulator in f32
    (janusx_tpu/models/grm.py:165,204); the result is an f64 array. Bound:
    rtol 1e-5 / atol 1e-5, the sharded-GRM bound (tests/test_sharding.py:46)
    — the reference has no f32-accumulator test — against the f64 build,
    the reference's f32 build and, sharded, the reference's sharded one."""
    from janusx_tpu.models.grm import grm_from_packed as j_grm
    from janusx_tpu_torch.models.grm import grm_from_packed

    pj, pt = _toy_both(rng, m=2000, n=64)
    K32 = grm_from_packed(pt, block=32, dtype=np.float32)
    assert K32.dtype == np.float64
    np.testing.assert_allclose(K32, grm_from_packed(pt, block=32), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(K32, j_grm(pj, block=32, dtype=np.float32), rtol=1e-5,
                               atol=1e-5)
    K32m = grm_from_packed(pt, block=32, dtype=np.float32, mesh=tmesh8)
    np.testing.assert_allclose(K32m, K32, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(K32m, j_grm(pj, block=32, dtype=np.float32, mesh=mesh8),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="float64 or float32"):
        grm_from_packed(pt, dtype=np.float16)


def test_production_scans_sharded(mesh8, tmesh8, rng):
    from janusx_tpu.core.spectral import eigh_grm
    from janusx_tpu.models.fvlmm import fvlmm_scan as j_fvlmm
    from janusx_tpu.models.grm import grm_from_packed as j_grm
    from janusx_tpu.models.lm import lm_scan as j_lm
    from janusx_tpu.models.lmm import lmm_scan as j_lmm
    from janusx_tpu_torch.models.fvlmm import fvlmm_scan
    from janusx_tpu_torch.models.lm import lm_scan
    from janusx_tpu_torch.models.lmm import lmm_scan
    from janusx_tpu_torch.utils import devcache

    pj, pt = _toy_both(rng)
    basis = eigh_grm(j_grm(pj, block=64), diag_ridge=1e-6)
    tb = interop.basis_from_numpy(basis)
    y = rng.normal(size=pt.n) + pt.centered()[3] * 0.4

    _close(lm_scan(pt, y, block=64), lm_scan(pt, y, block=64, mesh=tmesh8))
    _close_ref(j_lm(pj, y, block=64, mesh=mesh8), lm_scan(pt, y, block=64, mesh=tmesh8))
    f8, _ = fvlmm_scan(pt, tb, y, block=64, mesh=tmesh8)
    _close(fvlmm_scan(pt, tb, y, block=64)[0], f8)
    _close_ref(j_fvlmm(pj, basis, y, block=64, mesh=mesh8)[0], f8)
    l1, n1 = lmm_scan(pt, tb, y, block=64)
    l8, n8 = lmm_scan(pt, tb, y, block=64, mesh=tmesh8)
    assert n1.lbd == n8.lbd
    _close(l1, l8)
    lj = j_lmm(pj, basis, y, block=64, use_pallas=False, mesh=mesh8)[0]
    _close_ref(lj, l8, beta=False)
    # against the reference: λ* within 2.02 grid spacings, more than half
    # within half a spacing (tests/test_pallas.py:102-110, as
    # tests/test_torch_lmm_family.py holds the single-device scans)
    t2 = lmm_scan(pt, tb, y, block=64, lmm2=True, mesh=tmesh8)[0]
    j2 = j_lmm(pj, basis, y, block=64, use_pallas=False, lmm2=True, mesh=mesh8)[0]
    _close_ref(j2, t2, beta=False)
    dlg = np.abs(np.log10(t2.lbd) - np.log10(j2.lbd))
    ok = np.isfinite(dlg)
    assert dlg[ok].max() <= 2.02 * 10.0 / 255 and np.mean(dlg[ok] < 0.5 * 10.0 / 255) > 0.5

    # the uploaded packed buffer really is split over all 8 shards
    sharded = [v for v in devcache._cache.values()
               if isinstance(v, list) and len(v) == 8 and v[0].dtype == torch.uint8]
    assert sharded, "no device-cache entry is sharded across the mesh"


def _plink_with_trait(tmp_path, name, pj, y):
    from janusx_tpu.io.plink import write_plink

    geno = str(tmp_path / name)
    write_plink(geno, pj.packed, pj.n_samples, pj.sites, pj.samples)
    cols = np.atleast_2d(y.T).T
    with open(tmp_path / f"{name}.pheno", "wt") as fh:
        fh.write("id\t" + "\t".join(f"t{i + 1}" for i in range(cols.shape[1])) + "\n")
        for s, row in zip(pj.samples, cols):
            fh.write(f"{s}\t" + "\t".join(f"{v:.6f}" for v in row) + "\n")
    return geno + ".bed", str(tmp_path / f"{name}.pheno")


def _gwas_three(tmp_path, tag, common):
    """(port single, port sharded, reference sharded) run_gwas results."""
    from janusx_tpu.workflows.gwas import GwasConfig as JCfg, run_gwas as j_run
    from janusx_tpu_torch.workflows.gwas import GwasConfig, run_gwas

    one = run_gwas(GwasConfig(out_prefix=str(tmp_path / f"{tag}1"), n_devices=1, **common))
    eight = run_gwas(GwasConfig(out_prefix=str(tmp_path / f"{tag}8"), n_devices=8, **common))
    ref = j_run(JCfg(out_prefix=str(tmp_path / f"{tag}j8"), n_devices=8, **common))
    return one, eight, ref


def test_run_gwas_sharded_matches_single(tmp_path, mesh8, eight_devices):
    rng = np.random.default_rng(42)
    pj, _ = _toy_both(rng, m=300, n=80)
    y = rng.normal(size=pj.n) + pj.centered()[7] * 0.6
    geno, pheno = _plink_with_trait(tmp_path, "toy", pj, y)
    common = dict(genotype=geno, phenotype=pheno, models=("lmm",), force_model=True,
                  block=64, use_cache=False)
    for model in ("lmm", "splmm"):
        common["models"] = (model,)
        one, eight, ref = _gwas_three(tmp_path, model, common)
        _close(one[0].result, eight[0].result, atol=1e-5, what=model)
        _close_ref(ref[0].result, eight[0].result, atol=1e-5, what=model,
                   beta=model != "lmm")


def test_run_gwas_sharded_multilocus_routes(tmp_path, mesh8, eight_devices):
    """-farmcpu, -frgwas, -algwas, -lowrank, -splmm-exact, -lm2, -fvlmm2
    through the 8-shard mesh (tests/test_sharding.py:199-259). A selected
    QTN is a covariate of its own final scan, so its lane's g'Mg is f32
    noise and its beta 0/0 (finite or NaN by the last bits of the LM
    grams, which a (w, n) shard and a (block, n) block sum in another
    order): the QTN lanes are held by p-value, every other lane by beta
    and p."""
    from janusx_tpu_torch.models import farmcpu as tfc
    from janusx_tpu_torch.models.algwas import algwas_scan

    rng = np.random.default_rng(11)
    pj, pt = _toy_both(rng, m=400, n=100)
    Z = pj.centered()
    y = 1.2 * Z[60] + 1.0 * Z[250] + rng.normal(size=pj.n) * 0.6
    geno, pheno = _plink_with_trait(tmp_path, "toy", pj, y)
    cov = rng.normal(size=(pj.n, 1))
    covf = str(tmp_path / "toy.cov")
    with open(covf, "wt") as fh:
        fh.write("id\tc1\n")
        for s, v in zip(pj.samples, cov[:, 0]):
            fh.write(f"{s}\t{v:.6f}\n")
    qtns = {"farmcpu": tfc.farmcpu_scan(pt, y, block=64).qtns,
            "frgwas": tfc.farmcpu_unified_scan(pt, y, block=64).qtns,
            "algwas": algwas_scan(pt, y, block=64).selected}
    for model in ("farmcpu", "frgwas", "algwas", "lowrank", "splmm-exact", "lm2", "fvlmm2"):
        common = dict(genotype=geno, phenotype=pheno, models=(model,), force_model=True,
                      block=64, use_cache=False, lowrank_snps=128)
        if model in ("lm2", "fvlmm2"):
            common["covariates"] = covf
        one, eight, ref = (r[0].result for r in _gwas_three(tmp_path, model, common))
        qtn = np.isin(eight.sites.snp.astype(str), pt.sites.snp[qtns.get(model, [])].astype(str))
        _close(_rows(one, ~qtn), _rows(eight, ~qtn), atol=1e-5, what=model)
        _close_ref(_rows(ref, ~qtn), _rows(eight, ~qtn), atol=1e-5, what=model)
        assert qtn.any() == (model in qtns), model
        for a in (one, ref) if qtn.any() else ():
            _close_ref(_rows(a, qtn), _rows(eight, qtn), what=model, beta=None)


def test_run_gwas_trait_level_sharded_matches_single(tmp_path, mesh8, eight_devices):
    """-trait-level's batched multi-trait scans through the 8-shard mesh,
    m not divisible by 8 (tests/test_sharding.py:431-478)."""
    rng = np.random.default_rng(11)
    pj, _ = _toy_both(rng, m=301, n=90)
    gc = pj.centered()
    Y = np.column_stack([rng.normal(size=pj.n) + gc[7] * 0.6,
                         rng.normal(size=pj.n) + gc[40] * 0.8,
                         rng.normal(size=pj.n) - gc[120] * 0.7])
    geno, pheno = _plink_with_trait(tmp_path, "tl", pj, Y)
    common = dict(genotype=geno, phenotype=pheno, models=("lmm",), force_model=True,
                  block=64, use_cache=False, trait_level=True)
    one, eight, ref = _gwas_three(tmp_path, "t", common)
    assert len(one) == len(eight) == len(ref) == 3
    by = [{r.trait: r.result for r in rs} for rs in (one, eight, ref)]
    assert set(by[0]) == set(by[1]) == set(by[2])
    for trait in by[0]:
        _close(by[0][trait], by[1][trait], atol=1e-5, what=trait)
        _close_ref(by[2][trait], by[1][trait], what=trait, beta=False)
    rows = [sum(1 for _ in open(str(tmp_path / t) + ".traitlevel.assoc.tsv"))
            for t in ("t1", "t8", "tj8")]
    assert rows[0] == rows[1] == rows[2]


def test_run_gs_sharded_matches_single(tmp_path, mesh8, monkeypatch):
    """run_gs (GBLUP CV + GEBVs) with an 8-shard GRM build against one
    device, and against the reference's 8-device run."""
    from janusx_tpu.gs.workflow import GsConfig as JCfg, run_gs as j_run
    from janusx_tpu.io import plink
    from janusx_tpu.models.sim import simulate_genotypes, simulate_phenotype, write_pheno
    from janusx_tpu_torch.gs.workflow import GsConfig, run_gs

    gd = simulate_genotypes(120, 500, seed=13)
    sim = simulate_phenotype(gd, n_qtl=25, h2=0.6, seed=13)
    prefix = str(tmp_path / "g")
    plink.write_plink_genotypes(prefix, gd)
    y = sim.phenotypes.copy()
    y[-20:] = np.nan  # prediction set
    write_pheno(prefix + ".pheno", gd.samples, y)
    kw = dict(genotype=prefix, phenotype=prefix + ".pheno", methods=("BLUP",), cv=3)

    runs = {}
    for tag, ndev in (("single", 1), ("mesh", 8)):
        monkeypatch.setattr(tmesh_mod, "visible_devices",
                            lambda k=ndev: [torch.device("cpu")] * k)
        runs[tag] = run_gs(GsConfig(out_prefix=str(tmp_path / tag), **kw))[1]
    runs["ref"] = j_run(JCfg(out_prefix=str(tmp_path / "ref"), **kw))[1]
    cv = {t: s["traits"]["trait0"]["BLUP"]["cv"]["pearson"] for t, s in runs.items()}
    assert cv["mesh"] == pytest.approx(cv["single"], abs=1e-4)
    assert cv["mesh"] == pytest.approx(cv["ref"], abs=1e-4)
    gebv = {t: open(str(tmp_path / f"{t}.trait0.gebv.tsv")).read().splitlines()
            for t in runs}
    for other in ("single", "ref"):
        for a, b in zip(gebv[other][1:], gebv["mesh"][1:]):
            sa, va = a.split("\t")
            sb, vb = b.split("\t")
            assert sa == sb
            assert float(va) == pytest.approx(float(vb), abs=2e-3)


def test_windowed_sharded_scan_chromosome_scale(mesh8, tmesh8, tmp_path):
    """Disk-backed (windowed) input through the 8-shard mesh with an uneven
    final shard: the scan streams superblocks through the sharded resident
    scan and agrees with single-device scans of spot-check slices (head +
    uneven tail) and with the reference's sharded scan. The reference's
    case runs m = 2^20 + 37 at 2^17-SNP superblocks; this one keeps its
    shape (several superblocks, a 37-SNP tail) at m = 2^16 + 37 and 2^13."""
    from janusx_tpu.io.windowed import WindowedBed as JWindowedBed
    from janusx_tpu.io.packed import QcParams as JQ
    from janusx_tpu.models.lm import lm_scan as j_lm
    from janusx_tpu_torch.io import plink
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.packed import QcParams
    from janusx_tpu_torch.io.windowed import WindowedBed
    from janusx_tpu_torch.models.lm import lm_scan
    from janusx_tpu_torch.utils import devcache

    rng = np.random.default_rng(31)
    m, n, win = (1 << 16) + 37, 64, 1 << 13
    p = rng.uniform(0.1, 0.5, size=m).astype(np.float32)
    g = rng.binomial(2, p[:, None], size=(m, n)).astype(np.int8)
    sites = SiteInfo(chrom=np.array(["1"] * m, object),
                     pos=np.arange(1, m + 1, dtype=np.int64),
                     snp=np.array([f"s{i}" for i in range(m)], object),
                     allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    prefix = str(tmp_path / "big")
    plink.write_plink_genotypes(prefix, GenotypeData(g, sites, np.array(
        [f"i{j}" for j in range(n)], object)))
    del g

    wp = WindowedBed(prefix, window=win).prepare(QcParams(maf=0.0, geno=1.0))
    wp.max_resident_snps = win  # force true superblock streaming
    assert wp.m == m
    y = rng.normal(size=n)

    # spy on the packed uploads: every superblock arrives split into eight
    # 1/8 slices (a windowed superblock is uploaded on its own, uncached)
    seen = []
    orig = devcache.upload_packed_blocks

    def spy(pg_, shape, *a, **kw):
        out = orig(pg_, shape, *a, **kw)
        if isinstance(out, list):
            seen.append((shape, [tuple(t.shape) for t in out]))
        return out

    devcache.upload_packed_blocks = spy
    try:
        res = lm_scan(wp, y, block=1024, mesh=tmesh8)
    finally:
        devcache.upload_packed_blocks = orig
    assert res.m == m and np.isfinite(res.beta).all()
    assert len(seen) == -(-m // win), "windowed superblocks were not mesh-sharded"
    for shape, shards in seen:
        assert len(shards) == 8 and all(s[1] == shape[1] // 8 for s in shards)

    for lo, hi in ((0, 1024), (m - 1024 - 37, m)):
        ref = lm_scan(wp.take_snps(np.arange(lo, hi)), y, block=1024)
        _close(ref, _rows(res, lo, hi))
    jwp = JWindowedBed(prefix, window=win).prepare(JQ(maf=0.0, geno=1.0))
    jwp.max_resident_snps = win
    _close_ref(j_lm(jwp, y, block=1024, mesh=mesh8), res)


def _rows(res, lo, hi=None):
    """beta and pwald of rows lo:hi (or of the boolean mask ``lo``)."""
    from types import SimpleNamespace

    idx = lo if hi is None else slice(lo, hi)
    return SimpleNamespace(beta=res.beta[idx], pwald=res.pwald[idx])


def test_grm_sharded_hlo_has_one_allreduce(tmesh8, rng):
    """The sharded GRM sums its shards' partials exactly once per
    grm_from_packed call — in memory and disk-backed (streamed windows
    keep each shard's partial on its device) — the twin of the reference's
    single all-reduce in the compiled program."""
    import tempfile

    from janusx_tpu_torch.io.plink import write_plink
    from janusx_tpu_torch.io.windowed import WindowedBed
    from janusx_tpu_torch.models import grm as tgrm

    _, pt = _toy_both(rng, m=512, n=96)
    before = tgrm.reduce_shards.calls
    K = tgrm.grm_from_packed(pt, block=64, mesh=tmesh8)
    assert tgrm.reduce_shards.calls - before == 1
    with tempfile.TemporaryDirectory() as td:
        write_plink(f"{td}/wp", pt.packed, pt.n_samples, pt.sites, pt.samples)
        wp = WindowedBed(f"{td}/wp", window=128).prepare()
        wp.max_resident_snps = 128
        before = tgrm.reduce_shards.calls
        Kw = tgrm.grm_from_packed(wp, block=64, mesh=tmesh8)
        assert tgrm.reduce_shards.calls - before == 1
    np.testing.assert_allclose(Kw, K, rtol=1e-5, atol=1e-5)
    before = tgrm.reduce_shards.calls
    tgrm.grm_from_packed(pt, block=64)
    assert tgrm.reduce_shards.calls == before  # one device: nothing to sum


# ---------------------------------------------------------------------------
# parallel/distributed.py
# ---------------------------------------------------------------------------
def test_distributed_recipe_single_process(mesh8, tmesh8):
    """padded totals, host slice and the local-slice assembly for
    non-divisible m_total in one process (one device), and the same rows
    as the reference's global array on its eight devices."""
    from janusx_tpu.parallel import distributed as jdist
    from janusx_tpu_torch.parallel import distributed as dist
    from janusx_tpu_torch.parallel.mesh import shard_snp_block

    for m_total in (10, 16, 17, 129):
        m_pad = dist.padded_snp_total(m_total)
        assert m_pad % dist.device_count() == 0 and m_pad >= m_total
        lo, hi = dist.host_snp_range(m_total)
        assert (lo, hi) == (0, m_pad)  # single process owns everything
        block = np.arange(hi - lo, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)
        g = dist.make_global_snp_array(dist.global_snp_mesh(), block, m_total)
        assert g.global_shape == (m_pad, 3) and (g.lo, g.hi) == (0, m_pad)
        np.testing.assert_array_equal(torch.cat(g.shards).numpy(), block)
        # the reference's global array over its eight devices holds the
        # same rows; eight shards of the port's mesh split them evenly
        blk8 = np.arange(jdist.padded_snp_total(m_total), dtype=np.float32)[:, None] \
            * np.ones((1, 3), np.float32)
        jg = np.asarray(jdist.make_global_snp_array(jdist.global_snp_mesh(), blk8, m_total))
        np.testing.assert_array_equal(torch.cat(g.shards).numpy()[:m_total], jg[:m_total])
        shards8 = shard_snp_block(tmesh8, blk8)
        assert len({tuple(t.shape) for t in shards8}) == 1
        np.testing.assert_array_equal(torch.cat(shards8).numpy(), jg)
        with pytest.raises(ValueError):
            dist.make_global_snp_array(dist.global_snp_mesh(), block[:-1], m_total)


NO_GROUP = 3  # tests/torch_dist_worker.py's exit code for a group that did not form


def _free_port() -> int:
    with socket.socket() as s:  # a free port, bound here and released
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_worker_pair(worker, port, out_dir, env, cwd, timeout=180):
    """Both ranks of tests/torch_dist_worker.py on ``port``, their output in
    files under ``out_dir`` (which also takes their results). When one rank
    exits with NO_GROUP the other, which may wait for the group until its
    timeout, is stopped. Returns (the processes, their outputs)."""
    import time

    out_dir.mkdir()
    logs = [open(out_dir / f"rank{i}.log", "w+") for i in range(2)]
    procs = [subprocess.Popen([sys.executable, worker, str(i), "2", str(port), str(out_dir)],
                              stdout=log, stderr=subprocess.STDOUT, text=True, env=env, cwd=cwd)
             for i, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() == NO_GROUP for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    return procs, outs


def test_distributed_two_process_recipe(tmp_path, mesh8):
    """Two torch.distributed processes (gloo, JX_TPU_PLATFORM=cpu) run the
    whole parallel/distributed.py recipe (tests/torch_dist_worker.py);
    the parent checks the saved result against numpy and against the
    reference's sharded GRM of the same panel. Gloo ships in every torch
    build, so a group that does not form is a failure, not a skip."""
    from janusx_tpu.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu.io.packed import QcParams, pack_genotypes
    from janusx_tpu.models.grm import grm_from_packed as j_grm

    worker = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
    env = dict(os.environ, JX_TPU_PLATFORM="cpu", JX_TPU_HISTORY_DB="0", OMP_NUM_THREADS="1")
    repo_root = os.path.dirname(os.path.dirname(worker))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    # the port is bound here and released before rank 0 binds it, while other
    # test workers open ports too; a worker that finds its group not formed
    # exits with NO_GROUP, and the pair runs again on a fresh port
    for attempt in range(3):
        procs, outs = _run_worker_pair(worker, _free_port(), tmp_path / f"try{attempt}", env,
                                       repo_root)
        if all(p.returncode != NO_GROUP for p in procs):
            break
    joined = "\n---\n".join(outs)
    assert all(p.returncode == 0 for p in procs), joined[-3000:]
    assert all("DIST_OK" in o for o in outs), joined[-3000:]

    data = np.load(tmp_path / f"try{attempt}" / "dist_result.npz")
    rng2 = np.random.default_rng(7)
    G = rng2.integers(0, 3, size=(101, 24)).astype(np.float32)
    y = rng2.normal(size=24).astype(np.float32)
    np.testing.assert_allclose(data["K"], G.T @ G, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(data["beta"], (G @ y) / (G * G).sum(axis=1), rtol=1e-5,
                               atol=1e-6)
    # the worker's distributed GRM panel, built by the reference on mesh8
    mg, ng = 97, 18
    codes = np.random.default_rng(21).integers(0, 3, size=(mg, ng)).astype(np.int8)
    sites = SiteInfo(chrom=np.array(["1"] * mg, object),
                     pos=np.arange(1, mg + 1, dtype=np.int64),
                     snp=np.array([f"s{i}" for i in range(mg)], object),
                     allele0=np.array(["A"] * mg, object), allele1=np.array(["G"] * mg, object))
    pgv = pack_genotypes(GenotypeData(codes, sites, np.array([f"i{j}" for j in range(ng)],
                                                             object)),
                         QcParams(maf=0.0, geno=1.0))
    np.testing.assert_allclose(data["K_grm"], j_grm(pgv, mesh=mesh8), rtol=1e-4, atol=1e-6)


def test_distributed_grm_single_process_equals_full(rng):
    """distributed_grm == grm_from_packed in one process (in memory and
    disk-backed), and the reference's distributed_grm within the GRM
    parity bound."""
    import tempfile

    from janusx_tpu.parallel import distributed as jdist
    from janusx_tpu_torch.io.plink import write_plink
    from janusx_tpu_torch.io.windowed import WindowedBed
    from janusx_tpu_torch.models.grm import grm_from_packed
    from janusx_tpu_torch.parallel import distributed as dist

    pj, pt = _toy_both(rng, m=301, n=50)
    K = grm_from_packed(pt)
    np.testing.assert_allclose(dist.distributed_grm(pt), K, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dist.distributed_grm(pt), jdist.distributed_grm(pj),
                               rtol=1e-5, atol=1e-5)
    with tempfile.TemporaryDirectory() as td:
        write_plink(td + "/wp", pt.packed, pt.n_samples, pt.sites, pt.samples)
        np.testing.assert_allclose(dist.distributed_grm(WindowedBed(td + "/wp").prepare()),
                                   K, rtol=1e-10, atol=1e-10)


def test_distributed_scan_single_process_equals_full(rng):
    """distributed_scan == the direct production scan in one process (lm
    and lmm), and the reference's distributed_scan at the scan bounds."""
    from janusx_tpu.core.spectral import eigh_grm
    from janusx_tpu.models.grm import grm_from_packed as j_grm
    from janusx_tpu.models.lm import lm_scan as j_lm
    from janusx_tpu.models.lmm import lmm_scan as j_lmm
    from janusx_tpu.parallel import distributed as jdist
    from janusx_tpu_torch.models.lm import lm_scan
    from janusx_tpu_torch.models.lmm import lmm_scan
    from janusx_tpu_torch.parallel import distributed as dist

    pj, pt = _toy_both(rng, m=217, n=60)
    y = rng.normal(size=pt.n) + pt.centered()[5] * 0.5
    d = dist.distributed_scan(pt, lambda sub: lm_scan(sub, y))
    ref = lm_scan(pt, y)
    np.testing.assert_array_equal(d.beta, ref.beta)
    np.testing.assert_array_equal(d.pwald, ref.pwald)
    assert d.m == pt.m and list(d.sites.snp) == list(pt.sites.snp)
    _close_ref(jdist.distributed_scan(pj, lambda sub: j_lm(sub, y)), d)

    basis = eigh_grm(j_grm(pj), diag_ridge=1e-6)
    tb = interop.basis_from_numpy(basis)
    d2 = dist.distributed_scan(pt, lambda sub: lmm_scan(sub, tb, y)[0])
    np.testing.assert_array_equal(d2.beta, lmm_scan(pt, tb, y)[0].beta)
    _close_ref(jdist.distributed_scan(pj, lambda sub: j_lmm(sub, basis, y,
                                                            use_pallas=False)[0]),
               d2, beta=False)


def test_dryrun_multichip_on_eight_cpu_shards():
    """The port's twin of __graft_entry__.py: the flagship step, then the
    production GRM/scans on an 8-shard mesh with its invariants."""
    from janusx_tpu_torch.parallel import dryrun

    fn, args = dryrun.entry()
    lgs, beta, se = fn(*args)
    assert lgs.shape == beta.shape == se.shape == (16,)
    dryrun.dryrun_multichip(8, repeat=True)
