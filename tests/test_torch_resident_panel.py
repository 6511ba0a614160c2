"""The resident panel of ``models.superblocks``: a scan that streams an
in-memory panel in superblocks serves each one as a slice of the whole
panel held on the device (``utils.devcache.resident_packed_blocks``),
uploaded once for every scan of that panel.

Each route is held bit for bit (``np.array_equal``) to the same call on a
copy of the panel: a fresh identity, whose first scan uploads it whole
again, and, with the budget ``devcache.room`` set to 0, to the streamed
path, which uploads every superblock on its own. The counters
``feed.resident`` and ``feed.streamed`` say which path served each
superblock. The superblocks are forced with the routes' ``superblock=``
argument (three or more at m = 3,000). Port only: no JAX.
"""

import copy
import gc

import numpy as np
import pytest

from janusx_tpu_torch.core.spectral import eigh_grm
from janusx_tpu_torch.io import plink
from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
from janusx_tpu_torch.io.packed import QcParams, pack_genotypes
from janusx_tpu_torch.io.windowed import WindowedBed
from janusx_tpu_torch.models import fastlmm, lm, lmm
from janusx_tpu_torch.parallel.mesh import Mesh
from janusx_tpu_torch.utils import devcache, trace

M, N, BLOCK, SUPERBLOCK = 3000, 120, 256, 1024
SUPERBLOCKS = -(-M // SUPERBLOCK)


def _genotypes(seed=7):
    rng = np.random.default_rng(seed)
    g = rng.binomial(2, rng.uniform(0.05, 0.5, M)[:, None], size=(M, N)).astype(np.int8)
    g[rng.random((M, N)) < 0.01] = -1
    sites = SiteInfo(chrom=np.array(["1"] * M, object), pos=np.arange(1, M + 1),
                     snp=np.array([f"rs{i}" for i in range(M)], object),
                     allele0=np.array(["A"] * M, object), allele1=np.array(["G"] * M, object))
    return GenotypeData(g, sites, np.array([f"i{j}" for j in range(N)], object))


@pytest.fixture(scope="module")
def problem():
    gd = _genotypes()
    pg = pack_genotypes(gd, QcParams(maf=0.0, geno=1.0))
    assert pg.m == M
    gc_ = pg.centered()
    basis = eigh_grm(gc_.T @ gc_ / pg.m, diag_ridge=1e-6)
    rng = np.random.default_rng(11)
    Y = 1.0 + gc_.T @ rng.normal(0, 0.03, (pg.m, 4)) + rng.normal(size=(N, 4))
    lrb = fastlmm.lowrank_basis_from_snps(pg, q=64)
    return gd, pg, basis, Y, lrb


def _fresh(pg):
    """The same panel under a new identity (its codes a new host array)."""
    out = copy.copy(pg)
    out.packed = pg.packed.copy()
    return out


def _feed():
    c = trace.counts()
    return {k: c.get(k, 0) for k in ("feed.resident", "feed.streamed", trace.H2D)}


def _delta(before):
    after = _feed()
    return {k: after[k] - before[k] for k in after}


def _arrays(out):
    """The per-SNP outputs of a route's result (a list of traits' results)."""
    res = out if isinstance(out, list) else [out]
    return [np.stack([r.beta, r.se, r.pwald]) for r in res]


def _route(name, problem, pg, **kw):
    _, _, basis, Y, lrb = problem
    args = dict(block=BLOCK, superblock=SUPERBLOCK, device="cpu", **kw)
    if name == "lmm_scan":
        return lmm.lmm_scan(pg, basis, Y[:, 0], **args)[0]
    if name == "lmm_scan_multi":
        return lmm.lmm_scan_multi(pg, basis, Y, **args)[0]
    if name == "fastlmm_scan":
        return fastlmm.fastlmm_scan(pg, lrb, Y[:, 0], grid_points=64, **args)[0]
    return lm.lm_scan(pg, Y[:, 0], **args)


def _assert_equal(a, b):
    for x, y in zip(_arrays(a), _arrays(b), strict=True):
        np.testing.assert_array_equal(x, y)


ROUTES = ["lmm_scan", "lmm_scan_multi", "fastlmm_scan", "lm_scan"]


@pytest.mark.parametrize("route", ROUTES)
def test_second_scan_is_served_from_the_resident_panel(problem, route):
    """Two scans of one panel equal the scan of a copy bit for bit; the
    second serves every superblock from the resident copy and uploads
    under 1 % of the panel's bytes (h2d_bytes counts only uploads to a
    card: the CPU's read 0)."""
    pg = _fresh(problem[1])
    first = _route(route, problem, pg)
    before = _feed()
    second = _route(route, problem, pg)
    d = _delta(before)
    assert d["feed.resident"] == SUPERBLOCKS and d["feed.streamed"] == 0
    assert d[trace.H2D] < 0.01 * pg.packed.nbytes
    copied = _route(route, problem, _fresh(pg))
    _assert_equal(first, second)
    _assert_equal(first, copied)


@pytest.mark.parametrize("route", ROUTES)
def test_a_panel_beyond_the_budget_streams(problem, route, monkeypatch):
    """With no room (``devcache.room`` patched to 0) nothing is held: every
    superblock is uploaded on its own, counted under ``feed.streamed``,
    and the results are those of the resident path."""
    pg = _fresh(problem[1])
    resident = _route(route, problem, pg)
    monkeypatch.setattr(devcache, "room", lambda device: 0)
    other = _fresh(pg)
    before = _feed()
    streamed = _route(route, problem, other)
    d = _delta(before)
    assert d["feed.streamed"] == SUPERBLOCKS and d["feed.resident"] == 0
    assert not [k for k in devcache._resident if k[0] == id(other.packed)]
    _assert_equal(resident, streamed)


def test_the_resident_copy_dies_with_its_panel(problem):
    pg = _fresh(problem[1])
    _route("lmm_scan", problem, pg)
    keys = [k for k in devcache._resident if k[0] == id(pg.packed)]
    assert len(keys) == 1 and keys[0] in devcache._cache
    del pg
    gc.collect()
    assert not [k for k in keys if k in devcache._resident or k in devcache._cache]


def test_the_least_recently_used_panel_makes_way(problem, monkeypatch):
    """A budget of one panel: a second panel evicts the first, which the
    next scan of the first uploads again (and evicts the second)."""
    a, b = _fresh(problem[1]), _fresh(problem[1])
    _route("lm_scan", problem, a)
    (key_a,) = [k for k in devcache._resident if k[0] == id(a.packed)]
    one = sum(devcache._resident[key_a].values())
    ours = (id(a.packed), id(b.packed))
    held = lambda: sum(sum(v.values()) for k, v in devcache._resident.items() if k[0] in ours)
    monkeypatch.setattr(devcache, "room", lambda device: 2 * one - 1 - held())
    before = _feed()
    _route("lm_scan", problem, b)
    assert _delta(before)["feed.resident"] == SUPERBLOCKS
    assert key_a not in devcache._resident and key_a not in devcache._cache
    assert [k for k in devcache._resident if k[0] == id(b.packed)]
    _route("lm_scan", problem, a)
    assert key_a in devcache._resident
    assert not [k for k in devcache._resident if k[0] == id(b.packed)]


@pytest.mark.parametrize("route", ["lmm_scan", "lmm_scan_multi", "fastlmm_scan"])
def test_two_shard_mesh_resident_equals_one_device(problem, route):
    """A mesh of two CPU shards holds one resident tensor per shard; its
    results equal one device's bit for bit, on the second scan too."""
    pg = _fresh(problem[1])
    mesh = Mesh(["cpu", "cpu"])
    one = _route(route, problem, _fresh(pg))
    first = _route(route, problem, pg, mesh=mesh)
    before = _feed()
    second = _route(route, problem, pg, mesh=mesh)
    assert _delta(before)["feed.resident"] == SUPERBLOCKS
    (key,) = [k for k in devcache._resident if k[0] == id(pg.packed)]
    assert isinstance(devcache._cache[key], list) and len(devcache._cache[key]) == 2
    _assert_equal(first, second)
    _assert_equal(one, first)


def test_a_windowed_input_streams_unchanged(problem, tmp_path):
    """A disk-backed input (WindowedPacked, no ``packed``) streams every
    superblock, held by nothing, with the results of the in-memory panel."""
    gd, pg = problem[0], problem[1]
    prefix = str(tmp_path / "panel")
    plink.write_plink_genotypes(prefix, gd)
    wp = WindowedBed(prefix, window=512).prepare(QcParams(maf=0.0, geno=1.0))
    assert not hasattr(wp, "packed") and wp.m == M
    held = len(devcache._resident)
    before = _feed()
    streamed = _route("lmm_scan", problem, wp)
    d = _delta(before)
    assert d["feed.streamed"] == SUPERBLOCKS and d["feed.resident"] == 0
    assert len(devcache._resident) == held
    _assert_equal(_route("lmm_scan", problem, _fresh(pg)), streamed)
