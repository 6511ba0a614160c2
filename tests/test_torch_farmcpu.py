"""Port parity of FarmCPU (``-farmcpu``) and its unified route
(``-frgwas``): janusx_tpu_torch/models/farmcpu.py is a verbatim copy of the
reference's, so every difference would come from the port's LM scan under
it. The per-loop pseudo-QTN sets, the final QTN set and the loop count
must equal the reference's exactly, on the fixtures of
tests/test_farmcpu_independent.py and tests/test_multilocus.py:16-44; the
final p-values within Δ(-log10 p) 5e-3 (the f32-gram envelope,
tests/test_farmcpu_independent.py:226-228). The many conditional LM scans
run on one panel: the device cache uploads its packed genotypes once.
"""

import numpy as np
import pytest

from janusx_tpu.io.gdata import GenotypeData as JGenotypeData, SiteInfo as JSiteInfo
from janusx_tpu.io.packed import QcParams as JQc, pack_genotypes as j_pack
from janusx_tpu.models import farmcpu as jfc
from janusx_tpu.models.sim import simulate_genotypes, simulate_phenotype
from janusx_tpu_torch.io.gdata import GenotypeData as TGenotypeData, SiteInfo as TSiteInfo
from janusx_tpu_torch.io.packed import QcParams as TQc, pack_genotypes as t_pack
from janusx_tpu_torch.models import farmcpu as tfc
from janusx_tpu_torch.utils import devcache


def _both(g, sites: dict, qc: dict):
    """The same int8 dosages packed by each package."""
    samples = np.array([f"i{j}" for j in range(g.shape[1])], object)
    return (j_pack(JGenotypeData(g, JSiteInfo(**sites), samples), JQc(**qc)),
            t_pack(TGenotypeData(g, TSiteInfo(**sites), samples), TQc(**qc)))


def _sites(gd):
    s = gd.sites
    return dict(chrom=s.chrom, pos=s.pos, snp=s.snp, allele0=s.allele0, allele1=s.allele1)


def _independent_problem(h2, seed):
    """tests/test_farmcpu_independent.py:_problem."""
    gd = simulate_genotypes(260, 1600, seed=seed)
    sim = simulate_phenotype(gd, n_qtl=8, h2=h2, seed=seed + 77)
    pj, pt = _both(gd.genotypes, _sites(gd), {})
    return pj, pt, np.asarray(sim.phenotypes, np.float64).reshape(-1)


def _multilocus_problem():
    """tests/test_multilocus.py:16-44 (ml_problem)."""
    rng = np.random.default_rng(23)
    m, n = 500, 250
    p = rng.uniform(0.1, 0.5, size=m)
    g = rng.binomial(2, p[:, None], size=(m, n)).astype(np.int8)
    sites = dict(
        chrom=np.array(["1"] * (m // 2) + ["2"] * (m - m // 2), object),
        pos=np.concatenate([np.arange(1, m // 2 + 1),
                            np.arange(1, m - m // 2 + 1)]).astype(np.int64) * 100_000,
        snp=np.array([f"v{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object), allele1=np.array(["T"] * m, object))
    pj, pt = _both(g, sites, dict(maf=0.05, geno=0.05))
    Z = pj.centered()
    y = (1.0 + Z[20] * 1.2 + Z[300] * 1.0
         + Z[::7].T @ rng.normal(size=len(Z[::7])) * 0.05 + rng.normal(size=n) * 0.8)
    return pj, pt, y


def _same_selection(a, b):
    assert a.loops == b.loops
    assert a.loop_sets == b.loop_sets
    np.testing.assert_array_equal(a.qtns, b.qtns)
    pa, pb = a.result.pwald, b.result.pwald
    np.testing.assert_array_equal(np.isfinite(pa), np.isfinite(pb))
    ok = np.isfinite(pb)
    assert ok.mean() > 0.95
    assert np.max(np.abs(np.log10(pa[ok]) - np.log10(pb[ok]))) < 5e-3


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")  # read by the port only


@pytest.mark.parametrize("h2,seed", [(0.5, 3), (0.4, 9)])
def test_farmcpu_matches_reference(h2, seed):
    pj, pt, y = _independent_problem(h2, seed)
    ref = jfc.farmcpu_scan(pj, y)
    out = tfc.farmcpu_scan(pt, y)
    assert len(out.qtns) > 0
    _same_selection(out, ref)


def test_farmcpu_and_frgwas_match_reference_on_multilocus_panel():
    pj, pt, y = _multilocus_problem()
    raw = tfc.farmcpu_scan(pt, y)
    uni = tfc.farmcpu_unified_scan(pt, y)
    _same_selection(raw, jfc.farmcpu_scan(pj, y))
    _same_selection(uni, jfc.farmcpu_unified_scan(pj, y))
    # tests/test_multilocus.py:164-165's frozen selections
    assert raw.qtns.tolist() == [20, 65, 84, 152, 238, 286, 300, 448]
    assert uni.qtns.tolist() == [20, 65, 152, 300]


def test_farmcpu_uploads_the_panel_once(monkeypatch):
    """Every conditional LM scan of a FarmCPU run reads one device copy of
    the packed panel."""
    _, pt, y = _multilocus_problem()
    uploads = []
    remember = devcache._remember

    def counting(src, key, dev):
        if key[1] == "packedb" and src is pt.packed:
            uploads.append(key)
        return remember(src, key, dev)

    monkeypatch.setattr(devcache, "_remember", counting)
    out = tfc.farmcpu_scan(pt, y)
    assert out.loops > 2  # several loops, each with its conditional scans
    assert len(uploads) == 1
