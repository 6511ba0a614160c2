"""Port parity of FarmCPU (``-farmcpu``) and its unified route
(``-frgwas``) against the reference's, on the fixtures of
tests/test_farmcpu_independent.py and tests/test_multilocus.py:16-44: the
per-loop pseudo-QTN sets, the final QTN set and the loop count must equal
the reference's exactly; the final p-values within Δ(-log10 p) 5e-3 (the
f32-gram envelope, tests/test_farmcpu_independent.py:226-228).
janusx_tpu_torch/models/farmcpu.py was a verbatim copy of the reference's
and is port-owned now (its docstring says why), so these tests are what
holds its selection to the reference's.

Besides: each loop's candidate lead sets, now from one stable p order a
loop, sorted only as far as its walks reach (``_lead_sets``), equal the
reference's former per-pair selection (``_bin_leads`` below, kept here as
the oracle) for every (window, count); ``_pos_key`` equals the per-site key;
the final table's pseudo-QTN rows hold their coefficients' beta, se and p
in the joint background model; a run opens the route's spans and counts
its scans (``lm.scans``, ``lm.design_cols``). The many conditional LM scans
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
from janusx_tpu_torch.models.lm import design_matrix, student_t_p_two_sided
from janusx_tpu_torch.utils import devcache, trace


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


@pytest.mark.parametrize("head,windows", [(4096, tfc.WINDOW_SIZES),
                                          (200, (20_000, 100_000, 500_000))])
@pytest.mark.parametrize("h2,seed", [(0.5, 3), (0.4, 9)])
def test_farmcpu_matches_reference(h2, seed, head, windows, monkeypatch):
    """The second case sorts a head of 200 of the 1,600 markers a loop: its
    windows give every walk bins enough (7 to 160 a chromosome of 3.2 Mb)."""
    monkeypatch.setattr(tfc, "_HEAD", head)
    pj, pt, y = _independent_problem(h2, seed)
    ref = jfc.farmcpu_scan(pj, y, window_sizes=windows)
    out = tfc.farmcpu_scan(pt, y, window_sizes=windows)
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


def _bin_leads(pos_key: np.ndarray, pvals: np.ndarray, window: int, n_lead: int):
    """The selection of one (window, count) pair as the reference makes it
    (janusx_tpu/models/farmcpu.py ``_bin_leads``): best marker per genomic
    window, then the n_lead most significant, from a full stable sort."""
    chrom_part = pos_key // 10_000_000_000
    bins = chrom_part * (1 << 40) + (pos_key % 10_000_000_000) // window
    order = np.argsort(pvals, kind="stable")
    seen: set = set()
    leads = []
    for i in order:
        b = bins[i]
        if b in seen:
            continue
        seen.add(b)
        leads.append(i)
        if len(leads) >= n_lead:
            break
    return np.array(sorted(leads), dtype=np.int64)


def _selection_case(case):
    """(pos_key, p-values, windows, counts) of one selection case."""
    rng = np.random.default_rng(7)
    _, pt, y = _multilocus_problem()
    pos_key = tfc._pos_key(pt)
    p = tfc.lm_scan(pt, y).pwald
    windows, counts = tfc.WINDOW_SIZES, (3, 7, 11, 40, 250)
    if case == "ties":  # p on a coarse grid: most markers tie with others
        p = np.round(np.clip(p, 1e-6, 1.0), 1)
    elif case == "few_bins":  # two chromosomes of one bin each, counts beyond it
        windows = (10**9, 3_000_000_000)
    elif case == "odd_windows":  # windows that do not divide the key stride
        windows = (123_457, 3_333_333, 77_777_777)
    elif case == "nan":  # invalid scans sort last
        p[rng.choice(len(p), 40, replace=False)] = np.nan
    elif case == "uniform":
        p = rng.random(len(p))
    return pos_key, p, windows, counts


@pytest.mark.parametrize("head", [4096, 5])
@pytest.mark.parametrize("case", ["scan", "ties", "few_bins", "odd_windows", "nan", "uniform"])
@pytest.mark.parametrize("window", [0, 1])
def test_one_sort_lead_sets_equal_the_per_pair_selection(case, window, head, monkeypatch):
    """A head of 5 markers is outrun by every walk here, so the walks are
    made again over the whole order."""
    monkeypatch.setattr(tfc, "_HEAD", head)
    pos_key, p, windows, counts = _selection_case(case)
    sets = tfc._lead_sets(pos_key, p, windows, counts)
    assert set(sets) == {(w, k) for w in windows for k in counts}
    w = windows[window]
    for k in counts:
        want = _bin_leads(pos_key, p, w, k)
        assert sets[w, k].dtype == np.int64
        np.testing.assert_array_equal(sets[w, k], want)
    if case == "few_bins":
        assert len(sets[w, counts[-1]]) <= 2  # the walk never reaches k


@pytest.mark.parametrize("head", [64, 128])
@pytest.mark.parametrize("case", ["scan", "nan", "uniform"])
def test_lead_sets_sort_only_the_head(case, head, monkeypatch):
    """When the head of the p order holds every walk, nothing longer than
    the head is sorted, and the sets are still the per-pair selection's."""
    pos_key, p, _, _ = _selection_case(case)
    windows, counts = (100_000, 500_000, 2_000_000), (2, 5, 9)
    monkeypatch.setattr(tfc, "_HEAD", head)
    sorted_lengths = []
    argsort = np.argsort

    def spy(a, *args, **kw):
        sorted_lengths.append(len(a))
        return argsort(a, *args, **kw)

    monkeypatch.setattr(np, "argsort", spy)
    sets = tfc._lead_sets(pos_key, p, windows, counts)
    monkeypatch.setattr(np, "argsort", argsort)
    assert sorted_lengths and max(sorted_lengths) < len(p)
    for w in windows:
        for k in counts:
            np.testing.assert_array_equal(sets[w, k], _bin_leads(pos_key, p, w, k))


def _per_site_key(chrom, pos):
    """The composite key site by site, as the reference builds it."""
    ids = {c: i for i, c in enumerate(dict.fromkeys(chrom))}
    return np.array([ids[c] * 10_000_000_000 + p for c, p in zip(chrom, pos)], dtype=np.int64)


@pytest.mark.parametrize("chrom", [
    ["1"] * 5 + ["2"] * 3 + ["1"] * 2 + ["X"],  # a chromosome met again later
    [],
    ["7"],
    [3, 3, 1, 1, 2, 3],
])
def test_pos_key_is_the_per_site_key(chrom):
    from types import SimpleNamespace

    chrom = np.array(chrom, object)
    pos = np.random.default_rng(len(chrom)).integers(1, 10**9, len(chrom))
    key = tfc._pos_key(SimpleNamespace(sites=SimpleNamespace(chrom=chrom, pos=pos)))
    assert key.dtype == np.int64
    np.testing.assert_array_equal(key, _per_site_key(chrom, pos))


def _joint_model(pg, y, cov, qtns):
    """beta, se and p of the pseudo-QTN coefficients in [1, cov, Z] by least
    squares (numpy's lstsq, not the route's normal equations)."""
    X = np.concatenate([design_matrix(pg.n, cov), pg.take_snps(qtns).centered().T], axis=1)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    r = y - X @ coef
    df = pg.n - X.shape[1]
    cov_b = float(r @ r) / df * np.linalg.inv(X.T @ X)
    se = np.sqrt(np.diag(cov_b))
    j = X.shape[1] - len(qtns)
    return coef[j:], se[j:], student_t_p_two_sided(coef[j:] / se[j:], df)


@pytest.mark.parametrize("ncov", [0, 2])
def test_pseudo_qtn_rows_hold_the_joint_model(ncov):
    """The final table's pseudo-QTN rows are finite and equal their
    coefficients in the joint background model; the other rows are the
    final scan's."""
    _, pt, y = _multilocus_problem()
    cov = np.random.default_rng(ncov).normal(size=(pt.n, ncov)) if ncov else None
    out = tfc.farmcpu_scan(pt, y, cov)
    q = out.qtns
    assert len(q) > 2
    res = out.result
    for a in (res.beta[q], res.se[q], res.pwald[q]):
        assert np.all(np.isfinite(a))
    beta, se, p = _joint_model(pt, y, cov, q)
    np.testing.assert_allclose(res.beta[q], beta, rtol=1e-8)
    np.testing.assert_allclose(res.se[q], se, rtol=1e-8)
    np.testing.assert_allclose(np.log10(res.pwald[q]), np.log10(p), rtol=1e-8, atol=1e-10)
    qcov = pt.take_snps(q).centered().T
    scan = tfc.lm_scan(pt, y, qcov if cov is None else np.concatenate([cov, qcov], axis=1))
    rest = np.setdiff1d(np.arange(pt.m), q)
    np.testing.assert_array_equal(res.beta[rest], scan.beta[rest])
    np.testing.assert_array_equal(res.pwald[rest], scan.pwald[rest])


def test_spans_and_scan_counters():
    """Under torch.profiler a run opens the route's spans; ``lm.scans``
    counts the loops plus the final scan and ``lm.design_cols`` the widths
    of their designs (intercept, covariates, the pseudo-QTNs of the loop)."""
    from torch.profiler import ProfilerActivity, profile

    _, pt, y = _multilocus_problem()
    cov = np.random.default_rng(1).normal(size=(pt.n, 1))
    before = trace.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = tfc.farmcpu_scan(pt, y + 0.25, cov)
    after = trace.counts()
    names = {ev.name()[len(trace.PREFIX):] for ev in prof.profiler.kineto_results.events()
             if ev.name().startswith(trace.PREFIX)}
    assert {"farmcpu", "fc_map", "fc_bins", "fc_rem", "fc_decode", "fc_prune", "fc_qtn_p",
            "lm_scan"} <= names
    assert out.loops >= 2 and len(out.loop_sets) == out.loops
    scans = after["lm.scans"] - before.get("lm.scans", 0)
    assert scans == out.loops + 1
    widths = [2] + [2 + len(s) for s in out.loop_sets[:-1]] + [2 + len(out.qtns)]
    assert after["lm.design_cols"] - before.get("lm.design_cols", 0) == sum(widths)
