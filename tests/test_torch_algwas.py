"""Port parity of ``-algwas``: janusx_tpu_torch.models.algwas against
janusx_tpu's on the reference's own fixture
(tests/test_garfield_algwas.py::epi_problem, n = 400, 300 markers) with
the trait of its test_algwas_selects_causal (three planted markers), the
port on the CPU.

Bounds: the same selected set, the λ path equal, the EBIC path within
rtol 1e-4 (the same steps infinite, above the selection cap), the final
Δ(−log10 p) ≤ 5e-3 (tests/test_scans.py:155). Both packages run stage 1
as the same f32 FISTA iterations; their matvecs sum in another order. A
selected marker is a covariate of its own stage-2 scan, so its g'M_X g is
f32 noise around 0 and whether its beta is NaN differs between the two
(its p-value is the joint model's in both): the NaN pattern is compared
off the selected rows.
"""

import dataclasses

import numpy as np
import pytest

from janusx_tpu.models import algwas as jal
from janusx_tpu_torch.io.gdata import SiteInfo as TSiteInfo
from janusx_tpu_torch.io.packed import PackedGenotypes as TPacked
from janusx_tpu_torch.models import algwas as tal

from test_garfield_algwas import epi_problem  # noqa: F401  (module fixture)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """ALGWAS's FISTA path is 9,600 iterations of small torch ops on the
    CPU; with the suite's six workers sharing the cores, each op's
    intra-op threads wait on one another (~100x slower than alone). One
    thread per worker runs them as fast as they run alone."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_panel(pj) -> TPacked:
    """The reference's packed panel as the port's PackedGenotypes."""
    sites = TSiteInfo(*(getattr(pj.sites, f.name) for f in dataclasses.fields(pj.sites)))
    return TPacked(packed=pj.packed.copy(), n_samples=pj.n_samples, sites=sites,
                   samples=pj.samples, af=pj.af, miss=pj.miss, mean=pj.mean)


def _trait(pg):
    """test_algwas_selects_causal's trait: three planted markers."""
    rng = np.random.default_rng(5)
    Z = pg.centered()
    return Z[[7, 77, 150]].T @ np.array([0.9, -0.8, 0.7]) + rng.normal(size=pg.n) * 0.8


def _compare(oj, ot):
    np.testing.assert_array_equal(ot.selected, oj.selected)
    np.testing.assert_array_equal(ot.lambda_path, oj.lambda_path)
    inf = np.isinf(oj.ebic_path)
    np.testing.assert_array_equal(np.isinf(ot.ebic_path), inf)
    np.testing.assert_allclose(ot.ebic_path[~inf], oj.ebic_path[~inf], rtol=1e-4)
    rj, rt = oj.result, ot.result
    off = np.ones(rj.m, bool)
    off[oj.selected] = False
    np.testing.assert_array_equal(np.isnan(rt.beta[off]), np.isnan(rj.beta[off]))
    dl = np.abs(np.log10(rt.pwald) - np.log10(rj.pwald))
    assert dl.max() <= 5e-3, dl.max()


@pytest.mark.parametrize("ncov", [0, 2])
def test_algwas_matches_reference(epi_problem, ncov):  # noqa: F811
    pj = epi_problem[0]
    pt = _port_panel(pj)
    y = _trait(pj)
    cov = np.random.default_rng(9).normal(size=(pj.n, 2)) if ncov else None
    oj = jal.algwas_scan(pj, y, cov)
    ot = tal.algwas_scan(pt, y, cov, device="cpu")
    assert 2 <= len(ot.selected) <= 200
    _compare(oj, ot)
    hits = sum(1 for c in (7, 77, 150) if np.any(np.abs(ot.selected - c) <= 1))
    assert hits >= 2, ot.selected


def test_algwas_qtn_panel_matches_reference(epi_problem):  # noqa: F811
    """An alternate stage-1 panel (-qbfile): the first 200 markers; the
    stage-2 scan still runs on the whole panel, QTN rows keep their scan
    p-values."""
    pj = epi_problem[0]
    pt = _port_panel(pj)
    y = _trait(pj)
    sub = np.arange(200)
    oj = jal.algwas_scan(pj, y, pg_qtn=pj.take_snps(sub))
    ot = tal.algwas_scan(pt, y, pg_qtn=pt.take_snps(sub), device="cpu")
    assert len(ot.selected) and ot.selected.max() < 200
    _compare(oj, ot)


def test_momentum_weights_are_the_f32_fista_sequence():
    mom = tal._momentum(150)
    t = np.float32(1.0)
    for c in mom[:5]:
        t_new = np.float32(0.5) * (1 + np.sqrt(np.float32(1) + 4 * t * t))
        assert c == float(np.float32((t - 1) / t_new))
        t = np.float32(t_new)
    assert mom[0] == 0.0 and 0.9 < mom[-1] < 1.0
