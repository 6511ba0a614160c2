"""The cell ``jxbench-farmcpu`` (``jx gwas -farmcpu`` on the five-chromosome
map of JanusX's benchmark script) runs whole on the CPU at a small size:
``correct``, exactly the metrics it lists, and no module of JAX or the JAX
package loaded; the control (the plain reference one precision down) reads
past the cell's limits. Its readers of the program's spans and counters are
held on a trace made by hand, and read nothing from a program that lacks
them. On the card (``-m cuda``) the same at the configuration's sample
size over fewer SNPs."""

from __future__ import annotations

import io
import json

import numpy as np
import pytest

from portbench import calibrate, roofline
from portbench import manifest as mf
from portbench.harness import RunRecord, Step, forbidden_modules, run_cell
from portbench.reference.farmcpu import site_map
from portbench.trace import TraceData

from conftest import tiny_copy

SEED = 2**31 + 2323
CELL = "jxbench-farmcpu"
SIZES = {"farmcpu-5k-500k": dict(n_samples=400, n_phenotyped=400, n_snps=3000)}
MID = {"farmcpu-5k-500k": dict(n_snps=50_000)}


@pytest.fixture()
def small(tmp_path, monkeypatch) -> mf.Manifest:
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    return tiny_copy(tmp_path, SIZES)


def run(man, trace=False, seconds=1.0, device="cpu", seed=SEED):
    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(CELL, seed, seconds, trace, manifest=man, device=device, out=out, err=err)
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_cell_runs_correct_with_its_metrics(small):
    res = run(small)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    want = {m["name"]: m["unit"] for m in small.metrics(CELL, "end_to_end")}
    assert set(want) == {"scan_snps_per_s", "setup_s"}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert set(res["checks"]) == set(small.limits(CELL))
    traced = run(small, trace=True, seconds=0.5)
    assert traced["correct"] is True, traced["checks"]
    names = {m["name"] for m in small.metrics(CELL, "per_layer")}
    # on the CPU the trace holds no device operation, so the device readers
    # read nothing
    assert set(traced["metrics"]) <= names
    assert forbidden_modules() == []


def test_cell_metric_lists():
    man = mf.Manifest()
    names = {m["name"] for m in man.metrics(CELL, "per_layer")}
    assert names == {"h2d_mb_per_trait", "device_idle_pct.farmcpu", "fc_host_ms",
                     "fc_scans_per_trait", "fc_grams_roofline_pct"}
    assert {m["name"] for m in man.metrics(CELL, "end_to_end")} == {"scan_snps_per_s",
                                                                    "setup_s"}
    assert "lambda_log10_gap" not in man.limits(CELL)


def test_control_is_not_correct(small):
    """The reference one precision step down in the program's place (the
    route has no lower path of its own)."""
    r = calibrate.readings(CELL, SEED, True, "cpu", small)
    assert r["control"] == "reference_low"
    limits = small.limits(CELL)
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["reference_low"][k] > v for k, v in limits.items()), r


def test_site_map_is_the_benchmark_scripts_simulator():
    """janusx_tpu's simulate_genotypes (models/sim.py:107-115): chromosome
    1 + floor(5 i / m), positions restarting at 10 kb on each."""
    m = 1003
    chrom, pos = site_map(np.arange(m), m, {"n_chrom": 5, "spacing_bp": 10_000})
    want_c = np.array([1 + (i * 5) // m for i in range(m)])
    want_p, counter = np.zeros(m, np.int64), {}
    for i, c in enumerate(want_c):
        counter[c] = counter.get(c, 0) + 1
        want_p[i] = counter[c] * 10_000
    np.testing.assert_array_equal(chrom, want_c)
    np.testing.assert_array_equal(pos, want_p)
    # a subset (SNPs dropped by QC) keeps each SNP's own place
    keep = np.arange(0, m, 3)
    c2, p2 = site_map(keep, m, {"n_chrom": 5, "spacing_bp": 10_000})
    np.testing.assert_array_equal(p2, want_p[keep])


def _run(names, starts, ends, dev=((0, 10), (20, 60)), traits=2, shape=None):
    ns = lambda x: np.array(x, np.int64)
    tr = TraceData(t0=0, t1=1000, dev_names=["k"] * len(dev), dev_start=ns([a for a, _ in dev]),
                   dev_end=ns([b for _, b in dev]), host_names=["jx." + n for n in names],
                   host_start=ns(starts), host_end=ns(ends), steps=[(0, 1000)])
    return RunRecord(cell=CELL, config={}, traffic={}, shape=shape or {}, steps=[],
                     window_s=1.0, setup_s=1.0, trace=tr,
                     traced=[Step(0, 1, i, 1, 10) for i in range(traits)])


def test_fc_host_ms_takes_the_union_of_its_spans():
    # fc_decode inside fc_qtn_p and inside fc_prune counts once; the scan's
    # own spans and farmcpu around them count not at all
    run = _run(["farmcpu", "fc_map", "lm_scan", "fc_qtn_p", "fc_decode", "fc_bins", "fc_rem",
                "fc_decode", "fc_prune", "fc_decode"],
               [0, 10, 30, 100, 110, 200, 300, 310, 400, 405],
               [990, 20, 90, 150, 120, 260, 350, 320, 450, 420])
    assert mf.reader("fc_host_ms")(run) == pytest.approx(1e-6 * (10 + 50 + 60 + 50 + 50) / 2)
    # the parent's program: the scan's spans, none of FarmCPU's
    assert mf.reader("fc_host_ms")(_run(["lm_scan"], [0], [10])) is None
    assert mf.reader("device_idle_pct.farmcpu")(run) == pytest.approx(95.0)


def test_counter_readers(monkeypatch):
    from janusx_tpu_torch.utils import trace

    shape = {"m": 1000, "n": 400}
    run = _run([], [], [], shape=shape)
    monkeypatch.setattr(trace, "_profiled", {})
    assert mf.reader("fc_scans_per_trait")(run) is None
    assert mf.reader("fc_grams_roofline_pct")(run) is None
    # two traits, 7 scans of widths 1, 3, 5, ... 13
    monkeypatch.setattr(trace, "_profiled", {"lm.scans": 7, "lm.design_cols": 49})
    assert mf.reader("fc_scans_per_trait")(run) == 3.5
    ops = sum(roofline.lm_grams(1000, 400, p, 1)[0] for p in range(1, 14, 2))
    nbytes = 7 * roofline.lm_grams(1000, 400, 1, 1)[1]
    want = roofline.share_pct(ops, nbytes, 50e-9)
    assert mf.reader("fc_grams_roofline_pct")(run) == pytest.approx(want)


@pytest.fixture()
def mid(tmp_path, cuda):
    return tiny_copy(tmp_path, MID)


@pytest.mark.cuda
def test_on_the_card_program_within_and_control_outside_the_limits(mid):
    r = calibrate.readings(CELL, 2**31 + 23, True, "cuda", mid)
    limits = mid.limits(CELL)
    assert all(r["program"][k] <= limits[k] for k in limits), (r["program"], limits)
    assert any(r["reference_low"][k] > limits[k] for k in limits), (r, limits)


@pytest.mark.cuda
def test_on_the_card_a_short_traced_run(mid):
    res = run(mid, trace=True, seconds=2.0, device="cuda", seed=31)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert set(res["metrics"]) == {m["name"] for m in mid.metrics(CELL, "per_layer")}
    for v in res["metrics"].values():
        assert 0 <= v["value"] <= 105 or v["unit"] != "%"
