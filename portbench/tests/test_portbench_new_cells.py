"""The cells ``jxbench-lmm-t4`` (four traits a step of the dense scan) and
``fastlmm-60k-lowrank`` (``jx gwas -lowrank``) run whole on the CPU at a
small size, each configuration cut by sizes of its own: ``correct``, the
metrics each cell lists, and no module of JAX or the JAX package loaded.
The low-rank cell's readers of the program's spans and counter are held
on a trace made by hand."""

from __future__ import annotations

import io
import json

import numpy as np
import pytest

from portbench import calibrate
from portbench import manifest as mf
from portbench.harness import RunRecord, Step, forbidden_modules, run_cell
from portbench.trace import TraceData

from conftest import tiny_copy

SEED = 2**31 + 1919
SIZES = {"jxbench-5k-500k": dict(n_samples=400, n_phenotyped=300, n_snps=3000),
         "fastlmm-60k-250k": dict(n_samples=400, n_phenotyped=400, n_snps=3000,
                                  lowrank_snps=256)}
CELLS = ("jxbench-lmm-t4", "fastlmm-60k-lowrank")


@pytest.fixture()
def small(tmp_path, monkeypatch) -> mf.Manifest:
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    return tiny_copy(tmp_path, SIZES)


def run(man, cell, trace=False, seconds=1.0):
    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(cell, SEED, seconds, trace, manifest=man, device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_new_cell_runs_correct_with_its_metrics(small, cell):
    res = run(small, cell)
    assert res["correct"] is True, res["checks"]
    T = small.traffic(small.cell(cell)["traffic"])["traits_per_step"]
    assert res["failed"] == 0 and res["attempted"] >= T and res["attempted"] % T == 0
    want = {m["name"]: m["unit"] for m in small.metrics(cell, "end_to_end")}
    assert {"scan_snps_per_s", "setup_s"} <= set(want)
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert set(res["checks"]) == set(small.limits(cell))
    traced = run(small, cell, trace=True, seconds=0.5)
    assert traced["correct"] is True, traced["checks"]
    assert set(traced["metrics"]) <= {m["name"] for m in small.metrics(cell, "per_layer")}
    assert forbidden_modules() == []


def test_lowrank_cell_metric_lists():
    man = mf.Manifest()
    names = {m["name"] for m in man.metrics("fastlmm-60k-lowrank", "per_layer")}
    assert names == {"k1_roofline_pct", "h2d_mb_per_trait", "feed_idle_ms",
                     "device_idle_pct.lowrank", "lr_host_ms", "lr_scan_idle_ms",
                     "lr_superblocks_per_trait"}
    names = {m["name"] for m in man.metrics("jxbench-lmm-t4", "per_layer")}
    assert names == {"k1_roofline_pct", "k2_roofline_pct", "device_idle_pct.lmm",
                     "h2d_mb_per_trait", "feed_idle_ms", "scan_host_idle_ms"}


def test_lowrank_control_is_not_correct(small):
    """The reference one precision step down in the program's place (the
    route calls K1 at ``highest`` and has no lower path of its own)."""
    r = calibrate.readings("fastlmm-60k-lowrank", SEED, True, "cpu", small)
    assert r["control"] == "reference_low"
    limits = small.limits("fastlmm-60k-lowrank")
    assert any(r["reference_low"][k] > v for k, v in limits.items()), r
    assert all(r["program"][k] <= v for k, v in limits.items()), r


def _run(names, starts, ends, dev=((0, 10),), traits=2):
    ns = lambda x: np.array(x, np.int64)
    tr = TraceData(t0=0, t1=1000, dev_names=["k"] * len(dev), dev_start=ns([a for a, _ in dev]),
                   dev_end=ns([b for _, b in dev]), host_names=["jx." + n for n in names],
                   host_start=ns(starts), host_end=ns(ends), steps=[(0, 1000)])
    return RunRecord(cell="c", config={}, traffic={}, shape={}, steps=[], window_s=1.0,
                     setup_s=1.0, trace=tr, traced=[Step(0, 1, i, 1, 10) for i in range(traits)])


def test_lr_host_ms_takes_the_union_of_nested_spans():
    # lr_null inside lr_null (the switch test around the null fit) counts once
    run = _run(["lr_rotate_y", "lr_null", "lr_null", "lowrank_scan"],
               [100, 300, 310, 500], [200, 400, 390, 900])
    assert mf.reader("lr_host_ms")(run) == pytest.approx(1e-6 * 200 / 2)


def test_lr_scan_idle_ms_reads_only_a_program_with_the_route_span():
    read = mf.reader("lr_scan_idle_ms")
    # the parent's program: the shared scan spans, no route span
    assert read(_run(["superblock", "kernels"], [100, 150], [900, 800])) is None
    run = _run(["lowrank_scan", "superblock", "kernels", "lr_lattice"],
               [50, 100, 150, 300], [950, 900, 800, 700])
    # device busy 0-10 only: idle 50-950 inside the route, split by span
    assert read(run) == pytest.approx(1e-6 * 900 / 2)
    assert mf.reader("lr_superblocks_per_trait")(_run([], [], [], dev=())) is None
