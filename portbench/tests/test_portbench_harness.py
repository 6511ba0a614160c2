"""Whole runs of the harness on the CPU at a small size (the look for a card
skipped): the result line's schema, a new traffic file run with no edit
to an existing file, and ``correct`` coming out false when the timed path
is broken underneath or replaced by the control."""

from __future__ import annotations

import dataclasses
import io
import json

import numpy as np
import pytest

from portbench import calibrate
from portbench.harness import run_cell

CELLS = {"jxbench-lmm-scan": ("janusx_tpu_torch.models.lmm", "lmm_scan"),
         "biobank-10k-splmm": ("janusx_tpu_torch.models.splmm", "splmm_grammar_scan")}
SEED = 2**31 + 4242


def run(man, cell, trace=False, seconds=1.0):
    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(cell, SEED, seconds, trace, manifest=man, device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("cell", list(CELLS))
def test_result_line_schema_and_check_lines(tiny, cell):
    res, err = run(tiny, cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"]: m["unit"] for m in tiny.metrics(cell, "end_to_end")}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    lines = err.strip().splitlines()[-len(res["checks"]):]
    for line, (k, c) in zip(lines, res["checks"].items()):
        assert line == f"check {k} {c['value']!r} limit {c['limit']!r}"
        assert c["value"] <= c["limit"]


def test_traced_run_reports_per_layer_metrics_and_the_breakdown(tiny):
    res, err = run(tiny, "jxbench-lmm-scan", trace=True)
    # an untraced window (the host clock's readings), then the traced stretch
    assert len([ln for ln in err.splitlines() if " steps in " in ln]) == 2
    assert set(res["metrics"]) <= {m["name"] for m in tiny.metrics("jxbench-lmm-scan",
                                                                    "per_layer")}
    assert "null_fit_ms" in res["metrics"]  # the CPU has no device trace to read
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


def test_a_new_traffic_file_runs_with_no_edit(tiny):
    """The T = 4 multi-trait cell is one more traffic file and one more
    BENCHMARK.json entry (here in the copy)."""
    base = tiny.base
    t4 = json.loads((base / "traffic" / "lmm-scan.json").read_text())
    t4.update(name="lmm-scan-t4", traits_per_step=4, warmup_steps=1)
    t4["check"] = {"traits": 4}
    (base / "traffic" / "lmm-scan-t4.json").write_text(json.dumps(t4))
    (base / "limits" / "jxbench-lmm-t4.json").write_text(
        (base / "limits" / "jxbench-lmm-scan.json").read_text())
    bench = json.loads(tiny.path.read_text())
    bench["workloads"].append({"name": "jxbench-lmm-t4", "config": "jxbench-5k-500k",
                               "traffic": "lmm-scan-t4", "chips": 1, "why": "four traits a step"})
    for m in bench["end_to_end"]:
        if "jxbench-lmm-scan" in m.get("workloads", []):
            m["workloads"].append("jxbench-lmm-t4")
    tiny.path.write_text(json.dumps(bench))
    from portbench import manifest as mf

    res, _ = run(mf.Manifest(tiny.path, base), "jxbench-lmm-t4")
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] % 4 == 0 and res["failed"] == 0
    assert "scan_snps_per_s" in res["metrics"]


def test_a_run_leaves_the_programs_switches_at_their_defaults(tiny, monkeypatch):
    import os

    from portbench.entries import lmm_scan

    for k in lmm_scan.CONTROL_KNOBS:
        monkeypatch.delenv(k, raising=False)
    before = {k: v for k, v in os.environ.items() if k.startswith("JX_TPU_")}
    for cell in CELLS:
        run(tiny, cell, seconds=0.5)
    assert {k: v for k, v in os.environ.items() if k.startswith("JX_TPU_")} == before
    for f in (tiny.base / "traffic").glob("*.json"):
        assert "knobs" not in json.loads(f.read_text())


def test_calibrate_restores_the_environment_exactly(monkeypatch):
    import os

    monkeypatch.setenv("PORTBENCH_TEST_SET", "a")
    monkeypatch.delenv("PORTBENCH_TEST_UNSET", raising=False)
    saved = {k: os.environ.get(k) for k in ("PORTBENCH_TEST_SET", "PORTBENCH_TEST_UNSET")}
    os.environ.update(PORTBENCH_TEST_SET="b", PORTBENCH_TEST_UNSET="c")
    calibrate.restore(saved)
    assert os.environ["PORTBENCH_TEST_SET"] == "a"
    assert "PORTBENCH_TEST_UNSET" not in os.environ


def _stale(fn):
    first = {}

    def f(*a, **k):
        out = fn(*a, **k)
        return first.setdefault("out", out)
    return f


def _half_left_out(fn):
    def f(*a, **k):
        res, x = fn(*a, **k)
        half = len(res.beta) // 2
        nan = np.full(len(res.beta) - half, np.nan)
        return dataclasses.replace(
            res, beta=np.concatenate([res.beta[:half], nan]),
            se=np.concatenate([res.se[:half], nan]),
            pwald=np.concatenate([res.pwald[:half], np.ones(len(nan))])), x
    return f


def _one_answer_altered(fn):
    def f(*a, **k):
        res, x = fn(*a, **k)
        i = int(np.nanargmax(np.abs(res.beta / res.se)))
        beta = res.beta.copy()
        beta[i] = -beta[i]
        return dataclasses.replace(res, beta=beta), x
    return f


# the cells run on one chip: no exchange between chips to leave out
FAULTS = {"state_unchanged": _stale, "half_left_out": _half_left_out,
          "answer_altered": _one_answer_altered}


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    import importlib

    mod, fn = CELLS[cell]
    m = importlib.import_module(mod)
    monkeypatch.setattr(m, fn, FAULTS[fault](getattr(m, fn)))
    res, _ = run(tiny, cell, seconds=1.5)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_is_not_correct(tiny, cell):
    """The control (the program's own lower-precision paths, else the
    reference one precision step down) against the cell's limits."""
    r = calibrate.readings(cell, SEED, True, "cpu", tiny)
    limits = tiny.limits(cell)
    ctl = r[r["control"]]
    assert any(ctl[k] > limits[k] for k in limits), (ctl, limits)
    assert all(r["program"][k] <= limits[k] for k in limits), (r["program"], limits)


def test_sign_mismatch_counts_flips_away_from_zero():
    from portbench import compare

    ref = {"beta": np.array([1.0, -2.0, 0.001, 3.0]), "se": np.ones(4),
           "p": np.full(4, 0.5), "lam": 1.0}
    prog = dict(ref, beta=np.array([1.0, 2.0, -0.001, -3.0]))
    g = compare.gaps([prog], [ref])
    # SNP 2 sits within SIGN_Z of zero in the reference: its flip is rounding
    assert g["sign_mismatch"] == 2.0 and g["logp_gap"] == 0.0


def test_a_run_pins_itself_to_four_cores_and_threads():
    import os
    import subprocess
    import sys

    from portbench.manifest import ROOT

    code = ("from portbench.run import pin; pin(); import os, torch; "
            "print(len(os.sched_getaffinity(0)), os.environ['OMP_NUM_THREADS'], "
            "torch.get_num_threads())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
    k = min(4, len(os.sched_getaffinity(0)))
    assert out == [str(k)] * 3


def test_device_readers_count_the_traced_steps_only():
    """A traced run's untraced window has many more steps than its trace:
    the rooflines divide the traced steps' bound by the traced time."""
    from portbench import manifest as mf
    from portbench import roofline
    from portbench.harness import RunRecord, Step
    from portbench.trace import TraceData

    ns = lambda x: np.array(x, np.int64)
    tr = TraceData(t0=0, t1=10**9, dev_names=["decode_rotate_wgmma"] * 2,
                   dev_start=ns([0, 5 * 10**8]), dev_end=ns([10**8, 6 * 10**8]),
                   host_names=[], host_start=ns([]), host_end=ns([]))
    shape = {"m": 1000, "n": 64, "N": 64}
    run = RunRecord(cell="c", config={}, traffic={}, shape=shape,
                    steps=[Step(0, 1, i, 1, 1000) for i in range(30)], window_s=30.0,
                    setup_s=1.0, trace=tr, traced=[Step(0, 1, i, 1, 1000) for i in range(2)])
    want = roofline.share_pct(*(2 * x for x in roofline.k1(1000, 64, 64)), 0.2)
    assert mf.reader("k1_roofline_pct")(run) == pytest.approx(want)
