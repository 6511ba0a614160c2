"""On the card (``-m cuda``): each cell's program reads within its limits
and the control does not, at the configurations' sample sizes over fewer
SNPs; and a short run of each cell gives a result line."""

from __future__ import annotations

import io
import json

import pytest

from portbench import calibrate
from portbench.harness import run_cell

pytestmark = pytest.mark.cuda
MID = {"jxbench-5k-500k": dict(n_snps=32_000), "biobank-10k-1m": dict(n_snps=64_000)}


@pytest.fixture()
def mid(tmp_path, cuda):
    from conftest import tiny_copy

    return tiny_copy(tmp_path, MID)


@pytest.mark.parametrize("cell", ["jxbench-lmm-scan", "biobank-10k-splmm"])
def test_program_within_and_control_outside_the_limits(mid, cell):
    r = calibrate.readings(cell, 2**31 + 7, True, "cuda", mid)
    limits = mid.limits(cell)
    ctl = r[r["control"]]
    assert all(r["program"][k] <= limits[k] for k in limits), (r["program"], limits)
    assert any(ctl[k] > limits[k] for k in limits), (ctl, limits)


@pytest.mark.parametrize("cell", ["jxbench-lmm-scan", "biobank-10k-splmm"])
def test_a_short_traced_run(mid, cell):
    out, err = io.StringIO(), io.StringIO()
    assert run_cell(cell, 31, 2.0, True, manifest=mid, out=out, err=err) == 0, err.getvalue()
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    for v in res["metrics"].values():
        assert 0 <= v["value"] <= 105 or v["unit"] != "%"
