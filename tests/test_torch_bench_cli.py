"""The benchmark CLIs (``jx benchmark``, ``jx gblupbench``, ``jx
bayesbench``, ``jx garfieldbench``; a copy of janusx_tpu/cli/benchmark.py
run on the port's functions): the port's dispatcher against the
reference's on the CPU at toy sizes, from the same seed.

They write the reference's JSON: the same keys, the same module, route
and method rows in the same order, and the same simulated problem (n, m,
each garfieldbench gate's members). The numbers that do not depend on a
generator agree: the GBLUP route's accuracies within 1e-3 (the PCG route
solves in f32), the planted gates' recovery flags. Times differ and are
not compared; the Bayes chains draw from another generator than the
reference's, so only their rows are compared.
"""

import json

import pytest

from janusx_tpu.cli.main import main as ref_main
from janusx_tpu_torch.cli.main import _SUBENTRY
from janusx_tpu_torch.cli.main import main as port_main


def _run(tmp_path, argv, name):
    out = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        assert main([*argv, "-o", str(tmp_path / tag)]) == 0
        default = argv[0] if argv[0] != "benchmark" else "bench"
        with open(tmp_path / tag / f"{default}.{name}.json") as fh:
            out[tag] = json.load(fh)
    return out["ref"], out["port"]


def _keys(rows):
    return [sorted(r) for r in rows]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("JX_TPU_HISTORY_DB", "0")


def test_benchmark(tmp_path):
    ref, port = _run(tmp_path, ["benchmark", "-nind", "120", "-nsnp", "400", "-modules",
                                "grm,pca,lm,lmm,fvlmm,splmm,gblup,bayesa,farmcpu", "-repeats",
                                "1"], "benchmark")
    assert sorted(port) == sorted(ref) == ["m", "n", "results"]
    assert (port["n"], port["m"]) == (ref["n"], ref["m"])
    assert [r["module"] for r in port["results"]] == [r["module"] for r in ref["results"]] == [
        "grm", "pca_rsvd", "lm_scan", "lmm_scan", "fvlmm_scan", "splmm_scan", "gblup_fit",
        "bayesa_fit_400it", "farmcpu"]
    assert _keys(port["results"]) == _keys(ref["results"])
    fp, fr = port["results"][-1], ref["results"][-1]
    assert (fp["qtns"], fp["loops"]) == (fr["qtns"], fr["loops"])


def test_gblupbench(tmp_path):
    ref, port = _run(tmp_path, ["gblupbench", "-nind", "200", "-nsnp", "800", "-cv", "2",
                                "--check"], "gblupbench")
    assert sorted(port) == sorted(ref) == ["grm_seconds", "m", "n", "routes"]
    assert [r["route"] for r in port["routes"]] == [r["route"] for r in ref["routes"]] == [
        "GBLUP", "rrBLUP-PCG"]
    assert _keys(port["routes"]) == _keys(ref["routes"])
    for rp, rr in zip(port["routes"], ref["routes"]):
        for k in ("cv_pearson", "test_pearson"):
            assert rp[k] == pytest.approx(rr[k], abs=1e-3), (rp["route"], k)


def test_bayesbench(tmp_path):
    ref, port = _run(tmp_path, ["bayesbench", "-nind", "100", "-nsnp", "120", "-iters", "16",
                                "-burnin", "6", "-thin", "2", "--chains", "2"], "bayesbench")
    assert sorted(port) == sorted(ref) == ["chains", "iters", "m", "methods", "n"]
    assert [port[k] for k in ("n", "m", "iters", "chains")] == [
        ref[k] for k in ("n", "m", "iters", "chains")]
    assert [r["method"] for r in port["methods"]] == [r["method"] for r in ref["methods"]] == [
        "BLUP", "BayesA", "BayesB", "BayesCpi"]
    assert _keys(port["methods"]) == _keys(ref["methods"])
    assert port["methods"][0]["test_pearson"] == pytest.approx(
        ref["methods"][0]["test_pearson"], abs=1e-4)


def test_garfieldbench(tmp_path):
    # --and-het-max 1: at the default 0.05 no member site of the outbred
    # simulation qualifies, every rep skips and no search runs
    ref, port = _run(tmp_path, ["garfieldbench", "-nind", "200", "-nsnp", "200", "-reps", "2",
                                "-beam", "16", "--and-het-max", "1"], "garfieldbench")
    assert sorted(port) == sorted(ref) and len(port["reps"]) == 2
    assert _keys(port["reps"]) == _keys(ref["reps"])
    for rp, rr in zip(port["reps"], ref["reps"]):
        assert (rp["k"], rp["members"], rp["recovered"], rp["validated"]) == (
            rr["k"], rr["members"], rr["recovered"], rr["validated"])
    assert (port["power"], port["validated_power"]) == (ref["power"], ref["validated_power"])


def test_sub_entries_listed():
    from janusx_tpu_torch.cli.main import _help

    assert set(_SUBENTRY) == {"kmerge", "kstats", "gblupbench", "bayesbench", "garfieldbench"}
    assert all(name in _help() for name in (*_SUBENTRY, "garfield", "postgarfield",
                                            "benchmark"))
