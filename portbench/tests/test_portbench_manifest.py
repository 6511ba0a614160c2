"""``BENCHMARK.json`` against the benchmark's contract, and the discovery of
every cell's pieces by name from files."""

from __future__ import annotations

import ast
import json
import re

import pytest

from portbench import manifest as mf

ROOT = mf.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def one_line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_shape():
    assert set(BENCH) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_configs_cells_and_metrics_follow_the_rules():
    names = set()
    cfgs = {c["name"] for c in BENCH["configs"]}
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
    assert cfgs == {w["config"] for w in cells}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        for wl in m.get("workloads", []):
            assert wl in {w["name"] for w in cells}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        for wl in m.get("workloads", [w["name"] for w in cells]):
            assert wl in e2e[m["moves"]].get("workloads", [wl]), (m["name"], wl)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline_pct") or m["name"].endswith("_roofline")
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    man = mf.Manifest()
    e2e = {m["name"] for m in man.metrics(cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert man.metrics(cell, "per_layer")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_finds_its_pieces_by_name(cell):
    man = mf.Manifest()
    w = man.cell(cell)
    cfg = man.config(w["config"])
    tr = man.traffic(w["traffic"])
    assert cfg["name"] == w["config"] and tr["name"] == w["traffic"]
    ent = mf.entry(tr["entry"])
    for fn in ("setup", "step", "reference"):
        assert callable(getattr(ent, fn))
    limits = man.limits(cell)
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    for m in man.metrics(cell, "end_to_end") + man.metrics(cell, "per_layer"):
        assert callable(mf.reader(m["name"]))


def test_every_metric_file_and_traffic_file_is_named_for_its_entry():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (mf.HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for p in (mf.HERE / "traffic").glob("*.json"):
        assert json.loads(p.read_text())["name"] == p.stem


def test_a_new_metric_is_found_by_its_file(tmp_path):
    import shutil

    base = tmp_path / "pb"
    shutil.copytree(mf.HERE / "metrics", base / "metrics")
    (base / "metrics" / "steps_done.x.py").write_text(
        "def read(run):\n    return len(run.steps)\n")
    assert mf.reader("steps_done.x", base)(type("R", (), {"steps": [1, 2]})()) == 2


FORBIDDEN = {"jax", "jaxlib", "flax", "janusx_tpu"}


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in mf.HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN, (path, tops)
