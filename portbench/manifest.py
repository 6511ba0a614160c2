"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration, its traffic mix, its limits, its entry module and the
reader of each metric. Nothing here names a cell, a configuration or a
metric: a later cell brings its own files and entries."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Manifest:
    """``BENCHMARK.json`` and the folders it points at (``base``: the
    benchmark's own folder, which a test may swap for a copy)."""

    def __init__(self, path: Path = ROOT / "BENCHMARK.json", base: Path = HERE):
        self.path, self.base = Path(path), Path(base)
        self.bench = load_json(self.path)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return load_json(self.path.parent / c["file"])
        raise KeyError(f"no config {name!r} in {self.path}")

    def traffic(self, name: str) -> dict:
        return load_json(self.base / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        path = self.base / "limits" / f"{cell}.json"
        return load_json(path)["limits"] if path.exists() else {}

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or cell in m["workloads"]]


def entry(name: str):
    """The module ``portbench.entries.<name>``: setup, step and reference."""
    return importlib.import_module(f"portbench.entries.{name}")


def reader(name: str, base: Path = HERE):
    """``read(run) -> float | None`` of ``<base>/metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
