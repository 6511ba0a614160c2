"""Fixtures of the benchmark's tests: a copy of the benchmark's files with
its configurations cut to a size the CPU runs in seconds.

Run with ``python -m pytest portbench/tests -q`` (the card's tests with
``-m cuda`` on a machine with a card)."""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import pytest

from portbench import manifest as mf

ROOT = mf.ROOT
TINY = {"jxbench-5k-500k": dict(n_samples=400, n_phenotyped=300, n_snps=3000),
        "biobank-10k-1m": dict(n_samples=300, n_phenotyped=300, n_snps=30000)}


def tiny_copy(tmp: Path, sizes: dict = TINY) -> mf.Manifest:
    """BENCHMARK.json and the benchmark's folder copied under ``tmp``, each
    configuration cut to ``sizes``; the limits are the real ones."""
    base = tmp / "portbench"
    shutil.copytree(mf.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(sizes.get(c["name"], {}))
        path.write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return mf.Manifest(tmp / "BENCHMARK.json", base)


@pytest.fixture()
def tiny(tmp_path, monkeypatch) -> mf.Manifest:
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    return tiny_copy(tmp_path)


@pytest.fixture()
def cuda():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    os.environ.pop("JX_TPU_PLATFORM", None)
