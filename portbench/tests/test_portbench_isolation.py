"""No module whose top-level name is JAX's or the JAX package's is loaded
by a run of either cell (compared by whole top-level names, so
``janusx_tpu_torch`` passes and ``janusx_tpu`` does not)."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

from portbench import manifest as mf

SCRIPT = r"""
import os, sys, pathlib, io
sys.path.insert(0, sys.argv[2])
from conftest import tiny_copy
import portbench.run, portbench.calibrate
from portbench.harness import run_cell, forbidden_modules
man = tiny_copy(pathlib.Path(sys.argv[1]))
for cell in ("jxbench-lmm-scan", "biobank-10k-splmm"):
    for trace in (False, True):
        rc = run_cell(cell, 17, 0.3, trace, manifest=man, device="cpu",
                      out=io.StringIO(), err=io.StringIO())
        print("RC", cell, trace, rc)
print("TOP", sorted({m.split(".")[0] for m in sys.modules}))
print("FORBIDDEN", forbidden_modules())
"""


def test_runs_load_neither_jax_nor_the_jax_package(tmp_path):
    env = dict(os.environ, JX_TPU_PLATFORM="cpu")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path),
                           str(Path(__file__).parent)], cwd=mf.ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert out.count("RC ") == 4 and all(line.endswith(" 0") for line in out.splitlines()
                                          if line.startswith("RC ")), out
    assert "FORBIDDEN []" in out, out
    tops = out.split("TOP ", 1)[1].splitlines()[0]
    assert "'janusx_tpu_torch'" in tops and "'janusx_tpu'" not in tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "janusx_tpu_torchlike", sys)
    assert "janusx_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
