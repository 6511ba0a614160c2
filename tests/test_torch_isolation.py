"""Guards on the port's boundary.

- The port never imports JAX: a fresh interpreter runs the whole CPU
  slice (write a toy PLINK panel, ``jx gwas -lmm`` through the port's CLI)
  and must end with no ``jax`` module loaded.
- The host modules the port carries as copies (janusx_tpu/__init__.py
  imports jax, so they cannot be shared by import) stay identical to their
  originals once ``janusx_tpu`` is renamed in import lines and citations
  of the upstream JanusX sources drop the local checkout prefix the
  originals give them.
"""

import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

COPIES = (
    ["io/__init__.py"]
    + [f"io/{m}.py" for m in ("gdata", "bitcodec", "packed", "plink", "pheno", "vcf",
                              "hapmap", "txt", "gfreader", "windowed", "native")]
    + [f"utils/{m}.py" for m in ("nativelib", "tsv", "prefetch", "progress", "cache")]
    + ["models/scan_common.py", "cli/common.py"]
)

_IMPORT = re.compile(r"^\s*(from|import)\s+janusx_tpu\b")


# the originals cite upstream JanusX sources under a local checkout path
# (/<dir>/reference/src/...); the copies cite them as "JanusX src/..."
_CHECKOUT = re.compile(r"/\w+/reference/")


def _renamed(text: str) -> str:
    text = _CHECKOUT.sub("JanusX ", text)
    return "".join(re.sub(r"\bjanusx_tpu\b", "janusx_tpu_torch", ln) if _IMPORT.match(ln)
                   else ln for ln in text.splitlines(keepends=True))


@pytest.mark.parametrize("rel", COPIES)
def test_host_copy_matches_original(rel):
    original = (ROOT / "janusx_tpu" / rel).read_text()
    copy = (ROOT / "janusx_tpu_torch" / rel).read_text()
    assert copy == _renamed(original), f"janusx_tpu_torch/{rel} drifted from janusx_tpu/{rel}"


def test_gwas_parser_is_the_reference_parser():
    from janusx_tpu.cli.gwas import build_parser as j_parser
    from janusx_tpu_torch.cli.gwas import build_parser as t_parser

    assert inspect.getsource(t_parser) == inspect.getsource(j_parser)


_SLICE = r"""
import os, sys
import numpy as np
from janusx_tpu_torch.io import bitcodec
from janusx_tpu_torch.io.gdata import SiteInfo
from janusx_tpu_torch.io.plink import write_plink
from janusx_tpu_torch.cli.main import main

rng = np.random.default_rng(1)
n, m = 60, 400
g = rng.binomial(2, rng.uniform(0.1, 0.5, m)[:, None], size=(m, n))
sites = SiteInfo(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                 snp=np.array([f"rs{i}" for i in range(m)], object),
                 allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
d = sys.argv[1]
write_plink(d + "/toy", bitcodec.pack_codes(g.astype(np.uint8)), n, sites,
            np.array([f"s{j}" for j in range(n)], object))
y = (g - g.mean(1, keepdims=True)).T @ rng.normal(0, 0.1, m) + rng.normal(size=n)
with open(d + "/toy.pheno", "w") as fh:
    fh.write("ID\ttest0\n" + "".join(f"s{j}\t{v}\n" for j, v in enumerate(y)))
assert main(["gwas", "-bfile", d + "/toy", "-p", d + "/toy.pheno", "-lmm",
             "-force-model", "-n", "0", "-o", d + "/out"]) == 0
assert os.path.exists(d + "/out/jx.test0.LMM.assoc.tsv")
print("JAX_LOADED", "jax" in sys.modules)
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, JX_TPU_PLATFORM="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _SLICE, str(tmp_path)], env=env,
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_LOADED False" in proc.stdout


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(p) for p in (ROOT / "janusx_tpu_torch").rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []


def test_cuda_request_without_card_raises(monkeypatch):
    from janusx_tpu_torch import config

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("JX_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        config.resolve_device()
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    assert config.resolve_device().type == "cpu"
