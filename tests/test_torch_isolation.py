"""Guards on the port's boundary.

- The port never imports JAX: a fresh interpreter runs the whole CPU
  slice (write a toy PLINK panel, then ``jx gwas`` through the port's CLI
  with every ported model, ``-trait-level`` over three traits of which
  one switches to LM, ``-bimrange``, ``-global``, ``-scan-method brent``,
  the sparse routes on a band-streamed and on a written ``-spk`` GRM,
  ``-lowrank`` in two genetic models with ``-lowrank-prune``, ``-algwas``)
  and must end with no ``jax`` module loaded; a second one does the same
  for ``jx gs`` and ``jx gspredict``, a third for ``jx grm``, ``jx pca``,
  ``jx gstats`` and ``jx fvlmm2 -i``, which must also load neither
  matplotlib nor pandas (so they run where neither is installed), and
  others for the Bayes/fastpop/tree slice and for ``jx garfield``,
  ``jx garfieldbench``, ``jx benchmark``, the WGCNA helpers and
  ``ASSOC._assoc_arrays``, and one for the k-mer tools, the fastq
  pipelines' dry runs and the web UI.
- The host modules the port carries as copies (janusx_tpu/__init__.py
  imports jax, so they cannot be shared by import) stay identical to their
  originals once ``janusx_tpu`` is renamed in import lines and citations
  of the upstream JanusX sources drop the local checkout prefix the
  originals give them; so do the host functions that the ported modules
  keep line for line, and the two port-owned modules that differ from
  theirs only where they name the port's package.
"""

import functools
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
                              "hapmap", "txt", "gfreader", "windowed", "native",
                              "jxgrm")]
    + [f"utils/{m}.py" for m in ("nativelib", "tsv", "prefetch", "progress", "cache")]
    + ["models/scan_common.py", "models/farmcpu.py", "cli/common.py", "utils/history.py"]
    + [f"gs/{m}.py" for m in ("__init__", "kfold", "metrics", "model_io", "workflow")]
    + ["cli/gspredict.py", "cli/pca.py", "plots/__init__.py", "plots/structure.py"]
    + ["cli/fastpop.py", "cli/tree.py", "models/mltree.py"]
    + ["models/sim.py", "utils/gff.py", "io/bin01.py", "cli/garfield.py", "cli/postgarfield.py",
       "gtools/reader.py", "cli/benchmark.py"]
    + ["io/writers.py", "models/vcomp.py", "models/lme.py"]
    + [f"cli/{m}.py" for m in ("sim", "gformat", "gmerge", "view", "refcheck", "hybrid", "reml",
                               "env", "postgwas", "postgs", "treeplot", "ggval")]
    + [f"plots/{m}.py" for m in ("gwasplots", "geneplot", "haplotype", "regionreport",
                                 "gsplots")]
    + ["models/kmer.py", "cli/kmer.py", "models/bsa.py", "cli/bsa.py", "cli/postbsa.py",
       "models/logreg.py", "utils/baseline_cpu.py", "utils/interrupt.py"]
    + [f"pipeline/{m}.py" for m in ("__init__", "executor", "fastq2vcf")]
    + ["cli/fastq2vcf.py", "cli/fastq2count.py", "ui/__init__.py", "cli/webui.py"]
)

# host modules the port keeps line for line but for the named lines (1-based),
# each of which names the port's package where the original names its own:
# a web-UI job runs the port's dispatcher, and the count step of fastq2count
# runs the port's module
PORT_OWNED = {"ui/server.py": {81, 85, 86, 87, 88}, "pipeline/fastq2count.py": {187}}

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


@pytest.mark.parametrize("rel", sorted(PORT_OWNED))
def test_port_owned_copies_differ_only_at_named_lines(rel):
    want = _renamed((ROOT / "janusx_tpu" / rel).read_text()).splitlines()
    got = (ROOT / "janusx_tpu_torch" / rel).read_text().splitlines()
    assert len(got) == len(want)
    differ = {i + 1 for i, (a, b) in enumerate(zip(got, want)) if a != b}
    assert differ and differ <= PORT_OWNED[rel], sorted(differ)
    for i in differ:
        assert "janusx_tpu_torch" in got[i - 1], got[i - 1]
        assert got[i - 1] == re.sub(r"\bjanusx_tpu\b", "janusx_tpu_torch", want[i - 1])


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
x = (g - g.mean(1, keepdims=True)).T
Y = np.stack([x @ rng.normal(0, 0.15, m) + rng.normal(size=n),
              x @ rng.normal(0, 0.15, m) + rng.normal(size=n),
              rng.normal(size=n)], axis=1)  # the third has no polygenic signal
with open(d + "/toy.pheno", "w") as fh:
    fh.write("ID\ttest0\ttest1\tnull\n")
    fh.writelines(f"s{j}\t" + "\t".join(map(str, r)) + "\n" for j, r in enumerate(Y))
with open(d + "/toy.cov", "w") as fh:
    fh.write("ID\tc0\n" + "".join(f"s{j}\t{v}\n" for j, v in enumerate(rng.normal(size=n))))
base = ["gwas", "-bfile", d + "/toy", "-p", d + "/toy.pheno"]
assert main(base + ["-lm", "-lmm", "-lmm2", "-fvlmm", "-trait-level", "-bimrange",
                    "1:0.0001-0.0003", "-o", d + "/out"]) == 0
for f in ("test0.LMM", "test1.LMM2", "null.LMM", "null.FvLMM", "traitlevel"):
    assert os.path.exists(f"{d}/out/jx.{f}.assoc.tsv"), f
assert main(base + ["-lm2", "-fvlmm2", "-farmcpu", "-c", d + "/toy.cov", "-n", "0",
                    "-o", d + "/out2"]) == 0
assert main(base + ["-lmm", "-scan-method", "brent", "-frgwas", "-global",
                    "-o", d + "/out3"]) == 0
assert main(base + ["-splmm", "-splmm-exact", "0.1", "-lowrank", "40", "-n", "0",
                    "-o", d + "/out4"]) == 0
for f in ("SparseLMM", "SparseLMM2", "FaSTLMM"):
    assert os.path.exists(f"{d}/out4/jx.test0.{f}.assoc.tsv"), f
# ALGWAS on a 31-SNP window: on 60 samples the lasso path over all 400
# SNPs reaches more markers than there are samples
assert main(base + ["-algwas", "-n", "0", "-bimrange", "1:0.0001-0.00013",
                    "-o", d + "/out6"]) == 0
assert os.path.exists(d + "/out6/jx.test0.ALGWAS.assoc.tsv")
spk = [f for f in os.listdir(d) if f.endswith(".jxgrm")]
assert len(spk) == 2, spk  # the band-streamed GRMs' caches, one per cutoff
assert main(base + ["-splmm", "-spk", d + "/" + spk[0], "-lowrank", "40", "-gmodel",
                    "dom", "-lowrank-prune", "-n", "1", "-o", d + "/out5"]) == 0
print("JAX_LOADED", "jax" in sys.modules)
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, JX_TPU_PLATFORM="cpu", JX_TPU_HISTORY_DB="0",
               PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _SLICE, str(tmp_path)], env=env,
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_LOADED False" in proc.stdout


_GS_SLICE = r"""
import os, sys
import numpy as np
from janusx_tpu_torch.io import bitcodec
from janusx_tpu_torch.io.gdata import SiteInfo
from janusx_tpu_torch.io.plink import write_plink
from janusx_tpu_torch.cli.main import main

rng = np.random.default_rng(2)
n, m = 70, 300
g = rng.binomial(2, rng.uniform(0.1, 0.5, m)[:, None], size=(m, n))
sites = SiteInfo(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                 snp=np.array([f"rs{i}" for i in range(m)], object),
                 allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
d = sys.argv[1]
write_plink(d + "/toy", bitcodec.pack_codes(g.astype(np.uint8)), n, sites,
            np.array([f"s{j}" for j in range(n)], object))
x = (g - g.mean(1, keepdims=True)).T
Y = np.stack([x @ rng.normal(0, 0.1, m) + rng.normal(size=n) for _ in range(2)], axis=1)
Y[:10] = np.nan  # the test set
with open(d + "/toy.pheno", "w") as fh:
    fh.write("ID\tt0\tt1\n")
    fh.writelines(f"s{j}\t" + "\t".join("NA" if np.isnan(v) else str(v) for v in r) + "\n"
                  for j, r in enumerate(Y))
base = ["gs", "-bfile", d + "/toy", "-p", d + "/toy.pheno", "-cv", "3"]
assert main(base + ["-BLUP", "-rrBLUP", "-GBLUPad", "-effect", "-save-model", "-select",
                    "-o", d + "/o1"]) == 0
assert main(base + ["-BLUP", "--rrblup-solver", "pcg", "-hash", "128", "-select",
                    "-o", d + "/o2"]) == 0
for f in ("o1/jxgs.t0.gebv.tsv", "o1/jxgs.t1.rrBLUP.effect.tsv", "o1/jxgs.gs.TOP.rank.tsv",
          "o2/jxgs.gs.TOP.weights.tsv"):
    assert os.path.exists(f"{d}/{f}"), f
assert main(["gspredict", "-model", d + "/o1/jxgs.t0.rrBLUP.jxmodel.npz", "-bfile",
             d + "/toy", "-o", d + "/o3"]) == 0
assert os.path.exists(d + "/o3/gspred.gebv.tsv")
print("JAX_LOADED", "jax" in sys.modules)
"""


def test_port_gs_runs_without_jax(tmp_path):
    """``jx gs`` (BLUP, rrBLUP with exports, GBLUPad, the PCG route on a
    signed-hash sketch, the TOP bundle) and ``jx gspredict`` through the
    port's CLI in a fresh interpreter, with no jax module loaded."""
    # one intra-op thread: the AI-REML and PCG loops of small torch ops
    # stall on their own threads when the suite's workers share the cores
    env = dict(os.environ, JX_TPU_PLATFORM="cpu", JX_TPU_HISTORY_DB="0",
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _GS_SLICE, str(tmp_path)], env=env,
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_LOADED False" in proc.stdout


_STRUCT_SLICE = r"""
import os, sys
import numpy as np
from janusx_tpu_torch.io import bitcodec
from janusx_tpu_torch.io.gdata import SiteInfo
from janusx_tpu_torch.io.plink import write_plink
from janusx_tpu_torch.cli.main import main

rng = np.random.default_rng(3)
n, m = 60, 300
g = rng.binomial(2, rng.uniform(0.1, 0.5, m)[:, None], size=(m, n)).astype(np.uint8)
g[:, 1] = g[:, 0]  # a duplicate pair for KING
g[rng.random((m, n)) < 0.02] = 3
sites = SiteInfo(chrom=np.array(["1"] * 150 + ["2"] * 150, object), pos=np.arange(1, m + 1),
                 snp=np.array([f"rs{i}" for i in range(m)], object),
                 allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
d = sys.argv[1]
write_plink(d + "/toy", bitcodec.pack_codes(g), n, sites,
            np.array([f"s{j}" for j in range(n)], object))
with open(d + "/toy.pheno", "w") as fh:
    fh.write("ID\tt0\n" + "".join(f"s{j}\t{v}\n" for j, v in enumerate(rng.normal(size=n))))
with open(d + "/pairs.txt", "w") as fh:
    fh.write("rs1&rs2\n!rs3|rs4\nrs5*rs6\nrs7^!rs8\nnosuch&rs1\n")
b = ["-bfile", d + "/toy"]
assert main(["grm", *b, "-sparse", "--stage-timing", "-o", d + "/g"]) == 0
assert main(["grm", *b, "-part", "3", "-o", d + "/g", "-prefix", "p"]) == 0
assert main(["pca", "-k", d + "/g/jx.cGRM.npy", "-dim", "3", "-o", d + "/k"]) == 0
assert main(["pca", *b, "-dim", "3", "-o", d + "/e"]) == 0
assert main(["pca", *b, "-dim", "3", "-rsvd", "-o", d + "/r"]) == 0
assert main(["gstats", *b, "-site", "-ind", "-king", "-ldscore", "20", "-o", d + "/s"]) == 0
assert main(["fvlmm2", *b, "-p", d + "/toy.pheno", "-i", d + "/pairs.txt", "-k",
             d + "/g/jx.cGRM.npy", "-o", d + "/f"]) == 0
for f in ("g/jx.cGRM.spgrm", "g/p.cGRM.part3_3.npy", "k/jx.eigenvec", "r/jx.eigenval",
          "s/jx.king.pairs.tsv", "f/jx.t0.fvlmm2.tsv", "f/jx.fvlmm2.skip"):
    assert os.path.exists(f"{d}/{f}"), f
print("JAX_LOADED", "jax" in sys.modules)
print("MPL_LOADED", "matplotlib" in sys.modules)
print("PANDAS_LOADED", "pandas" in sys.modules)
"""


def test_port_structure_runs_without_jax(tmp_path):
    """``jx grm`` (-sparse, -part), ``jx pca`` (-k, eigh, -rsvd), ``jx
    gstats -site -ind -king -ldscore`` and ``jx fvlmm2 -i`` through the
    port's CLI in a fresh interpreter, with no jax, matplotlib or pandas
    module loaded."""
    env = dict(os.environ, JX_TPU_PLATFORM="cpu", JX_TPU_HISTORY_DB="0",
               PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _STRUCT_SLICE, str(tmp_path)], env=env,
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for mod in ("JAX", "MPL", "PANDAS"):
        assert f"{mod}_LOADED False" in proc.stdout


_BAYES_POP_SLICE = r"""
import os, sys
import numpy as np
from janusx_tpu_torch.io import bitcodec
from janusx_tpu_torch.io.gdata import SiteInfo
from janusx_tpu_torch.io.plink import write_plink
from janusx_tpu_torch.cli.main import main

rng = np.random.default_rng(4)
n, m = 48, 200
g = rng.binomial(2, rng.uniform(0.1, 0.5, m)[:, None], size=(m, n)).astype(np.uint8)
g[:, n // 2:] = rng.binomial(2, rng.uniform(0.1, 0.9, m)[:, None], size=(m, n - n // 2))
sites = SiteInfo(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                 snp=np.array([f"rs{i}" for i in range(m)], object),
                 allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
d = sys.argv[1]
write_plink(d + "/toy", bitcodec.pack_codes(g), n, sites,
            np.array([f"s{j}" for j in range(n)], object))
y = (g - g.mean(1, keepdims=True)).T @ rng.normal(0, 0.1, m) + rng.normal(size=n)
with open(d + "/toy.pheno", "w") as fh:
    fh.write("ID\tt0\n" + "".join(f"s{j}\t{'NA' if j < 6 else v}\n" for j, v in enumerate(y)))
b = ["-bfile", d + "/toy"]
assert main(["gs", *b, "-p", d + "/toy.pheno", "-BayesA", "-BayesB", "-BayesCpi", "-cv", "2",
             "--bayes-iters", "12", "--bayes-burnin", "4", "-save-model", "-o", d + "/b"]) == 0
assert main(["gspredict", "-model", d + "/b/jxgs.t0.BayesB.jxmodel.npz", *b,
             "-o", d + "/p"]) == 0
assert main(["fastpop", *b, "-K", "2", "-cv", "-iter", "8", "-o", d + "/f"]) == 0
assert main(["adamixture", *b, "-K", "2", "-solver", "adam", "-iter", "8", "-o", d + "/a"]) == 0
assert main(["tree", *b, "-b", "5", "-nj", "bionj", "-o", d + "/t"]) == 0
assert main(["tree", *b, "-ml", "-ml-sites", "100", "-o", d + "/m"]) == 0
for f in ("b/jxgs.t0.gebv.tsv", "p/gspred.gebv.tsv", "f/fastpop.2.Q", "a/fastpop.2.P",
          "t/jxtree.nwk", "m/jxtree.ml.nwk"):
    assert os.path.exists(f"{d}/{f}"), f
print("JAX_LOADED", "jax" in sys.modules)
print("REFERENCE_LOADED", any(k.split(".")[0] == "janusx_tpu" for k in sys.modules))
print("MPL_LOADED", "matplotlib" in sys.modules)
"""


def test_port_bayes_fastpop_tree_run_without_jax(tmp_path):
    """``jx gs -BayesA -BayesB -BayesCpi`` (CV, model export, then ``jx
    gspredict``), ``jx fastpop`` (both solvers, ``-cv``, the ``adamixture``
    alias) and ``jx tree`` (``-b``, ``-nj bionj``, ``-ml``) through the
    port's CLI in a fresh interpreter: no jax, no module of janusx_tpu
    and no matplotlib loaded."""
    env = dict(os.environ, JX_TPU_PLATFORM="cpu", JX_TPU_HISTORY_DB="0",
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _BAYES_POP_SLICE, str(tmp_path)], env=env,
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for mod in ("JAX", "REFERENCE", "MPL"):
        assert f"{mod}_LOADED False" in proc.stdout


_GARFIELD_SLICE = r"""
import os, sys
import numpy as np
from janusx_tpu_torch.io import bitcodec
from janusx_tpu_torch.io.gdata import SiteInfo
from janusx_tpu_torch.io.plink import write_plink
from janusx_tpu_torch.cli.main import main

rng = np.random.default_rng(5)
n, m = 80, 160
g = rng.binomial(2, 0.4, size=(m, n)).astype(np.uint8)
sites = SiteInfo(chrom=np.array(["1"] * 80 + ["2"] * 80, object),
                 pos=np.arange(1, m + 1, dtype=np.int64) * 100,
                 snp=np.array([f"s{i}" for i in range(m)], object),
                 allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
d = sys.argv[1]
write_plink(d + "/toy", bitcodec.pack_codes(g), n, sites,
            np.array([f"i{j}" for j in range(n)], object))
y = 2.0 * ((g[10] == 2) & (g[90] == 2)) + rng.normal(size=n) * 0.5
with open(d + "/toy.pheno", "w") as fh:
    fh.write("ID\tt0\n" + "".join(f"i{j}\t{v}\n" for j, v in enumerate(y)))
b = ["garfield", "-bfile", d + "/toy", "-p", d + "/toy.pheno", "-perm", "5", "-maf", "0",
     "-geno", "1"]
assert main(b + ["-o", d + "/g1"]) == 0
assert main(b + ["-w", "4", "-o", d + "/g2"]) == 0
assert main(b + ["-width", "24", "-grm", "-o", d + "/g3"]) == 0
assert main(["garfieldbench", "-nind", "60", "-nsnp", "80", "-reps", "1", "--and-het-max", "1",
             "-o", d + "/gb"]) == 0
assert main(["benchmark", "-nind", "60", "-nsnp", "200", "-modules", "grm,lm,lmm,gblup",
             "-repeats", "1", "-o", d + "/b"]) == 0
for f in ("g1/garfield.t0.garfield.tsv", "g2/garfield.t0.garfield.windows.tsv",
          "g3/garfield.t0.garfield.tsv", "gb/garfieldbench.garfieldbench.json",
          "b/bench.benchmark.json"):
    assert os.path.exists(f"{d}/{f}"), f
from janusx_tpu_torch.api import ASSOC
from janusx_tpu_torch.gtools import cluster, cor, tom, adj
G = np.where(g == 3, np.nan, g.astype(float)).T
beta, se, p = ASSOC("lmm").fit(y)._assoc_arrays(G)
assert np.isfinite(p).all()
labels = cluster(tom(adj(cor(G[:, :60]), 4)), min_cluster_size=3)
assert labels.shape == (60,)
print("JAX_LOADED", "jax" in sys.modules)
print("REFERENCE_LOADED", any(k.split(".")[0] == "janusx_tpu" for k in sys.modules))
print("MPL_LOADED", "matplotlib" in sys.modules)
print("PANDAS_LOADED", "pandas" in sys.modules)
"""


def test_port_garfield_api_bench_run_without_jax(tmp_path):
    """``jx garfield`` (whole-genome, ``-w``, ``-width -grm``), ``jx
    garfieldbench``, ``jx benchmark``, the WGCNA helpers and
    ``ASSOC._assoc_arrays`` in a fresh interpreter: no jax, no module of
    janusx_tpu, and neither matplotlib nor pandas loaded (so they run where
    neither is installed)."""
    env = dict(os.environ, JX_TPU_PLATFORM="cpu", JX_TPU_HISTORY_DB="0",
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _GARFIELD_SLICE, str(tmp_path)], env=env,
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for mod in ("JAX", "REFERENCE", "MPL", "PANDAS"):
        assert f"{mod}_LOADED False" in proc.stdout


_TOOLS_SLICE = r"""
import importlib.abc, os, sys

BLOCKED = {"jax", "jaxlib", "pandas", "matplotlib", "sklearn"}
tried = set()


class Absent(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            tried.add(name.split(".")[0])
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None


sys.meta_path.insert(0, Absent())
from janusx_tpu_torch.cli.main import main

d = sys.argv[1]
assert main(["ggval", "gwas", "gs", "gs-vcf", "gs-hmp", "grm-pca", "-nind", "60", "-nsnp",
             "200", "-o", d + "/gg"]) == 0
assert main(["sim", "-nind", "40", "-nsnp", "150", "-miss", "0.02", "-o", d, "-prefix",
             "s"]) == 0
b = ["-bfile", d + "/s"]
assert main(["gformat", *b, "-prune", "20", "2", "0.1", "-o", d + "/f"]) == 0
assert main(["gformat", *b, "-chr", "1", "-fmt", "vcf", "-o", d + "/f", "-prefix", "v"]) == 0
assert main(["gformat", *b, "-fmt", "hmp", "-o", d + "/f", "-prefix", "h"]) == 0
ids = [ln.split()[1] for ln in open(d + "/s.fam")]
open(d + "/p1", "w").write("\n".join(ids[:3]))
open(d + "/p2", "w").write("\n".join(ids[3:6]))
assert main(["hybrid", *b, "-p1", d + "/p1", "-p2", d + "/p2", "-fmt", "plink",
             "-o", d + "/h"]) == 0
assert main(["hybrid", *b, "-p", d + "/s.pheno", "-top", "10", "-o", d + "/h"]) == 0
assert main(["gmerge", "-bfile", d + "/f/jxout", d + "/h/hybrid", "-sample-prefix",
             "-fmt", "plink", "-o", d + "/m"]) == 0
assert main(["view", d + "/s"]) == 0
assert main(["refcheck", *b, "-p", d + "/s.pheno"]) == 0
assert main(["env"]) == 0
for f in ("gg/ggval.ggval.log", "f/jxout.bed", "f/v.vcf.gz", "f/h.hmp.txt", "h/hybrid.bed",
          "h/hybrid.hybrid.tsv", "m/merged.bed"):
    assert os.path.exists(f"{d}/{f}"), f
print("TRIED", sorted(tried))
print("LOADED", sorted(m for m in BLOCKED | {"janusx_tpu"} if m in sys.modules))
"""


def test_port_tools_run_without_jax_pandas_matplotlib_sklearn(tmp_path):
    """``jx ggval gwas gs gs-vcf gs-hmp grm-pca`` (the suites chip_smoke.py
    runs) and ``jx sim``, ``jx gformat`` (-prune, -fmt vcf/hmp), ``jx
    hybrid`` (build and predict), ``jx gmerge``, ``jx view``, ``jx
    refcheck`` and ``jx env`` in a fresh interpreter whose import system
    raises on jax, pandas, matplotlib and sklearn, as on a machine where
    none of them is installed: each command exits 0 and none of them, nor
    any module of janusx_tpu, is loaded."""
    env = dict(os.environ, JX_TPU_PLATFORM="cpu", JX_TPU_HISTORY_DB="0",
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _TOOLS_SLICE, str(tmp_path)], env=env,
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]


_HOST_SLICE = r"""
import importlib, os, sys, threading, urllib.request
import numpy as np
from janusx_tpu_torch.cli.main import main

for m in ("kmer", "bsa", "postbsa", "fastq2vcf", "fastq2count", "webui"):
    importlib.import_module("janusx_tpu_torch.cli." + m)
d = sys.argv[1]
rng = np.random.default_rng(7)
base = rng.integers(0, 4, 600)
fas = []
for j in range(4):
    g = base.copy()
    flip = rng.random(600) < 0.03
    g[flip] = (g[flip] + 1) % 4
    fas.append(f"{d}/s{j}.fa")
    open(fas[-1], "w").write(">c\n" + "".join("ACGT"[b] for b in g) + "\n")
assert main(["kmer", "-i", *fas, "-k", "21", "-min-count", "1", "-stream-db", "-o", d + "/k"]) == 0
assert main(["kmer", "-i", *fas, "-k", "15", "-min-count", "1", "-tree", "-o", d + "/t"]) == 0
dbs = [f"{d}/k/kmer.s{j}.k21.jxkdb" for j in range(4)]
assert main(["kmerge", "-i", *dbs, "-min-samples", "1", "-o", d + "/m"]) == 0
assert main(["kstats", "-kbin", d + "/m/kmerged", "-o", d + "/s"]) == 0
assert main(["kstats", "-i", *dbs, "-pair", "both", "-venn", "-o", d + "/s"]) == 0
fq = d + "/fq"
os.makedirs(fq)
for mate in (1, 2):
    open(f"{fq}/x_{mate}.fq.gz", "w").write("x")
assert main(["fastq2vcf", "-fq", fq, "-ref", "ref.fa", "-dry-run", "-o", d + "/v"]) == 0
assert main(["fastq2count", "-i", fq, "-r", "ref.fa", "-a", "ann.gtf", "-w", d + "/w",
             "-dry-run"]) == 0
for f in ("m/kmerged.bed", "m/kmerged.bin", "t/kmer.kmer.nwk", "s/kstats.venn.tsv"):
    assert os.path.exists(f"{d}/{f}"), f
print("HOST_LOADED", sorted(m for m in ("pandas", "matplotlib") if m in sys.modules))
from janusx_tpu_torch.ui.server import serve

srv, state = serve(d, port=0)
threading.Thread(target=srv.serve_forever, daemon=True).start()
with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/", timeout=10) as r:
    assert r.status == 200 and "Run history" in r.read().decode()
srv.shutdown()
print("JAX_LOADED", "jax" in sys.modules)
print("REFERENCE_LOADED", any(k.split(".")[0] == "janusx_tpu" for k in sys.modules))
"""


def test_port_host_tools_run_without_jax(tmp_path):
    """``jx kmer`` (-stream-db, -tree), ``jx kmerge``, ``jx kstats`` (-kbin,
    -pair, -venn) on a toy FASTA set and ``jx fastq2vcf``/``jx fastq2count
    -dry-run`` through the port's CLI, which load neither pandas nor
    matplotlib; then the web UI's server and one GET; no jax and no module
    of janusx_tpu loaded at the end."""
    env = dict(os.environ, JX_TPU_PLATFORM="cpu", JX_TPU_HISTORY_DB=str(tmp_path / "h.db"),
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _HOST_SLICE, str(tmp_path)], env=env,
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in ("HOST_LOADED []", "JAX_LOADED False", "REFERENCE_LOADED False"):
        assert line in proc.stdout, proc.stdout[-2000:]


_PARALLEL_SLICE = r"""
import os, socket, subprocess, sys

import numpy as np
import torch

from janusx_tpu_torch.cli.main import main
from janusx_tpu_torch.io import bitcodec
from janusx_tpu_torch.io.gdata import SiteInfo
from janusx_tpu_torch.io.plink import write_plink
from janusx_tpu_torch.parallel import distributed, dryrun, mesh

d, worker = sys.argv[1], sys.argv[2]
fn, args = dryrun.entry()
fn(*args)
dryrun.dryrun_multichip(8, repeat=True)
rng = np.random.default_rng(3)
n, m = 60, 300
g = rng.binomial(2, rng.uniform(0.1, 0.5, m)[:, None], size=(m, n))
sites = SiteInfo(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                 snp=np.array([f"rs{i}" for i in range(m)], object),
                 allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
write_plink(d + "/toy", bitcodec.pack_codes(g.astype(np.uint8)), n, sites,
            np.array([f"s{j}" for j in range(n)], object))
y = (g - g.mean(1, keepdims=True)).T @ rng.normal(0, 0.15, m) + rng.normal(size=n)
with open(d + "/toy.pheno", "w") as fh:
    fh.write("ID\ttest0\n" + "".join(f"s{j}\t{v}\n" for j, v in enumerate(y)))
# a host of eight devices: jx gwas builds its mesh from them
mesh.visible_devices = lambda: [torch.device("cpu")] * 8
assert main(["gwas", "-bfile", d + "/toy", "-p", d + "/toy.pheno", "-lm", "-lmm", "-fvlmm",
             "-o", d + "/out"]) == 0
assert main(["grm", "-bfile", d + "/toy", "--distributed", "-o", d + "/grm"]) == 0
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
procs = [subprocess.Popen([sys.executable, worker, str(i), "2", str(port), d],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
         for i in range(2)]
outs = [p.communicate(timeout=180)[0] for p in procs]
assert all(p.returncode == 0 for p in procs), outs
print("WORKERS", [o.splitlines()[-1] for o in outs])
print("JAX_LOADED", "jax" in sys.modules)
print("REFERENCE_LOADED", any(k.split(".")[0] == "janusx_tpu" for k in sys.modules))
"""


def test_port_parallel_runs_without_jax(tmp_path):
    """parallel/{mesh,distributed,dryrun}.py, ``jx gwas`` on an eight-shard
    mesh, ``jx grm --distributed`` and two tests/torch_dist_worker.py
    processes over gloo: neither the parent nor a worker loads jax or a
    module of janusx_tpu."""
    env = dict(os.environ, JX_TPU_PLATFORM="cpu", JX_TPU_HISTORY_DB="0",
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("JX_TPU_DEVICES", None)
    worker = str(ROOT / "tests" / "torch_dist_worker.py")
    proc = subprocess.run([sys.executable, "-c", _PARALLEL_SLICE, str(tmp_path), worker],
                          env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in ("JAX_LOADED False", "REFERENCE_LOADED False"):
        assert line in proc.stdout, proc.stdout[-2000:]
    assert proc.stdout.count("DIST_OK") == 2, proc.stdout[-2000:]
    assert proc.stdout.count("jax_loaded=False reference_loaded=False") == 2, proc.stdout


def test_only_the_pallas_module_has_no_counterpart():
    """Every ``*.py`` of the reference package has a file of the same path
    in the port, except ``ops/pallas_kernels.py``, whose two Pallas
    kernels are ``csrc/rotate.cu`` and ``csrc/lattice.cu`` behind
    ``ops/kernels.py``."""
    rel = lambda pkg: {p.relative_to(ROOT / pkg).as_posix()
                       for p in (ROOT / pkg).rglob("*.py") if "__pycache__" not in p.parts}
    assert rel("janusx_tpu") - rel("janusx_tpu_torch") == {"ops/pallas_kernels.py"}


# the reference's modules that the port lacks: none is left
_NOT_YET = set()


def test_dispatcher_lists_every_reference_module_but_the_later_slices():
    from janusx_tpu.cli import main as ref
    from janusx_tpu_torch.cli import main as port

    want = set(ref._MODULES) | set(ref._SUBENTRY) | set(ref._ALIASES)
    have = set(port._MODULES) | set(port._SUBENTRY) | set(port._ALIASES)
    assert want - have == _NOT_YET
    assert have <= want
    for name in set(port._SUBENTRY):
        assert port._SUBENTRY[name][1:] == ref._SUBENTRY[name][1:], name
    for name in have & set(ref._MODULES):
        assert port._MODULES[name][1] == ref._MODULES[name][1] or name in (
            "gwas", "gs", "gspredict"), name
    assert port._ALIASES == ref._ALIASES


# functions that the ported modules keep line for line: (module, name)
_KEPT = (
    [("models/grm.py", "balanced_part_bounds"), ("models/pca.py", "pca_from_grm"),
     ("models/pca.py", "write_pca_outputs"), ("models/king.py", "unrelated_set"),
     ("models/king.py", "unrelated_set_from_pairs"), ("cli/grm.py", "build_parser"),
     ("cli/grm.py", "_write_spgrm"), ("cli/fvlmm2.py", "build_parser")]
    + [("cli/gstats.py", f) for f in ("build_parser", "_parse_ldsc_window", "_hist_pdf",
                                      "_ldsc_manhattan_pdf", "_sample_counts",
                                      "_row_stats_streamed", "main")]
    + [("models/combo.py", f) for f in ("ComboSpec", "_split_literal", "build_name_map",
                                        "parse_interaction_file", "literalize", "xor_dual",
                                        "make_combos", "bh_adjust")]
    + [("models/tree.py", f) for f in ("neighbor_joining", "rapid_neighbor_joining", "upgma",
                                       "nj_tree", "weighted_pair_counts",
                                       "weighted_ibs_distance", "weighted_jc_distance",
                                       "_tree_splits", "bootstrap_support",
                                       "annotate_split_support", "read_fasta_alignment",
                                       "bionj", "bionj_stats")]
    + [("models/fastpop.py", f) for f in ("AdmixtureFit", "cv_error",
                                          "write_admixture_outputs")]
    + [("models/garfield.py", f) for f in ("Rule", "GarfieldResult", "_residualize",
                                           "parse_pm_spec", "rule_null_threshold", "bh_fdr",
                                           "write_garfield_tsv")]
    + [("gtools/wgcna.py", f) for f in ("cor", "_scale_free_fit", "pick_soft_threshold", "adj",
                                        "cluster", "write_modules_tsv")]
    + [("api.py", f) for f in ("ASSOC.fit", "GenomicSelection.predict")]
)


@pytest.mark.parametrize("rel,name", _KEPT)
def test_kept_function_matches_original(rel, name):
    import importlib

    def obj(pkg):  # a function, a class, or a class's method "Class.method"
        mod = importlib.import_module(f"{pkg}.{rel[:-3].replace('/', '.')}")
        return functools.reduce(getattr, name.split("."), mod)

    original = inspect.getsource(obj("janusx_tpu"))
    assert inspect.getsource(obj("janusx_tpu_torch")) == _renamed(original)


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
