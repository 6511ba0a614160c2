"""The port's genotype-tool and validation CLIs against the reference's, on
the CPU, through both dispatchers (``janusx_tpu.cli.main`` and
``janusx_tpu_torch.cli.main``, the port under JX_TPU_PLATFORM=cpu).

Inputs are one simulated panel (``jx sim`` of the reference: 120 samples,
half in families of 5, x 600 SNPs on 3 chromosomes, 2 % missing calls).
Bounds:
- byte-identical: every file ``jx sim``, ``jx gformat`` (plink, vcf, hmp,
  txt, npy; -prune with a count and a kb window; the filters of
  tests/test_cli.py), ``jx gmerge``, ``jx hybrid`` build mode (all four
  -fmt), ``jx reml`` (given the same GRM), ``jx postgwas`` (the top-hit and
  clump tables) and ``jx postgs`` (the metric table) write, the standard
  output of ``jx view`` and ``jx refcheck``, and the Newick tree ``jx
  treeplot`` draws;
- ``jx hybrid`` predict: the values within atol 1e-4 of the reference's
  (both print %.4f; the GRM under them agrees to rtol 1e-6,
  tests/test_torch_grm.py) and the same top 20 crosses off ties;
- plots: only that they exist;
- ``jx ggval all -nind 120 -nsnp 300``: every check PASS, and the same
  check names as the reference's run.
"""

import os
import re

import numpy as np
import pytest

from janusx_tpu.cli.main import main as j_jx
from janusx_tpu_torch.cli.main import main as t_jx

NEW_MODULES = ("sim", "simulation", "gformat", "postgwas", "reml", "gmerge", "env", "postgs",
               "hybrid", "view", "refcheck", "ggval", "treeplot")


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JX_TPU_PLATFORM", "cpu")
        mp.setenv("JX_TPU_HISTORY_DB", "0")
        yield


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    out = tmp_path_factory.mktemp("panel")
    assert j_jx(["sim", "-nind", "120", "-nsnp", "600", "-nchr", "3", "-nqtl", "10",
                 "-h2", "0.6", "-structure", "mixed", "-miss", "0.02", "-seed", "7",
                 "-o", str(out), "-prefix", "sim"]) == 0
    return str(out / "sim")


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d)) if not f.endswith(".log")}


def _both(tmp_path, argv, prefix="x"):
    """One command through both CLIs, outputs under tmp_path/ref and
    tmp_path/port with the same prefix; returns each side's files."""
    got = {}
    for name, main in (("ref", j_jx), ("port", t_jx)):
        d = tmp_path / name
        assert main(argv + ["-o", str(d), "-prefix", prefix]) == 0, name
        got[name] = _files(d)
    return got["ref"], got["port"]


def _same_files(tmp_path, argv, prefix="x", skip_col=None):
    """Every output byte-identical; ``skip_col`` names a TSV column of
    wall seconds, left out of the comparison."""
    ref, port = _both(tmp_path, argv, prefix)
    assert sorted(port) == sorted(ref)
    for f in ref:
        a, b = port[f], ref[f]
        if skip_col and f.endswith(".tsv"):
            a, b = (_drop_col(x.decode(), skip_col) for x in (a, b))
        assert a == b, f
    return port


def _drop_col(text: str, col: str) -> list:
    rows = [ln.split("\t") for ln in text.splitlines()]
    k = rows[0].index(col) if col in rows[0] else None
    return [r[:k] + r[k + 1:] if k is not None else r for r in rows]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_help_of_each_new_module(module, capsys):
    with pytest.raises(SystemExit) as e:
        t_jx([module, "-h"])
    assert e.value.code == 0
    assert "usage:" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["-structure", "mixed", "-ntrait", "2", "-miss", "0.05",
                                        "-na-rate", "0.1", "-dom-pve", "0.2"]],
                         ids=["defaults", "mixed"])
def test_sim_matches_reference(tmp_path, extra):
    port = _same_files(tmp_path, ["sim", "-nind", "80", "-nsnp", "300", "-seed", "3", *extra])
    assert {"x.bed", "x.bim", "x.fam", "x.pheno", "x.qtl.tsv"} <= set(port)


def test_simulation_alias(tmp_path):
    for name, argv0 in (("a", "sim"), ("b", "simulation")):
        assert t_jx([argv0, "-nind", "30", "-nsnp", "50", "-o", str(tmp_path / name)]) == 0
    assert _files(tmp_path / "a") == _files(tmp_path / "b")


@pytest.mark.parametrize("args", [
    ["-fmt", "plink"], ["-fmt", "vcf"], ["-fmt", "hmp"], ["-fmt", "txt"], ["-fmt", "npy"],
    ["-make-vcf", "-make-hmp"],
    ["-prune", "50", "5", "0.05"], ["-prune", "200kb", "2", "0.05", "-fmt", "vcf"],
    ["-chr", "2", "-from-bp", "300000", "-to-bp", "1200000", "-snp-name", "chr_pos"],
    ["-chr", "1,3", "-maf", "0.1", "-geno", "0.02", "-snps-only", "-fmt", "hmp"],
], ids=["plink", "vcf", "hmp", "txt", "npy", "make-vcf-hmp", "prune-count", "prune-kb",
        "region-rename", "chr-qc"])
def test_gformat_matches_reference(panel, tmp_path, args):
    port = _same_files(tmp_path, ["gformat", "-bfile", panel, *args])
    assert port


def test_gformat_keep_extract_match_reference(panel, tmp_path):
    from janusx_tpu_torch.io import plink

    orig = plink.read_plink(panel)
    keep = tmp_path / "keep.txt"
    keep.write_text("\n".join(str(s) for s in orig.samples[5:42]))
    sites = tmp_path / "sites.txt"
    sites.write_text("\n".join(f"{orig.sites.chrom[i]}:{orig.sites.pos[i]}"
                               for i in range(0, orig.m, 3)))
    ranges = tmp_path / "ranges.txt"
    ranges.write_text("1 20000 900000\n3 0 400000\n")
    port = _same_files(tmp_path, ["gformat", "-bfile", panel, "-keep", str(keep), "-extract",
                                  str(sites), "-fmt", "npy"])
    assert np.load(tmp_path / "port" / "x.npy").shape == (len(range(0, orig.m, 3)), 37)
    assert port
    _same_files(tmp_path / "r", ["gformat", "-bfile", panel, "-extract", "range", str(ranges),
                                 "-snp-name", "{chr}_{pos}", "-fmt", "txt"])


def test_gformat_prune_removes_and_matches(panel, tmp_path):
    """The prune threshold that the byte-equal cases use does drop SNPs,
    so the greedy walk's decisions are compared, not only the copy."""
    _same_files(tmp_path, ["gformat", "-bfile", panel, "-prune", "50", "5", "0.05"])
    with open(tmp_path / "port" / "x.bim") as fh, open(panel + ".bim") as src:
        assert 0 < sum(1 for _ in fh) < sum(1 for _ in src)


@pytest.mark.parametrize("fmt", ["plink", "vcf", "hmp"])
def test_gmerge_matches_reference(panel, tmp_path, fmt):
    from janusx_tpu_torch.io import plink

    gd = plink.read_plink(panel)
    halves = []
    for k, idx in enumerate((np.arange(0, 70), np.arange(70, gd.n))):
        halves.append(str(tmp_path / f"h{k}"))
        plink.write_plink_genotypes(halves[-1], gd.take_samples(idx))
    port = _same_files(tmp_path / "m", ["gmerge", "-bfile", *halves, "-fmt", fmt,
                                        "-sample-prefix", "-maf", "0.05"])
    assert port
    if fmt == "plink":
        # without a filter the merge of the halves is the whole panel
        _same_files(tmp_path / "w", ["gmerge", "-bfile", *halves, "-fmt", "plink"])
        assert (tmp_path / "w" / "port" / "x.bed").read_bytes() == open(panel + ".bed",
                                                                         "rb").read()


def _stdout_both(capsys, argv):
    out = []
    for main in (j_jx, t_jx):
        assert main(argv) == 0
        out.append(capsys.readouterr().out)
    return out


def test_view_matches_reference(panel, tmp_path, capsys):
    from janusx_tpu_torch.io.jxgrm import write_jxgrm
    import scipy.sparse as sp

    K = np.eye(6) + 0.1
    np.save(tmp_path / "k.npy", K)
    np.savez(tmp_path / "m.npz", a=K, b=np.arange(3))
    write_jxgrm(str(tmp_path / "k.jxgrm"), sp.csr_matrix(np.where(K > 0.5, K, 0.0)))
    for argv in ([panel], [panel, "-head", "3"], [str(tmp_path / "k.npy")],
                 [str(tmp_path / "m.npz")], [str(tmp_path / "k.jxgrm")]):
        ref, port = _stdout_both(capsys, ["view", *argv])
        assert port == ref and port, argv


def test_refcheck_matches_reference(panel, tmp_path, capsys):
    ris = tmp_path / "refs.ris"
    ris.write_text("TY  - JOUR\nTI  - A study\nAU  - Smith, John\nAU  - Smith, John\n"
                   "ER  - \nTY  - JOUR\nTI  - A study\nAU  - Doe, J\nSP  - 5\nN1  - x\n"
                   "ER  - \n")
    for argv in (["-bfile", panel, "-p", panel + ".pheno", "-g2", panel], ["-i", str(ris)]):
        ref, port = _stdout_both(capsys, ["refcheck", *argv])
        assert port == ref and port, argv
    assert "matched=120" in port or "checked 2 entries" in port


def test_env_lists_the_ports_knobs(capsys, monkeypatch):
    from janusx_tpu import config as ref
    from janusx_tpu_torch import config

    # the knobs the port reads that its table lacked: the reference's entries
    for name in ("JX_TPU_ML_SITE_BUDGET", "JX_TPU_HISTORY_DB"):
        assert config.KNOBS[name] == ref.KNOBS[name], name

    monkeypatch.setenv("JX_TPU_SNP_BLOCK", "1024")
    assert t_jx(["env"]) == 0
    out = capsys.readouterr().out
    names = [ln.split()[0].rstrip("*") for ln in out.splitlines()[1:]
             if ln.strip() and ln[0] != "("]
    assert names == list(config.KNOBS)
    assert re.search(r"^JX_TPU_SNP_BLOCK\s*\*\s+1024\s", out, re.M)
    assert t_jx(["env", "-set-only"]) == 0
    shown = [ln.split()[0].rstrip("*")
             for ln in capsys.readouterr().out.splitlines()[1:] if ln.strip()]
    assert set(shown) == {k for k in config.KNOBS if k in os.environ}


@pytest.mark.parametrize("fmt", ["plink", "vcf", "txt", "npy"])
def test_hybrid_build_matches_reference(panel, tmp_path, fmt):
    from janusx_tpu_torch.io import plink

    ids = [str(s) for s in plink.read_plink(panel).samples]
    (tmp_path / "p1.txt").write_text("\n".join(ids[:5] + ["absent"]))
    (tmp_path / "p2.txt").write_text("\n".join(ids[40:44]))
    port = _same_files(tmp_path, ["hybrid", "-bfile", panel, "-p1", str(tmp_path / "p1.txt"),
                                  "-p2", str(tmp_path / "p2.txt"), "-fmt", fmt])
    assert port


def _hybrid_rows(path):
    with open(path) as fh:
        assert fh.readline() == "parent1\tparent2\tpredicted\n"
        return [(a, b, float(v)) for a, b, v in (ln.split("\t") for ln in fh)]


def test_hybrid_predict_matches_reference(panel, tmp_path):
    ids = [ln.split()[1] for ln in open(panel + ".fam")]
    (tmp_path / "crosses.tsv").write_text("".join(f"{ids[i]}\t{ids[j]}\n"
                                                  for i in range(0, 60, 3)
                                                  for j in range(1, 120, 7)))
    for extra, top in ((["-top", "0"], None), ([], 50),
                       (["-top", "0", "-crosses", str(tmp_path / "crosses.tsv")], None)):
        ref, port = _both(tmp_path / str(top) / str(len(extra)),
                          ["hybrid", "-bfile", panel, "-p", panel + ".pheno", *extra])
        r = _hybrid_rows(tmp_path / str(top) / str(len(extra)) / "ref" / "x.hybrid.tsv")
        p = _hybrid_rows(tmp_path / str(top) / str(len(extra)) / "port" / "x.hybrid.tsv")
        assert len(p) == len(r) == (top or len(p)) > 0
        want = {(a, b): v for a, b, v in r}
        got = {(a, b): v for a, b, v in p}
        if top is None:
            assert sorted(got) == sorted(want)
        else:  # the top 50: the same set but at the tie-broken border
            border = r[-1][2]
            assert {k for k, v in got.items() if v > border + 1e-4} <= set(want)
        # atol 1e-4: one unit of the %.4f both print
        common = [k for k in got if k in want]
        units = np.rint(np.array([[got[k], want[k]] for k in common]) * 1e4)
        assert np.abs(units[:, 0] - units[:, 1]).max() <= 1
        # the same top 20 off ties (values within the print bound of the 20th)
        cut = r[19][2]
        assert ({(a, b) for a, b, v in p[:20] if abs(v - cut) > 2e-4}
                == {(a, b) for a, b, v in r[:20] if abs(v - cut) > 2e-4})


@pytest.fixture(scope="module")
def grm_npy(panel, tmp_path_factory):
    out = tmp_path_factory.mktemp("grm")
    assert j_jx(["grm", "-bfile", panel, "-o", str(out), "-prefix", "g"]) == 0
    return str(out / "g.cGRM.npy")


@pytest.mark.parametrize("extra", [[], ["-n", "trait0", "-maxiter", "50"]], ids=["all", "n"])
def test_reml_with_grm_matches_reference(panel, grm_npy, tmp_path, extra):
    port = _same_files(tmp_path, ["reml", "-p", panel + ".pheno", "-k", grm_npy, *extra],
                       skip_col="elapsed_sec")
    assert "x.reml.summary.tsv" in port


def test_reml_design_matches_reference(tmp_path):
    rng = np.random.default_rng(11)
    rows = ["lines\ttr\tyear\tloc\tx"]
    u = rng.normal(size=60)
    for line in range(60):
        for yi, yr in enumerate(("2022", "2023")):
            for li, lc in enumerate(("HZ", "HF", "WH")):
                y = 10 + u[line] + 0.5 * yi + 0.3 * li + rng.normal()
                rows.append(f"L{line:03d}\t{y:.6f}\t{yr}\t{lc}\t{rng.normal():.4f}")
    (tmp_path / "p.tsv").write_text("\n".join(rows) + "\n")
    port = _same_files(tmp_path, ["reml", "-p", str(tmp_path / "p.tsv"), "-n", "tr", "-c",
                                  "year,loc", "-gxe", "loc", "-gxc", "x"], skip_col="elapsed_sec")
    assert "x.reml.summary.tsv" in port


@pytest.fixture(scope="module")
def assoc(panel, tmp_path_factory):
    out = tmp_path_factory.mktemp("assoc")
    assert t_jx(["gwas", "-bfile", panel, "-p", panel + ".pheno", "-lm", "-lmm",
                 "-force-model", "-o", str(out), "-prefix", "a"]) == 0
    return str(out / "a.trait0.LM.assoc.tsv"), str(out / "a.trait0.LMM.assoc.tsv")


def test_postgwas_tables_match_reference(panel, assoc, tmp_path):
    ref, port = _both(tmp_path, ["postgwas", "-i", *assoc, "-bfile", panel, "-LDclump",
                                 "100kb", "0.2", "-thr", "0.01", "-manh-merge"])
    tables = [f for f in ref if f.endswith((".top.tsv", ".clumped.tsv"))]
    assert len(tables) == 4 and sorted(port) == sorted(ref)
    for f in tables:
        assert port[f] == ref[f], f
    assert "x.manhattan.merge.png" in port and "x.a.trait0.LMM.qq.png" in port
    ref, port = _both(tmp_path / "ld", ["postgwas", "-i", assoc[0], "-ldblock", "1:10000-300000",
                                        "-bfile", panel])
    assert any(f.startswith("x.ldblock.") for f in port) and sorted(port) == sorted(ref)


def test_postgs_table_matches_reference(panel, tmp_path):
    gs = tmp_path / "gs"
    assert t_jx(["gs", "-bfile", panel, "-p", panel + ".pheno", "-BLUP", "-rrBLUP", "-cv", "3",
                 "-effect", "-o", str(gs), "-prefix", "g"]) == 0
    ref, port = _both(tmp_path, ["postgs", "-i", str(gs / "g.gs.summary.json"), "-oof",
                                 str(gs / "g.trait0.oof.tsv"), "-effect",
                                 str(gs / "g.trait0.rrBLUP.effect.tsv")])
    assert port["x.gs.metrics.tsv"] == ref["x.gs.metrics.tsv"]
    assert sorted(port) == sorted(ref) and "x.cv.violin.png" in port


def test_treeplot_draws_the_reference_tree(grm_npy, tmp_path, monkeypatch):
    import janusx_tpu.cli.treeplot as jt
    import janusx_tpu_torch.cli.treeplot as tt

    texts = {}
    for name, mod in (("ref", jt), ("port", tt)):
        parse = mod.parse_newick
        monkeypatch.setattr(mod, "parse_newick",
                            lambda text, _n=name, _p=parse: texts.setdefault(_n, []).append(text)
                            or _p(text))
    nwk = tmp_path / "t.nwk"
    nwk.write_text("((a:1,b:2):0.5,(c:1,(d:0.2,e:0.3):0.4):0.7);\n")
    for argv in (["-k", grm_npy], ["-k", grm_npy, "-method", "upgma", "-layout", "c"],
                 ["-i", str(nwk), "-root", "d", "-layout", "w", "-showlabels"]):
        ref, port = _both(tmp_path / str(len(texts.get("ref", []))), ["treeplot", *argv])
        assert sorted(port) == sorted(ref) == ["x.tree.png"]
    assert texts["port"] == texts["ref"] and len(texts["port"]) == 3
    assert texts["port"][0].startswith("(") and texts["port"][0].rstrip().endswith(";")


def _checks(out: str) -> list:
    return [re.split(r"\s{2,}", ln.strip())[:2] for ln in out.splitlines()
            if ln.rstrip().endswith(("PASS", "FAIL")) or "  FAIL  " in ln]


def test_ggval_all_passes_with_the_reference_checks(tmp_path, capsys):
    assert j_jx(["ggval", "all", "-nind", "120", "-nsnp", "300", "-o", str(tmp_path / "r")]) == 0
    ref = _checks(capsys.readouterr().out)
    assert t_jx(["ggval", "all", "-nind", "120", "-nsnp", "300", "-o", str(tmp_path / "p")]) == 0
    out = capsys.readouterr().out
    port = _checks(out)
    assert [c[0] for c in port] == [c[0] for c in ref] and len(port) == 30
    assert all(mark == "PASS" for _, mark in port)
    assert "30/30 checks passed" in out
