"""End-to-end parity of ``jx gwas -lmm``: the port's CLI
(janusx_tpu_torch.cli.main) against the reference's (janusx_tpu.cli.main)
on one tiny PLINK fileset, with a phenotype that leaves some samples
missing so the per-trait subset/re-QC path runs.

Bounds (tests/test_golden_mouse.py:57-68): the same header and SNP rows,
max Δ(-log10 p) <= 0.05, the same top-5 SNPs, λ_null within 2e-3
(relative).
"""

import json
import shutil

import numpy as np
import pytest

from janusx_tpu.io import bitcodec
from janusx_tpu.io.gdata import SiteInfo
from janusx_tpu.io.plink import write_plink


def _write_panel(d, n=150, m=2000, seed=31, polygenic=True):
    rng = np.random.default_rng(seed)
    g = rng.binomial(2, rng.uniform(0.03, 0.5, m)[:, None], size=(m, n))
    codes = g.astype(np.uint8)
    codes[rng.random((m, n)) < 0.02] = bitcodec.CODE_MISSING
    sites = SiteInfo(
        chrom=np.array(["1"] * (m // 2) + ["2"] * (m - m // 2), object),
        pos=np.arange(1, m + 1, dtype=np.int64) * 1000,
        snp=np.array([f"rs{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    samples = np.array([f"s{j}" for j in range(n)], object)
    prefix = str(d / "panel")
    write_plink(prefix, bitcodec.pack_codes(codes), n, sites, samples)
    x = g - g.mean(axis=1, keepdims=True)
    y = rng.normal(size=n)
    if polygenic:
        h = rng.normal(0, 0.04, m)
        h[[100, 600, 1100, 1500, 1900]] = [1.2, -1.0, 1.1, 0.9, -1.3]
        y = y + x.T @ h
    y[rng.choice(n, 17, replace=False)] = np.nan  # unphenotyped samples
    pheno = str(d / "panel.pheno")
    with open(pheno, "wt") as fh:
        fh.write("ID\ttest0\n")
        for s, v in zip(samples, y):
            fh.write(f"{s}\t{'NA' if np.isnan(v) else f'{v:.6f}'}\n")
    return prefix, pheno


def _gwas_args(prefix, pheno, out, *extra):
    return ["gwas", "-bfile", prefix, "-p", pheno, "-lmm", "-n", "0", "-o", str(out),
            *extra]


def _read(out):
    with open(out / "jx.test0.LMM.assoc.tsv") as fh:
        header = fh.readline()
        rows = [ln.rstrip("\n").split("\t") for ln in fh]
    with open(out / "jx.gwas.summary.json") as fh:
        lam = json.load(fh)["runs"][0]["lambda_null"]
    return header, rows, lam


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")  # read by the port only
    monkeypatch.setenv("JX_TPU_HISTORY_DB", "0")  # reference run history off


def test_gwas_lmm_cli_matches_reference(tmp_path):
    from janusx_tpu.cli.main import main as j_main
    from janusx_tpu_torch.cli.main import main as t_main

    # one fileset per package, so neither reads the other's cached GRM
    (tmp_path / "ref").mkdir()
    prefix, pheno = _write_panel(tmp_path / "ref")
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    assert j_main(_gwas_args(prefix, pheno, tmp_path / "out_ref", "-force-model")) == 0
    tprefix = str(tmp_path / "port" / "panel")
    assert t_main(_gwas_args(tprefix, tprefix + ".pheno", tmp_path / "out_port",
                             "-force-model")) == 0
    h_ref, rows_ref, lam_ref = _read(tmp_path / "out_ref")
    h_port, rows_port, lam_port = _read(tmp_path / "out_port")
    assert h_port == h_ref and len(h_port.split("\t")) == 11
    assert len(rows_port) == len(rows_ref) > 1500
    assert [r[:7] for r in rows_port] == [r[:7] for r in rows_ref]
    p_ref = np.array([float(r[10]) for r in rows_ref])
    p_port = np.array([float(r[10]) for r in rows_port])
    assert np.all(np.isfinite(p_port))
    assert np.max(np.abs(np.log10(p_port) - np.log10(p_ref))) <= 0.05
    assert set(np.argsort(p_port)[:5]) == set(np.argsort(p_ref)[:5])
    assert lam_port == pytest.approx(lam_ref, rel=2e-3)


def test_gwas_switch_to_lm_is_not_ported(tmp_path):
    """Without -force-model a trait with no polygenic signal would switch
    to LM (null LRT p >= 0.05); the port raises instead of falling back."""
    from janusx_tpu_torch.cli.main import main as t_main

    prefix, pheno = _write_panel(tmp_path, n=120, m=300, polygenic=False)
    with pytest.raises(NotImplementedError, match="force-model"):
        t_main(_gwas_args(prefix, pheno, tmp_path / "out"))


@pytest.mark.parametrize("flag", [["-lm"], ["-lmm2"], ["-trait-level"]])
def test_gwas_unported_flags_raise(tmp_path, flag):
    from janusx_tpu_torch.cli.main import main as t_main

    with pytest.raises(NotImplementedError, match="not ported"):
        t_main(_gwas_args("x", "x.pheno", tmp_path / "out", *flag))
