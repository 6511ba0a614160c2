"""End-to-end parity of the dense-GRM ``jx gwas`` routes: the port's CLI
(janusx_tpu_torch.cli.main) against the reference's (janusx_tpu.cli.main),
each on its own copy of one toy PLINK panel with four traits that share
one sample mask: three polygenic and one with no polygenic signal, so the
LMM->LM switch fires on it (no -force-model anywhere).

Bounds (tests/test_golden_mouse.py:57-68): the same TSV file names and
headers, rows equal on their first 7 columns, max Δ(-log10 p) <= 0.05 in
every p-value column, the same top-5 SNPs by pwald, λ_null within 2e-3
(relative).
"""

import json
import os
import shutil

import numpy as np
import pytest

from janusx_tpu.io import bitcodec
from janusx_tpu.io.gdata import SiteInfo
from janusx_tpu.io.plink import write_plink

TRAITS = ("t0", "t1", "t2", "flat")
P_COLS = ("pwald", "plrt", "pwald_i1", "p_int_joint", "p_joint")


def _write(d, n=150, m=1500, seed=8):
    """Panel of sibships of 5 (so the GRM carries relatedness and the
    polygenic traits keep the mixed model), 4-trait phenotype (17 samples
    unphenotyped in every trait), a 2-column covariate file and a
    QTN-search panel (every other SNP)."""
    rng = np.random.default_rng(seed)
    fam = np.arange(n) // 5
    haps = rng.random((m, 4 * (fam[-1] + 1))) < rng.uniform(0.05, 0.5, m)[:, None]
    g = (haps[:, 4 * fam + rng.integers(0, 2, n)].astype(np.int64)
         + haps[:, 4 * fam + 2 + rng.integers(0, 2, n)])
    codes = g.astype(np.uint8)
    codes[rng.random((m, n)) < 0.02] = bitcodec.CODE_MISSING
    sites = SiteInfo(
        chrom=np.array(["1"] * (m // 2) + ["2"] * (m - m // 2), object),
        pos=np.arange(1, m + 1, dtype=np.int64) * 1000,
        snp=np.array([f"rs{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    samples = np.array([f"s{j}" for j in range(n)], object)
    write_plink(str(d / "panel"), bitcodec.pack_codes(codes), n, sites, samples)
    half = np.arange(0, m, 2)
    write_plink(str(d / "qtn"), bitcodec.pack_codes(codes[half]), n,
                SiteInfo(**{k: getattr(sites, k)[half] for k in
                            ("chrom", "pos", "snp", "allele0", "allele1")}), samples)
    x = (g - g.mean(axis=1, keepdims=True)).T
    Y = []
    for t in range(3):
        h = rng.normal(0, 0.05, m)
        h[rng.choice(m, 3, replace=False)] = rng.choice([-1.0, 1.0], 3) * 1.2
        Y.append(x @ h + rng.normal(size=n))
    Y.append(rng.normal(size=n))
    Y = np.stack(Y, axis=1)
    Y[rng.choice(n, 17, replace=False)] = np.nan
    with open(d / "panel.pheno", "wt") as fh:
        fh.write("ID\t" + "\t".join(TRAITS) + "\n")
        for s, row in zip(samples, Y):
            fh.write(s + "\t" + "\t".join("NA" if np.isnan(v) else f"{v:.6f}" for v in row)
                     + "\n")
    cov = rng.normal(size=(n, 2))
    with open(d / "panel.cov", "wt") as fh:
        fh.write("ID\tc0\tc1\n")
        fh.writelines(f"{s}\t{a:.6f}\t{b + 1.5:.6f}\n" for s, (a, b) in zip(samples, cov))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")  # read by the port only
    monkeypatch.setenv("JX_TPU_HISTORY_DB", "0")


def _run_both(tmp_path, *flags):
    """Run both CLIs on their own copy of the panel; returns the two
    output directories."""
    from janusx_tpu.cli.main import main as j_main
    from janusx_tpu_torch.cli.main import main as t_main

    (tmp_path / "ref").mkdir()
    _write(tmp_path / "ref")
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    outs = []
    for name, main in (("ref", j_main), ("port", t_main)):
        d = tmp_path / name
        argv = ["gwas", "-bfile", str(d / "panel"), "-p", str(d / "panel.pheno"),
                "-o", str(tmp_path / f"out_{name}")]
        argv += [str(d / f[1:]) if f.startswith("@") else f for f in flags]
        assert main(argv) == 0
        outs.append(tmp_path / f"out_{name}")
    return outs


def _read(path):
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln in fh]
    return header, rows


def _compare_tsv(a, b, key_cols=7):
    ha, ra = _read(a)
    hb, rb = _read(b)
    assert ha == hb, (a, ha, hb)
    assert len(ra) == len(rb) > 0
    assert [r[:key_cols] for r in ra] == [r[:key_cols] for r in rb]
    for col in (c for c in P_COLS if c in ha):
        i = ha.index(col)
        pa = np.array([float(r[i]) for r in ra])
        pb = np.array([float(r[i]) for r in rb])
        assert np.all(np.isfinite(pa) & (pa > 0) & (pa <= 1)), (a, col)
        assert np.max(np.abs(np.log10(pa) - np.log10(pb))) <= 0.05, (a, col)
        if col == "pwald":
            assert set(np.argsort(pa, kind="stable")[:5]) == set(np.argsort(pb, kind="stable")[:5])


def _compare_outputs(out_port, out_ref):
    names = sorted(f for f in os.listdir(out_ref) if f.endswith(".assoc.tsv"))
    assert sorted(f for f in os.listdir(out_port) if f.endswith(".assoc.tsv")) == names
    for f in names:
        # trait-level files lead with the trait and model columns
        _compare_tsv(out_port / f, out_ref / f, 9 if ".traitlevel" in f else 7)
    runs = []
    for out in (out_port, out_ref):
        with open(out / "jx.gwas.summary.json") as fh:
            runs.append(json.load(fh)["runs"])
    for rp, rr in zip(*runs):
        assert (rp["trait"], rp["model"], rp["requested"], rp["m"]) == (
            rr["trait"], rr["model"], rr["requested"], rr["m"])
        if rr["lambda_null"] is None:
            assert rp["lambda_null"] is None
        else:
            assert rp["lambda_null"] == pytest.approx(rr["lambda_null"], rel=2e-3)
    return names, runs[0]


def test_trait_level_models_match_reference(tmp_path):
    """-lm -lmm -lmm2 -fvlmm -trait-level -bimrange: the trait-level
    batches (LM over all four traits; the mixed models over the three that
    keep them), the switched trait's per-trait LM runs, the combined TSVs
    grouped by header, and the scan-only SNP window."""
    out_ref, out_port = _run_both(tmp_path, "-lm", "-lmm", "-lmm2", "-fvlmm",
                                  "-trait-level", "-bimrange", "1:0.1-0.6",
                                  "-bimrange", "2:1.0-1.4")
    names, runs = _compare_outputs(out_port, out_ref)
    assert "jx.traitlevel.assoc.tsv" in names and "jx.traitlevel.lmm2.assoc.tsv" in names
    assert len(names) == 4 * 4 + 2
    flat = [r for r in runs if r["trait"] == "flat"]
    assert [r["model"] for r in flat] == ["lm"] * 4
    assert [r["model"] for r in runs if r["trait"] == "t1"] == ["lm", "lmm", "lmm2", "fvlmm"]
    ms = {r["m"] for r in runs}  # the window: 902 SNPs before QC
    assert len(ms) == 1 and 800 < ms.pop() <= 902
    for f in names:  # rectangular
        header, rows = _read(out_port / f)
        assert {len(r) for r in rows} == {len(header)}


@pytest.mark.parametrize("flags", [
    ("-lmm", "-scan-method", "brent", "-n", "0,3"),
    ("-lm", "-lmm", "-fvlmm", "-global", "-n", "0,1"),
    ("-lm2", "-fvlmm2", "-c", "@panel.cov", "-n", "0"),
    ("-farmcpu", "-c", "@panel.cov", "-n", "1"),
    ("-farmcpu", "-qbfile", "@qtn", "-n", "2"),
    ("-frgwas", "-n", "0"),
], ids=["brent", "global", "gxe", "farmcpu", "farmcpu_qbfile", "frgwas"])
def test_routes_match_reference(tmp_path, flags):
    out_ref, out_port = _run_both(tmp_path, *flags)
    names, _ = _compare_outputs(out_port, out_ref)
    assert names
