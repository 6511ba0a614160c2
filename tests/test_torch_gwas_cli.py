"""End-to-end parity of ``jx gwas``: the port's CLI
(janusx_tpu_torch.cli.main) against the reference's (janusx_tpu.cli.main)
on one tiny PLINK fileset, with a phenotype that leaves some samples
missing so the per-trait subset/re-QC path runs: ``-lmm`` with and
without its LMM->LM switch, and each of the sparse, low-rank and ALGWAS
routes.

Bounds of ``-lmm`` (tests/test_golden_mouse.py:57-68): the same header
and SNP rows, max Δ(-log10 p) <= 0.05, the same top-5 SNPs, λ_null within
2e-3 (relative); each other route's bound is stated at its test.
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


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """ALGWAS's FISTA path is 9,600 iterations of small torch ops on the
    CPU; with the suite's six workers sharing the cores, each op's
    intra-op threads wait on one another (~100x slower than alone). One
    thread per worker runs them as fast as they run alone."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """Without -force-model a trait with no polygenic signal switches to LM
    (null LRT p >= 0.05), in the port as in the reference: the same LM
    statistics under the requested model's tag."""
    from janusx_tpu.cli.main import main as j_main
    from janusx_tpu_torch.cli.main import main as t_main

    (tmp_path / "ref").mkdir()
    prefix, pheno = _write_panel(tmp_path / "ref", n=120, m=300, polygenic=False)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    assert j_main(_gwas_args(prefix, pheno, tmp_path / "out_ref")) == 0
    tprefix = str(tmp_path / "port" / "panel")
    assert t_main(_gwas_args(tprefix, tprefix + ".pheno", tmp_path / "out_port")) == 0
    h_ref, rows_ref, lam_ref = _read(tmp_path / "out_ref")
    h_port, rows_port, lam_port = _read(tmp_path / "out_port")
    assert lam_port is None and lam_ref is None
    with open(tmp_path / "out_port" / "jx.gwas.summary.json") as fh:
        run = json.load(fh)["runs"][0]
    assert (run["model"], run["requested"]) == ("lm", "lmm")
    assert h_port == h_ref
    assert [r[:7] for r in rows_port] == [r[:7] for r in rows_ref]
    p_ref = np.array([float(r[10]) for r in rows_ref])
    p_port = np.array([float(r[10]) for r in rows_port])
    np.testing.assert_allclose(p_port, p_ref, rtol=1e-4)  # the TSV's 5 digits


def _write_spk(d, n, seed=4):
    """A precomputed sparse GRM over the panel's samples, written with its
    .id sidecar in a shuffled sample order (the run aligns it by ID)."""
    import scipy.sparse

    from janusx_tpu.io.jxgrm import write_jxgrm
    from test_sparse_path import _family_sparse_k

    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    K = _family_sparse_k(n, rng)
    path = str(d / "kin.jxgrm")
    write_jxgrm(path, scipy.sparse.csc_matrix(K.toarray()[np.ix_(order, order)]))
    with open(path + ".id", "wt") as fh:
        fh.write("".join(f"s{j}\n" for j in order))
    return path


# route flags -> (TSV tag, max Δ(-log10 p)): 5e-3 for the scans whose
# per-SNP statistics are f32 grams at a host-f64 null (tests/test_scans.py:
# 155, tests/test_torch_sparse.py, test_torch_lowrank.py,
# test_torch_algwas.py); the TSV's own rounding is ~2e-5
_ROUTES = {"splmm": (["-splmm"], "SparseLMM"),
           "splmm-exact": (["-splmm-exact", "0.1"], "SparseLMM2"),
           "lowrank": (["-lowrank", "100"], "FaSTLMM"),
           # full-set QC stats for the 133 phenotyped samples: the add rows
           # are centered by the subset's observed-code mean all the same
           # (under -global this panel's switch test picks LM)
           "lowrank-global": (["-lowrank", "100", "-global", "-force-model"], "FaSTLMM"),
           "algwas": (["-algwas"], "ALGWAS"),
           "spk-file": (["-splmm", "-spk", None], "SparseLMM")}


@pytest.mark.parametrize("route", list(_ROUTES))
def test_gwas_route_cli_matches_reference(tmp_path, route):
    """-splmm, -splmm-exact, -lowrank (with its LMM->LM switch test, and
    under -global), -algwas and a precomputed -spk file through both CLIs:
    the same TSV
    header and SNP rows, max Δ(-log10 p) <= 5e-3, the same top 5, λ_null
    within 1e-6 relative (host f64 null fits on both sides)."""
    from janusx_tpu.cli.main import main as j_main
    from janusx_tpu_torch.cli.main import main as t_main

    flag, tag = _ROUTES[route]
    (tmp_path / "ref").mkdir()
    prefix, pheno = _write_panel(tmp_path / "ref")
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    tprefix = str(tmp_path / "port" / "panel")
    if route == "spk-file":
        flag = flag[:-1] + [_write_spk(tmp_path, 150)]
    args = lambda pre, out: ["gwas", "-bfile", pre, "-p", pre + ".pheno", *flag, "-o",
                             str(out)]
    assert j_main(args(prefix, tmp_path / "out_ref")) == 0
    assert t_main(args(tprefix, tmp_path / "out_port")) == 0
    runs = []
    for out in ("out_ref", "out_port"):
        with open(tmp_path / out / f"jx.test0.{tag}.assoc.tsv") as fh:
            header = fh.readline()
            rows = [ln.rstrip("\n").split("\t") for ln in fh]
        with open(tmp_path / out / "jx.gwas.summary.json") as fh:
            runs.append((header, rows, json.load(fh)["runs"][0]))
    (h_ref, rows_ref, run_ref), (h_port, rows_port, run_port) = runs
    assert h_port == h_ref
    assert len(rows_port) == len(rows_ref) > 1500
    assert [r[:7] for r in rows_port] == [r[:7] for r in rows_ref]
    assert (run_port["model"], run_port["requested"]) == (run_ref["model"],
                                                          run_ref["requested"])
    if route.startswith("lowrank"):
        assert run_port["model"] == "lowrank"  # the switch test kept the mixed model
    col = h_ref.rstrip("\n").split("\t").index("pwald")
    p_ref = np.array([float(r[col]) for r in rows_ref])
    p_port = np.array([float(r[col]) for r in rows_port])
    assert np.all(np.isfinite(p_port) & (p_port > 0))
    assert np.max(np.abs(np.log10(p_port) - np.log10(p_ref))) <= 5e-3
    assert set(np.argsort(p_port)[:5]) == set(np.argsort(p_ref)[:5])
    if run_ref["lambda_null"] is None:
        assert run_port["lambda_null"] is None
    else:
        assert run_port["lambda_null"] == pytest.approx(run_ref["lambda_null"], rel=1e-6)
