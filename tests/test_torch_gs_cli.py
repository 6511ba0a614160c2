"""End-to-end parity of ``jx gs`` and ``jx gspredict``: the port's
workflow and CLI (janusx_tpu_torch) against the reference's (janusx_tpu)
on one toy PLINK panel with two traits, each leaving some samples
unphenotyped (GS's test set).

Bounds: the same routes; test and out-of-fold predictions within rtol
1e-4; the CV metrics within 1e-4; an HE pre-fit for every trait, h2
within 1e-4; the TOP weights within 1e-6; the effect TSV and the
.jxmodel.npz within rtol 1e-4. Then the interfaces: the parser is the
reference's, gspredict runs through the port's dispatcher, and ``jx gwas`` prints the
reference's run line.
"""

import contextlib
import inspect
import io
import json
import os

import numpy as np
import pytest
import torch

from janusx_tpu.io import bitcodec
from janusx_tpu.io.gdata import SiteInfo
from janusx_tpu.io.plink import write_plink

N, M, TRAITS = 100, 800, ("ta", "tb")


def _write_panel(d, n=N, m=M, seed=41):
    """A PLINK panel in sibships of 4 (so the kernels carry relatedness)
    and two polygenic traits with a dominance part, 20 samples
    unphenotyped in each."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    fam = np.arange(n) // 4
    p = rng.uniform(0.05, 0.5, m)[:, None]
    haps = (rng.random((m, 4 * (fam[-1] + 1))) < p).astype(np.uint8)
    g = (haps[:, 4 * fam + rng.integers(0, 2, n)]
         + haps[:, 4 * fam + 2 + rng.integers(0, 2, n)])
    codes = g.astype(np.uint8)
    codes[rng.random((m, n)) < 0.02] = bitcodec.CODE_MISSING
    sites = SiteInfo(
        chrom=np.array(["1"] * (m // 2) + ["2"] * (m - m // 2), object),
        pos=np.arange(1, m + 1, dtype=np.int64) * 1000,
        snp=np.array([f"rs{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    samples = np.array([f"s{j}" for j in range(n)], object)
    prefix = os.path.join(d, "panel")
    write_plink(prefix, bitcodec.pack_codes(codes), n, sites, samples)
    x = (g - g.mean(axis=1, keepdims=True)).T
    h = (g == 1) - (g == 1).mean(axis=1, keepdims=True)
    Y = np.stack([x @ rng.normal(0, 0.06, m) + h.T @ rng.normal(0, 0.04, m)
                  + rng.normal(size=n) for _ in TRAITS], axis=1) + 5.0
    for t in range(len(TRAITS)):
        Y[rng.choice(n, 20, replace=False), t] = np.nan
    pheno = prefix + ".pheno"
    with open(pheno, "wt") as fh:
        fh.write("ID\t" + "\t".join(TRAITS) + "\n")
        for s, row in zip(samples, Y):
            fh.write(f"{s}\t" + "\t".join("NA" if np.isnan(v) else f"{v:.6f}"
                                          for v in row) + "\n")
    return prefix, pheno


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")  # read by the port only
    monkeypatch.setenv("JX_TPU_HISTORY_DB", "0")  # reference run history off


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """GBLUPad's AI-REML (the port's in torch, the reference's in numpy)
    and the PCG solve are loops of small linear-algebra calls on the CPU;
    with the suite's six workers sharing the cores, each call's threads
    wait on one another. One torch and one BLAS thread per worker run them
    as fast as they run alone."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    return _write_panel(str(tmp_path_factory.mktemp("gs") / "data"))


def _run_both(panel, tmp_path, **kw):
    from janusx_tpu.gs.workflow import GsConfig as JCfg, run_gs as j_run
    from janusx_tpu_torch.gs.workflow import GsConfig as TCfg, run_gs as t_run

    prefix, pheno = panel
    base = dict(genotype=prefix, phenotype=pheno, cv=5, seed=3, **kw)
    rj, sj = j_run(JCfg(out_prefix=str(tmp_path / "ref" / "gs"), **base))
    rt, st = t_run(TCfg(out_prefix=str(tmp_path / "port" / "gs"), **base))
    return rj, sj, rt, st


def _same_results(rj, sj, rt, st):
    assert list(rt) == list(rj) == list(TRAITS)
    for trait in TRAITS:
        assert list(rt[trait]) == list(rj[trait])
        for mm, a in rj[trait].items():
            b = rt[trait][mm]
            assert b.route == a.route, (trait, mm)
            np.testing.assert_allclose(b.test_pred, a.test_pred, rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(b.oof_pred, a.oof_pred, rtol=1e-4, atol=1e-6)
            for k, v in a.cv_mean.items():
                assert b.cv_mean[k] == pytest.approx(v, abs=1e-4), (trait, mm, k)
    # the HE pre-fit ran for every trait in both (its failure is swallowed
    # by the workflow, so a broken port would only show as a missing entry)
    assert set(st["he_prefit"]) == set(sj["he_prefit"]) == set(TRAITS)
    for trait, h in sj["he_prefit"].items():
        g = st["he_prefit"][trait]
        assert g["boundary"] == h["boundary"]
        assert g["h2"] == pytest.approx(h["h2"], abs=1e-4)
        assert g["vg"] == pytest.approx(h["vg"], rel=1e-4)
        assert g["ve"] == pytest.approx(h["ve"], rel=1e-4)
    assert st["selected_method"] == sj["selected_method"]
    assert st["top"]["traits"] == sj["top"]["traits"]
    np.testing.assert_allclose(st["top"]["weights"], sj["top"]["weights"], rtol=0, atol=1e-6)
    assert sum(st["top"]["weights"]) == pytest.approx(1.0, abs=1e-12)


def _read_tsv(path):
    with open(path) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh]


def _same_tsv(a, b, num_from, num_to=None):
    """The same header and rows; fields num_from:num_to within rtol 1e-4
    (atol 2e-4: the last printed digit), the others equal."""
    ra, rb = _read_tsv(a), _read_tsv(b)
    assert len(ra) == len(rb) > 1 and ra[0] == rb[0]
    for x, y in zip(ra[1:], rb[1:]):
        assert x[:num_from] == y[:num_from] and x[len(x[:num_to]):] == y[len(y[:num_to]):]
        np.testing.assert_allclose(np.array(x[num_from:num_to], float),
                                   np.array(y[num_from:num_to], float), rtol=1e-4, atol=2e-4)


def test_gs_workflow_matches_reference(panel, tmp_path):
    """BLUP (the GBLUP route at this n), rrBLUP with effect and model
    export, GBLUPad through AI-REML, and the TOP bundle."""
    rj, sj, rt, st = _run_both(panel, tmp_path, methods=("BLUP", "rrBLUP", "GBLUPad"),
                               export_effects=True, save_models=True, select="max")
    _same_results(rj, sj, rt, st)
    assert [rt["ta"][m].route for m in ("BLUP", "rrBLUP", "GBLUPad")] == \
        ["GBLUP(add)", "rrBLUP", "GBLUP(ad)"]
    ref, port = tmp_path / "ref", tmp_path / "port"
    for trait in TRAITS:
        _same_tsv(ref / f"gs.{trait}.gebv.tsv", port / f"gs.{trait}.gebv.tsv", 1)
        _same_tsv(ref / f"gs.{trait}.oof.tsv", port / f"gs.{trait}.oof.tsv", 1)
        for mm in ("BLUP", "rrBLUP"):
            _same_tsv(ref / f"gs.{trait}.{mm}.effect.tsv", port / f"gs.{trait}.{mm}.effect.tsv",
                      5)
            zj = np.load(ref / f"gs.{trait}.{mm}.jxmodel.npz")
            zt = np.load(port / f"gs.{trait}.{mm}.jxmodel.npz")
            assert sorted(zt.files) == sorted(zj.files)
            for k in zj.files:
                if zj[k].dtype.kind == "f":
                    np.testing.assert_allclose(zt[k], zj[k], rtol=1e-4, atol=1e-9)
                elif k != "meta":
                    np.testing.assert_array_equal(zt[k], zj[k])
            mj, mt = json.loads(str(zj["meta"])), json.loads(str(zt["meta"]))
            assert mt.keys() == mj.keys()
    _same_tsv(ref / "gs.gs.TOP.weights.tsv", port / "gs.gs.TOP.weights.tsv", 4, -1)
    rank_j, rank_t = _read_tsv(ref / "gs.gs.TOP.rank.tsv"), _read_tsv(port / "gs.gs.TOP.rank.tsv")
    assert [r[1] for r in rank_t] == [r[1] for r in rank_j]
    bj, bt = np.load(ref / "gs.gs.TOP.jxmodel.npz"), np.load(port / "gs.gs.TOP.jxmodel.npz")
    np.testing.assert_allclose(bt["weights"], bj["weights"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("hash_dim", [None, 256])
def test_gs_pcg_and_hash_match_reference(panel, tmp_path, hash_dim):
    """The rrBLUP(PCG) route at each trait's HE pre-fit λ, on the GRM and
    on a signed-hash sketch, with the TOP bundle."""
    rj, sj, rt, st = _run_both(panel, tmp_path, methods=("BLUP",), rrblup_solver="pcg",
                               hash_dim=hash_dim, select="max")
    _same_results(rj, sj, rt, st)
    for trait in TRAITS:
        info_j, info_t = sj["traits"][trait]["BLUP"], st["traits"][trait]["BLUP"]
        assert info_t["route"] == "rrBLUP(PCG)"
        assert info_t["lambda_pcg"] == pytest.approx(info_j["lambda_pcg"], rel=1e-4)
        he = st["he_prefit"][trait]
        assert info_t["lambda_pcg"] == pytest.approx(he["ve"] / he["vg"], rel=1e-12)
    if hash_dim:
        assert st["hash"]["kept_snps"] == sj["hash"]["kept_snps"] > 0
        assert st["hash"]["scale"] == pytest.approx(sj["hash"]["scale"], rel=1e-5)


def test_gs_parser_is_the_reference_parser():
    from janusx_tpu.cli.gs import build_parser as j_parser
    from janusx_tpu.cli.gspredict import build_parser as j_pred
    from janusx_tpu_torch.cli.gs import build_parser as t_parser
    from janusx_tpu_torch.cli.gspredict import build_parser as t_pred

    assert inspect.getsource(t_parser) == inspect.getsource(j_parser)
    assert inspect.getsource(t_pred) == inspect.getsource(j_pred)


def test_gs_without_card_raises(panel, tmp_path, monkeypatch):
    import torch

    from janusx_tpu_torch.cli.main import main as t_main

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("JX_TPU_PLATFORM")
    prefix, pheno = panel
    with pytest.raises(RuntimeError, match="CUDA"):
        t_main(["gs", "-bfile", prefix, "-p", pheno, "-BLUP", "-o", str(tmp_path / "o")])


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def test_gs_and_gspredict_cli_match_reference(panel, tmp_path):
    """`jx gs -rrBLUP -save-model` then `jx gspredict` on the same panel,
    through each package's dispatcher: the same printed lines (the CV
    metrics to 3 decimals) and the same predictions; the saved model
    reproduces the GEBV TSV's rrBLUP column on the test samples."""
    from janusx_tpu.cli.main import main as j_main
    from janusx_tpu_torch.cli.main import main as t_main

    prefix, pheno = panel
    outs = {}
    for tag, main in (("ref", j_main), ("port", t_main)):
        o = str(tmp_path / tag / "gs")
        lines = _cli(main, ["gs", "-bfile", prefix, "-p", pheno, "-rrBLUP", "-cv", "3",
                            "-save-model", "-n", "0", "-o", os.path.dirname(o),
                            "-prefix", "gs"])
        pred = _cli(main, ["gspredict", "-model", f"{o}.ta.rrBLUP.jxmodel.npz",
                           "-bfile", prefix, "-o", os.path.dirname(o), "-prefix", "gp"])
        outs[tag] = (lines, pred, o)
    assert outs["port"][0] == outs["ref"][0]
    assert [ln.split("\t")[1:] for ln in outs["port"][1]] == \
        [ln.split("\t")[1:] for ln in outs["ref"][1]]
    gp = {t: {r[0]: float(r[1]) for r in _read_tsv(os.path.join(os.path.dirname(o), "gp.gebv.tsv"))[1:]}
          for t, (_, _, o) in outs.items()}
    assert gp["port"].keys() == gp["ref"].keys()
    np.testing.assert_allclose([gp["port"][s] for s in gp["ref"]], list(gp["ref"].values()),
                               rtol=1e-4, atol=2e-4)
    gebv = _read_tsv(outs["port"][2] + ".ta.gebv.tsv")[1:]
    assert len(gebv) == 20
    np.testing.assert_allclose([gp["port"][r[0]] for r in gebv], [float(r[1]) for r in gebv],
                               rtol=0, atol=2e-4)


def test_gwas_run_line_is_the_reference_layout(panel, tmp_path):
    from janusx_tpu.cli.main import main as j_main
    from janusx_tpu_torch.cli.main import main as t_main

    prefix, pheno = panel
    argv = lambda o: ["gwas", "-bfile", prefix, "-p", pheno, "-lm", "-o", str(o)]
    ref = [ln.split("\t") for ln in _cli(j_main, argv(tmp_path / "r"))]
    port = [ln.split("\t") for ln in _cli(t_main, argv(tmp_path / "p"))]
    assert len(port) == len(ref) == len(TRAITS)
    for a, b in zip(port, ref):
        assert len(a) == len(b) == 6
        assert a[:4] == b[:4] and a[4].endswith("s") and b[4].endswith("s")
        assert os.path.basename(a[5]) == os.path.basename(b[5])
