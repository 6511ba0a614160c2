"""Port parity of ``jx fvlmm2 -i`` (janusx_tpu_torch.models.combo and
janusx_tpu_torch.cli.fvlmm2) against janusx_tpu on the CPU.

Bounds:
- ``_joint_chunk``: rtol 1e-8 against the reference's on the same inputs,
  and the reference's own check against a direct numpy weighted GLS
  (tests/test_gxe.py:123: beta and se rtol 1e-8, p rtol 1e-6);
- the literal and xor hardcall tables exactly (tests/test_gxe.py:152);
- ``fvlmm_joint_combo_scan`` at the same basis and the same null λ: beta,
  se and p rtol 1e-6 (the port's gxe fvlmm2 bound at the same null λ), with the
  whole-panel ``pg.dosages()`` never called;
- the CLI's TSV against the reference CLI's pandas output at the same null
  λ: the header and every text field byte-identical, every float within
  rtol 1e-6 of the reference's value plus one unit of the sixth
  significant digit that ``%.6g`` keeps (both sides print rounded values);
  the ``.skip`` table byte-identical; the planted ``s10&s40`` recovered at
  p < 1e-6 (tests/test_gxe.py:170);
- the null fit itself: both packages pass the design with its intercept
  to ``make_rotated``, which prepends another, so X'WX is singular up to
  its 1e-6 ridge and the null −REML is noisy at ~1e-7 near its optimum
  (an H ~ 100 curvature then fixes log10 λ only to ~4e-5). Each package's
  Brent stops at its own point of that plateau: the port's optimum is held
  to the reference's REML value within 1e-6 and to its log10 λ within
  1e-4 (measured 1.4e-5), and every other comparison here runs at the
  reference's null λ.
"""

import numpy as np
import pytest

from janusx_tpu.models import combo as jcombo
from janusx_tpu_torch.models import combo as tcombo

COLUMNS = ["chrom", "pos", "combo_id", "combo_af", "unit_name",
           "beta_combo_joint", "se_combo_joint", "p_combo_joint",
           "p_combo_joint_fdr", "p_lit1_joint", "p_lit2_joint"]
TEXT = ("chrom", "pos", "combo_id", "unit_name")


def test_joint_chunk_matches_reference_and_numpy():
    import torch
    from scipy import stats

    rng = np.random.default_rng(4)
    n, p, B = 80, 2, 5
    Xr = np.column_stack([np.ones(n), rng.normal(size=n)])
    w = rng.uniform(0.5, 2.0, n)
    yr = rng.normal(size=n)
    G3 = rng.normal(size=(B, 3, n))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    out = tcombo._joint_chunk(t(G3), t(Xr), t(yr), t(w), n, p).numpy()
    np.testing.assert_allclose(out, np.asarray(jcombo._joint_chunk(G3, Xr, yr, w, n, p)),
                               rtol=1e-8)
    for b in range(B):
        D = np.column_stack([Xr, G3[b].T])  # (n, p+3)
        A = D.T @ (D * w[:, None])
        Ar = A + 1e-6 * np.eye(p + 3)
        beta = np.linalg.solve(Ar, D.T @ (w * yr))
        r = yr - D @ beta
        sigma2 = np.sum(w * r * r) / (n - p - 3)
        se = np.sqrt(sigma2 * np.diag(np.linalg.inv(Ar)))[p:]
        np.testing.assert_allclose(out[b, 0::3], beta[p:], rtol=1e-8)
        np.testing.assert_allclose(out[b, 1::3], se, rtol=1e-8)
        np.testing.assert_allclose(out[b, 2::3], 2 * stats.norm.sf(np.abs(beta[p:] / se)),
                                   rtol=1e-6)


def test_joint_chunk_bad_rows_are_nan():
    """A zero-weight design makes σ² ≤ 0: every term of that row is NaN,
    as in the reference."""
    import torch

    n, p = 12, 1
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    G3 = np.zeros((1, 3, n))
    args = (G3, np.ones((n, 1)), np.zeros(n), np.ones(n), n, p)
    out = tcombo._joint_chunk(*(t(a) if isinstance(a, np.ndarray) else a for a in args))
    want = np.asarray(jcombo._joint_chunk(*args))
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(want))
    assert np.isnan(want).all()


def test_literal_and_xor_tables():
    g = np.array([[0.0, 0.6, 1.4, 2.0, 1.0]])
    np.testing.assert_array_equal(tcombo.literalize(g, [False]), [[0, 1, 1, 2, 1]])
    np.testing.assert_array_equal(tcombo.literalize(g, [True]), [[2, 1, 1, 0, 1]])
    a = np.array([[0, 0, 0, 1, 1, 2, 2, 1, 2]], float)
    b = np.array([[0, 1, 2, 1, 2, 2, 0, 0, 1]], float)
    np.testing.assert_array_equal(tcombo.xor_dual(a, b), [[0, 1, 2, 1, 1, 0, 2, 1, 1]])
    np.testing.assert_array_equal(tcombo.xor_dual(a, b), jcombo.xor_dual(a, b))


PAIRS = ("s10&s40\n"
         "s5|s7\n"
         "!s3&s4\n"
         "s1*s2\n"
         "1:11000^s40\n"      # chrom:pos token spelling
         "s10&!s40\n"
         "!s12|!s13\n"
         "# comment\n"
         "s10&&s40\n"          # invalid expression -> skipped
         "nosuch&s1\n"         # unknown token -> skipped
         "!s1*s2\n")           # negated multiplicative -> skipped


@pytest.fixture(scope="module")
def combo_panel(tmp_path_factory):
    """The reference's planted AND case (tests/test_gxe.py:170), with 3 %
    missing calls so the row decode imputes."""
    from janusx_tpu.io import plink
    from janusx_tpu.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu.models.sim import write_pheno

    d = tmp_path_factory.mktemp("combo")
    rng = np.random.default_rng(11)
    m, n = 60, 400
    g = rng.binomial(2, 0.45, size=(m, n)).astype(np.int8)
    lit = np.minimum(g[10], g[40]).astype(float)  # AND hardcall combo
    y = 1.5 * lit + rng.normal(size=n)
    g[rng.random((m, n)) < 0.03] = -1
    sites = SiteInfo(chrom=np.array(["1"] * m, object),
                     pos=(np.arange(m, dtype=np.int64) + 1) * 1000,
                     snp=np.array([f"s{i}" for i in range(m)], object),
                     allele0=np.array(["A"] * m, object),
                     allele1=np.array(["G"] * m, object))
    prefix = str(d / "cb")
    plink.write_plink_genotypes(
        prefix, GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object)))
    write_pheno(prefix + ".pheno", [f"i{j}" for j in range(n)], y[:, None])
    (d / "pairs.txt").write_text(PAIRS)
    return d, prefix


@pytest.fixture
def reference_null(monkeypatch):
    """The port's combo scan at the reference's null λ: fit_null_reml of
    the port returns the reference's fit on the same rotated data."""
    import jax.numpy as jnp

    from janusx_tpu.core import reml as jreml
    from janusx_tpu_torch.core import reml as treml

    def fit(rot, *a, **k):
        nj = jreml.fit_null_reml(jreml.RotatedData(*(jnp.asarray(t.cpu().numpy())
                                                     for t in rot)))
        return treml.NullFit(nj.lbd, nj.log10_lbd, nj.reml, nj.ml)

    monkeypatch.setattr(treml, "fit_null_reml", fit)


def _run_both(d, prefix, extra=()):
    from janusx_tpu.cli.fvlmm2 import main as j_main
    from janusx_tpu_torch.cli.fvlmm2 import main as t_main

    for name, main in (("ref", j_main), ("port", t_main)):
        assert main(["-bfile", prefix, "-p", prefix + ".pheno", "-i", str(d / "pairs.txt"),
                     "-maf", "0.0", "-geno", "1.0", *extra, "-o", str(d / name),
                     "-prefix", "fx"]) == 0
    return d / "ref", d / "port"


def _printed_close(got: str, want: str, rtol: float) -> bool:
    """Two ``%.6g`` fields: within rtol of each other plus one unit of
    the sixth significant digit that printing keeps."""
    if want == "" or got == "":
        return got == want
    a, b = float(got), float(want)
    unit = 10.0 ** (np.floor(np.log10(abs(b))) - 5) if b != 0 else 0.0
    return abs(a - b) <= rtol * abs(b) + unit * (1 + 1e-9)


def test_fvlmm2_cli_matches_reference_cli(combo_panel, monkeypatch, reference_null):
    import pandas as pd

    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    d, prefix = combo_panel
    ref, port = _run_both(d, prefix)
    lines_r = (ref / "fx.trait0.fvlmm2.tsv").read_text().splitlines()
    lines_p = (port / "fx.trait0.fvlmm2.tsv").read_text().splitlines()
    assert lines_p[0] == lines_r[0] == "\t".join(COLUMNS)
    assert len(lines_p) == len(lines_r) == 8
    for lp, lr in zip(lines_p[1:], lines_r[1:]):
        fp, fr = lp.split("\t"), lr.split("\t")
        assert len(fp) == len(fr) == len(COLUMNS)
        for col, a, b in zip(COLUMNS, fp, fr):
            if col in TEXT:
                assert a == b, (col, a, b)
            else:
                assert _printed_close(a, b, 1e-6), (col, a, b)
    assert (port / "fx.fvlmm2.skip").read_bytes() == (ref / "fx.fvlmm2.skip").read_bytes()
    # the reference CLI's own checks (tests/test_gxe.py:170) on the port's TSV
    df = pd.read_csv(port / "fx.trait0.fvlmm2.tsv", sep="\t")
    top = df.loc[df["p_combo_joint"].idxmin()]
    assert top["combo_id"] == "s10&s40" and top["p_combo_joint"] < 1e-6
    assert (df["p_combo_joint_fdr"].dropna() <= 1.0).all()
    null_rows = df[df["combo_id"].isin(["s5|s7", "!s3&s4", "s1*s2"])]
    assert (null_rows["p_combo_joint"] > 1e-4).all()
    assert len(pd.read_csv(port / "fx.fvlmm2.skip", sep="\t")) == 3


def test_fvlmm2_cli_with_grm_and_n_tests(combo_panel, monkeypatch, tmp_path,
                                        reference_null):
    """-k GRM.npy and --n-tests through both CLIs: the same TSV."""
    from janusx_tpu.cli.main import main as j_jx

    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    d, prefix = combo_panel
    assert j_jx(["grm", "-bfile", prefix, "-o", str(tmp_path), "-prefix", "g"]) == 0
    ref, port = _run_both(d, prefix, ("-k", str(tmp_path / "g.cGRM.npy"), "--n-tests", "50"))
    lines_r = (ref / "fx.trait0.fvlmm2.tsv").read_text().splitlines()
    lines_p = (port / "fx.trait0.fvlmm2.tsv").read_text().splitlines()
    assert len(lines_p) == len(lines_r)
    for lp, lr in zip(lines_p[1:], lines_r[1:]):
        for col, a, b in zip(COLUMNS, lp.split("\t"), lr.split("\t")):
            assert (a == b) if col in TEXT else _printed_close(a, b, 1e-6), (col, a, b)


def _scan_inputs(combo_panel):
    """Both packages' QC'd panels, one basis, the trait, a covariate and
    the parsed expressions."""
    from janusx_tpu.core.spectral import eigh_grm
    from janusx_tpu.io.gfreader import load_raw_packed as j_load
    from janusx_tpu.io.packed import QcParams as JQc
    from janusx_tpu.models.grm import grm_from_packed
    from janusx_tpu_torch.core.spectral import SpectralBasis
    from janusx_tpu_torch.io.gfreader import load_raw_packed as t_load
    from janusx_tpu_torch.io.packed import QcParams as TQc

    d, prefix = combo_panel
    pj = j_load(prefix).prepare(JQc(maf=0.0, geno=1.0))
    pt = t_load(prefix).prepare(TQc(maf=0.0, geno=1.0))
    y = np.loadtxt(prefix + ".pheno", skiprows=1, usecols=1)
    cov = np.random.default_rng(2).normal(size=(len(y), 1))
    jb = eigh_grm(grm_from_packed(pj), diag_ridge=1e-6)
    specs_j, _ = jcombo.parse_interaction_file(str(d / "pairs.txt"),
                                               jcombo.build_name_map(pj.sites))
    specs_t, _ = tcombo.parse_interaction_file(str(d / "pairs.txt"),
                                               tcombo.build_name_map(pt.sites))
    assert [s.expr for s in specs_t] == [s.expr for s in specs_j]
    return (pj, jb, specs_j), (pt, SpectralBasis(S=jb.S, U=jb.U), specs_t), y, cov


def test_combo_scan_decodes_only_named_rows(combo_panel, monkeypatch, reference_null):
    """The scan decodes the rows its expressions name, never the whole
    panel, and matches the reference's scan at the same basis and null."""
    from janusx_tpu_torch.io.packed import PackedGenotypes

    (pj, jb, specs_j), (pt, tb, specs_t), y, cov = _scan_inputs(combo_panel)

    def whole_panel(*a, **k):
        raise AssertionError("pg.dosages() decodes the whole panel")

    monkeypatch.setattr(PackedGenotypes, "dosages", whole_panel)
    got, null_t = tcombo.fvlmm_joint_combo_scan(pt, tb, y, cov, specs_t, batch_size=3,
                                                device="cpu")
    want, null_j = jcombo.fvlmm_joint_combo_scan(pj, jb, y, cov, specs_j, batch_size=3)
    assert null_t.lbd == null_j.lbd
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert {k: a[k] for k in TEXT} == {k: b[k] for k in TEXT}
        np.testing.assert_allclose(a["combo_af"], b["combo_af"], rtol=1e-12)
        for k in ("beta_combo_joint", "se_combo_joint", "p_combo_joint", "p_lit1_joint",
                  "p_lit2_joint"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)


def test_combo_null_fit_matches_reference(combo_panel):
    """The port's own null fit on the doubled-intercept design reaches the
    reference's REML optimum (see the module docstring)."""
    (pj, jb, specs_j), (pt, tb, specs_t), y, cov = _scan_inputs(combo_panel)
    _, null_t = tcombo.fvlmm_joint_combo_scan(pt, tb, y, cov, specs_t[:1], device="cpu")
    _, null_j = jcombo.fvlmm_joint_combo_scan(pj, jb, y, cov, specs_j[:1])
    assert abs(null_t.reml - null_j.reml) <= 1e-6
    assert abs(null_t.log10_lbd - null_j.log10_lbd) <= 1e-4


def test_write_table_is_pandas_to_csv(tmp_path):
    """The port's hand-written table is byte-identical to pandas'
    to_csv(sep="\\t", index=False[, float_format="%.6g"]) on awkward
    values: NaN, ±inf, -0.0, integral floats, quotes, an empty string."""
    import pandas as pd

    from janusx_tpu_torch.cli.fvlmm2 import _write_table

    rows = [{"a": "x\"y", "n": 3, "f": float("nan"), "g": 1e-308, "s": ""},
            {"a": "1:200", "n": -1, "f": float("inf"), "g": -0.0, "s": "z"},
            {"a": "p q", "n": 0, "f": 2.0, "g": 123456789.0, "s": "t\tab"},
            {"a": "r", "n": 7, "f": -float("inf"), "g": 0.1234565, "s": ""}]
    cols = ["n", "a", "f", "g", "s"]
    for fmt in ("%.6g", None):
        _write_table(str(tmp_path / "port.tsv"), cols, rows, float_format=fmt)
        pd.DataFrame(rows)[cols].to_csv(tmp_path / "pd.tsv", sep="\t", index=False,
                                        float_format=fmt)
        assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "pd.tsv").read_bytes()


def test_fvlmm2_without_interaction_forwards_to_gwas(combo_panel, monkeypatch, tmp_path):
    from janusx_tpu_torch.cli.fvlmm2 import main as t_main

    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    _, prefix = combo_panel
    cov = tmp_path / "c.cov"
    cov.write_text("ID\tc0\n" + "".join(f"i{j}\t{v}\n" for j, v in
                                        enumerate(np.random.default_rng(0).normal(size=400))))
    assert t_main(["-bfile", prefix, "-p", prefix + ".pheno", "-c", str(cov), "-n", "0",
                   "-o", str(tmp_path)]) == 0
    assert (tmp_path / "jx.trait0.FvLMM2.assoc.tsv").exists()
