"""The port's ``jx grm``, ``jx pca`` and ``jx gstats`` against the
reference CLIs on the same simulated panels, on the CPU.

The panel is the reference's ``sim_dataset`` (tests/test_cli.py:13: 300
samples x 800 SNPs from ``jx sim``), here with half the samples in
families of 5 and 2 % missing calls, so KING has relatives and the LD
scores take the pairwise-complete route. Bounds (each printed value also
gets one unit of the last digit its format keeps, since both sides print
rounded values):
- dense GRM files (.npy and -txt) and the -part / -part-group strips:
  rtol 1e-6 with the floor 1e-6 x max|K| (tests/test_torch_grm.py); the
  .id sidecars byte-identical; the .spgrm the same pattern, values under
  the same bound; ``-k FILE -sparse`` (the same dense input) byte-identical;
- PCA: eigenvalues rtol 1e-6 on the GRM routes (rtol 1e-8 from the same
  GRM file), 1e-5 on the RSVD routes; PCs equal up to sign at atol 1e-4;
  the RSVD routes on the reference's structured fixture
  (tests/test_cli.py:66), whose leading PC is identifiable;
- gstats: every table byte-identical (they are integer counts and their
  ratios) but the LD-score columns, rtol 1e-5.
"""

import os

import numpy as np
import pytest

from janusx_tpu.cli.main import main as j_jx
from janusx_tpu_torch.cli.main import main as t_jx


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("JX_TPU_HISTORY_DB", "0")


@pytest.fixture(scope="module")
def sim_dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("simdata")
    assert j_jx(["sim", "-nind", "300", "-nsnp", "800", "-nqtl", "20", "-h2", "0.6",
                 "-structure", "mixed", "-miss", "0.02", "-o", str(out),
                 "-prefix", "sim"]) == 0
    return str(out / "sim")


def _both(tmp_path, argv, prefix):
    """One module through both CLIs: outputs under tmp_path/ref and
    tmp_path/port with the same prefix."""
    for name, main in (("ref", j_jx), ("port", t_jx)):
        assert main(argv + ["-o", str(tmp_path / name), "-prefix", prefix]) == 0
    return tmp_path / "ref", tmp_path / "port"


def _unit(x: np.ndarray, digits: int) -> np.ndarray:
    """One unit of the last of ``digits`` significant digits of x."""
    ax = np.abs(x)
    return np.where(ax > 0, 10.0 ** (np.floor(np.log10(np.where(ax > 0, ax, 1.0)))
                                     - (digits - 1)), 0.0)


def _close_grm(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_grm_cli_matches_reference(sim_dataset, tmp_path, capsys):
    ref, port = _both(tmp_path, ["grm", "-bfile", sim_dataset, "-sparse", "0.05",
                                 "--stage-timing"], "g")
    assert "stage-timing\tload=" in capsys.readouterr().out
    K = np.load(port / "g.cGRM.npy")
    assert K.shape == (300, 300)
    _close_grm(K, np.load(ref / "g.cGRM.npy"))
    for f in ("g.cGRM.id", "g.cGRM.spgrm.id"):
        assert (port / f).read_bytes() == (ref / f).read_bytes()
    from janusx_tpu_torch.io.jxgrm import read_jxgrm

    sp_p, sp_r = (read_jxgrm(str(d / "g.cGRM.spgrm")).tocsc() for d in (port, ref))
    np.testing.assert_array_equal(sp_p.indptr, sp_r.indptr)
    np.testing.assert_array_equal(sp_p.indices, sp_r.indices)
    _close_grm(sp_p.data, sp_r.data)
    assert sp_p.nnz > 300  # the families

    # -k FILE -sparse converts the same dense file: the same bytes
    ref, port = _both(tmp_path, ["grm", "-k", str(ref / "g.cGRM.npy"), "-sparse"], "k")
    assert (port / "k.cGRM.spgrm").read_bytes() == (ref / "k.cGRM.spgrm").read_bytes()


def test_grm_cli_txt_and_method2(sim_dataset, tmp_path):
    ref, port = _both(tmp_path, ["grm", "-bfile", sim_dataset, "-txt", "-m", "2"], "t")
    got, want = (np.loadtxt(d / "t.sGRM.txt", delimiter="\t") for d in (port, ref))
    err = np.abs(got - want)
    assert np.all(err <= 1e-6 * np.abs(want) + 1e-6 * np.abs(want).max() + _unit(want, 6))


def test_grm_cli_parts_match_reference(sim_dataset, tmp_path):
    ref, port = _both(tmp_path, ["grm", "-bfile", sim_dataset], "full")
    K = np.load(port / "full.cGRM.npy")
    ref, port = _both(tmp_path, ["grm", "-bfile", sim_dataset, "-part", "3"], "pp")
    strips = []
    for k in (1, 2, 3):
        s = np.load(port / f"pp.cGRM.part{k}_3.npy")
        _close_grm(s, np.load(ref / f"pp.cGRM.part{k}_3.npy"))
        strips.append(s)
    _close_grm(np.vstack(strips), K)
    ref, port = _both(tmp_path, ["grm", "-bfile", sim_dataset, "-part", "4", "2"], "p1")
    written = lambda d: sorted(f for f in os.listdir(d) if f.startswith("p1.cGRM"))
    assert written(port) == written(ref) == ["p1.cGRM.id", "p1.cGRM.part2_4.npy"]
    _close_grm(np.load(port / "p1.cGRM.part2_4.npy"), np.load(ref / "p1.cGRM.part2_4.npy"))
    samples = [ln.split()[0] for ln in open(port / "full.cGRM.id")]
    groups = tmp_path / "groups.txt"
    groups.write_text("".join(f"{s}\tg{i % 3}\n" for i, s in enumerate(samples)
                              if i % 5))  # some samples in no group
    ref, port = _both(tmp_path, ["grm", "-bfile", sim_dataset, "-part-group", str(groups)],
                      "gg")
    for g in ("g0", "g1", "g2"):
        s = np.load(port / f"gg.cGRM.group_{g}.npy")
        _close_grm(s, np.load(ref / f"gg.cGRM.group_{g}.npy"))
        rows = [i for i in range(300) if i % 5 and f"g{i % 3}" == g]
        _close_grm(s, K[rows])


def test_grm_cli_distributed_is_not_ported(sim_dataset, tmp_path, monkeypatch):
    """``jx grm --distributed``, once refused here, now builds the GRM; in
    one process (no JX_DIST_* nor launcher environment) it writes the
    same .npy as ``jx grm``."""
    for k in ("JX_DIST_COORDINATOR", "MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert t_jx(["grm", "-bfile", sim_dataset, "-o", str(tmp_path / "one")]) == 0
    assert t_jx(["grm", "-bfile", sim_dataset, "--distributed",
                 "-o", str(tmp_path / "dist")]) == 0
    (one,), (dist,) = (list((tmp_path / d).glob("*.cGRM.npy")) for d in ("one", "dist"))
    np.testing.assert_array_equal(np.load(dist), np.load(one))


def _pcs(d, prefix):
    vals = np.loadtxt(d / f"{prefix}.eigenval", ndmin=1)
    vecs = np.loadtxt(d / f"{prefix}.eigenvec", dtype=str)
    return vals, vecs[:, 0], vecs[:, 1:].astype(float)


def _same_pcs(port, ref, prefix, val_rtol):
    vp, sp, Vp = _pcs(port, prefix)
    vr, sr, Vr = _pcs(ref, prefix)
    assert list(sp) == list(sr)
    assert np.all(np.abs(vp - vr) <= val_rtol * np.abs(vr) + _unit(vr, 6))
    signs = np.sign(np.sum(Vp * Vr, axis=0))
    np.testing.assert_allclose(Vp * signs, Vr, rtol=0, atol=1e-4)
    return vp, Vp


def test_pca_cli_matches_reference(sim_dataset, tmp_path):
    ref, port = _both(tmp_path, ["grm", "-bfile", sim_dataset], "g")
    ref, port = _both(tmp_path, ["pca", "-k", str(ref / "g.cGRM.npy"), "-dim", "5"], "k")
    _same_pcs(port, ref, "k", 1e-8)
    ref, port = _both(tmp_path, ["pca", "-bfile", sim_dataset, "-dim", "5"], "e")
    vals, _ = _same_pcs(port, ref, "e", 1e-6)
    assert len(vals) == 5 and np.all(np.diff(vals) <= 0)


@pytest.fixture(scope="module")
def two_pops(tmp_path_factory):
    """tests/test_cli.py:66: two diverged subpopulations."""
    from janusx_tpu.io import plink
    from janusx_tpu.io.gdata import GenotypeData, SiteInfo

    rng = np.random.default_rng(5)
    m, n = 600, 200
    p1 = rng.uniform(0.1, 0.9, m)
    p2 = np.clip(p1 + rng.normal(0, 0.25, m), 0.02, 0.98)
    g = np.concatenate([rng.binomial(2, p1[:, None], (m, n // 2)),
                        rng.binomial(2, p2[:, None], (m, n - n // 2))], axis=1).astype(np.int8)
    sites = SiteInfo(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1, dtype=np.int64),
                     snp=np.array([f"s{i}" for i in range(m)], object),
                     allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    prefix = str(tmp_path_factory.mktemp("pops") / "pop")
    plink.write_plink_genotypes(
        prefix, GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object)))
    return prefix


@pytest.mark.parametrize("flags", [["-approx", "-gk", "2"], ["-rsvd"], ["-rsvd", "2"]])
def test_pca_cli_rsvd_matches_reference(two_pops, tmp_path, flags):
    ref, port = _both(tmp_path, ["pca", "-bfile", two_pops, "-dim", "2", *flags], "r")
    vals, vecs = _same_pcs(port, ref, "r", 1e-5)
    # the reference's own check: RSVD close to exact on the leading PC
    gk = flags[flags.index("-gk"):] if "-gk" in flags else []
    ref, port = _both(tmp_path, ["pca", "-bfile", two_pops, "-dim", "2", *gk], "e")
    ve, _, Ve = _pcs(port, "e")
    assert vals[0] == pytest.approx(ve[0], rel=1e-3)
    assert abs(np.corrcoef(vecs[:, 0], Ve[:, 0])[0, 1]) > 0.999


def test_pca_cli_plots(sim_dataset, tmp_path):
    """-plot with -group, then -c (visualization only), as the reference
    CLI draws them (matplotlib is imported only for these flags)."""
    pytest.importorskip("matplotlib")
    port = tmp_path / "port"
    assert t_jx(["pca", "-bfile", sim_dataset, "-dim", "3", "-plot", "-o", str(port),
                 "-prefix", "g"]) == 0
    samples = np.loadtxt(port / "g.eigenvec", dtype=str)[:, 0]
    grp = tmp_path / "groups.txt"
    grp.write_text("".join(f"{s}\tG{i % 2}\n" for i, s in enumerate(samples)))
    assert t_jx(["pca", "-c", str(port / "g"), "-group", str(grp), "-palette", "red,blue",
                 "-o", str(port), "-prefix", "viz"]) == 0
    for f in ("g.pca.png", "g.pca13.png", "viz.pca.png", "viz.pca13.png"):
        assert (port / f).stat().st_size > 0, f


def _table(path):
    return [ln.rstrip("\n").split("\t") for ln in open(path)]


def _same_table(port, ref, name, ld_cols=(), ld_digits=6, fixed=False):
    """Byte-identical but for the LD-score columns, held to rtol 1e-5
    (plus one printed unit: 6 significant digits, or 6 decimals)."""
    tp, tr = _table(port / name), _table(ref / name)
    assert tp[0] == tr[0] and len(tp) == len(tr)
    cols = [tr[0].index(c) for c in ld_cols]
    for rp, rr in zip(tp[1:], tr[1:]):
        assert [v for i, v in enumerate(rp) if i not in cols] == \
            [v for i, v in enumerate(rr) if i not in cols]
        for i in cols:
            a, b = float(rp[i]), float(rr[i])
            unit = 1e-6 if fixed else float(_unit(np.array(b), ld_digits))
            assert abs(a - b) <= 1e-5 * abs(b) + unit * (1 + 1e-9), (name, rr, rp)
    return tp


def test_gstats_cli_matches_reference(sim_dataset, tmp_path, capsys):
    ref, port = _both(tmp_path, ["gstats", "-bfile", sim_dataset, "-site", "-ind", "-king",
                                 "-ldscore", "20"], "st")
    printed = capsys.readouterr().out.splitlines()
    kings = [ln for ln in printed if ln.startswith("KING:")]
    assert len(kings) == 2 and kings[0] == kings[1]
    site = _same_table(port, ref, "st.site.stats.tsv", ld_cols=("ldscore",))
    assert len(site) == 801 and site[0][-1] == "ldscore"
    assert all(float(r[-1]) >= -1e-6 for r in site[1:])
    for f in ("st.ind.stats.tsv", "st.king.pairs.tsv", "st.king.unrelated.id"):
        assert (port / f).read_bytes() == (ref / f).read_bytes(), f
    assert len(_table(port / "st.ind.stats.tsv")) == 301
    assert len(_table(port / "st.king.pairs.tsv")) > 50  # the families


def test_gstats_cli_reference_tables(sim_dataset, tmp_path):
    """-freq -miss -het -ldsc (the reference's script/gstats.py tables),
    with their PDFs, and the SNP-count -ldsc spelling."""
    pytest.importorskip("matplotlib")
    ref, port = _both(tmp_path, ["gstats", "-bfile", sim_dataset, "-freq", "-miss", "-het",
                                 "-ldsc", "30kb"], "st")
    for f in ("st.freq", "st.lmiss", "st.imiss", "st.lhet", "st.ihet"):
        assert (port / f).read_bytes() == (ref / f).read_bytes(), f
    ldsc = _same_table(port, ref, "st.30kb.ldsc", ld_cols=("ldsc",), fixed=True)
    assert len(ldsc) == 801
    for f in ("st.freq.pdf", "st.miss.pdf", "st.het.pdf", "st.30kb.ldsc.pdf"):
        assert (port / f).stat().st_size > 0, f
    ref, port = _both(tmp_path, ["gstats", "-bfile", sim_dataset, "-ldsc", "25"], "sc")
    _same_table(port, ref, "sc.25snp.ldsc", ld_cols=("ldsc",), fixed=True)
