"""GARFIELD (``jx garfield``, ``jx postgarfield``): janusx_tpu_torch
against janusx_tpu on the CPU, from the same numpy-seeded inputs.

Bounds: B bit-equal to ``dosages == 2`` (missing calls, n not a multiple
of 4); the extension scores rtol 1e-5 with the supports exact; depth-1
scores rtol 1e-12 and the same pre-selected markers; whole scans (corr
and mcc, ``preselect``, ``snp_subset``, the window scan, ``K``) with the
rule scores and the permutation maxima rtol 1e-5, the p-values equal, and
the same rules off ties. Ties: the reference orders equal scores by
``np.argsort``, whose order for equal keys is unspecified, so a rule
whose score lies within 1e-6 (relative) of another rule's may differ; a
rule is "the same" when its indicator vector over the samples is (two
markers with identical hom-alt rows name one rule). The CLI TSVs: every
row's score rtol 1e-5 and p-value equal, and the text columns equal on
the rows off ties.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import janusx_tpu.models.garfield as jg
import janusx_tpu_torch.models.garfield as tg
from janusx_tpu.io.gdata import GenotypeData, SiteInfo
from janusx_tpu.io.packed import QcParams, pack_genotypes
from janusx_tpu_torch.io.packed import PackedGenotypes as TorchPacked


def _port_pg(pg):
    return TorchPacked(**{k: getattr(pg, k) for k in (
        "packed", "n_samples", "sites", "samples", "af", "miss", "mean")})


@pytest.fixture(scope="module")
def epi():
    """300 SNPs x 401 samples (2 % missing), a planted AND of the hom-alt
    indicators of SNPs 10 and 40 (~4 % carriers); SNPs on two chromosomes."""
    rng = np.random.default_rng(31)
    m, n = 300, 401
    p = rng.uniform(0.25, 0.6, size=m)
    p[10] = p[40] = 0.45
    g = rng.binomial(2, p[:, None], size=(m, n)).astype(np.int8)
    g[rng.random((m, n)) < 0.02] = -1
    sites = SiteInfo(
        chrom=np.array(["1"] * 150 + ["2"] * 150, object),
        pos=np.arange(1, m + 1, dtype=np.int64) * 10,
        snp=np.array([f"s{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    pg = pack_genotypes(GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object)),
                        QcParams(maf=0.05, geno=0.1))
    d = pg.dosages()
    rule = ((d[10] == 2) & (d[40] == 2)).astype(float)
    y = 2.0 * rule + rng.normal(size=pg.n) * 0.8
    return pg, _port_pg(pg), y, (d == 2).astype(np.uint8)


def _rule_vector(H, ru):
    b = H[ru.snps[0]]
    v = 1 - b if ru.ops[0] == "NOT" else b
    for op, s in zip(ru.ops[1:], ru.snps[1:]):
        v = v & H[s] if op == "AND" else v & (1 - H[s]) if op == "ANDN" else v ^ H[s]
    return v


def _off_ties(scores, rel=1e-6):
    s = np.asarray(scores)
    return [i for i in range(len(s))
            if np.all(np.abs(np.delete(s, i) - s[i]) > rel * abs(s[i]))]


def assert_same_result(rj, rt, H):
    sj = np.array([ru.score for ru in rj.rules])
    st = np.array([ru.score for ru in rt.rules])
    assert len(sj) == len(st) and rj.mode == rt.mode
    np.testing.assert_allclose(st, sj, rtol=1e-5)
    np.testing.assert_allclose(rt.perm_max_scores, rj.perm_max_scores, rtol=1e-5)
    np.testing.assert_array_equal(rt.pvalues, rj.pvalues)
    off = _off_ties(sj)
    assert off, "no rule off ties: the comparison would be empty"
    for i in off:
        a, b = rj.rules[i], rt.rules[i]
        va, vb = _rule_vector(H, a), _rule_vector(H, b)
        if _has_twin(a.ops):  # its complement scores alike
            assert np.array_equal(va, vb) or np.array_equal(va, 1 - vb), (i, a, b)
        else:
            assert np.array_equal(va, vb) and a.support == b.support, (i, a, b)
        assert len(a.snps) == len(b.snps)


def _has_twin(ops) -> bool:
    """A literal, or a chain of XORs, has a complement twin of the same
    form and score (corr^2 and MCC^2 are blind to complementing): ``a`` /
    ``NOT a``, ``a XOR b`` / ``NOT a XOR b``."""
    return all(op == "XOR" for op in ops[1:])


def test_hom_alt_matrix_equals_dosages(epi):
    pg, tpg, _, H = epi
    assert pg.n % 4 != 0 and (pg.dosages() < 0).any()
    B = tg.hom_alt_matrix(tpg, device="cpu")
    assert B.dtype == torch.float32
    np.testing.assert_array_equal(B.numpy(), H.astype(np.float32))
    rows = np.array([5, 0, 299, 17])
    np.testing.assert_array_equal(tg.hom_alt_matrix(tpg, rows, device="cpu").numpy(), H[rows])


@pytest.mark.parametrize("mode", ["corr", "mcc"])
def test_extension_scores(mode):
    rng = np.random.default_rng(7)
    m, n, S = 500, 203, 24
    B = (rng.random((m, n)) < 0.3).astype(np.float32)
    seeds = (rng.random((S, n)) < 0.4).astype(np.float32)
    t = rng.normal(size=n) if mode == "corr" else (rng.random(n) < 0.3).astype(float)
    t = t - t.mean() if mode == "corr" else t
    t2sum = float(t @ t) if mode == "corr" else float(t.sum())
    ref = jg._extension_scores(jnp.asarray(seeds), jnp.asarray(B), jnp.asarray(t, jnp.float32),
                               t2sum, float(n), mode)
    got = tg._extension_scores(torch.as_tensor(seeds), torch.as_tensor(B),
                               torch.as_tensor(t, dtype=torch.float32), t2sum, float(n), mode)
    for op in tg._OPS:
        np.testing.assert_array_equal(got[op][1].numpy(), np.asarray(ref[op][1]))
        np.testing.assert_allclose(got[op][0].numpy(), np.asarray(ref[op][0]), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("mode", ["corr", "mcc"])
def test_single_scores_and_preselect(epi, mode):
    pg, _, y, H = epi
    t = (y > 1.0).astype(float) if mode == "mcc" else y - y.mean()
    t2sum = float(t @ t) if mode == "corr" else float(t.sum())
    sj, cj = jg._single_scores(H, t, t2sum, mode, pg.n)
    st, ct = tg._single_scores(torch.as_tensor(H, dtype=torch.float32), t, t2sum, mode, pg.n)
    np.testing.assert_array_equal(ct.numpy(), cj)
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-12)
    kj = jg.preselect_features(H, t, mode, 40, pair_sample=500, seed=3)
    kt = tg.preselect_features(torch.as_tensor(H, dtype=torch.float32), t, mode, 40,
                               pair_sample=500, seed=3)
    # the same kept markers off ties: every marker that scores strictly
    # above the 40th best is kept by both, and each kept one scores at
    # least the 40th best
    c = _screen_scores(H, t, t2sum, mode, 500, seed=3)
    thr = np.sort(c)[::-1][39]
    above = set(np.flatnonzero(c > thr * (1 + 1e-9)).tolist())
    assert above <= set(kt.tolist()) and above <= set(kj.tolist())
    assert len(kt) == len(kj) == 40 and bool(np.all(c[kt] >= thr * (1 - 1e-9)))
    if mode == "corr":  # continuous target: no tie at the boundary
        np.testing.assert_array_equal(kt, kj)


def _screen_scores(H, t, t2sum, mode, pair_sample, seed):
    """The reference screen's per-marker score (janusx_tpu/models/
    garfield.py:255-283), which ``preselect_features`` ranks."""
    m, n = H.shape
    s1, _ = jg._single_scores(H, t, t2sum, mode, n)
    rng = np.random.default_rng(seed)
    ii, jj = rng.integers(0, m, size=pair_sample), rng.integers(0, m, size=pair_sample)
    Bi, Bj = H[ii].astype(float), H[jj].astype(float)
    num, cnt = (Bi * t * Bj).sum(1), (Bi * Bj).sum(1)
    best = np.zeros(m)
    for nm, ct in ((num, cnt), (Bi @ t - num, Bi.sum(1) - cnt),
                   (Bi @ t + Bj @ t - 2 * num, Bi.sum(1) + Bj.sum(1) - 2 * cnt)):
        sc = jg._score_np(nm, ct, t2sum, float(n), mode)
        np.maximum.at(best, ii, sc)
        np.maximum.at(best, jj, sc)
    return np.maximum(np.maximum(s1[:m], s1[m:]), 0.5 * best)


@pytest.mark.parametrize("case", [
    dict(depth=2, beam=48, n_perm=20, seed=2),
    dict(depth=3, beam=32, n_perm=6, seed=1, preselect=60),
    dict(depth=2, beam=16, n_perm=10, seed=3, trait_type="binary"),
    dict(depth=2, beam=24, n_perm=8, seed=4, snp_subset=np.arange(0, 300, 2)),
    dict(depth=2, beam=24, n_perm=8, seed=5, grm=True, min_support=10),
], ids=["corr", "depth3-preselect", "mcc", "snp-subset", "grm"])
def test_garfield_scan(epi, case):
    pg, tpg, y, H = epi
    kw = dict(case)
    if kw.pop("grm", False):
        from janusx_tpu.models.grm import grm_from_packed

        kw["K"] = np.asarray(grm_from_packed(pg))
    yy = (y > 1.0).astype(float) if kw.get("trait_type") == "binary" else y
    rj = jg.garfield_scan(pg, yy, **kw)
    rt = tg.garfield_scan(tpg, yy, device="cpu", **kw)
    assert_same_result(rj, rt, H)


def test_garfield_window_scan(epi):
    pg, tpg, y, H = epi
    kw = dict(window_kb=0.8, step_kb=0.6, depth=2, beam=16, n_perm=6, seed=9, top_per_window=3)
    wj = jg.garfield_window_scan(pg, y, **kw)
    wt = tg.garfield_window_scan(tpg, y, device="cpu", **kw)
    assert [w[:3] for w in wt] == [w[:3] for w in wj] and len(wj) >= 6
    for a, b in zip(wj, wt):
        assert_same_result(a[3], b[3], H)


# ------------------------------------------------------------------ CLI
@pytest.fixture(scope="module")
def cli_panel(tmp_path_factory):
    """The panel of tests/test_garfield_algwas.py:214-236: 120 SNPs x 150
    samples, an AND of SNPs 10 and 40, two genes, two traits."""
    from janusx_tpu.io import plink
    from janusx_tpu.models.sim import write_pheno

    d = tmp_path_factory.mktemp("gcli")
    rng = np.random.default_rng(5)
    m, n = 120, 150
    g = rng.binomial(2, 0.4, size=(m, n)).astype(np.int8)
    b = (g[10] == 2) & (g[40] == 2)
    y = rng.normal(size=n) * 0.5 + 2.0 * b
    sites = SiteInfo(chrom=np.array(["Chr1"] * m, object),
                     pos=(np.arange(m, dtype=np.int64) + 1) * 100,
                     snp=np.array([f"s{i}" for i in range(m)], object),
                     allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    prefix = str(d / "gf")
    plink.write_plink_genotypes(
        prefix, GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object)))
    ids = [f"i{j}" for j in range(n)]
    write_pheno(prefix + ".pheno", ids, y[:, None])
    write_pheno(prefix + ".pheno2", ids, np.stack([y, rng.normal(size=n)], axis=1))
    (d / "g.gff3").write_text(
        "##gff-version 3\n"
        "Chr1\tsrc\tgene\t900\t4500\t.\t+\t.\tID=GeneA\n"
        "Chr1\tsrc\tgene\t3500\t6000\t.\t+\t.\tID=GeneB\n")
    (d / "genes.txt").write_text("GeneA\tset1\nGeneB\tset1\n")
    return d, prefix


def _read(path):
    with open(path) as fh:
        lines = [ln.rstrip("\n").split("\t") for ln in fh]
    return lines[0], lines[1:]


def assert_same_tsv(ref_path, port_path):
    hj, rj = _read(ref_path)
    ht, rt = _read(port_path)
    assert ht == hj and len(rt) == len(rj) and rj, (ht, hj, len(rt), len(rj))
    num = {"score", "pperm", "pfdr"}
    text = [i for i, h in enumerate(hj) if h not in num]
    si = hj.index("score")
    # ties are judged within one scan unit: the window or gene unit
    unit = [i for i, h in enumerate(hj) if h in ("chrom", "start", "unit")]
    groups = {}
    for k, r in enumerate(rj):
        groups.setdefault(tuple(r[i] for i in unit), []).append(k)
    for i, h in enumerate(hj):
        if h in num:
            np.testing.assert_allclose([float(r[i]) for r in rt], [float(r[i]) for r in rj],
                                       rtol=1e-5, err_msg=h)
    n_off = 0
    for ks in groups.values():
        scores = [float(rj[k][si]) for k in ks]
        for k in (ks[j] for j in _off_ties(scores)):
            n_off += 1
            got, want = ([r[i] for i in text] for r in (rt[k], rj[k]))
            ri, su = text.index(hj.index("rule")), text.index(hj.index("support"))
            if "AND" not in rj[k][hj.index("rule")].split():
                # a literal or an XOR chain (_has_twin): the rule or its
                # complement, whose head's NOT and support differ
                for v in (got, want):
                    v[ri] = v[ri].removeprefix("NOT ")
                    del v[su]
            assert got == want, (rt[k], rj[k])
    assert n_off, "no row off ties"


@pytest.mark.parametrize("spelling", ["wg", "genes", "window", "pm"])
def test_garfield_cli_tsv_equals_reference(cli_panel, spelling, monkeypatch):
    from janusx_tpu.cli.main import main as ref_main
    from janusx_tpu_torch.cli.main import main as port_main

    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("JX_TPU_HISTORY_DB", "0")
    d, prefix = cli_panel
    common = ["-maf", "0.0", "-geno", "1.0"]
    argv, outs = {
        "wg": (["-p", prefix + ".pheno", "-layer", "2", "-width", "48", "-topk", "5", "-lmaf",
                "0.03", "-perm", "20", "-wg", "--xor-search"], ["trait0.garfield.tsv"]),
        "genes": (["-p", prefix + ".pheno2", "-n", "0,1", "-g", str(d / "genes.txt"), "-gff",
                   str(d / "g.gff3"), "-w", "0.5", "-perm", "20"],
                  ["trait0.garfield.genes.tsv", "trait1.garfield.genes.tsv"]),
        "window": (["-p", prefix + ".pheno", "-w", "3", "1.5", "-perm", "10", "-bimrange",
                    "Chr1:0-0.008"], ["trait0.garfield.windows.tsv"]),
        "pm": (["-p", prefix + ".pheno", "-perm", "20", "-pm", "q90", "-m", "40"],
               ["trait0.garfield.tsv"]),
    }[spelling]
    for tag, main in (("ref", ref_main), ("port", port_main)):
        assert main(["garfield", "-bfile", prefix, *argv, *common, "-o", str(d / tag),
                     "-prefix", spelling]) == 0
    for out in outs:
        assert_same_tsv(str(d / "ref" / f"{spelling}.{out}"), str(d / "port" / f"{spelling}.{out}"))


def test_postgarfield_on_port_tsv(cli_panel, monkeypatch):
    """``jx postgarfield`` (a copy) through the port's dispatcher on the
    port's ``jx garfield`` TSV, with a background GWAS, -circle and -gff:
    the reference's figures and the same endpoint table."""
    from janusx_tpu.cli.main import main as ref_main
    from janusx_tpu_torch.cli.main import main as port_main

    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("JX_TPU_HISTORY_DB", "0")
    d, prefix = cli_panel
    tsv = d / "pg" / "x.trait0.garfield.tsv"
    assert port_main(["garfield", "-bfile", prefix, "-p", prefix + ".pheno", "-perm", "10",
                      "-maf", "0.0", "-geno", "1.0", "-o", str(d / "pg"), "-prefix", "x"]) == 0
    gwas = d / "bg.tsv"
    gwas.write_text("chrom\tpos\tsnp\tpwald\n" + "".join(
        f"Chr1\t{(i + 1) * 100}\ts{i}\t{0.5 / (i + 1)}\n" for i in range(120)))
    for tag, main in (("ref", ref_main), ("port", port_main)):
        assert main(["postgarfield", "-i", str(tsv), "-gwasfile", str(gwas), "-thr", "1e-3",
                     "-circle", "-gff", str(d / "g.gff3"), "-o", str(d / f"pp{tag}"),
                     "-prefix", "v"]) == 0
    files = {tag: sorted(os.listdir(d / f"pp{tag}")) for tag in ("ref", "port")}
    assert files["port"] == files["ref"]
    assert {"v.x.trait0.garfield.rules.png", "v.x.trait0.garfield.arcs.png",
            "v.x.trait0.garfield.circle.png"} <= set(files["port"])
    ep = "v.x.trait0.garfield.endpoints.tsv"
    assert (d / "ppport" / ep).read_text() == (d / "ppref" / ep).read_text()
