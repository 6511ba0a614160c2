"""The WGCNA helpers (``gtools``) and the in-memory API (``ASSOC``,
``GenomicSelection``): janusx_tpu_torch against janusx_tpu on the CPU, from
the same numpy-seeded inputs.

Bounds: ``cor`` and ``tom`` rtol 1e-5 (atol 1e-6), the same soft-threshold
power and the same ``cluster`` labels; ``ASSOC("lm")`` rtol 1e-8;
``lmm``/``fvlmm``/``splmm`` the null fit's λ rtol 1e-6, every SNP within
Δ(-log10 p) <= 5e-3 (tests/test_scans.py:155), and beta and se rtol 1e-5
on the SNPs whose λ* the two grid scans put within 1e-7 (log10) of each
other (at least 90 %): the scans' f32 grams sum in other orders, which
moves the parabolic refinement of λ* inside its grid cell by up to ~2e-4
on the rest; where λ* stayed in its cell, the port's beta and se at the
reference's λ* rtol 1e-5. ``GenomicSelection("GBLUP")`` predictions rtol 1e-6; the Bayes
routes fed the reference's draws through the port's ``_draws`` seam
(test_torch_bayes.ReplayDraws), predictions rtol 1e-3 (the chain's own
bound, test_torch_bayes.py:7-11).
"""

import numpy as np
import pytest

import janusx_tpu.api as ja
import janusx_tpu.gtools as jgt
import janusx_tpu_torch.api as ta
import janusx_tpu_torch.gtools as tgt


@pytest.fixture(scope="module")
def expr():
    """60 samples x 90 genes: three planted modules of 30 genes, each
    driven by one latent factor (tests/test_gtools.py:52-59)."""
    rng = np.random.default_rng(3)
    labels = np.repeat([0, 1, 2], 30)
    latent = rng.normal(size=(60, 3))
    return latent[:, labels] * 2.0 + rng.normal(size=(60, 90)) * 0.7, labels


def test_wgcna_cor_tom_cluster(expr, monkeypatch):
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    X, planted = expr
    for cortype in ("unsigned", "signed"):
        np.testing.assert_allclose(tgt.cor(X, cortype), jgt.cor(X, cortype), rtol=1e-5,
                                   atol=1e-6)
    sim = jgt.cor(X)
    pj, tj = jgt.pick_soft_threshold(sim, range(1, 13))
    pt, tt = tgt.pick_soft_threshold(tgt.cor(X), range(1, 13))
    assert pt == pj and [r[0] for r in tt] == [r[0] for r in tj]
    np.testing.assert_allclose([r[1:] for r in tt], [r[1:] for r in tj], rtol=1e-4)
    Aj, At = jgt.adj(X, sft=list(range(1, 13))), tgt.adj(X, sft=list(range(1, 13)))
    np.testing.assert_allclose(At, Aj, rtol=1e-5, atol=1e-6)
    Dj, Dt = jgt.tom(Aj), tgt.tom(At, device="cpu")
    np.testing.assert_allclose(Dt, Dj, rtol=1e-5, atol=1e-6)
    for kw in (dict(min_cluster_size=10), dict(min_cluster_size=10, num_modules=3)):
        lj, ij = jgt.cluster(Dj, return_info=True, **kw)
        lt, it = tgt.cluster(Dt, return_info=True, **kw)
        np.testing.assert_array_equal(lt, lj)
        assert it == ij
    assert lt.max() == 3 and all(len(set(lt[planted == k])) == 1 for k in range(3))


def test_wgcna_modules_tsv(expr, tmp_path, monkeypatch):
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    X, _ = expr
    paths = []
    for tag, g in (("ref", jgt), ("port", tgt)):
        labels, info = g.cluster(g.tom(g.adj(X, 6)), min_cluster_size=10, num_modules=3,
                                 return_info=True)
        paths.append(g.write_modules_tsv(str(tmp_path / f"{tag}.tsv"),
                                         [f"g{i}" for i in range(X.shape[1])], labels, info))
    assert open(paths[1]).read() == open(paths[0]).read()


def test_gtools_readers_load_on_use(tmp_path):
    """The annotation readers (a copy, pandas) come through the package's
    lazy attribute and answer as the reference's."""
    p = tmp_path / "regions.bed"
    p.write_text("chr1\t999\t2000\tregA\nchr1\t4999\t9000\tregB\n")
    dj, dt = jgt.bedreader(str(p)), tgt.bedreader(str(p))
    assert dt.equals(dj)
    assert len(tgt.GFFQuery(dt).query_range(1, 1, 3000)) == 1
    with pytest.raises(AttributeError):
        tgt.no_such_reader


@pytest.fixture(scope="module")
def assoc_problem():
    """n = 160 in sibships of 4 (so the REML profile has an interior
    optimum), m = 300 SNPs, 3 % missing dosages, a planted SNP 5 and a
    polygenic background; a covariate."""
    rng = np.random.default_rng(3)
    n, m = 160, 300
    fam = np.arange(n) // 4
    p = rng.uniform(0.1, 0.5, m)[:, None]
    haps = (rng.random((m, 4 * (fam[-1] + 1))) < p).astype(float)
    G = (haps[:, 4 * fam + rng.integers(0, 2, n)]
         + haps[:, 4 * fam + 2 + rng.integers(0, 2, n)]).T
    Gc = G - G.mean(0)
    K = Gc @ Gc.T / m
    y = G[:, 5] * 0.6 + Gc @ rng.normal(0, 0.08, m) + rng.normal(size=n)
    G[rng.random(G.shape) < 0.03] = np.nan
    y[:7] = np.nan
    return G, y, K, rng.normal(size=(n, 1))


@pytest.mark.parametrize("model", ["lm", "lmm", "fvlmm", "splmm"])
@pytest.mark.parametrize("with_k", [True, False], ids=["K", "K-from-G"])
def test_assoc_routes(assoc_problem, model, with_k):
    G, y, K, X = assoc_problem
    K = K if with_k else None
    rj = ja.ASSOC(model).fit(y, X=X, K=K)
    rt = ta.ASSOC(model, device="cpu").fit(y, X=X, K=K)
    dj = rj.assoc(G, chunk=128)
    bt, st, pt = rt._assoc_arrays(G, chunk=128)
    dt = rt.assoc(G, chunk=128)
    assert list(dt.columns) == list(dj.columns) == ["beta", "se", "pwald"]
    np.testing.assert_array_equal(dt["pwald"].to_numpy(), pt)
    bj, sj, pj = (dj[c].to_numpy() for c in ("beta", "se", "pwald"))
    if model == "lm":
        for got, want in ((bt, bj), (st, sj), (pt, pj)):
            np.testing.assert_allclose(got, want, rtol=1e-8)
        return
    assert rt.null_fit_["lambda"] == pytest.approx(rj.null_fit_["lambda"], rel=1e-6)
    # λ* of each side's grid scan on the same rotated SNPs: f32 grams in
    # two summation orders move the parabolic refinement inside its cell
    # (by up to ~2e-4 in log10 here), which moves beta past rtol 1e-5 on
    # up to 10 % of the SNPs. So beta/se are held at rtol 1e-5 where λ*
    # agrees to 1e-7 (on >= 90 % of the SNPs, the least measured); where λ*
    # moved inside its cell, the port's beta/se at the reference's λ* are
    # held at rtol 1e-5; a λ* that left its grid cell is held by p alone
    lgj, lgt, bx, sx = _lambda_star(rj, rt, G, model, chunk=128)
    cell = lambda lg: np.floor((lg + 5.0) / (10.0 / 1023))
    kept = cell(lgt) == cell(lgj)
    same = np.abs(lgt - lgj) <= 1e-7
    assert same.mean() >= 0.9, f"λ* agrees on {same.sum()} of {same.size} SNPs"
    np.testing.assert_allclose(bt[same], bj[same], rtol=1e-5)
    np.testing.assert_allclose(st[same], sj[same], rtol=1e-5)
    np.testing.assert_allclose(bx[kept], bj[kept], rtol=1e-5)
    np.testing.assert_allclose(sx[kept], sj[kept], rtol=1e-5)
    dlp = np.abs(np.log10(pt) - np.log10(pj))
    assert dlp.max() <= 5e-3, f"max Δ(-log10 p) {dlp.max()}"
    assert int(np.argmin(pt)) == int(np.argmin(pj)) == 5


def _lambda_star(rj, rt, G, model, chunk):
    """Each side's per-SNP log10 λ* on its own rotation of the mean-imputed
    G, chunk by chunk as ``assoc`` scans it (the null λ on fvlmm), and the
    port's (beta, se) at the reference's λ*."""
    import jax.numpy as jnp
    import torch

    from janusx_tpu.core.reml import lmm_grid_scan as j_scan
    from janusx_tpu_torch.core.reml import beta_se_snp_batch
    from janusx_tpu_torch.core.reml import lmm_grid_scan as t_scan

    Gk = G[rj._keep]
    Gk = np.where(np.isfinite(Gk), Gk, np.nanmean(Gk, axis=0, keepdims=True))
    grid = np.linspace(-5.0, 5.0, 1024)
    lj, lt, bx, sx = [], [], [], []
    for s0 in range(0, Gk.shape[1], chunk):
        g = Gk[:, s0:s0 + chunk]
        Gr = torch.as_tensor((rt._basis.U.T @ g).T)
        if model == "fvlmm":
            lj.append(np.full(g.shape[1], rj._null.log10_lbd))
            lt.append(np.full(g.shape[1], rt._null.log10_lbd))
        else:
            lj.append(np.asarray(j_scan(rj._rot, jnp.asarray((rj._basis.U.T @ g).T),
                                        jnp.asarray(grid))))
            lt.append(t_scan(rt._rot, Gr, torch.as_tensor(grid)).numpy())
        b, s = beta_se_snp_batch(torch.tensor(lj[-1]), rt._rot, Gr)
        bx.append(b.numpy())
        sx.append(s.numpy())
    return tuple(np.concatenate(x) for x in (lj, lt, bx, sx))


def test_gs_blup(assoc_problem):
    G, y, _, _ = assoc_problem
    train = np.isfinite(y)
    pj = ja.GenomicSelection("GBLUP").fit(G, y).predict()
    pt = ta.GenomicSelection("GBLUP", device="cpu").fit(G, y).predict()
    np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-9)
    assert np.corrcoef(pt[train], y[train])[0, 1] > 0.3
    idx = np.flatnonzero(~train)
    np.testing.assert_allclose(ta.GenomicSelection("rrBLUP", device="cpu").fit(G, y)
                               .predict(idx), pj[idx], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("method", ["BayesA", "BayesB", "BayesCpi"])
def test_gs_bayes_with_replayed_draws(assoc_problem, method):
    import torch
    from test_torch_bayes import ReplayDraws

    G, y, _, _ = assoc_problem
    G = G[:, :140]  # two marker blocks, the second padded
    kw = dict(n_iter=10, burnin=4, seed=7)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        gt = ta.GenomicSelection(method, device="cpu", _draws=ReplayDraws(7), **kw).fit(G, y)
    finally:
        torch.set_num_threads(n)
    gj = ja.GenomicSelection(method, **kw).fit(G, y)
    np.testing.assert_allclose(gt.predict(), gj.predict(), rtol=1e-3, atol=1e-5)
