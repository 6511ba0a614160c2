"""The Bayes marker models of ``jx gs`` (BayesA, BayesB, BayesCpi):
janusx_tpu_torch against janusx_tpu on the CPU.

- Replayed draws: the port's chains (the plain sweeps the CPU runs) fed
  the reference's own ``jax.random`` numbers in the reference's key
  order (``split(key, 9)`` per iteration of ``_gibbs``, ``split(key, 5)``
  of ``_gibbs_blocked_a``) follow the reference's chains: the (μ, σe²)
  trace within rtol 1e-4 and the posterior-mean effects within rtol 1e-3
  (atol 1e-6). The two differ only in f32 summation order (the Grams, the
  right-hand sides, the Cholesky), ~1e-6 relative after 12 iterations;
  a spike-and-slab indicator δ that flips at its threshold would move one
  marker's mean by a whole draw, and the test names such markers.
- Accuracy band: tests/test_gs.py:113-127 on the port with its own
  generator (another chain than the reference's): r > 0.3 for every
  method, and within 0.05 of the reference's r on the same split.
- The CLI: ``jx gs -BLUP -BayesA -BayesB -BayesCpi -cv 2 -save-model``
  writes the reference CLI's files with its layout, and a saved Bayes
  model round-trips through ``jx gspredict``.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janusx_tpu.gs import bayes as jb
from janusx_tpu_torch.gs import bayes as tb

f32 = jnp.float32


def _t(a):
    return torch.as_tensor(np.array(a))


class ReplayDraws:
    """The reference's draws, replayed through the port's ``_draws`` seam:
    each iteration's keys are split as ``_gibbs`` (bayes.py:121) or
    ``_gibbs_blocked_a`` (bayes.py:240) split them, and every draw is the
    one the reference makes from its key."""

    def __init__(self, seed, df0_b=5.0):
        self.key = jax.random.PRNGKey(seed)
        self.df0_b = df0_b

    def sweep(self, n_blocks, C, method):
        shape = (n_blocks, C)
        gamma = lambda k, a: 2.0 * jax.random.gamma(k, a, shape, f32)
        if method == "A":
            self.key, km, kn, kca, self.ke = jax.random.split(self.key, 5)
            return (_t(jax.random.normal(km, dtype=f32)), _t(jax.random.normal(kn, shape, f32)),
                    None, _t(gamma(kca, (self.df0_b + 1.0) / 2.0)), None)
        (self.key, km, kn, ku, kca, kci, self.ke, self.kp,
         self.kc) = jax.random.split(self.key, 9)
        if method == "B":
            rca, rci = gamma(kca, (self.df0_b + 1.0) / 2.0), gamma(kci, self.df0_b / 2.0)
        else:
            rca = rci = jnp.ones(shape, f32)
        return (_t(jax.random.normal(km, dtype=f32)), _t(jax.random.normal(kn, shape, f32)),
                _t(jax.random.uniform(ku, shape, dtype=f32)), _t(rca), _t(rci))

    def var_e(self, shape):
        return _t(2.0 * jax.random.gamma(self.ke, shape, (), f32))

    def slab(self, shape):
        return _t(2.0 * jax.random.gamma(self.kc, jnp.asarray(shape.numpy()), (), f32))

    def pi(self, a, b):
        return _t(jax.random.beta(self.kp, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                                  dtype=f32))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain sweeps are loops of tiny torch ops; with the suite's six
    workers sharing the cores, one torch thread per worker runs them as
    fast as they run alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _panel(n, m, seed):
    """Standardized dosages (n, m) of a random panel and a polygenic trait."""
    rng = np.random.default_rng(seed)
    g = rng.binomial(2, rng.uniform(0.1, 0.5, m)[:, None], size=(m, n)).astype(np.float64)
    sd = g.std(axis=1, keepdims=True)
    Z = np.where(sd > 0, (g - g.mean(axis=1, keepdims=True)) / np.where(sd > 0, sd, 1), 0.0)
    y = Z.T @ rng.normal(0, 0.08, m) + rng.normal(size=n) + 3.0
    return Z.T.astype(np.float32), y


@pytest.mark.parametrize("method", ["BayesA", "BayesB", "BayesCpi"])
def test_chain_follows_reference_with_replayed_draws(method):
    """n = 120, m = 250 (two blocks of C = 128, the second padded), 12
    iterations, burn-in 4."""
    Z, y = _panel(120, 250, seed=5)
    kw = dict(n_iter=12, burnin=4, seed=7, return_trace=True)
    bj, mj, trj = jb.bayes_fit(Z, y, method, **kw)
    bt, mt, trt = tb.bayes_fit(Z, y, method, device="cpu", _draws=ReplayDraws(7), **kw)
    assert trt.shape == trj.shape == (12, 2)
    np.testing.assert_allclose(trt, trj, rtol=1e-4)
    assert mt == pytest.approx(mj, rel=1e-4)
    off = np.flatnonzero(~np.isclose(bt, bj, rtol=1e-3, atol=1e-6))
    assert off.size == 0, (
        f"{method}: {off.size} markers' posterior means differ beyond rtol 1e-3 (a δ that "
        f"flipped at its threshold shows so): markers {off[:10]}, port {bt[off[:10]]}, "
        f"reference {bj[off[:10]]}")


def test_generator_draws_have_the_chain_distributions():
    """The port's own draws (torch.Generator): the χ² draws' means 2·shape,
    Beta(a, b)'s mean a / (a + b), normals and uniforms their moments; the
    same seed repeats them, another seed does not."""
    d = tb.GeneratorDraws(3, torch.device("cpu"), df0_b=5.0)
    mu, rn, ru, rca, rci = d.sweep(400, 128, "B")
    assert mu.shape == () and rn.shape == ru.shape == rca.shape == rci.shape == (400, 128)
    assert abs(float(rn.mean())) < 0.01 and float(rn.std()) == pytest.approx(1.0, abs=0.01)
    assert float(ru.min()) >= 0 and float(ru.max()) < 1
    assert float(rca.mean()) == pytest.approx(6.0, rel=0.02)  # χ² with df0_b + 1 dof
    assert float(rci.mean()) == pytest.approx(5.0, rel=0.02)
    _, _, _, ones, _ = d.sweep(4, 8, "Cpi")
    assert torch.equal(ones, torch.ones(4, 8))
    _, z, none, rchi, _ = d.sweep(4, 8, "A")
    assert none is None and rchi.shape == z.shape == (4, 8)
    chi = torch.stack([d.var_e(60.0) for _ in range(2000)])
    assert float(chi.mean()) == pytest.approx(120.0, rel=0.02)
    a, b = torch.tensor(6.0), torch.tensor(14.0)
    pis = torch.stack([d.pi(a, b) for _ in range(4000)])
    assert float(pis.mean()) == pytest.approx(0.3, abs=0.01)
    again = tb.GeneratorDraws(3, torch.device("cpu"), df0_b=5.0).sweep(400, 128, "B")
    assert all(torch.equal(x, y) for x, y in zip(again, (mu, rn, ru, rca, rci)))
    other = tb.GeneratorDraws(4, torch.device("cpu"), df0_b=5.0).sweep(400, 128, "B")
    assert not torch.equal(other[1], rn)


def test_bayes_fit_refuses_burnin_past_iterations():
    Z, y = _panel(30, 20, seed=1)
    with pytest.raises(ValueError, match="burnin"):
        tb.bayes_fit(Z, y, "BayesB", n_iter=10, burnin=10, device="cpu")


@pytest.fixture(scope="module")
def gs_problem():
    """tests/test_gs.py's problem (the reference's accuracy anchor)."""
    from janusx_tpu.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu.io.packed import QcParams, pack_genotypes

    rng = np.random.default_rng(11)
    m, n = 400, 220
    p = rng.uniform(0.1, 0.5, size=m)
    g = rng.binomial(2, p[:, None], size=(m, n)).astype(np.int8)
    sites = SiteInfo(
        chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1, dtype=np.int64),
        snp=np.array([f"s{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object), allele1=np.array(["C"] * m, object))
    gd = GenotypeData(g, sites, np.array([f"i{j}" for j in range(n)], object))
    pg = pack_genotypes(gd, QcParams(maf=0.01, geno=0.1))
    beta = np.zeros(pg.m)
    idx = rng.choice(pg.m, 30, replace=False)
    beta[idx] = rng.normal(0, 0.5, 30)
    x = pg.centered()
    y = x.T @ beta + rng.normal(0, 1.0, n)
    return pg, y


@pytest.mark.parametrize("method", ["BayesA", "BayesB", "BayesCpi"])
def test_accuracy_band_on_reference_problem(gs_problem, method):
    """tests/test_gs.py:113-127: fit on the first n - 40 samples (300
    iterations, burn-in 150, seed 3), predict the last 40: r > 0.3, and the
    port's r (its own generator's chain) within 0.05 of the reference's."""
    from janusx_tpu.gs.metrics import regression_metrics

    pg, y = gs_problem
    var = 2 * pg.af * (1 - pg.af)
    inv = np.where(var > 0, 1 / np.sqrt(var), 0.0)
    Z = (pg.centered() * inv[:, None]).T.astype(np.float32)
    tr, te = np.arange(0, pg.n - 40), np.arange(pg.n - 40, pg.n)
    r = {}
    for name, fit in (("ref", jb.bayes_fit), ("port", tb.bayes_fit)):
        kw = {"device": "cpu"} if name == "port" else {}
        beta, mu = fit(Z[tr], y[tr], method, n_iter=300, burnin=150, seed=3, **kw)
        r[name] = regression_metrics(y[te], mu + Z[te] @ beta)["pearson"]
    assert r["port"] > 0.3, r
    assert abs(r["port"] - r["ref"]) <= 0.05, r


# ------------------------------------------------------------------ CLI
def _write_panel(d, n=60, m=240, seed=9):
    """A PLINK panel in sibships of 4, one polygenic trait, 12 samples
    unphenotyped (the test set)."""
    from janusx_tpu.io import bitcodec
    from janusx_tpu.io.gdata import SiteInfo
    from janusx_tpu.io.plink import write_plink

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    fam = np.arange(n) // 4
    haps = (rng.random((m, 4 * (fam[-1] + 1))) < rng.uniform(0.1, 0.5, m)[:, None]).astype(np.uint8)
    g = (haps[:, 4 * fam + rng.integers(0, 2, n)] + haps[:, 4 * fam + 2 + rng.integers(0, 2, n)])
    sites = SiteInfo(
        chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1, dtype=np.int64) * 100,
        snp=np.array([f"rs{i}" for i in range(m)], object),
        allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    samples = np.array([f"s{j}" for j in range(n)], object)
    prefix = os.path.join(d, "panel")
    write_plink(prefix, bitcodec.pack_codes(g.astype(np.uint8)), n, sites, samples)
    y = (g - g.mean(axis=1, keepdims=True)).T @ rng.normal(0, 0.1, m) + rng.normal(size=n)
    y[rng.choice(n, 12, replace=False)] = np.nan
    with open(prefix + ".pheno", "wt") as fh:
        fh.write("ID\tbt\n")
        fh.writelines(f"{s}\t{'NA' if np.isnan(v) else f'{v:.6f}'}\n" for s, v in zip(samples, y))
    return prefix, prefix + ".pheno"


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def _read_tsv(path):
    with open(path) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh]


def _layout(x):
    """A JSON value's shape: its keys (recursively) and value types."""
    if isinstance(x, dict):
        return {k: _layout(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_layout(v) for v in x[:1]]
    return "number" if isinstance(x, (int, float)) and not isinstance(x, bool) else type(x).__name__


def test_gs_bayes_cli_has_the_reference_layout(tmp_path, monkeypatch):
    """``jx gs -BLUP -BayesA -BayesB -BayesCpi -cv 2 --bayes-iters 40
    --bayes-burnin 20 -save-model`` through both dispatchers: the same
    files, the GEBV and out-of-fold TSVs with the same header, samples and
    finite values, the summary with the same keys, BLUP equal, the same
    printed lines but for the Bayes metrics (another generator's chain);
    then ``jx gspredict`` with the port's saved BayesB model gives its
    GEBV TSV's BayesB column on the test samples."""
    from janusx_tpu.cli.main import main as j_main
    from janusx_tpu_torch.cli.main import main as t_main

    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("JX_TPU_HISTORY_DB", "0")
    prefix, pheno = _write_panel(str(tmp_path / "data"))
    out, lines = {}, {}
    for tag, main in (("ref", j_main), ("port", t_main)):
        out[tag] = str(tmp_path / tag)
        lines[tag] = _cli(main, ["gs", "-bfile", prefix, "-p", pheno, "-BLUP", "-BayesA",
                                 "-BayesB", "-BayesCpi", "-cv", "2", "--bayes-iters", "40",
                                 "--bayes-burnin", "20", "-save-model", "-o", out[tag]])
    assert sorted(os.listdir(out["port"])) == sorted(os.listdir(out["ref"]))
    for name in ("jxgs.bt.gebv.tsv", "jxgs.bt.oof.tsv"):
        a, b = _read_tsv(os.path.join(out["ref"], name)), _read_tsv(os.path.join(out["port"], name))
        assert b[0] == a[0] and [r[0] for r in b] == [r[0] for r in a]
        assert np.isfinite(np.array([r[1:] for r in b[1:]], float)).all()
        blup = a[0].index("BLUP")
        np.testing.assert_allclose([float(r[blup]) for r in b[1:]],
                                   [float(r[blup]) for r in a[1:]], rtol=1e-4, atol=2e-4)
    sj, st = (json.load(open(os.path.join(out[t], "jxgs.gs.summary.json"))) for t in ("ref", "port"))
    assert _layout(st) == _layout(sj)
    for mm in ("BayesA", "BayesB", "BayesCpi"):
        assert st["traits"]["bt"][mm]["cv"]["pearson"] > -1.0
    assert len(lines["port"]) == len(lines["ref"])
    for a, b in zip(lines["port"], lines["ref"]):
        if "Bayes" not in b:
            assert a == b
        else:
            assert a.split("\t")[0] == b.split("\t")[0]
    pred = str(tmp_path / "pred")
    _cli(t_main, ["gspredict", "-model", os.path.join(out["port"], "jxgs.bt.BayesB.jxmodel.npz"),
                  "-bfile", prefix, "-o", pred])
    gp = {r[0]: float(r[1]) for r in _read_tsv(os.path.join(pred, "gspred.gebv.tsv"))[1:]}
    gebv = _read_tsv(os.path.join(out["port"], "jxgs.bt.gebv.tsv"))
    col = gebv[0].index("BayesB")
    assert len(gebv) == 13
    np.testing.assert_allclose([gp[r[0]] for r in gebv[1:]], [float(r[col]) for r in gebv[1:]],
                               rtol=0, atol=2e-4)
