"""The port's host tools against the reference's, on the CPU: the fastq2count
pipeline, the web UI, the native CPU baseline scan, logistic regression and
bulked-segregant analysis.

Each mirrors the reference's own tests through the port's modules:
tests/test_fastq2count.py (6), tests/test_webui.py (5),
tests/test_baseline_cpu.py (3, against the port's ``lmm_scan(method=
"brent")``), the ``logreg`` tests of tests/test_garfield_algwas.py (3) and
the BSA tests of tests/test_longtail.py (5). Beyond them:
- ``jx bsa`` (both input modes) and ``jx postbsa`` through both dispatchers:
  every table byte-identical, the plots only present;
- a web UI job runs the port's dispatcher in its child: a ``sim`` job whose
  child sees a ``jax`` that raises on import ends ``ok``, which the
  reference's child could not, and its command names
  ``janusx_tpu_torch.cli.main``;
- the FPKM/TPM tables and the pipeline commands equal the reference's but
  where they name the package.

The baseline's library (native/libjxbaseline.so) is shared with the
reference's copy; it is first loaded under the same file lock as the k-mer
counter's (tests/test_torch_kmer.py ``load_native_locked``).
"""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

from janusx_tpu.cli.main import main as j_jx
from janusx_tpu.utils import baseline_cpu as j_baseline
from janusx_tpu_torch.cli.main import main as t_jx
from janusx_tpu_torch.pipeline.executor import PipelineOptions
from janusx_tpu_torch.pipeline.fastq2count import (
    Fastq2CountConfig,
    build_pipelines,
    discover_samples,
    fpkm_tpm_from_featurecounts,
    infer_samples_from_bam,
    run,
)
from janusx_tpu_torch.utils import baseline_cpu
from test_torch_kmer import load_native_locked


@pytest.fixture(autouse=True, scope="module")
def _env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JX_TPU_PLATFORM", "cpu")
        mp.setenv("JX_TPU_HISTORY_DB", "0")
        yield


# ------------------------------------------------ tests/test_fastq2count.py
def test_discover_samples_pairing(tmp_path):
    (tmp_path / "sub").mkdir()
    for nm in ("A_1.fq.gz", "A_2.fq.gz", "B_R1.fastq.gz", "B_R2.fastq.gz", "sub/C.R1.fastq",
               "sub/C.R2.fastq", "lonely_1.fq.gz", "notes.txt"):
        (tmp_path / nm).write_text("x")
    samples = discover_samples(str(tmp_path))
    assert [s["id"] for s in samples] == ["A", "B", "C"]
    for s in samples:
        assert s["fq1"].endswith(("_1.fq.gz", "_R1.fastq.gz", ".R1.fastq"))
        assert s["fq2"].endswith(("_2.fq.gz", "_R2.fastq.gz", ".R2.fastq"))
    from janusx_tpu.pipeline.fastq2count import discover_samples as j_discover

    assert samples == j_discover(str(tmp_path))


def test_discover_samples_duplicate_mate_errors(tmp_path):
    (tmp_path / "X_1.fq").write_text("x")
    (tmp_path / "X_R1.fastq").write_text("x")
    with pytest.raises(ValueError, match="Duplicate"):
        discover_samples(str(tmp_path))


def test_infer_samples_from_bam(tmp_path):
    (tmp_path / "s1.bam").write_text("")
    (tmp_path / "s1.bam.bai").write_text("")
    (tmp_path / "s2.bam").write_text("")
    assert [s["id"] for s in infer_samples_from_bam(str(tmp_path))] == ["s1", "s2"]


def test_fpkm_tpm_math(tmp_path):
    from janusx_tpu.pipeline.fastq2count import fpkm_tpm_from_featurecounts as j_fpkm

    counts = tmp_path / "gene_counts.txt"
    counts.write_text(
        "# featureCounts v2 command line\n"
        "Geneid\tChr\tStart\tEnd\tStrand\tLength\t/w/04_mapping/s1.bam\t/w/04_mapping/s2.bam\n"
        "g1\t1\t1\t1000\t+\t1000\t100\t0\n"
        "g2\t1\t1\t500\t+\t500\t50\t200\n"
        "g3\t2\t1\t2000\t+\t2000\t850\t800\n")
    fpkm_p, tpm_p = str(tmp_path / "f.tsv"), str(tmp_path / "t.tsv")
    fpkm_tpm_from_featurecounts(str(counts), fpkm_p, tpm_p)
    C = np.array([[100.0, 0.0], [50.0, 200.0], [850.0, 800.0]])
    L = np.array([1000.0, 500.0, 2000.0])[:, None]
    fpkm_ref = C * 1e9 / (L * C.sum(axis=0, keepdims=True))
    rpk = C / L
    tpm_ref = rpk * 1e6 / rpk.sum(axis=0, keepdims=True)

    def load(path):
        with open(path) as fh:
            header = fh.readline().rstrip("\n").split("\t")
            rows = [ln.rstrip("\n").split("\t") for ln in fh]
        return header, rows

    header, rows = load(fpkm_p)
    assert header == ["Geneid", "s1", "s2"]
    got = np.array([[float(v) for v in r[1:]] for r in rows])
    np.testing.assert_allclose(got, fpkm_ref, rtol=1e-5)
    _, rows = load(tpm_p)
    got = np.array([[float(v) for v in r[1:]] for r in rows])
    np.testing.assert_allclose(got, tpm_ref, rtol=1e-5)
    np.testing.assert_allclose(got.sum(axis=0), [1e6, 1e6], rtol=1e-6)
    # byte for byte the reference's tables
    j_fpkm(str(counts), str(tmp_path / "jf.tsv"), str(tmp_path / "jt.tsv"))
    for mine, theirs in ((fpkm_p, "jf.tsv"), (tpm_p, "jt.tsv")):
        assert open(mine, "rb").read() == (tmp_path / theirs).read_bytes()


def test_pipeline_wiring_and_step_range(tmp_path):
    from janusx_tpu.pipeline.executor import PipelineOptions as JOptions
    from janusx_tpu.pipeline.fastq2count import Fastq2CountConfig as JCfg
    from janusx_tpu.pipeline.fastq2count import build_pipelines as j_build

    kw = dict(ref_fasta="ref.fa", annotation="ann.gtf", workdir=str(tmp_path),
              samples=[{"id": "s1", "fq1": "s1_1.fq", "fq2": "s1_2.fq"},
                       {"id": "s2", "fq1": "s2_1.fq", "fq2": "s2_2.fq"}],
              strandness="RF")
    cfg = Fastq2CountConfig(**kw, options=PipelineOptions(dry_run=True))
    stages = build_pipelines(cfg)
    assert [no for no, _ in stages] == [1, 2, 3, 4]
    clean, index, align, count = (p for _, p in stages)
    assert len(clean.items) == 2 and len(index.items) == 1
    assert len(align.items) == 2 and len(count.items) == 1
    c_align = align.steps[0].command(cfg.samples[0])
    assert "hisat2 " in c_align and "--rna-strandness RF" in c_align
    assert "samtools sort" in c_align and "samtools index" in c_align
    c_count = count.steps[0].command({"id": "cohort"})
    assert "featureCounts" in c_count and "-t exon" in c_count
    assert "s1.bam" in c_count and "s2.bam" in c_count
    # the FPKM/TPM stage runs the port's module
    assert "-m janusx_tpu_torch.pipeline.fastq2count " in c_count
    c_index = index.steps[0].command({"id": "cohort"})
    assert "hisat2-build" in c_index and "reference.index.ok" in c_index
    # every command the reference's, but where the count step names its module
    theirs = j_build(JCfg(**kw, options=JOptions(dry_run=True)))
    for (_, a), (_, b) in zip(stages, theirs):
        item = a.items[0]
        assert [s.command(item) for s in a.steps] == [
            s.command(item).replace("-m janusx_tpu.pipeline", "-m janusx_tpu_torch.pipeline")
            for s in b.steps]
    reports = run(cfg, from_step=2, to_step=3)
    assert set(reports) == {"index", "align"}


def test_cli_dry_run(tmp_path):
    fq = tmp_path / "fq"
    fq.mkdir()
    (fq / "s1_1.fq.gz").write_text("x")
    (fq / "s1_2.fq.gz").write_text("x")
    for name, main in (("ref", j_jx), ("port", t_jx)):
        assert main(["fastq2count", "-i", str(fq), "-r", "ref.fa", "-a", "ann.gtf",
                     "-w", str(tmp_path / name), "-dry-run"]) == 0
        assert main(["fastq2vcf", "-fq", str(fq), "-ref", "ref.fa", "-dry-run",
                     "-o", str(tmp_path / f"v_{name}")]) == 0


# ------------------------------------------------ tests/test_webui.py
@pytest.fixture()
def ui(tmp_path, monkeypatch):
    monkeypatch.setenv("JX_TPU_HISTORY_DB", str(tmp_path / "hist.db"))
    from janusx_tpu_torch.ui.server import serve

    srv, state = serve(str(tmp_path), port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", state, tmp_path
    srv.shutdown()


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def _post(url: str, data: dict, state=None):
    if state is not None:
        data = {**data, "csrf": state.csrf}
    req = urllib.request.Request(url, data=urllib.parse.urlencode(data).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.read().decode()


def _wait_job(base: str, timeout_s: float = 120.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        jobs = json.loads(_get(base + "/api/jobs")[1])
        if jobs and jobs[0]["status"] != "running":
            return jobs
        time.sleep(0.5)
    raise AssertionError("the web UI job did not end")


def test_dashboard_and_history(ui):
    base, state, tmp = ui
    from janusx_tpu_torch.utils import history

    out = tmp / "res.tsv"
    out.write_text("chrom\tpos\tpwald\n1\t100\t0.5\n")
    history.record_run("gwas", str(tmp / "jx"), {"models": ["lmm"]}, [str(out)], 1.5)
    code, body = _get(base + "/")
    assert code == 200 and "gwas" in body and "Run history" in body
    runs = json.loads(_get(base + "/api/runs")[1])
    assert len(runs) == 1 and runs[0][2] == "gwas"
    code, body = _get(f"{base}/run/{runs[0][0]}")
    assert code == 200 and "res.tsv" in body and "pwald" in body


def test_job_submit_and_cancel(ui):
    base, state, tmp = ui
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/submit", {"module": "sim", "args": "-o x"})
    assert e.value.code == 403
    code, _ = _post(base + "/submit", {"module": "sim", "args": "-nind 30 -nsnp 50 -o simout"},
                    state=state)
    assert code == 200
    jobs = _wait_job(base)
    assert jobs[0]["status"] == "ok", jobs
    code, body = _get(f"{base}/job/{jobs[0]['id']}")
    assert ".bed" in body or "sim" in body
    assert os.path.exists(tmp / "simout")


def test_submit_rejects_unknown_module(ui):
    base, state, _ = ui
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/submit", {"module": "rm_rf", "args": "-x"}, state=state)
    assert e.value.code == 400


def test_file_access_restricted(ui):
    base, _, tmp = ui
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + f"/file?p={urllib.parse.quote('/etc/hostname')}")
    assert e.value.code == 403
    ok = tmp / "ok.txt"
    ok.write_text("fine")
    code, body = _get(base + f"/file?p={urllib.parse.quote(str(ok))}")
    assert code == 200 and body == "fine"


def test_render_sigsites_and_upload(ui):
    base, state, tmp = ui
    from janusx_tpu_torch.utils import history

    tsv = tmp / "x.trait0.LM.assoc.tsv"
    rows = ["chrom\tpos\tsnp\taf\tbeta\tse\tpwald"]
    for i in range(50):
        p = 1e-8 if i == 7 else 0.3 + i * 0.01
        rows.append(f"1\t{100 + i}\ts{i}\t0.3\t0.1\t0.05\t{p}")
    tsv.write_text("\n".join(rows) + "\n")
    history.record_run("gwas", str(tmp / "x"), {}, [str(tsv)], 1.0)
    run_id = json.loads(_get(base + "/api/runs")[1])[0][0]
    code, body = _post(f"{base}/run/{run_id}/render", {}, state=state)
    assert code == 200 and "manhattan" in body
    assert os.path.exists(tmp / "x.trait0.LM.ui.manhattan.png")
    assert os.path.exists(tmp / "x.trait0.LM.ui.qq.png")
    code, body = _get(f"{base}/run/{run_id}/sigsites")
    assert code == 200 and "s7" in body and "1 sites" in body
    code, body = _get(f"{base}/run/{run_id}/sigsites?thr=0.5")
    assert "s7" in body and "20 sites" in body
    content = "\n".join(rows) + "\n"
    code, body = _post(base + "/upload", {"name": "pasted", "content": content}, state=state)
    assert code == 200 and ("lambda" in body.lower() or "λ" in body)
    assert os.path.exists(tmp / "uploads" / "pasted.assoc.tsv")
    assert os.path.exists(tmp / "uploads" / "pasted.ui.manhattan.png")
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/upload", {"name": "bad", "content": "not a tsv"}, state=state)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/upload", {"name": "x", "content": content})
    assert e.value.code == 403


def test_webui_job_runs_the_port(ui, monkeypatch):
    """The job's child imports a ``jax`` that raises: the port's dispatcher
    never imports it, the reference's package does at its first line."""
    base, state, tmp = ui
    shim = tmp / "shim" / "jax"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text("raise ImportError('jax is not installed here')\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp / "shim"))
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")
    code, _ = _post(base + "/submit", {"module": "sim", "args": "-nind 30 -nsnp 50 -o simout"},
                    state=state)
    assert code == 200
    jobs = _wait_job(base)
    job = state.jobs[jobs[0]["id"]]
    assert jobs[0]["status"] == "ok", job.log_tail()
    assert job.proc.args[1:3] == ["-m", "janusx_tpu_torch.cli.main"]
    assert (tmp / "simout" / "sim.bed").exists()


# ------------------------------------------------ tests/test_baseline_cpu.py
@pytest.fixture(scope="module")
def problem():
    from janusx_tpu_torch.core.spectral import eigh_grm

    load_native_locked(j_baseline, baseline_cpu)
    rng = np.random.default_rng(17)
    m, n = 200, 120
    G = rng.binomial(2, 0.3, size=(m, n)).astype(np.int8)
    Gc = G.astype(np.float64) - G.mean(axis=1, keepdims=True)
    basis = eigh_grm(Gc.T @ Gc / m, diag_ridge=1e-6)
    y = rng.normal(size=n) + Gc[11] * 0.5
    return basis, y, G, Gc


def test_baseline_builds(problem):
    assert baseline_cpu.available(), "g++ build of jxbaseline.cpp failed"


def test_baseline_matches_production_brent_scan(problem):
    from janusx_tpu_torch.core import stats
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes
    from janusx_tpu_torch.models.lmm import lmm_scan

    basis, y, G, Gc = problem
    m, n = Gc.shape
    lg, beta, se = baseline_cpu.baseline_scan(basis, y, Gc)
    assert np.isfinite(beta).all() and np.isfinite(se).all()
    # the reference's copy on the same inputs, value for value
    rlg, rbeta, rse = j_baseline.baseline_scan(basis, y, Gc)
    np.testing.assert_array_equal(beta, rbeta)
    np.testing.assert_array_equal(se, rse)
    sites = SiteInfo(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1, dtype=np.int64),
                     snp=np.array([f"s{i}" for i in range(m)], object),
                     allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    pg = pack_genotypes(GenotypeData(G, sites, np.array([f"i{j}" for j in range(n)], object)),
                        QcParams(maf=0.0, geno=1.0))
    res, _ = lmm_scan(pg, basis, y, method="brent", device="cpu")
    np.testing.assert_allclose(beta, res.beta, rtol=2e-2, atol=1e-8)
    np.testing.assert_allclose(se, res.se, rtol=2e-2, atol=1e-8)
    p_base = stats.pwald_from_beta_se(beta, se)
    assert np.nanmax(np.abs(np.log10(p_base) - np.log10(res.pwald))) < 5e-2


def test_baseline_thread_invariance(problem):
    basis, y, _, Gc = problem
    _, b1, s1 = baseline_cpu.baseline_scan(basis, y, Gc, n_threads=1)
    _, b4, s4 = baseline_cpu.baseline_scan(basis, y, Gc, n_threads=4)
    np.testing.assert_allclose(b4, b1, rtol=2e-3, atol=1e-10)
    np.testing.assert_allclose(s4, s1, rtol=2e-3, atol=1e-10)


# ------------------------------------------------ logreg (tests/test_garfield_algwas.py)
def test_logistic_fit_matches_statsmodels_style():
    import scipy.optimize

    from janusx_tpu.models.logreg import logistic_fit as j_fit
    from janusx_tpu_torch.models.logreg import logistic_fit

    rng = np.random.default_rng(3)
    n = 500
    x = rng.normal(size=(n, 2))
    eta = 0.5 + 1.2 * x[:, 0] - 0.7 * x[:, 1]
    y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(float)
    X = np.concatenate([np.ones((n, 1)), x], axis=1)
    beta, se, ll, conv = logistic_fit(X, y)
    assert conv
    assert beta[1] == pytest.approx(1.2, abs=0.35)
    assert beta[2] == pytest.approx(-0.7, abs=0.3)

    def nll(b):
        e = np.clip(X @ b, -30, 30)
        return -(y @ e - np.log1p(np.exp(e)).sum())

    ref = scipy.optimize.minimize(nll, np.zeros(3), method="BFGS").x
    np.testing.assert_allclose(beta, ref, atol=1e-4)
    jb, jse, jll, _ = j_fit(X, y)
    np.testing.assert_array_equal(beta, jb)
    np.testing.assert_array_equal(se, jse)


def test_fit_best_and_not_binary():
    from janusx_tpu.models.logreg import fit_best_and_not as j_fit
    from janusx_tpu_torch.models.logreg import fit_best_and_not

    rng = np.random.default_rng(8)
    m, n = 30, 600
    X = (rng.random((m, n)) < 0.4).astype(np.uint8)
    y = ((X[4] & (1 - X[9])).astype(bool) | (rng.random(n) < 0.03)).astype(float)
    fit = fit_best_and_not(X, y, response="binary", score="loglik")
    lits = set(fit.literals)
    assert (4, False) in lits and (9, True) in lits, fit.literals
    assert "x4" in fit.expression and "!x9" in fit.expression
    assert fit.expression == j_fit(X, y, response="binary", score="loglik").expression


def test_fit_best_and_not_continuous():
    from janusx_tpu_torch.models.logreg import fit_best_and_not

    rng = np.random.default_rng(9)
    m, n = 20, 500
    X = (rng.random((m, n)) < 0.5).astype(np.uint8)
    y = 3.0 * (X[2] & X[11]) + rng.normal(size=n) * 0.3
    fit = fit_best_and_not(X, y, response="continuous", score="mse")
    assert {(2, False), (11, False)} <= set(fit.literals)


# ------------------------------------------------ BSA (tests/test_longtail.py)
def test_bsa_analysis(rng):
    from janusx_tpu_torch.models.bsa import bsa_analysis

    m, depth = 500, 40
    chrom = np.array(["1"] * m)
    pos = np.arange(1, m + 1) * 10_000
    p2 = np.full(m, 0.5)
    p2[200:300] = 0.9
    alt1 = rng.binomial(depth, np.full(m, 0.5))
    alt2 = rng.binomial(depth, p2)
    res = bsa_analysis(chrom, pos, alt1, depth - alt1, alt2, depth - alt2, window_bp=500_000)
    assert np.nanmean(np.abs(res.delta[200:300])) > np.nanmean(np.abs(res.delta[:150]))
    assert np.nanmean(res.delta[200:300]) > 0.2
    assert 150 <= np.nanargmax(res.g_prime) <= 350


def test_bsa_filter_chain():
    from janusx_tpu_torch.models.bsa import ed_statistic, filter_bulk_depths

    dp1 = np.array([20.0, 5, 20, 20, 20, 20, 30])
    dp2 = np.array([20.0, 20, 20, 400, 20, 20, 30])
    ad1 = np.array([2.0, 10, 10, 10, 1, 19, 27])
    ad2 = np.array([18.0, 10, 10, 200, 1, 19, 3])
    gq1 = np.array([99.0, 99, 50, 99, 99, 99, 99])
    gq2 = np.full(7, 99.0)
    fr = filter_bulk_depths(dp1, ad1, dp2, ad2, gq1, gq2)
    np.testing.assert_array_equal(fr.keep, [True, False, False, False, False, False, True])
    stages = {label: (b, a) for label, b, a in fr.stages}
    assert stages["bulk1.DP>=minDP(15)"] == (7, 6)
    assert stages["bulk1.GQ>=minGQ(90)"] == (6, 5)
    assert stages["totalDP<=max(300)"][1] == 4
    assert stages["refAlleleFreq(0.2)"][1] == 2
    ed = ed_statistic(np.array([0.1, 0.5]), np.array([0.9, 0.5]))
    np.testing.assert_allclose(ed, [np.sqrt(2) * 0.8, 0.0], atol=1e-12)


def test_bsa_windows(rng):
    from janusx_tpu_torch.models.bsa import bsa_analysis, bsa_windows

    m, depth = 400, 40
    chrom = np.array(["1"] * m)
    pos = np.arange(1, m + 1) * 10_000
    alt1 = rng.binomial(depth, 0.5, m)
    alt2 = rng.binomial(depth, 0.5, m)
    res = bsa_analysis(chrom, pos, alt1, depth - alt1, alt2, depth - alt2,
                       window_bp=200_000, gprime=False)
    win = bsa_windows(res, window_bp=200_000, step_bp=100_000, ed_power=4)
    assert len(win.center) > 10
    assert win.center[0] == pos[0] + 100_000
    assert (win.n_snps >= max(5, int(200_000 * 1e-4))).all()
    k = len(win.center) // 2
    c = win.center[k]
    sel = (pos >= c - 100_000) & (pos <= c + 100_000)
    assert win.n_snps[k] == sel.sum()
    np.testing.assert_allclose(win.delta[k], np.nanmean(res.delta[sel]), rtol=1e-12)
    np.testing.assert_allclose(win.ed_power[k], np.nanmean(np.asarray(res.ed)[sel] ** 4),
                               rtol=1e-12)
    d = np.abs(pos[sel] - c) / 100_000.0
    w = (1 - np.minimum(d, 1.0) ** 3) ** 3
    np.testing.assert_allclose(win.g_prime[k], np.sum(w * res.g_stat[sel]) / w.sum(),
                               rtol=1e-10)
    short = bsa_analysis(chrom[:5], pos[:5], alt1[:5], depth - alt1[:5], alt2[:5],
                         depth - alt2[:5], gprime=False)
    assert len(bsa_windows(short, window_bp=200_000).center) == 0


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))
            if not f.endswith((".log", ".png", ".pdf", ".svg"))}


def _both(tmp_path, steps):
    """Each (argv, prefix flag) of ``steps`` through each dispatcher in turn,
    outputs under tmp_path/ref and tmp_path/port; returns each side's files
    but the plots, and each side's plot names."""
    got = {}
    for name, main in (("ref", j_jx), ("port", t_jx)):
        d = tmp_path / name
        for argv in steps:
            with redirect_stdout(io.StringIO()):
                assert main(argv + ["-o", str(d)]) == 0, (name, argv[0])
        got[name] = _files(d), sorted(f for f in os.listdir(d) if f.endswith(".png"))
    return got["ref"], got["port"]


def test_bsa_prefix_mode_cli(rng, tmp_path):
    """Caller tables with {bulk}.DP/.AD/.GQ columns through ``jx bsa
    -b1/-b2`` and ``jx postbsa -b1/-b2`` of both dispatchers."""
    import pandas as pd

    m, depth = 6000, 40
    p2 = np.full(m, 0.5)
    p2[250:300] = 1.0
    alt1 = rng.binomial(depth, 0.5, m)
    alt2 = rng.binomial(depth, p2)
    df = pd.DataFrame({
        "CHROM": ["1"] * m, "POS": np.arange(1, m + 1) * 10_000,
        "Bulk1.DP": depth, "Bulk1.GQ": 99, "Bulk1.AD": [f"{depth - a},{a}" for a in alt1],
        "Bulk2.DP": depth, "Bulk2.GQ": 99, "Bulk2.AD": [f"{depth - a},{a}" for a in alt2]})
    df.loc[0, "Bulk1.DP"] = 5
    df.loc[1, "Bulk2.GQ"] = 10
    half = m // 2
    df.iloc[:half].to_csv(tmp_path / "part1.tsv", sep="\t", index=False)
    df.iloc[half:].to_csv(tmp_path / "part2.tsv", sep="\t", index=False)
    bulks = ["-b1", "Bulk1", "-b2", "Bulk2"]
    (ref, ref_png), (port, png) = _both(tmp_path, [
        ["bsa", "-i", str(tmp_path / "part1.tsv"), *bulks, "-p", "pm", "-win", "500000"],
        ["postbsa", "-i", str(tmp_path / "part*.tsv"), *bulks, "-prefix", "pb",
         "-win", "500000", "-ci", "95", "-ci", "99"]])
    assert port == ref and png == ref_png == ["pb.snpindex.png", "pb.stats.png"]
    out = tmp_path / "port"
    per_snp = pd.read_csv(out / "pm.bsa.tsv", sep="\t")
    assert "ED" in per_snp.columns and len(per_snp) == half - 2
    raw = pd.read_csv(out / "pb.raw.tsv", sep="\t")
    assert len(raw) == m - 2
    dname = "Delta.SNPindex(Bulk2-Bulk1)"
    for col in ("Bulk1.SNPindex", "Bulk2.SNPindex", dname, "ED", "G"):
        assert col in raw.columns
    smooth = pd.read_csv(out / "pb.smooth.tsv", sep="\t")
    assert {"n_snps", "ED_power", "Gprime"} <= set(smooth.columns)
    assert 2_300_000 <= smooth.loc[smooth[dname].idxmax(), "pos"] <= 3_200_000
    thr = pd.read_csv(out / "pb.thr.tsv", sep="\t")
    assert len(thr) > 0
    assert thr.loc[thr["deltaSNPindex"].idxmax()]["direction"] == "upper"
    assert ((thr["start"] + thr["end"]) / 2).between(2_000_000, 3_500_000).all()


def test_postbsa_cli(rng, tmp_path):
    """A depth table through ``jx bsa`` and ``jx postbsa`` of both
    dispatchers."""
    import pandas as pd

    m, depth = 600, 40
    p2 = np.full(m, 0.5)
    p2[250:350] = 0.95
    df = pd.DataFrame({
        "chrom": ["1"] * (m // 2) + ["2"] * (m - m // 2),
        "pos": np.concatenate([np.arange(1, m // 2 + 1), np.arange(1, m - m // 2 + 1)]) * 10_000,
        "alt1": rng.binomial(depth, 0.5, m), "ref1": 0, "alt2": rng.binomial(depth, p2),
        "ref2": 0})
    df["ref1"] = depth - df["alt1"]
    df["ref2"] = depth - df["alt2"]
    dp = tmp_path / "depths.tsv"
    df.to_csv(dp, sep="\t", index=False)
    bsa_tsv = str(tmp_path / "{side}" / "x.bsa.tsv")
    got = {}
    for side, main in (("ref", j_jx), ("port", t_jx)):
        d = tmp_path / side
        assert main(["bsa", "-i", str(dp), "-o", str(d), "-p", "x", "-win", "500000"]) == 0
        assert main(["postbsa", "-i", bsa_tsv.format(side=side), "-d", str(dp), "-o", str(d),
                     "-prefix", "x", "-win", "500000", "-sims", "2000"]) == 0
        got[side] = _files(d)
    assert got["port"] == got["ref"] and {"x.bsa.tsv", "x.postbsa.tsv"} <= set(got["port"])
    out = pd.read_csv(tmp_path / "port" / "x.postbsa.tsv", sep="\t")
    for col in ("delta_ci_hi", "delta_smoothed", "gprime_p", "gprime_q", "sig_delta",
                "sig_gprime"):
        assert col in out.columns
    assert (out["gprime_p"] >= 0).all() and (out["gprime_p"] <= 1).all()
    c1 = out[out["chrom"] == 1]
    sig_pos = c1.loc[c1["sig_gprime"], "pos"]
    assert len(sig_pos) > 0
    assert sig_pos.between(2_300_000, 3_700_000).mean() > 0.8
    assert (tmp_path / "port" / "x.bsa.png").exists()
