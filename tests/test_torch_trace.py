"""The port's spans and counters (janusx_tpu_torch/utils/trace.py) on the CPU.

With no profiler recording, a span is a null context: it enters no
``record_function`` and the profiled table of counts gets nothing. Under
``torch.profiler.profile`` the scans of the benchmark's two cells give
their span trees: ``fit_null`` then ``lmm_scan`` over two streamed
superblocks, and ``splmm_grammar_scan`` on a small sparse GRM. The check
of whether a session records is pinned against the profiler itself.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from janusx_tpu_torch.ops import kernels
from janusx_tpu_torch.utils import trace


@pytest.fixture(scope="module")
def panel():
    """n = 200 samples x ~1,500 SNPs, a polygenic trait, the eigenbasis."""
    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.packed import QcParams, pack_genotypes

    rng = np.random.default_rng(16)
    m, n = 1500, 200
    g = rng.binomial(2, rng.uniform(0.05, 0.5, m)[:, None], size=(m, n)).astype(np.int8)
    site = dict(chrom=np.array(["1"] * m, object), pos=np.arange(1, m + 1),
                snp=np.array([f"rs{i}" for i in range(m)], object),
                allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    pg = pack_genotypes(GenotypeData(g, SiteInfo(**site), np.array(
        [f"i{j}" for j in range(n)], object)), QcParams())
    gc = pg.centered()
    K = gc.T @ gc / pg.m
    y = 1.0 + gc.T @ rng.normal(0, 0.05, pg.m) + rng.normal(size=n)
    return pg, K, eigh_grm(K, diag_ridge=1e-6), y


def _spans(prof) -> list:
    """The jx.* spans of a profile as (name, start, end), in start order."""
    out = [(ev.name()[len(trace.PREFIX):], ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.name().startswith(trace.PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _tree(prof) -> list:
    """Each span as "<parent>/<name>" in start order; the parent is the
    innermost span that encloses it ("" at the top)."""
    spans, out, open_ = _spans(prof), [], []
    for name, a, b in spans:
        while open_ and open_[-1][2] < b:
            open_.pop()
        out.append(f"{open_[-1][0] if open_ else ''}/{name}")
        open_.append((name, a, b))
    return out


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_recording_check_follows_the_profiler():
    """The flag a span checks is torch.profiler's: a span is the shared null
    context before and after a session, a record_function inside one, in
    step with the autograd profiler's own state."""
    def state():
        return (torch._C._autograd._profiler_enabled(),
                isinstance(trace.span("x"), torch.autograd.profiler.record_function))

    assert state() == (False, False)
    assert trace.span("x") is trace.span("y")
    with _profiled():
        assert state() == (True, True)
    assert state() == (False, False)


def test_no_profiler_no_record_function(panel, monkeypatch):
    """Without a profiler a span never builds a record_function, through a
    whole streamed scan, and the profiled table of counts is unchanged."""
    from janusx_tpu_torch.models import lmm

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    pg, _, basis, y = panel
    before = trace.counts(profiled=True)
    with trace.span("anything"):
        trace.count("test.unprofiled")
    null = lmm.fit_null(basis, y, device="cpu")
    lmm.lmm_scan(pg, basis, y, null=null, block=256, superblock=1024, device="cpu")
    assert trace.counts(profiled=True) == before


def test_count_lands_in_the_profiled_table_only_while_profiled():
    trace.reset("test.")
    trace.count("test.c", 2)
    assert trace.counts()["test.c"] == 2
    assert "test.c" not in trace.counts(profiled=True)
    with _profiled():
        trace.count("test.c", 3)
    trace.count("test.c")
    assert trace.counts()["test.c"] == 6
    assert trace.counts(profiled=True)["test.c"] == 3
    trace.reset("test.")
    assert "test.c" not in trace.counts() and "test.c" not in trace.counts(profiled=True)


def test_uploaded_counts_bytes_off_the_host_only():
    h2d = lambda: trace.counts().get(trace.H2D, 0)
    before = h2d()
    x = torch.zeros(5, dtype=torch.float64)
    assert trace.uploaded(x) is x
    assert h2d() == before  # a copy that stays on the host counts 0
    off = [torch.empty(4, dtype=torch.float32, device="meta"), torch.zeros(3)]
    assert trace.uploaded(off) is off
    assert h2d() == before + 16


def test_launch_counters_read_the_table():
    kernels.reset_launches()
    trace.count("test.other", 1)
    assert set(kernels.launch_counts().values()) == {0}
    trace.count("launch.decode_rotate", 2)
    trace.count("launch.gibbs_sweep_marker")
    assert kernels.launch_counts() == {"decode_rotate": 2, "grid_neg_reml_lattice": 0,
                                       "gibbs_sweep_marker": 1, "gibbs_sweep_block_mvn": 0,
                                       "null_reml_brent": 0, "student_t_p": 0}
    kernels.reset_launches()
    assert set(kernels.launch_counts().values()) == {0}
    assert trace.counts()["test.other"] == 1
    trace.reset("test.")


def test_dense_route_span_tree(panel):
    """fit_null then lmm_scan with its null, as the dense cell's step runs
    them, over two streamed superblocks: the span tree of the route."""
    from janusx_tpu_torch.models import lmm

    pg, _, basis, y = panel
    y = y + 0.5  # a trait the cached rotated states have not seen
    sb = lmm.lattice_superblock(pg.n, 256, 256, 1024)
    assert -(-pg.m // sb) == 2
    with _profiled() as prof:
        null = lmm.fit_null(basis, y, grid_points=256, device="cpu")
        lmm.lmm_scan(pg, basis, y, null=null, block=256, superblock=1024, grid_points=256,
                     device="cpu")
    chunk = ["lmm_scan/feed", "lmm_scan/superblock", "superblock/upload",
             "superblock/kernels", "superblock/to_host", "lmm_scan/results"]
    assert _tree(prof) == (["/fit_null", "fit_null/rotate_y", "fit_null/null_brent",
                            "/lmm_scan"] + chunk + chunk
                           + ["lmm_scan/feed", "lmm_scan/results"])


def test_multi_trait_route_opens_the_same_spans(panel):
    from janusx_tpu_torch.models import lmm

    pg, _, basis, y = panel
    Y = np.stack([y + 1.5, y - 1.5], axis=1)
    with _profiled() as prof:
        lmm.lmm_scan_multi(pg, basis, Y, block=256, superblock=1 << 20, device="cpu")
    assert _tree(prof) == ["/lmm_scan", "lmm_scan/rotate_y", "lmm_scan/rotate_y",
                           "lmm_scan/null_brent", "lmm_scan/null_brent",
                           "lmm_scan/superblock", "superblock/upload", "superblock/kernels",
                           "superblock/to_host", "lmm_scan/results"]


def test_sparse_route_span_tree(panel):
    """splmm_grammar_scan on a thresholded GRM in one resident chunk."""
    from janusx_tpu_torch.models.splmm import sparsify_grm, splmm_grammar_scan

    pg, K, _, y = panel
    Ks = sparsify_grm(K, 0.05)
    with _profiled() as prof:
        splmm_grammar_scan(pg, Ks, y, device="cpu")
    assert _tree(prof) == ["/splmm_grammar_scan", "splmm_grammar_scan/sparse_null",
                           "sparse_null/block_spectral", "splmm_grammar_scan/gamma",
                           "splmm_grammar_scan/superblock", "superblock/upload",
                           "superblock/kernels", "superblock/to_host",
                           "splmm_grammar_scan/host_p"]


def test_gwas_stage_timer_opens_a_span():
    """workflows.gwas._timed: the run summary's stage seconds as before,
    and under a profiler the span of the stage's key."""
    from janusx_tpu_torch.workflows import gwas

    stages = {"qc": 1.0}
    with _profiled() as prof:
        with gwas._timed(stages, "qc", "QC/pack"):
            time.sleep(0.002)
    assert stages["qc"] >= 1.002
    assert _tree(prof) == ["/qc"]
