"""``-lowrank`` (janusx_tpu_torch.models.fastlmm) against the benchmark's
plain reference (portbench/reference/lowrank.py), on the CPU, through the
calls of the benchmark's entry (portbench/entries/lowrank_scan.py):
``make_rotated_lr``, ``lowrank_switch_p``, ``fastlmm_scan(rot=, null=)``.

The panel is a seeded draw of portbench.panel: 400 samples in sibships
of 5 x 3,000 SNPs, 2 % missing, a kinship of q = 256 SNPs; three traits
of the benchmark's phenotype model, with no covariate or two.

Tolerances, on the numbers of portbench.compare.gaps over every SNP of
the three traits:

- ``invalid_mismatch`` and ``sign_mismatch`` 0: which SNPs are valid, and
  beta's sign where the reference puts beta 0.01 se or more from 0, are
  exact comparisons;
- ``lambda_log10_gap`` <= 1e-5: both null fits are host float64; the
  program's bounded Brent stops at an x tolerance of 1e-6
  (config.NULL_BRENT_TOL), the reference's at 1e-11 (measured <= 1.6e-7);
- ``se_rel_gap`` <= 3e-5, ``beta_gap_se`` <= 1e-4, ``logp_gap`` <= 1e-4:
  the program forms the rotation (K1's plain version here), the lattice's
  grams and the final grams in float32, so each SNP's λ* moves a little
  within its grid cell (measured <= 3.9e-6, 1.7e-5 and 1.9e-5 over two
  panels and both covariate sets; before the lattice scaled y's side per
  grid point, 6.1e-5, 2.3e-4 and 3.1e-4).

The reference one precision lower (float32, TF32 products) put in the
program's place fails all four (it read >= 3.5e-4 in λ, 7.1e-4 in se,
4.6e-3 in beta and 7.0e-3 in log10 p); the test asks for one. Under
``torch.profiler`` the calls open the route's spans,
``lowrank.superblocks`` counts the superblocks streamed, and the per-trait
operands of the grid and the constants count under ``h2d_bytes``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from janusx_tpu_torch.models import fastlmm
from janusx_tpu_torch.models.lmm import lattice_superblock
from janusx_tpu_torch.utils import trace
from portbench import compare
from portbench.panel import generate, program_input
from portbench.reference.lowrank import LowRankLmm
from portbench.traits import TraitStream

SEED = 2**31 + 1919
CFG = {"n_samples": 400, "n_phenotyped": 400, "n_snps": 3000, "family_size": 5,
       "segment_snps": 2000, "maf_range": [0.05, 0.5], "missing_rate": 0.02,
       "qc": {"maf": 0.02, "geno": 0.05}, "grm_method": 1, "lowrank_snps": 256,
       "eigh_ridge": 1e-6}
SCAN = {"grid_points": 256, "log10_lambda": [-5.0, 5.0], "gram_ridge": 1e-6,
        "genetic_model": "add"}
PHENO = {"n_qtl": 20, "h2": [0.2, 0.8], "qtl_share": 0.3, "background_scores": 64,
         "mean": 10.0}
TOL = {"invalid_mismatch": 0.0, "sign_mismatch": 0.0, "lambda_log10_gap": 1e-5,
       "se_rel_gap": 3e-5, "beta_gap_se": 1e-4, "logp_gap": 1e-4}


@pytest.fixture(scope="module")
def problem():
    panel = generate(CFG, SEED, "cpu", {"scan": "all"}, PHENO["background_scores"])
    pg = program_input(panel, "scan")
    lrb = fastlmm.lowrank_basis_from_snps(pg, q=CFG["lowrank_snps"],
                                          method=CFG["grm_method"], ridge=CFG["eigh_ridge"])
    traits = TraitStream(PHENO, panel, "scan", SEED)
    return panel, pg, lrb, [traits.trait(i) for i in range(3)]


def _covariates(ncov: int, n: int):
    return np.random.default_rng(ncov).normal(size=(n, ncov)) if ncov else None


def _program(pg, lrb, y, cov, **kw):
    """The entry's calls: the rotated design, the null fit with the switch
    test, the scan with both."""
    rot = fastlmm.make_rotated_lr(lrb, y, cov)
    _, null = fastlmm.lowrank_switch_p(rot)
    res, null = fastlmm.fastlmm_scan(pg, lrb, y, cov, rot=rot, null=null,
                                     grid_points=SCAN["grid_points"],
                                     model=SCAN["genetic_model"], device="cpu", **kw)
    return dict(beta=res.beta, se=res.se, p=res.pwald, lam=null.lbd)


@pytest.mark.parametrize("ncov", [0, 2])
def test_lowrank_scan_matches_plain_reference(problem, ncov):
    panel, pg, lrb, Ys = problem
    cov = _covariates(ncov, pg.n)
    prog = [_program(pg, lrb, y, cov) for y in Ys]
    ref = LowRankLmm(panel.raw, panel.n, panel.phenotyped, CFG, SCAN, "cpu", prec="ref")
    assert ref.k == lrb.k == CFG["lowrank_snps"]
    want = ref.run(Ys, cov)
    gaps = compare.gaps(prog, want)
    assert all(gaps[k] <= tol for k, tol in TOL.items()), gaps
    low = LowRankLmm(panel.raw, panel.n, panel.phenotyped, CFG, SCAN, "cpu",
                     prec="low").run(Ys, cov)
    low_gaps = compare.gaps(low, want)
    assert any(low_gaps[k] > tol for k, tol in TOL.items()), low_gaps


def _tree(prof) -> list:
    """Each jx.* span as "<parent>/<name>" in start order (the parent is
    the innermost span that encloses it, "" at the top)."""
    spans = sorted(((ev.name()[len(trace.PREFIX):], ev.start_ns(),
                     ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name().startswith(trace.PREFIX)), key=lambda s: (s[1], -s[2]))
    out, open_ = [], []
    for name, a, b in spans:
        while open_ and open_[-1][2] < b:
            open_.pop()
        out.append(f"{open_[-1][0] if open_ else ''}/{name}")
        open_.append((name, a, b))
    return out


def test_route_spans_and_superblock_counter(problem):
    """The entry's calls over three streamed superblocks: the spans of the
    host f64 work and of the route, and one count a superblock."""
    _, pg, lrb, Ys = problem
    sb = lattice_superblock(pg.n, SCAN["grid_points"], 512, 1024)
    supers = -(-pg.m // sb)
    assert supers == 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _program(pg, lrb, Ys[0] + 1.0, None, block=512, superblock=1024)
    chunk = ["lowrank_scan/feed", "lowrank_scan/superblock", "superblock/upload",
             "superblock/kernels", "kernels/lr_lattice", "superblock/to_host"]
    assert _tree(prof) == (["/lr_rotate_y", "/lr_null", "lr_null/lr_null", "/lowrank_scan"]
                           + chunk * supers + ["lowrank_scan/feed", "lowrank_scan/results"])
    assert trace.counts(profiled=True).get("lowrank.superblocks", 0) >= supers
    before = trace.counts().get("lowrank.superblocks", 0)
    _program(pg, lrb, Ys[1], None, block=512, superblock=1024)
    assert trace.counts()["lowrank.superblocks"] - before == supers


def test_basis_span_at_set_up(problem):
    _, pg, _, _ = problem
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fastlmm.lowrank_basis_from_snps(pg, q=64)
    assert _tree(prof) == ["/lr_basis"]


def test_per_trait_operands_count_as_uploads(problem):
    """``h2d_bytes`` grows by the bytes of every tensor that
    ``_grid_shared_lr`` and ``_lr_consts`` put on a device (the meta device
    stands in for the card); the basis, which the device cache uploads and
    counts once, is not counted again."""
    _, pg, lrb, Ys = problem
    dev = torch.device("meta")
    rot = fastlmm.make_rotated_lr(lrb, Ys[0], _covariates(2, pg.n))
    grid = np.linspace(-5.0, 5.0, SCAN["grid_points"])
    h2d = lambda: trace.counts().get(trace.H2D, 0)
    before = h2d()
    sh, ysc = fastlmm._grid_shared_lr(rot, grid, dev)
    assert h2d() - before == sum(t.nbytes for t in sh) + ysc.nbytes
    Uk = torch.empty(lrb.U.shape, dtype=torch.float32, device=dev)
    before = h2d()
    cs = fastlmm._lr_consts(rot, Uk, dev)
    want = sum(t.nbytes for t in cs if isinstance(t, torch.Tensor) and t is not Uk)
    assert want > 0 and h2d() - before == want
