"""``-farmcpu`` (janusx_tpu_torch.models.farmcpu) against the benchmark's
plain reference (portbench/reference/farmcpu.py), on the CPU, through the
call of the benchmark's entry (portbench/entries/farmcpu.py): the program
input at the sites of the configuration's genome map, then
``farmcpu_scan`` with ``jx gwas``'s defaults.

Panels are seeded draws of portbench.panel: sibships of 5, 2 % missing,
400 samples over 3,000 SNPs on five chromosomes of 10 kb spacing (so the
50 Mb window holds one bin a chromosome, fewer bins than most lead counts)
and 360 samples over 2,400 SNPs on three chromosomes of 25 kb spacing;
three traits each of the benchmark's phenotype model.

What must hold: every loop's pseudo-QTN set, the final set and the loop
count equal the reference's exactly (the reference selects from float64
p-values with its own bins, REM minimizer, pruning and joint model); and
over every SNP of the final tables, on the numbers of
portbench.compare.gaps:

- ``invalid_mismatch`` and ``sign_mismatch`` 0: exact comparisons;
- ``se_rel_gap``, ``beta_gap_se`` and ``logp_gap`` <= 1e-5: the program
  forms the scans' grams in float32 (measured <= 6.9e-7, 2.3e-6 and
  2.0e-6 over both panels); the pseudo-QTN rows come from the joint model
  in float64 on both sides (se <= 2.2e-12 apart), held at rel 1e-8.

The reference one precision lower (float32, TF32 products) put in the
program's place fails them (it picks other pseudo-QTNs on two of the first
panel's three traits: se_rel_gap 0.035, logp_gap 1.49); the test asks for
one number past its tolerance.
"""

import numpy as np
import pytest

from janusx_tpu_torch.models.farmcpu import farmcpu_scan
from portbench import compare
from portbench.entries.farmcpu import program_input
from portbench.panel import generate
from portbench.reference.farmcpu import FarmCpu
from portbench.traits import TraitStream

SEED = 2**31 + 2323
BASE = {"family_size": 5, "segment_snps": 2000, "maf_range": [0.05, 0.5],
        "missing_rate": 0.02, "qc": {"maf": 0.02, "geno": 0.05}}
PANELS = {
    "five_chrom": dict(BASE, n_samples=400, n_phenotyped=400, n_snps=3000,
                       genome_map={"n_chrom": 5, "spacing_bp": 10_000}),
    "three_chrom": dict(BASE, n_samples=360, n_phenotyped=360, n_snps=2400,
                        genome_map={"n_chrom": 3, "spacing_bp": 25_000}),
}
SCAN = {"max_loops": 10, "window_sizes": [500_000, 5_000_000, 50_000_000], "nbin": 5,
        "qtn_threshold": 0.01, "p_threshold": None, "qtn_bound": None}
PHENO = {"n_qtl": 20, "h2": [0.2, 0.8], "qtl_share": 0.3, "background_scores": 64,
         "mean": 10.0}
TOL = {"invalid_mismatch": 0.0, "sign_mismatch": 0.0, "se_rel_gap": 1e-5,
       "beta_gap_se": 1e-5, "logp_gap": 1e-5}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("JX_TPU_PLATFORM", "cpu")


def _problem(name):
    cfg = PANELS[name]
    panel = generate(cfg, SEED, "cpu", {"scan": "all"}, PHENO["background_scores"])
    traits = TraitStream(PHENO, panel, "scan", SEED)
    return cfg, panel, program_input(panel, "scan", cfg), [traits.trait(i) for i in range(3)]


def _program(pg, y):
    out = farmcpu_scan(pg, y, None, p_threshold=SCAN["p_threshold"],
                       qtn_threshold=SCAN["qtn_threshold"], max_loops=SCAN["max_loops"],
                       window_sizes=tuple(SCAN["window_sizes"]), qtn_bound=SCAN["qtn_bound"],
                       nbin=SCAN["nbin"])
    r = out.result
    return dict(beta=r.beta, se=r.se, p=r.pwald, lam=1.0, qtns=out.qtns, loops=out.loops,
                loop_sets=out.loop_sets)


@pytest.mark.parametrize("name", sorted(PANELS))
def test_farmcpu_matches_plain_reference(name):
    cfg, panel, pg, Ys = _problem(name)
    prog = [_program(pg, y) for y in Ys]
    ref = FarmCpu(panel.raw, panel.n, cfg, SCAN, "cpu", prec="ref")
    assert ref.m == pg.m
    want = ref.run(Ys)
    for a, b in zip(prog, want):
        assert a["loops"] == b["loops"]
        assert a["loop_sets"] == b["loop_sets"]
        np.testing.assert_array_equal(a["qtns"], b["qtns"])
    assert sum(len(a["qtns"]) for a in prog) > 0
    gaps = compare.gaps(prog, want)
    assert all(gaps[k] <= tol for k, tol in TOL.items()), gaps
    # the pseudo-QTN rows: finite, and the joint model's on both sides
    for a, b in zip(prog, want):
        q = a["qtns"]
        for k in ("beta", "se", "p"):
            assert np.all(np.isfinite(a[k][q]))
            np.testing.assert_allclose(a[k][q], b[k][q], rtol=1e-8)


def test_lower_precision_reference_fails_the_tolerances():
    cfg, panel, pg, Ys = _problem("five_chrom")
    want = FarmCpu(panel.raw, panel.n, cfg, SCAN, "cpu", prec="ref").run(Ys)
    low = FarmCpu(panel.raw, panel.n, cfg, SCAN, "cpu", prec="low").run(Ys)
    gaps = compare.gaps(low, want)
    assert any(gaps[k] > tol for k, tol in TOL.items()), gaps
