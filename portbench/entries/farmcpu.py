"""Entry ``farmcpu``: the per-trait work of ``jx gwas -farmcpu`` on samples
that are all phenotyped, with the call the port's workflow makes.

Set-up: the panel and its QC, and the program input with the
configuration's genome map (``genome_map``) as its sites; nothing else is
built per command. A step of one trait is ``models.farmcpu.farmcpu_scan``
over every SNP that passes QC, with the arguments ``jx gwas -farmcpu``
passes (the traffic's ``scan``): per loop a full LM scan on the card with
the pseudo-QTNs as covariates, the bins, the REM scores and the pruning on
the host, then the final scan; beta, se and p of every SNP on the host.

FarmCPU fits no null λ, and ``compare.gaps`` reads ``lam`` from every
output: both sides give 1.0, so ``lambda_log10_gap`` reads 0 and the
cell's limits leave it out. The pseudo-QTN set is held through the final
table: a different set changes the design of every SNP's test and puts
``se_rel_gap`` and ``logp_gap`` far past any limit.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import State, span
from portbench.panel import generate
from portbench.reference.farmcpu import site_map
from portbench.traits import TraitStream


def program_input(panel, name: str, cfg: dict):
    """The set's codes as the port's ``PackedGenotypes``, at the sites of
    the configuration's genome map."""
    from janusx_tpu_torch.io.gdata import SiteInfo
    from janusx_tpu_torch.io.packed import PackedGenotypes

    s = panel.sets[name]
    m = s.packed.shape[0]
    rows = np.nonzero(s.keep)[0].astype(np.int64)
    chrom, pos = site_map(rows, cfg["n_snps"], cfg["genome_map"])
    sites = SiteInfo(chrom=chrom.astype(str).astype(object), pos=pos,
                     snp=rows.astype(object), allele0=np.full(m, "A", object),
                     allele1=np.full(m, "G", object))
    return PackedGenotypes(packed=s.packed, n_samples=len(s.samples), sites=sites,
                           samples=np.array([f"s{j}" for j in s.samples], object),
                           af=s.af, miss=s.miss, mean=s.mean)


def setup(ctx) -> State:
    import torch

    from janusx_tpu_torch import config as jcfg

    cfg, tr = ctx.config, ctx.traffic
    if cfg["n_phenotyped"] != cfg["n_samples"]:
        raise ValueError("farmcpu: every sample must be phenotyped")
    if tr["traits_per_step"] != 1:
        raise ValueError("farmcpu scans one trait a step")
    panel = generate(cfg, ctx.seed, ctx.device, {"scan": "all"},
                     tr["phenotype"]["background_scores"])
    jcfg.set_full_f32_matmul()
    pg = program_input(panel, "scan", cfg)
    state = State(ctx=ctx, panel=panel,
                  traits=TraitStream(tr["phenotype"], panel, "scan", ctx.seed),
                  shape={"m": pg.m, "n": pg.n, "T": 1, "p": 1},
                  program={"pg": pg})
    for w in range(tr["warmup_steps"]):
        step(state, state.traits.warmup(w, 1), {})
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    return state


def step(state: State, Y: np.ndarray, spans: dict) -> list[dict]:
    from janusx_tpu_torch import config as jcfg
    from janusx_tpu_torch.models.farmcpu import farmcpu_scan

    sc = state.ctx.traffic["scan"]
    with span("farmcpu_scan"):
        out = farmcpu_scan(state.program["pg"], Y[:, 0], None, block=jcfg.DEFAULT_SNP_BLOCK,
                           p_threshold=sc["p_threshold"], qtn_threshold=sc["qtn_threshold"],
                           max_loops=sc["max_loops"], window_sizes=tuple(sc["window_sizes"]),
                           qtn_bound=sc["qtn_bound"], nbin=sc["nbin"])
    res = out.result
    return [dict(beta=res.beta, se=res.se, p=res.pwald, lam=1.0, qtns=out.qtns,
                 loops=out.loops, loop_sets=out.loop_sets)]


def reference(state: State, sample: list, prec: str = "ref") -> list[dict]:
    from portbench.reference.farmcpu import FarmCpu

    ctx, panel = state.ctx, state.panel
    ref = FarmCpu(panel.raw, panel.n, ctx.config, ctx.traffic["scan"], ctx.device, prec=prec)
    return ref.run([state.traits.trait(i) for i in sample])
