"""Entry ``lowrank_scan``: the per-trait work of ``jx gwas -lowrank``
(FaST-LMM's low-rank kinship, genetic model ``add``) on samples that are
all phenotyped, with the calls the port's workflow makes.

Set-up (the command's, not the trait's): the low-rank kinship basis from
the configuration's q evenly spaced SNPs
(``models.fastlmm.lowrank_basis_from_snps``: the economy SVD on the host
in float64). A step of one trait is ``make_rotated_lr``, then
``lowrank_switch_p`` (the null fit, which the scan reuses; the switch's p
is not acted on, as under ``-force-model``), then ``fastlmm_scan`` over
every SNP that passes QC: K1 at N = k, the torch lattice, beta, se and p
on the host. No n x n kinship, no eigh of one, no K2.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import State, span
from portbench.panel import generate, program_input
from portbench.traits import TraitStream


def setup(ctx) -> State:
    import torch

    from janusx_tpu_torch import config as jcfg
    from janusx_tpu_torch.models.fastlmm import lowrank_basis_from_snps

    cfg, tr = ctx.config, ctx.traffic
    if cfg["n_phenotyped"] != cfg["n_samples"]:
        raise ValueError("lowrank_scan: every sample must be phenotyped")
    if tr["traits_per_step"] != 1:
        raise ValueError("lowrank_scan scans one trait a step")
    panel = generate(cfg, ctx.seed, ctx.device, {"scan": "all"},
                     tr["phenotype"]["background_scores"])
    jcfg.set_full_f32_matmul()
    pg = program_input(panel, "scan")
    lrb = lowrank_basis_from_snps(pg, q=cfg["lowrank_snps"], method=cfg["grm_method"],
                                  ridge=cfg["eigh_ridge"])
    state = State(ctx=ctx, panel=panel,
                  traits=TraitStream(tr["phenotype"], panel, "scan", ctx.seed),
                  shape={"m": pg.m, "n": pg.n, "T": 1, "G": tr["scan"]["grid_points"],
                         "p": 1, "N": lrb.k},
                  program={"pg": pg, "lrb": lrb})
    for w in range(tr["warmup_steps"]):
        step(state, state.traits.warmup(w, 1), {})
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    return state


def step(state: State, Y: np.ndarray, spans: dict) -> list[dict]:
    from janusx_tpu_torch.models.fastlmm import (fastlmm_scan, lowrank_switch_p,
                                                 make_rotated_lr)

    pg, lrb = state.program["pg"], state.program["lrb"]
    scan, y = state.ctx.traffic["scan"], Y[:, 0]
    with span("make_rotated_lr"):
        rot = make_rotated_lr(lrb, y, None)
    with span("lowrank_switch_p"):
        _, null = lowrank_switch_p(rot)
    with span("fastlmm_scan"):
        res, null = fastlmm_scan(pg, lrb, y, rot=rot, null=null,
                                 grid_points=scan["grid_points"],
                                 model=scan["genetic_model"], device=state.ctx.device)
    return [dict(beta=res.beta, se=res.se, p=res.pwald, lam=null.lbd)]


def reference(state: State, sample: list, prec: str = "ref") -> list[dict]:
    from portbench.reference.lowrank import LowRankLmm

    ctx, panel = state.ctx, state.panel
    ref = LowRankLmm(panel.raw, panel.n, panel.phenotyped, ctx.config, ctx.traffic["scan"],
                     ctx.device, prec=prec)
    return ref.run([state.traits.trait(i) for i in sample])
