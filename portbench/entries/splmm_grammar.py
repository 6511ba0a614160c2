"""Entry ``splmm_grammar``: the per-trait work of ``jx gwas -splmm``, the
GRAMMAR-gamma scan with a thresholded sparse GRM, on samples that are all
phenotyped.

Set-up (the command's): the band-streamed sparse GRM
(``models.splmm.build_sparse_grm``) at the configuration's cutoff. A step
is ``models.splmm.splmm_grammar_scan`` over every SNP that passes QC, to
beta, se and p on the host: the host's sparse null fit and γ calibration,
the LM grams on the card and the host's p-values.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import State, span
from portbench.panel import generate, program_input
from portbench.traits import TraitStream


def setup(ctx) -> State:
    import torch

    from janusx_tpu_torch import config as jcfg
    from janusx_tpu_torch.models.splmm import build_sparse_grm

    cfg, tr = ctx.config, ctx.traffic
    if cfg["n_phenotyped"] != cfg["n_samples"]:
        raise ValueError("splmm_grammar: every sample must be phenotyped")
    panel = generate(cfg, ctx.seed, ctx.device, {"scan": "all"},
                     tr["phenotype"]["background_scores"])
    jcfg.set_full_f32_matmul()
    pg = program_input(panel, "scan")
    Ks = build_sparse_grm(pg, cutoff=cfg["sparse_cutoff"], method=cfg["grm_method"],
                          device=ctx.device)
    T = tr["traits_per_step"]
    if T != 1:
        raise ValueError("splmm_grammar scans one trait a step")
    state = State(ctx=ctx, panel=panel,
                  traits=TraitStream(tr["phenotype"], panel, "scan", ctx.seed),
                  shape={"m": pg.m, "n": pg.n, "T": 1, "p": 1},
                  program={"pg": pg, "Ks": Ks})
    for w in range(tr["warmup_steps"]):
        step(state, state.traits.warmup(w, 1), {})
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    return state


def step(state: State, Y: np.ndarray, spans: dict) -> list[dict]:
    from janusx_tpu_torch.models.splmm import splmm_grammar_scan

    with span("splmm_grammar_scan"):
        res, info = splmm_grammar_scan(state.program["pg"], state.program["Ks"], Y[:, 0],
                                       cutoff=state.ctx.config["sparse_cutoff"],
                                       seed=state.ctx.traffic["scan"]["gamma_seed"],
                                       device=state.ctx.device)
    return [dict(beta=res.beta, se=res.se, p=res.pwald, lam=info["lambda_null"],
                 gamma=info["gamma"])]


def reference(state: State, sample: list, prec: str = "ref") -> list[dict]:
    from portbench.reference.splmm import SparseGrammar

    ctx, panel = state.ctx, state.panel
    ref = SparseGrammar(panel.raw, panel.n, ctx.config, ctx.traffic["scan"], ctx.device,
                        prec=prec)
    return ref.run([state.traits.trait(i) for i in sample])
