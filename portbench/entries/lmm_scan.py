"""Entry ``lmm_scan``: the per-trait work of ``jx gwas -lmm`` on one sample
mask, as the port's workflow runs it.

Set-up (the command's, not the trait's): the GRM of every genotyped sample
(``models.grm.grm_from_packed``) and the eigenbasis of its phenotyped
block (``core.spectral.eigh_grm``). A step of one trait is
``models.lmm.fit_null`` then ``models.lmm.lmm_scan`` with that null over
every SNP that passes QC on the phenotyped samples, to beta, se and p on
the host; a step of T > 1 traits is ``models.lmm.lmm_scan_multi``.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import State, span
from portbench.panel import generate, program_input
from portbench.traits import TraitStream

# the port's lower-precision paths of this route (K2's one bf16 pass, K1's
# bf16x3): the program with them switched on is the cell's control
CONTROL_KNOBS = {"JX_TPU_GRID_MXU_PREC": "default", "JX_TPU_ROTATE_PREC": "high"}


def setup(ctx) -> State:
    import torch

    from janusx_tpu_torch import config as jcfg
    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.models.grm import grm_from_packed

    cfg, tr = ctx.config, ctx.traffic
    panel = generate(cfg, ctx.seed, ctx.device, {"all": "all", "scan": "phenotyped"},
                     tr["phenotype"]["background_scores"])
    jcfg.set_full_f32_matmul()
    pg_all, pg = program_input(panel, "all"), program_input(panel, "scan")
    K = grm_from_packed(pg_all, method=cfg["grm_method"], device=ctx.device)
    keep = panel.phenotyped
    basis = eigh_grm(K[np.ix_(keep, keep)], diag_ridge=cfg["eigh_ridge"])
    T = tr["traits_per_step"]
    state = State(ctx=ctx, panel=panel, traits=TraitStream(tr["phenotype"], panel, "scan",
                                                           ctx.seed),
                  shape={"m": pg.m, "n": pg.n, "T": T, "G": tr["scan"]["grid_points"],
                         "p": 1, "N": basis.n},
                  program={"pg": pg, "basis": basis})
    for w in range(tr["warmup_steps"]):
        step(state, state.traits.warmup(w, T), {})
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    return state


def step(state: State, Y: np.ndarray, spans: dict) -> list[dict]:
    from janusx_tpu_torch.models.lmm import fit_null, lmm_scan, lmm_scan_multi

    pg, basis = state.program["pg"], state.program["basis"]
    G, dev = state.shape["G"], state.ctx.device
    if Y.shape[1] == 1:
        y = Y[:, 0]
        t0 = time.perf_counter()
        with span("fit_null"):
            null = fit_null(basis, y, grid_points=G, device=dev)
        spans.setdefault("fit_null", []).append(time.perf_counter() - t0)
        with span("lmm_scan"):
            res, _ = lmm_scan(pg, basis, y, null=null, grid_points=G, device=dev)
        results, nulls = [res], [null]
    else:
        with span("lmm_scan_multi"):
            results, nulls = lmm_scan_multi(pg, basis, Y, grid_points=G, device=dev)
    return [dict(beta=r.beta, se=r.se, p=r.pwald, lam=nl.lbd) for r, nl in zip(results, nulls)]


def reference(state: State, sample: list, prec: str = "ref") -> list[dict]:
    from portbench.reference.lmm import DenseLmm

    ctx, panel = state.ctx, state.panel
    ref = DenseLmm(panel.raw, panel.n, panel.phenotyped, ctx.config, ctx.traffic["scan"],
                   ctx.device, prec=prec)
    return ref.run([state.traits.trait(i) for i in sample])
