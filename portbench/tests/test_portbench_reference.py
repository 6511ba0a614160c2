"""The plain references against a small CPU run of the port, piece by
piece: the GRM, the sparse GRM's components, the null fits and the scans."""

from __future__ import annotations

import json

import numpy as np
import torch

from portbench import compare
from portbench import manifest as mf
from portbench.panel import generate, program_input
from portbench.traits import TraitStream


def load(name: str, **sizes) -> dict:
    cfg = json.loads((mf.HERE / "configs" / f"{name}.json").read_text())
    cfg.update(sizes)
    return cfg


def traffic(name: str) -> dict:
    return json.loads((mf.HERE / "traffic" / f"{name}.json").read_text())


def test_dense_reference_matches_the_port():
    from janusx_tpu_torch import config as jcfg
    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.models.grm import grm_from_packed
    from janusx_tpu_torch.models.lmm import fit_null, lmm_scan
    from portbench.reference.lmm import DenseLmm

    cfg = load("jxbench-5k-500k", n_samples=160, n_phenotyped=120, n_snps=4000)
    tr = traffic("lmm-scan")
    panel = generate(cfg, 99, "cpu", {"all": "all", "scan": "phenotyped"}, 16)
    jcfg.set_full_f32_matmul()
    K = grm_from_packed(program_input(panel, "all"), device="cpu")
    ref = DenseLmm(panel.raw, panel.n, panel.phenotyped, cfg, tr["scan"], "cpu")
    basis = eigh_grm(K[np.ix_(panel.phenotyped, panel.phenotyped)], diag_ridge=1e-6)
    np.testing.assert_allclose(basis.S, ref.s.numpy(), rtol=1e-5, atol=1e-7)
    pg = program_input(panel, "scan")
    ys = [TraitStream(tr["phenotype"], panel, "scan", 99).trait(i) for i in range(2)]
    prog = []
    for y in ys:
        null = fit_null(basis, y, device="cpu")
        res, _ = lmm_scan(pg, basis, y, null=null, device="cpu")
        prog.append(dict(beta=res.beta, se=res.se, p=res.pwald, lam=null.lbd))
    g = compare.gaps(prog, ref.run(ys))
    assert g["invalid_mismatch"] == 0
    assert g["lambda_log10_gap"] < 1e-5
    assert g["se_rel_gap"] < 1e-3 and g["beta_gap_se"] < 1e-2 and g["logp_gap"] < 1e-2


def test_sparse_reference_matches_the_port():
    from janusx_tpu_torch import config as jcfg
    from janusx_tpu_torch.models.sparse_spectral import BlockSpectralK
    from janusx_tpu_torch.models.splmm import build_sparse_grm, splmm_grammar_scan
    from portbench.reference.splmm import SparseGrammar

    cfg = load("biobank-10k-1m", n_samples=300, n_phenotyped=300, n_snps=30000)
    tr = traffic("splmm-grammar")
    panel = generate(cfg, 5, "cpu", {"scan": "all"}, 16)
    jcfg.set_full_f32_matmul()
    pg = program_input(panel, "scan")
    Ks = build_sparse_grm(pg, cutoff=cfg["sparse_cutoff"], device="cpu")
    ref = SparseGrammar(panel.raw, panel.n, cfg, tr["scan"], "cpu")
    assert BlockSpectralK.from_sparse(Ks).max_comp == ref.max_comp == cfg["family_size"]
    ys = [TraitStream(tr["phenotype"], panel, "scan", 5).trait(i) for i in range(2)]
    prog = []
    for y in ys:
        res, info = splmm_grammar_scan(pg, Ks, y, seed=tr["scan"]["gamma_seed"], device="cpu")
        prog.append(dict(beta=res.beta, se=res.se, p=res.pwald, lam=info["lambda_null"],
                         gamma=info["gamma"]))
    g = compare.gaps(prog, ref.run(ys))
    assert g["invalid_mismatch"] == 0
    assert g["lambda_log10_gap"] < 1e-5 and g["gamma_rel_gap"] < 1e-5
    assert g["se_rel_gap"] < 1e-5 and g["beta_gap_se"] < 1e-4 and g["logp_gap"] < 1e-4


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from portbench.reference.common import tf32

    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11 + 2.0**-13, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, 3.0]
