"""The generator: the same seed gives the same panel and traits, every SNP
passes the port's QC at the configurations' sample sizes, and the program
input is what the port's own QC makes of the raw codes."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import manifest as mf
from portbench.panel import generate, pack, program_input, unpack
from portbench.traits import TraitStream

PHEN = {"n_qtl": 5, "h2": [0.2, 0.8], "qtl_share": 0.3, "background_scores": 8,
        "mean": 10.0}


def config(name: str, **sizes) -> dict:
    cfg = json.loads((mf.HERE / "configs" / f"{name}.json").read_text())
    cfg.update(sizes)
    return cfg


def test_pack_roundtrip():
    codes = torch.randint(0, 4, (7, 13), dtype=torch.uint8)
    assert torch.equal(unpack(pack(codes), 13), codes)


def test_same_seed_same_panel_and_traits():
    cfg = config("jxbench-5k-500k", n_samples=60, n_phenotyped=45, n_snps=2500)
    seed = 2**31 + 977
    a, b = (generate(cfg, seed, "cpu", {"s": "phenotyped"}, 8) for _ in range(2))
    c = generate(cfg, seed + 1, "cpu", {"s": "phenotyped"}, 8)
    assert np.array_equal(a.raw, b.raw) and np.array_equal(a.scores, b.scores)
    assert np.array_equal(a.phenotyped, b.phenotyped)
    assert not np.array_equal(a.raw, c.raw)
    ta, tb = (TraitStream(PHEN, p, "s", seed) for p in (a, b))
    assert np.array_equal(ta.batch(3, 2), tb.batch(3, 2))
    assert np.array_equal(ta.batch(3, 2)[:, 1], ta.trait(4))
    assert not np.array_equal(ta.trait(0), ta.warmup(0, 1)[:, 0])


@pytest.mark.parametrize("name,n_ph", [("jxbench-5k-500k", 5000), ("biobank-10k-1m", 10000)])
def test_every_snp_passes_qc_at_the_configured_samples(name, n_ph):
    cfg = config(name, n_snps=3000)
    p = generate(cfg, 12345, "cpu", {"s": "phenotyped"}, 4)
    assert len(p.phenotyped) == n_ph
    assert p.sets["s"].keep.all()


def test_program_input_matches_the_ports_qc():
    from janusx_tpu_torch.io.gdata import SiteInfo
    from janusx_tpu_torch.io.packed import QcParams, pack_from_codes

    cfg = config("jxbench-5k-500k", n_samples=80, n_phenotyped=50, n_snps=3000,
                 maf_range=[0.0, 0.5])  # some SNPs fail QC here
    p = generate(cfg, 7, "cpu", {"s": "phenotyped"}, 4)
    m, n = cfg["n_snps"], cfg["n_samples"]
    sites = SiteInfo(chrom=np.full(m, "1", object), pos=np.arange(1, m + 1),
                     snp=np.arange(m).astype(object), allele0=np.full(m, "A", object),
                     allele1=np.full(m, "G", object))
    want = pack_from_codes(p.raw, n, sites, np.arange(n).astype(object),
                           QcParams(maf=cfg["qc"]["maf"], geno=cfg["qc"]["geno"]),
                           sample_idx=p.phenotyped)
    got = program_input(p, "s")
    assert 0 < got.m < m
    assert np.array_equal(got.packed, want.packed)
    for k in ("af", "miss", "mean"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert np.array_equal(got.sites.pos, want.sites.pos)


def test_sibships_show_in_the_grm():
    from portbench.reference.common import centered, qc_rows
    from portbench.reference.common import unpack as ref_unpack

    n = 200
    cfg = config("biobank-10k-1m", n_samples=n, n_phenotyped=n, n_snps=20000)
    p = generate(cfg, 3, "cpu", {"s": "all"}, 4)
    codes = ref_unpack(p.raw, n, "cpu")
    keep, _, q = qc_rows(codes, 0.02, 0.05)
    x = centered(codes[keep], q[keep], torch.float64)
    K = (x.T @ x / torch.sum(2 * q[keep] * (1 - q[keep]))).numpy()
    fam = np.arange(n) // cfg["family_size"]
    eye = np.eye(n, dtype=bool)
    sib = (fam[:, None] == fam[None, :]) & ~eye
    assert abs(K[sib].mean() - 0.5) < 0.05
    # sample centering makes each row sum to ~0: 1 + 4 x 0.5 + (n - 5) x mean = 0
    assert abs(K[~sib & ~eye].mean() + 3 / (n - 5)) < 0.005
    assert np.abs(K[~sib & ~eye]).max() < 0.05 < K[sib].min()
