"""Genotype + phenotype simulation (``jx sim`` / g2p).

Replaces the reference's SimEngine / g2p_simulate
(JanusX src/io/sim.rs, src/sim/g2p.rs): HWE genotype draws with
uniform allele-frequency spectrum, optional family structure
(unrelated/family/mixed layouts, g2p.rs:85 _build_family_layout with
parent-pair meiosis offspring), then a phenotype composed of additive QTL
effects (equal/geometric models, g2p.rs CausalEffectModel), dominance
deviations, epistatic logic gates over hom-alt indicators
(A/NA/AN/NAN/X modes, g2p.rs LogicGateMode), and a polygenic background
term with normal/gamma/laplace effect distributions
(g2p.rs BackgroundDist), mixed to a target PVE split.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo


@dataclass
class SimResult:
    genotypes: GenotypeData
    phenotypes: np.ndarray  # (n, n_traits)
    qtl_idx: np.ndarray
    qtl_effects: np.ndarray
    dom_effects: np.ndarray | None = None
    epi_pairs: list = field(default_factory=list)  # [(i, j, gate, effect)]
    components: dict = field(default_factory=dict)  # realized variance shares


def _family_offspring(rng, parent_a: np.ndarray, parent_b: np.ndarray):
    """One meiosis child per SNP: draw one allele from each parent's two
    (dosage k -> allele Bernoulli(k/2)) — g2p.rs family offspring model."""
    a1 = rng.random(parent_a.shape) < parent_a / 2.0
    a2 = rng.random(parent_b.shape) < parent_b / 2.0
    return (a1.astype(np.int8) + a2.astype(np.int8))


def simulate_genotypes(
    n_samples: int,
    n_snps: int,
    maf_low: float = 0.05,
    maf_high: float = 0.5,
    missing_rate: float = 0.0,
    n_chrom: int = 5,
    seed: int = 0,
    structure: str = "unrelated",  # unrelated | family | mixed
    family_size: int = 5,
    family_frac: float = 0.5,
    homozygous: bool = False,
) -> GenotypeData:
    """HWE draws; with ``structure`` != unrelated, a fraction of samples
    form nuclear families (2 founder parents + family_size-2 offspring
    from meiosis) — mirrors g2p.rs:85-119 layout rules.

    ``homozygous`` (reference -homo): 0/2-only genotypes, the inbred
    DH/RIL-style panel — founders carry doubled alleles and family
    offspring inherit each locus whole from one random parent, so
    homozygosity is preserved through the pedigree."""
    if structure not in ("unrelated", "family", "mixed"):
        raise ValueError("structure must be unrelated|family|mixed")
    if structure != "unrelated" and family_size < 3:
        raise ValueError("family_size must be >= 3 (two parents + children)")
    rng = np.random.default_rng(seed)
    p = rng.uniform(maf_low, maf_high, size=n_snps)
    if structure == "unrelated":
        n_fam_samples = 0
    elif structure == "family":
        n_fam_samples = n_samples
    else:
        n_fam_samples = int(round(n_samples * min(max(family_frac, 0.0), 1.0)))
    n_fam_samples = (n_fam_samples // family_size) * family_size
    n_families = n_fam_samples // family_size
    n_founder = n_samples - n_fam_samples + 2 * n_families
    if homozygous:
        founders = (2 * rng.binomial(1, p[:, None], size=(n_snps, n_founder))
                    ).astype(np.int8)
    else:
        founders = rng.binomial(2, p[:, None], size=(n_snps, n_founder)).astype(
            np.int8
        )
    if n_families == 0:
        g = founders
    else:
        cols = [founders[:, 2 * n_families:]]  # unrelated block last
        fam_cols = []
        for f in range(n_families):
            pa = founders[:, 2 * f].astype(np.float64)
            pb = founders[:, 2 * f + 1].astype(np.float64)
            fam_cols.append(founders[:, 2 * f])
            fam_cols.append(founders[:, 2 * f + 1])
            for _ in range(family_size - 2):
                if homozygous:
                    pick = rng.random(n_snps) < 0.5
                    fam_cols.append(np.where(
                        pick, founders[:, 2 * f], founders[:, 2 * f + 1]
                    ).astype(np.int8))
                else:
                    fam_cols.append(_family_offspring(rng, pa, pb))
        g = np.column_stack(fam_cols + cols).astype(np.int8)
    if missing_rate > 0:
        g[rng.random(g.shape) < missing_rate] = -1
    chrom = np.array(
        [str(1 + (i * n_chrom) // n_snps) for i in range(n_snps)], object
    )
    # positions restart per chromosome at 1e4 spacing
    pos = np.zeros(n_snps, np.int64)
    counter: dict = {}
    for i, c in enumerate(chrom):
        counter[c] = counter.get(c, 0) + 1
        pos[i] = counter[c] * 10_000
    sites = SiteInfo(
        chrom=chrom,
        pos=pos,
        snp=np.array([f"snp{i + 1}" for i in range(n_snps)], object),
        allele0=np.array(["A"] * n_snps, object),
        allele1=np.array(["G"] * n_snps, object),
    )
    samples = np.array([f"ind{i + 1}" for i in range(n_samples)], object)
    return GenotypeData(g, sites, samples)


_GATES = ("A", "NA", "AN", "NAN", "X")


def _gate_value(gate: str, bi: np.ndarray, bj: np.ndarray) -> np.ndarray:
    """Logic-gate term over hom-alt indicators (g2p.rs LogicGateMode):
    A = i AND j, NA = NOT i AND j, AN = i AND NOT j, NAN = NOT i AND NOT j,
    X = i XOR j."""
    if gate == "A":
        return bi & bj
    if gate == "NA":
        return (1 - bi) & bj
    if gate == "AN":
        return bi & (1 - bj)
    if gate == "NAN":
        return (1 - bi) & (1 - bj)
    if gate == "X":
        return bi ^ bj
    raise ValueError(f"unknown logic gate {gate} (choose from {_GATES})")


def _scaled(term: np.ndarray, target_var: float) -> np.ndarray:
    v = np.var(term)
    if v <= 0 or target_var <= 0:
        return np.zeros_like(term)
    return term * np.sqrt(target_var / v)


def simulate_phenotype(
    gdata: GenotypeData,
    n_qtl: int = 50,
    h2: float = 0.5,
    n_traits: int = 1,
    effect_dist: str = "normal",  # "normal" | "gamma" | "laplace"
    effect_model: str = "random",  # "random" | "equal" | "geometric"
    dominance_pve: float = 0.0,
    epistasis_pairs: int = 0,
    epistasis_pve: float = 0.0,
    epistasis_gate: str = "A",
    bg_pve: float = 0.0,
    seed: int = 0,
    causal_pool: np.ndarray | None = None,
    logic_terms: tuple | None = None,
    logic_delta: float = 1e-6,
    pure_epistasis: bool = False,
    cs_pve: float | None = None,
) -> SimResult:
    """Phenotype = additive QTL + dominance deviations + epistatic logic
    gates + polygenic background + noise; ``h2`` is the total genetic PVE
    and the component PVEs partition it (additive takes the remainder).

    Mirrors the reference g2p composition (src/sim/g2p.rs: causal sets
    with Equal/Geometric effect models, LogicGateMode epistasis terms,
    BackgroundDist polygenic term, PVE mixing).

    ``logic_terms=(mode, size_weights)`` activates the reference
    `-logic-gate` mixed causal-term sampler (script/simulation.py:1798):
    the n_qtl causal terms get sizes 1..len(size_weights) in proportion
    to the weights; size-1 terms are additive sites, size>=2 terms are
    logic gates over hom-alt indicators (mode a|na|an|nan|x, or r =
    random per term; literals beyond the first two are ANDed on).
    ``logic_delta``: degenerate gates (constant, or indistinguishable
    from a parent literal — margin < delta) are redrawn.
    ``pure_epistasis`` (reference --pure-epistasis-only): residualize
    each gate against intercept + member dosages so members carry no
    fitted marginal effect. ``cs_pve`` (reference -cs-pve): PVE of the
    whole causal-term block; default min(0.05 * n_terms, available)."""
    if dominance_pve + epistasis_pve + bg_pve > h2 + 1e-12:
        raise ValueError("component PVEs exceed total h2")
    rng = np.random.default_rng(seed + 1)
    g = gdata.genotypes.astype(np.float64)
    g[gdata.genotypes < 0] = np.nan
    means = np.nanmean(g, axis=1)
    gc = np.nan_to_num(g - means[:, None])
    n = gdata.n
    phenos = np.empty((n, n_traits))
    # causal_pool restricts QTL/epistasis site eligibility (reference
    # `jx simulation` -lmaf/-bimrange/-gff causal-region controls)
    pool = (np.arange(gdata.m) if causal_pool is None
            else np.asarray(causal_pool, np.int64))
    if pool.size == 0:
        raise ValueError("empty causal pool after eligibility filters")
    if logic_terms is not None:
        return _simulate_logic_phenotype(
            gdata, g, gc, pool, n_qtl=n_qtl, h2=h2, n_traits=n_traits,
            logic_terms=logic_terms, logic_delta=logic_delta,
            pure_epistasis=pure_epistasis, cs_pve=cs_pve, bg_pve=bg_pve,
            effect_dist=effect_dist, rng=rng,
        )
    qtl_idx = np.sort(rng.choice(pool, size=min(n_qtl, pool.size), replace=False))
    q = len(qtl_idx)
    if effect_model == "equal":
        eff = rng.choice([-1.0, 1.0], q)
    elif effect_model == "geometric":
        eff = 0.9 ** np.arange(q) * rng.choice([-1.0, 1.0], q)
    elif effect_dist == "gamma":
        eff = rng.gamma(0.4, 1.0, size=q) * rng.choice([-1, 1], q)
    elif effect_dist == "laplace":
        eff = rng.laplace(size=q)
    else:
        eff = rng.normal(size=q)

    add_pve = h2 - dominance_pve - epistasis_pve - bg_pve
    gv = _scaled(gc[qtl_idx].T @ eff, add_pve)

    dom_eff = None
    if dominance_pve > 0:
        het = np.nan_to_num((g[qtl_idx] == 1).astype(np.float64))
        het -= het.mean(axis=1, keepdims=True)
        dom_eff = rng.normal(size=q)
        gv = gv + _scaled(het.T @ dom_eff, dominance_pve)

    epi_pairs: list = []
    if epistasis_pairs > 0 and epistasis_pve > 0:
        hom = np.nan_to_num((g == 2).astype(np.int8))
        cand = rng.choice(pool, size=min(2 * epistasis_pairs, pool.size), replace=False)
        n_pairs = len(cand) // 2  # small pools support fewer pairs
        terms = []
        for k in range(n_pairs):
            i, j = int(cand[2 * k]), int(cand[2 * k + 1])
            e = rng.normal()
            term = _gate_value(epistasis_gate, hom[i], hom[j]).astype(np.float64)
            terms.append((term - term.mean()) * e)
            epi_pairs.append((i, j, epistasis_gate, e))
        gv = gv + _scaled(np.sum(terms, axis=0), epistasis_pve)

    if bg_pve > 0:
        if effect_dist == "gamma":
            beff = rng.gamma(0.4, 1.0, size=gdata.m) * rng.choice([-1, 1], gdata.m)
        elif effect_dist == "laplace":
            beff = rng.laplace(size=gdata.m)
        else:
            beff = rng.normal(size=gdata.m)
        gv = gv + _scaled(gc.T @ beff, bg_pve)

    vg = np.var(gv)
    ve = vg * (1.0 - h2) / max(h2, 1e-9) if vg > 0 else 1.0
    for t in range(n_traits):
        phenos[:, t] = gv + rng.normal(size=n) * np.sqrt(ve)
    comp = {
        "additive": add_pve, "dominance": dominance_pve,
        "epistasis": epistasis_pve, "background": bg_pve, "h2": h2,
    }
    return SimResult(
        genotypes=gdata, phenotypes=phenos, qtl_idx=qtl_idx, qtl_effects=eff,
        dom_effects=dom_eff, epi_pairs=epi_pairs, components=comp,
    )


def _simulate_logic_phenotype(gdata, g, gc, pool, *, n_qtl, h2, n_traits,
                              logic_terms, logic_delta, pure_epistasis,
                              cs_pve, bg_pve, effect_dist, rng) -> SimResult:
    """Mixed causal-term sampler (reference `-logic-gate MODE WEIGHTS`,
    script/simulation.py:1798-1836 / src/sim/g2p.rs logic-gate units)."""
    mode, weights = logic_terms
    mode = str(mode).upper()
    if mode not in _GATES + ("R",):
        raise ValueError(f"logic-gate mode {mode!r} (want a|na|an|nan|x|r)")
    w = np.asarray([float(x) for x in weights], np.float64)
    if w.size == 0 or (w < 0).any() or w.sum() <= 0:
        raise ValueError("logic-gate size weights must be non-negative, not all zero")
    sizes = rng.choice(np.arange(1, w.size + 1), size=n_qtl, p=w / w.sum())
    hom = np.nan_to_num((g == 2).astype(np.int8))
    n = gdata.n

    def _draw_effect():
        if effect_dist == "gamma":
            return float(rng.gamma(0.4, 1.0) * rng.choice([-1, 1]))
        if effect_dist == "laplace":
            return float(rng.laplace())
        return float(rng.normal())

    qtl_idx, qtl_eff, epi_pairs, term_log = [], [], [], []
    block = np.zeros(n)
    for size in sizes:
        size = int(min(size, pool.size))
        if size == 1:
            i = int(rng.choice(pool))
            e = _draw_effect()
            block = block + gc[i] * e
            qtl_idx.append(i)
            qtl_eff.append(e)
            term_log.append({"members": [int(i)], "gate": "ADD", "effect": e})
            continue
        term = None
        members: list[int] = []
        gate = mode
        for _ in range(32):  # redraw degenerate gates (reference -logic-delta)
            members = [int(x) for x in
                       rng.choice(pool, size=size, replace=False)]
            gate = mode if mode != "R" else str(rng.choice(_GATES))
            t = _gate_value(gate, hom[members[0]], hom[members[1]])
            for extra in members[2:]:  # literals beyond 2 are ANDed on
                t = t & hom[extra]
            t = t.astype(np.float64)
            if t.std() <= 0:
                continue
            # margin over the best parent literal: 1 - max |corr|
            margin = 1.0 - max(
                abs(float(np.corrcoef(t, hom[mi])[0, 1]))
                if hom[mi].std() > 0 else 1.0
                for mi in members
            )
            if margin >= logic_delta:
                term = t
                break
        if term is None:
            continue
        if pure_epistasis:
            # residualize against intercept + member dosages
            X = np.column_stack([np.ones(n)] + [gc[mi] for mi in members])
            beta, *_ = np.linalg.lstsq(X, term, rcond=None)
            term = term - X @ beta
        e = _draw_effect()
        block = block + (term - term.mean()) * e
        epi_pairs.append((members[0], members[1], gate, e))
        term_log.append({"members": members, "gate": gate, "effect": e})
    n_terms = len(term_log)
    avail = min(h2 - bg_pve, 1.0 - bg_pve)
    block_pve = (min(float(cs_pve), avail) if cs_pve is not None
                 else min(0.05 * max(n_terms, 1), avail))
    # reference variance ledger (script/simulation.py:1716): the residual
    # share is 1 - bg_pve - cs_pve, so the realized causal PVE equals
    # block_pve exactly (total variance 1) — deriving ve from vg*(1-h2)/h2
    # here would rescale noise to whatever the block realized and make
    # -cs-pve a no-op
    gv = _scaled(block, block_pve)
    if bg_pve > 0:
        beff = rng.normal(size=gdata.m)
        gv = gv + _scaled(gc.T @ beff, bg_pve)
    ve = max(1.0 - block_pve - bg_pve, 1e-9)
    phenos = np.empty((n, n_traits))
    for t_ in range(n_traits):
        phenos[:, t_] = gv + rng.normal(size=n) * np.sqrt(ve)
    comp = {"causal_terms": block_pve, "background": bg_pve, "h2": h2,
            "n_terms": n_terms, "logic_terms": term_log,
            "pure_epistasis": bool(pure_epistasis)}
    return SimResult(
        genotypes=gdata, phenotypes=phenos,
        qtl_idx=np.asarray(sorted(qtl_idx), np.int64),
        qtl_effects=np.asarray([e for _, e in
                                sorted(zip(qtl_idx, qtl_eff))], np.float64),
        dom_effects=None, epi_pairs=epi_pairs, components=comp,
    )


def write_pheno(path: str, samples, phenos: np.ndarray, names=None) -> None:
    t = phenos.shape[1]
    names = names or [f"trait{i}" for i in range(t)]
    with open(path, "wt") as fh:
        fh.write("\t" + "\t".join(names) + "\n")
        for i, s in enumerate(samples):
            vals = "\t".join(
                "NA" if not np.isfinite(phenos[i, j]) else f"{phenos[i, j]:.6f}"
                for j in range(t)
            )
            fh.write(f"{s}\t{vals}\n")
