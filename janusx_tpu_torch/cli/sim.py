"""`jx sim` — simulate genotypes + phenotypes (reference: script/sim.py).

With a genotype input (-bfile/-vcf/-hmp/-file) it switches to g2p mode
(reference script/simulation.py): phenotypes simulated FROM the existing
panel, with causal-site eligibility controls (-lmaf MAF bounds,
-bimrange chr:start:end regions, -gff gene-restricted causals)."""

from __future__ import annotations

import argparse

from janusx_tpu_torch.cli import common


def build_parser(prog="jx sim") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Simulate genotypes + phenotypes")
    common.add_genotype_args(p, required=False)
    g2p = p.add_argument_group("g2p mode (phenotype from existing genotypes)")
    g2p.add_argument("-causal", "--causal", type=int, default=None,
                     help="number of causal sites (g2p alias of -nqtl)")
    g2p.add_argument("-lmaf", "--lmaf", nargs="+", type=float, default=None,
                     metavar="MAF", help="causal-site MAF bounds: LO [HI]")
    g2p.add_argument("-bimrange", "--bimrange", action="append", default=[],
                     metavar="CHR:START:END", help="repeatable causal region")
    g2p.add_argument("-gff", "--gff", "--gff3", dest="gff", type=str,
                     nargs="+", default=None,
                     metavar=("GFFFILE", "EXT_OR_MODE"),
                     help="restrict causal sites to gene features in this GFF3")
    g = p.add_argument_group("Simulation")
    g.add_argument("-nind", "--nind", type=int, default=1000, help="samples")
    g.add_argument("-nsnp", "--nsnp", type=int, default=10000, help="SNPs")
    g.add_argument("-nchr", "--nchr", type=int, default=5, help="chromosomes")
    g.add_argument("-nqtl", "--nqtl", type=int, default=50, help="causal QTLs")
    g.add_argument("-h2", "--h2", type=float, default=0.5, help="heritability")
    g.add_argument("-ntrait", "--ntrait", type=int, default=1)
    g.add_argument("-miss", "--miss", type=float, default=0.0, help="missing rate")
    g.add_argument("-maf-low", "--maf-low", type=float, default=0.05)
    g.add_argument("-maf-high", "--maf-high", type=float, default=0.5,
                   help="upper MAF bound for simulated sites")
    g.add_argument("-homo", "--homo", action="store_true",
                   help="pure homozygous genotypes (0/2 only — inbred "
                   "DH/RIL-style panels; reference -homo)")
    g.add_argument("-seed", "--seed", type=int, default=0)
    g.add_argument("-pve", "--pve", dest="h2_alias", type=float, default=None,
                   help="alias of -h2 (reference -pve)")
    g.add_argument("-ve", "--ve", type=float, default=None,
                   help="environmental variance scale: phenotypes are "
                   "rescaled so var(e) = VE (reference -ve; default "
                   "leaves total variance 1)")
    g.add_argument("-trait-name", "--trait-name", type=str, default=None,
                   help="trait column name(s) in .pheno (comma list)")
    g.add_argument("-na-rate", "--na-rate", type=float, default=None,
                   help="also write {prefix}.pheno.NA.txt with this "
                   "missing rate injected (reference -na-rate)")
    common.add_compat_flags(p, [
        (("-chunksize", "--chunksize"), {"type": int},
         "genotypes are packed 2-bit resident here; no chunked decode "
         "stage to size"),
    ])
    s = p.add_argument_group("Structure & architecture (g2p)")
    s.add_argument("-structure", "--structure", type=str, default="unrelated",
                   choices=["unrelated", "family", "mixed"],
                   help="population layout (families = 2 parents + offspring)")
    s.add_argument("-family-size", "--family-size", type=int, default=5)
    s.add_argument("-family-frac", "--family-frac", type=float, default=0.5,
                   help="fraction of samples in families (mixed mode)")
    s.add_argument("-effect-model", "--effect-model", type=str, default="random",
                   choices=["random", "equal", "geometric"])
    s.add_argument("-effect-dist", "--effect-dist", type=str, default="normal",
                   choices=["normal", "gamma", "laplace"])
    s.add_argument("-dom-pve", "--dom-pve", type=float, default=0.0,
                   help="dominance-deviation share of h2")
    s.add_argument("-epi-pairs", "--epi-pairs", type=int, default=0,
                   help="number of epistatic logic-gate pairs")
    s.add_argument("-epi-pve", "--epi-pve", type=float, default=0.0,
                   help="epistasis share of h2")
    s.add_argument("-gate", "--gate", type=str, default="A",
                   choices=["A", "NA", "AN", "NAN", "X"],
                   help="logic gate over hom-alt indicators")
    c = p.add_argument_group("Causal-term sampler (g2p)")
    c.add_argument("-cs-pve", "--cs-pve", type=float, default=None,
                   help="overall causal variance contribution Var(Qg) in "
                        "the final phenotype (reference -cs-pve; default "
                        "min(0.05 * n_terms, h2))")
    c.add_argument("-logic-gate", "--logic-gate", nargs=2,
                   metavar=("MODE", "WEIGHTS"), default=None,
                   help="mixed causal-term sampler: MODE a|na|an|nan|x|r, "
                        "WEIGHTS comma list of relative probabilities per "
                        "term size (1=additive, 2=two-site gate, ...); "
                        "literals beyond the first two are ANDed on "
                        "(reference -logic-gate)")
    c.add_argument("-logic-delta", "--logic-delta", type=float, default=1e-6,
                   help="minimum margin of a simulated gate over its best "
                        "parent literal; degenerate gates are redrawn "
                        "(reference -logic-delta)")
    c.add_argument("--pure-epistasis-only", action="store_true",
                   help="residualize each gate against intercept + member "
                        "main effects (pure interaction signal)")
    c.add_argument("--causal-ldsc", type=str, default=None,
                   help="LD-score table (chr, pos, ldsc) for LDMS causal "
                        "sampling")
    c.add_argument("--causal-freq", type=str, default=None,
                   help="MAF table (chr, pos, freq/maf) for LDMS causal "
                        "sampling")
    c.add_argument("--causal-ldsc-quantile", type=float, default=0.75,
                   help="keep causal sites at or above this LD-score "
                        "quantile (default 0.75)")
    c.add_argument("--causal-maf-quantile", type=float, default=0.75,
                   help="keep causal sites at or above this MAF quantile "
                        "(default 0.75)")
    c.add_argument("--causal-spacing-bp", type=int, default=1_000_000,
                   help="minimum distance between LDMS-sampled causal sites "
                        "on one chromosome (default 1e6)")
    s.add_argument("-bg-pve", "--bg-pve", type=float, default=0.0,
                   help="polygenic-background share of h2")
    common.add_compat_flags(p, [
        ("--chunk-size", {"dest": "chunk_size", "type": int},
         "generation runs blocked internally; no streaming chunk to size"),
    ])
    common.add_out_args(p, default_prefix="sim")
    return p


def _ldms_causal_mask(args, gd):
    """LDMS causal-site filters (reference --causal-ldsc/--causal-freq +
    quantile/spacing knobs, script/simulation.py:1756-1796): keep sites at
    or above the given LD-score/MAF quantile, then enforce a minimum
    per-chromosome spacing between eligible sites."""
    import numpy as np

    mask = np.ones(gd.m, bool)
    if args.causal_ldsc is None and args.causal_freq is None:
        return mask
    import pandas as pd

    chrom = np.asarray(gd.sites.chrom, dtype=object).astype(str)
    pos = np.asarray(gd.sites.pos, np.int64)
    key = pd.MultiIndex.from_arrays([chrom, pos])

    def _table_mask(path, value_cols, quantile):
        df = pd.read_csv(path, sep=None, engine="python")
        df.columns = [c.lower() for c in df.columns]
        ccol = next((c for c in ("chr", "chrom") if c in df.columns), None)
        vcol = next((c for c in value_cols if c in df.columns), None)
        if ccol is None or "pos" not in df.columns or vcol is None:
            raise SystemExit(
                f"{path}: need chr/chrom, pos and one of {value_cols} columns")
        ser = pd.Series(
            df[vcol].to_numpy(float),
            index=pd.MultiIndex.from_arrays(
                [df[ccol].astype(str), df["pos"].astype(np.int64)]),
        )
        vals = ser.reindex(key).to_numpy(float)
        thr = np.nanquantile(vals, quantile)
        return np.isfinite(vals) & (vals >= thr)

    if args.causal_ldsc is not None:
        mask &= _table_mask(args.causal_ldsc, ("ldsc", "ldscore"),
                            args.causal_ldsc_quantile)
    if args.causal_freq is not None:
        mask &= _table_mask(args.causal_freq, ("freq", "maf"),
                            args.causal_maf_quantile)
    if args.causal_spacing_bp > 0:
        keep = np.zeros(gd.m, bool)
        for c in np.unique(chrom):
            idx = np.nonzero(mask & (chrom == c))[0]
            idx = idx[np.argsort(pos[idx])]
            last = -np.inf
            for i in idx:
                if pos[i] - last >= args.causal_spacing_bp:
                    keep[i] = True
                    last = pos[i]
        mask = keep
    return mask


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "sim")
    common.warn_ignored_compat(parser, args)

    from janusx_tpu_torch.io import plink
    from janusx_tpu_torch.models.sim import (
        simulate_genotypes,
        simulate_phenotype,
        write_pheno,
    )

    import numpy as np

    g2p_mode = any((args.bfile, args.vcf, args.hmp, args.file))
    causal_pool = None
    if g2p_mode:
        from janusx_tpu_torch.io.gfreader import load_genotype_file

        gd = load_genotype_file(common.resolve_genotype(args))
        elig = np.ones(gd.m, bool)
        if args.lmaf:
            lo = float(args.lmaf[0])
            hi = float(args.lmaf[1]) if len(args.lmaf) > 1 else 0.5
            g = gd.genotypes.astype(np.float64)
            obs = g >= 0
            af = np.where(obs, g, 0).sum(1) / np.maximum(2.0 * obs.sum(1), 1)
            maf = np.minimum(af, 1 - af)
            elig &= (maf >= lo) & (maf <= hi)
        if args.bimrange:
            rmask = np.zeros(gd.m, bool)
            chrom = np.asarray(gd.sites.chrom, dtype=object).astype(str)
            pos = np.asarray(gd.sites.pos, np.int64)
            for tok in args.bimrange:
                parts = tok.split(":")
                if len(parts) != 3:
                    raise SystemExit(f"-bimrange wants CHR:START:END, got {tok!r}")
                c, a, b = parts[0], int(parts[1]), int(parts[2])
                rmask |= (chrom == c) & (pos >= a) & (pos <= b)
            elig &= rmask
        if args.gff:
            from janusx_tpu_torch.utils.gff import GffIndex

            gff_file, ext = args.gff[0], 0
            for tok in args.gff[1:]:
                if tok.lower() in ("g1", "g2", "g3"):
                    # reference gene-unit grouping modes: causal sites are
                    # sampled within gene intervals here either way
                    import logging

                    logging.getLogger("janusx_tpu.cli").info(
                        "-gff %s: gene-unit mode noted; causal sites are "
                        "sampled within (extended) gene intervals", tok)
                else:
                    ext = int(float(tok))
            gi = GffIndex.from_file(gff_file)
            chrom = np.asarray(gd.sites.chrom, dtype=object).astype(str)
            pos = np.asarray(gd.sites.pos, np.int64)
            elig &= np.fromiter(
                (bool(gi.query(c, int(p_), window=ext))
                 for c, p_ in zip(chrom, pos)),
                bool, count=gd.m)
        elig &= _ldms_causal_mask(args, gd)
        causal_pool = np.nonzero(elig)[0]
    else:
        gd = simulate_genotypes(
            args.nind, args.nsnp, maf_low=args.maf_low,
            maf_high=args.maf_high, missing_rate=args.miss,
            n_chrom=args.nchr, seed=args.seed, structure=args.structure,
            family_size=args.family_size, family_frac=args.family_frac,
            homozygous=args.homo,
        )
    # `or` would turn an explicit -causal 0 (pure-epistasis designs) into
    # the nqtl default
    n_qtl = args.causal if args.causal is not None else args.nqtl
    h2 = args.h2 if args.h2_alias is None else args.h2_alias
    sim = simulate_phenotype(
        gd, n_qtl=n_qtl, h2=h2, n_traits=args.ntrait,
        seed=args.seed,
        effect_dist=args.effect_dist, effect_model=args.effect_model,
        dominance_pve=args.dom_pve, epistasis_pairs=args.epi_pairs,
        epistasis_pve=args.epi_pve, epistasis_gate=args.gate,
        bg_pve=args.bg_pve, causal_pool=causal_pool,
        logic_terms=((args.logic_gate[0],
                      [t for t in args.logic_gate[1].split(",") if t])
                     if args.logic_gate else None),
        logic_delta=args.logic_delta,
        pure_epistasis=args.pure_epistasis_only,
        cs_pve=args.cs_pve,
    )
    phenos = sim.phenotypes
    if args.ve is not None:
        # rescale so the environmental variance equals VE while keeping
        # the h2 share (total variance is h2+(1-h2)=1 before scaling)
        if h2 >= 1.0:
            raise SystemExit("-ve needs h2 < 1")
        phenos = phenos * float(np.sqrt(args.ve / (1.0 - h2)))
    names = (args.trait_name.split(",") if args.trait_name else None)
    if names is not None and len(names) != phenos.shape[1]:
        if len(names) == 1:
            names = [f"{names[0]}{i}" for i in range(phenos.shape[1])]
        else:
            raise SystemExit(
                f"-trait-name: {len(names)} names for {phenos.shape[1]} traits")
    if not g2p_mode:
        plink.write_plink_genotypes(prefix, gd)
    write_pheno(prefix + ".pheno", gd.samples, phenos, names=names)
    if args.na_rate is not None:
        # reference -na-rate: a second phenotype file with injected NAs
        # (GS prediction-set demos)
        rng_na = np.random.default_rng(args.seed + 7)
        pna = phenos.copy()
        pna[rng_na.random(pna.shape) < args.na_rate] = np.nan
        write_pheno(prefix + ".pheno.NA.txt", gd.samples, pna, names=names)
    with open(prefix + ".qtl.tsv", "wt") as fh:
        fh.write("snp\tchrom\tpos\teffect\tkind\n")
        for k, (i, e) in enumerate(zip(sim.qtl_idx, sim.qtl_effects)):
            fh.write(
                f"{gd.sites.snp[i]}\t{gd.sites.chrom[i]}\t{gd.sites.pos[i]}"
                f"\t{e:.6g}\tadditive\n"
            )
            if sim.dom_effects is not None:
                fh.write(
                    f"{gd.sites.snp[i]}\t{gd.sites.chrom[i]}\t"
                    f"{gd.sites.pos[i]}\t{sim.dom_effects[k]:.6g}\tdominance\n"
                )
        for i, j, gate, e in sim.epi_pairs:
            fh.write(
                f"{gd.sites.snp[i]}*{gd.sites.snp[j]}\t{gd.sites.chrom[i]}\t"
                f"{gd.sites.pos[i]}\t{e:.6g}\tepistasis[{gate}]\n"
            )
    if sim.components:
        import json

        with open(prefix + ".sim.json", "wt") as fh:
            json.dump({"components": sim.components,
                       "structure": args.structure}, fh, indent=2)
    if g2p_mode:
        print(f"{prefix}.pheno\t{prefix}.qtl.tsv\t(g2p from existing genotypes,"
              f" causal pool {len(causal_pool)}/{gd.m})")
    else:
        print(f"{prefix}.bed/.bim/.fam\t{prefix}.pheno\t{prefix}.qtl.tsv")
    return 0
