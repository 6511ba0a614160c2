"""`jx gmerge` — merge genotype panels.

Reference: python/janusx/script/gmerge.py + src/io/gmerge.rs
merge_genotypes: multi-panel merge on shared (chrom, pos) sites with
ref-allele harmonization (swapped alleles recoded 2-x, mismatches set
missing), optional D{i}_ sample prefixes, post-merge MAF/missing
filters, and plink/vcf/txt/npy output.
"""

from __future__ import annotations

import argparse

import numpy as np

from janusx_tpu_torch.cli import common


def build_parser(prog="jx gmerge") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Merge genotype panels by shared sites")
    i = p.add_argument_group("Inputs (repeatable; >=2 total)")
    i.add_argument("-vcf", "--vcf", nargs="+", action="extend", default=[],
                   help="VCF / VCF.GZ files")
    i.add_argument("-hmp", "--hmp", nargs="+", action="extend", default=[],
                   help="HapMap files")
    i.add_argument("-bfile", "--bfile", nargs="+", action="extend", default=[],
                   help="PLINK prefixes")
    i.add_argument("-file", "--file", nargs="+", action="extend", default=[],
                   help="numeric matrix files/prefixes (.txt with .id sidecar)")
    i.add_argument("-i", "--inputs", type=str, nargs="+", default=[],
                   help="generic inputs, format auto-detected")
    o = p.add_argument_group("Output")
    o.add_argument("-fmt", "--fmt", dest="format", default="vcf",
                   choices=("plink", "vcf", "hmp", "txt", "npy"),
                   help="output format (default: vcf.gz)")
    o.add_argument("-sample-prefix", "--sample-prefix", action="store_true",
                   help="prefix sample IDs by dataset index (D1_, D2_, ...)")
    o.add_argument("-maf", "--maf", type=float, default=0.0,
                   help="drop merged sites with MAF below this (default: 0)")
    o.add_argument("-geno", "--geno", type=float, default=1.0,
                   help="drop merged sites with missing rate above this (default: 1)")
    common.add_compat_thread_arg(p)
    common.add_out_args(p, default_prefix="merged")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "gmerge")

    from janusx_tpu_torch.io import plink, writers
    from janusx_tpu_torch.io.gdata import GenotypeData
    from janusx_tpu_torch.io.gfreader import load_genotype_file

    paths = (list(args.vcf) + list(args.hmp) + list(args.bfile)
             + list(args.file) + list(args.inputs))
    if len(paths) < 2:
        raise SystemExit("need at least 2 inputs across -vcf/-hmp/-bfile/-file/-i")

    panels = [load_genotype_file(p) for p in paths]

    # site key: (chrom, pos, unordered allele pair) — split multi-allelics
    # share a position, so a bare (chrom, pos) key would collapse them to
    # one arbitrary row and null out consistent variants; alleles in the
    # key keep each biallelic split matched to its own counterpart.
    # Orientation is still harmonized to the first panel below.
    import logging

    def keys(gd, label=""):
        out = {}
        dups = 0
        for i, (c, p, x, y) in enumerate(zip(
            gd.sites.chrom, gd.sites.pos, gd.sites.allele0, gd.sites.allele1
        )):
            k = (str(c), int(p)) + tuple(sorted((str(x), str(y))))
            if k in out:
                dups += 1
            out[k] = i
        if dups:
            logging.getLogger("janusx_tpu.gmerge").warning(
                "%s: %d fully duplicated site rows (same chrom/pos/alleles);"
                " keeping the last of each", label or "panel", dups,
            )
        return out

    base = panels[0]
    common_keys = set(keys(base))
    for gd in panels[1:]:
        common_keys &= set(keys(gd))
    if not common_keys:
        raise SystemExit("no shared sites across panels")
    order = sorted(common_keys)
    base_idx = keys(base)
    sel0 = np.array([base_idx[k] for k in order])
    sites = base.sites.take(sel0)
    blocks = [base.genotypes[sel0]]
    samples = [np.asarray(base.samples, dtype=object)]
    dropped_strand = 0
    for gd in panels[1:]:
        idx = keys(gd)
        sel = np.array([idx[k] for k in order])
        g = gd.genotypes[sel].copy()
        a0 = gd.sites.allele0[sel]
        a1 = gd.sites.allele1[sel]
        same = (a0 == sites.allele0) & (a1 == sites.allele1)
        swapped = (a0 == sites.allele1) & (a1 == sites.allele0)
        sw = np.nonzero(swapped)[0]
        sub = g[sw]
        sub[sub >= 0] = 2 - sub[sub >= 0]
        g[sw] = sub
        bad = ~(same | swapped)
        g[bad] = -1  # allele mismatch -> missing
        dropped_strand += int(bad.sum())
        blocks.append(g)
        samples.append(np.asarray(gd.samples, dtype=object))
    if args.sample_prefix:
        samples = [np.array([f"D{d + 1}_{s}" for s in ss], dtype=object)
                   for d, ss in enumerate(samples)]
    geno = np.concatenate(blocks, axis=1)
    all_samples = np.concatenate(samples)
    dup = len(all_samples) - len(set(all_samples.tolist()))
    if dup:
        raise SystemExit(f"{dup} duplicate sample IDs across panels "
                         "(use -sample-prefix to disambiguate)")

    # post-merge site filters (reference gmerge.py -maf/-geno)
    obs = geno >= 0
    n_obs = obs.sum(axis=1)
    miss_rate = 1.0 - n_obs / geno.shape[1]
    with np.errstate(divide="ignore", invalid="ignore"):
        af = np.where(n_obs > 0, np.where(obs, geno, 0).sum(axis=1) / (2.0 * n_obs), 0.0)
    maf = np.minimum(af, 1.0 - af)
    keep = (miss_rate <= args.geno) & (maf >= args.maf)
    n_filtered = int((~keep).sum())
    if n_filtered:
        sel = np.nonzero(keep)[0]
        geno, sites = geno[sel], sites.take(sel)

    merged = GenotypeData(geno, sites, all_samples)
    if args.format == "plink":
        plink.write_plink_genotypes(prefix, merged)
        out = prefix + ".bed"
    elif args.format == "vcf":
        writers.write_vcf(prefix + ".vcf.gz", merged)
        out = prefix + ".vcf.gz"
    elif args.format == "hmp":
        writers.write_hapmap(prefix + ".hmp.txt", merged)
        out = prefix + ".hmp.txt"
    elif args.format == "txt":
        writers.write_txt(prefix + ".txt", merged)
        out = prefix + ".txt"
    else:
        np.save(prefix + ".npy", merged.genotypes.astype(np.int8))
        with open(prefix + ".id", "wt") as fh:
            fh.write("\n".join(str(s) for s in merged.samples) + "\n")
        out = prefix + ".npy"
    print(
        f"{out}\t{merged.m} shared SNPs x {merged.n} samples"
        f"\t(mismatched-allele rows set missing: {dropped_strand};"
        f" filtered sites: {n_filtered})"
    )
    return 0
