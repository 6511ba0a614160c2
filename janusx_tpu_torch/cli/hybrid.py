"""`jx hybrid` — pairwise hybrid genotypes + F1 performance prediction.

Reference: python/janusx/script/hybrid.py — a pairwise hybrid genotype
BUILDER: all |P1|x|P2| crosses from two parent-ID lists, dosage
g_F1 = (clip(g_p1,0,2) + clip(g_p2,0,2)) / 2, missing when either
parent is missing, hybrid IDs `p1@p2` ('@' in parent IDs mapped to
'at'; hybrid.py:560-580). VCF/PLINK outputs round to diploid 0/1/2;
TXT/NPY preserve 0.5/1.5 float dosages.

Two modes:
  build   (-p1 parents.txt -p2 parents.txt [-fmt npy])  — reference parity
  predict (-p pheno ...)  — GBLUP-based F1 prediction shortcut: trains on
          phenotyped parents and scores crosses as the parent-GEBV mean
          without materializing hybrid genotype files.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np

from janusx_tpu_torch.cli import common


def build_parser(prog="jx hybrid") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Pairwise hybrids: genotype builder / F1 prediction")
    common.add_genotype_args(p)
    b = p.add_argument_group("Build mode (hybrid genotypes, reference parity)")
    b.add_argument("-p1", "--p1", type=str, default=None,
                   help="parent-1 sample list (one ID per line)")
    b.add_argument("-p2", "--p2", type=str, default=None,
                   help="parent-2 sample list (one ID per line)")
    b.add_argument("-fmt", "--fmt", dest="format",
                   choices=("plink", "vcf", "txt", "npy"), default="npy",
                   help="build-mode output format (default: npy)")
    # pheno args attach to the parser itself: nesting argument groups is
    # deprecated (3.11+) and an error on 3.14
    common.add_pheno_args(p, required=False)
    common.add_qc_args(p)
    d = p.add_argument_group("Predict mode (GBLUP F1 prediction)")
    d.add_argument("-crosses", "--crosses", type=str, default=None,
                   help="TSV of p1<TAB>p2 crosses (default: all pairs)")
    d.add_argument("-top", "--top", type=int, default=50,
                   help="write only the top N crosses (0 = all)")
    common.add_compat_flags(p, [
        (("-chunksize", "--chunksize"), {"type": int},
         "genotypes are packed 2-bit resident here; no chunked decode "
         "stage to size"),
    ])
    common.add_out_args(p, default_prefix="hybrid")
    return p


def _read_ids(path: str) -> list:
    out, seen = [], set()
    for line in open(path):
        s = line.strip()
        if s and not s.startswith("#") and s not in seen:
            seen.add(s)
            out.append(s)
    if not out:
        raise SystemExit(f"parent list is empty: {path}")
    return out


def _hybrid_ids(p1_ids, p2_ids) -> list:
    out, seen = [], set()
    for a in p1_ids:
        left = str(a).replace("@", "at")
        for b in p2_ids:
            hid = f"{left}@{str(b).replace('@', 'at')}"
            if hid in seen:
                raise SystemExit(
                    f"hybrid sample name collision after '@' normalization: {hid}")
            seen.add(hid)
            out.append(hid)
    return out


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    common.warn_ignored_compat(parser, args)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "hybrid")
    if (args.p1 is None) != (args.p2 is None):
        raise SystemExit("build mode needs both -p1 and -p2")
    if args.p1 is not None:
        return _run_build(args, prefix)
    if not getattr(args, "pheno", None):
        raise SystemExit("either -p1/-p2 (build) or -p pheno (predict) is required")
    return _run_predict(args, prefix)


def _run_build(args, prefix: str) -> int:
    from janusx_tpu_torch.io import plink, writers
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo
    from janusx_tpu_torch.io.gfreader import load_raw_packed

    raw = load_raw_packed(common.resolve_genotype(args))
    p1_ids, p2_ids = _read_ids(args.p1), _read_ids(args.p2)
    pos = {str(s): i for i, s in enumerate(raw.samples)}
    # reference behavior: absent parent IDs are skipped with a warning,
    # erroring only when a list empties (hybrid.py _validate_parent_ids)
    import logging

    log = logging.getLogger("janusx_tpu.hybrid")
    kept = []
    for tag, ids in (("P1", p1_ids), ("P2", p2_ids)):
        missing = [s for s in ids if s not in pos]
        if missing:
            log.warning("%d %s IDs absent from genotypes, skipped (e.g. %s)",
                        len(missing), tag, missing[:3])
        found = [s for s in ids if s in pos]
        if not found:
            raise SystemExit(f"no {tag} IDs present in the genotype panel")
        kept.append(found)
    p1_ids, p2_ids = kept
    hyb_ids = _hybrid_ids(p1_ids, p2_ids)

    from janusx_tpu_torch.io.packed import QcParams

    # no QC in build mode: the builder is a genotype transform, QC belongs
    # to downstream analyses (matches the reference, which has no QC flags)
    pg = raw.prepare(QcParams(maf=0.0, geno=1.0, het=1.0))
    G = pg.dosages().astype(np.float32)  # (m, n) with -1 missing
    i1 = np.array([pos[s] for s in p1_ids])
    i2 = np.array([pos[s] for s in p2_ids])
    left, right = G[:, i1], G[:, i2]
    miss = (left < 0)[:, :, None] | (right < 0)[:, None, :]
    hyb = (np.clip(left, 0, 2)[:, :, None] + np.clip(right, 0, 2)[:, None, :]) * 0.5
    hyb = hyb.reshape(G.shape[0], -1)
    sites = pg.sites
    fmt = args.format
    if fmt in ("plink", "vcf"):
        h = np.rint(hyb).astype(np.int8)
        h[miss.reshape(hyb.shape)] = -1
        gd = GenotypeData(h, sites, np.array(hyb_ids, dtype=object))
        if fmt == "plink":
            plink.write_plink_genotypes(prefix, gd)
            out = prefix + ".bed"
        else:
            writers.write_vcf(prefix + ".vcf.gz", gd)
            out = prefix + ".vcf.gz"
    else:
        hf = hyb.astype(np.float32)
        hf[miss.reshape(hyb.shape)] = -9.0
        if fmt == "npy":
            np.save(prefix + ".npy", hf)
            out = prefix + ".npy"
        else:
            with open(prefix + ".txt", "wt") as fh:
                fh.write("snp\t" + "\t".join(hyb_ids) + "\n")
                for r in range(hf.shape[0]):
                    fh.write(str(sites.snp[r]) + "\t"
                             + "\t".join(f"{v:g}" for v in hf[r]) + "\n")
            out = prefix + ".txt"
        with open(prefix + ".id", "wt") as fh:
            fh.write("\n".join(hyb_ids) + "\n")
        with open(prefix + ".site", "wt") as fh:
            fh.write("chrom\tpos\tsnp\tallele0\tallele1\n")
            for i in range(len(sites.pos)):
                fh.write(f"{sites.chrom[i]}\t{sites.pos[i]}\t{sites.snp[i]}"
                         f"\t{sites.allele0[i]}\t{sites.allele1[i]}\n")
    print(f"{len(hyb_ids)} hybrids ({len(p1_ids)}x{len(p2_ids)}) x "
          f"{pg.m} sites ->\t{out}")
    return 0


def _run_predict(args, prefix: str) -> int:
    from janusx_tpu_torch.gs.blup import fit_gblup, marker_effects
    from janusx_tpu_torch.io.gfreader import prepare_packed
    from janusx_tpu_torch.io.packed import QcParams
    from janusx_tpu_torch.io.pheno import load_phenotype
    from janusx_tpu_torch.models.grm import grm_denominator, grm_from_packed

    pg = prepare_packed(
        common.resolve_genotype(args),
        QcParams(maf=args.maf, geno=args.geno, het=args.het),
    )
    ph = load_phenotype(args.pheno).select(common.parse_traits(args.ncol))
    y_all, _ = ph.align(pg.samples)
    y = y_all[:, 0]
    train = np.nonzero(np.isfinite(y))[0]
    if len(train) < 10:
        raise SystemExit("too few phenotyped parents")
    K = grm_from_packed(pg)
    model = fit_gblup(K, y, train)
    eff = marker_effects(pg, _alpha_full(model, pg.n), grm_denominator(pg))

    # centered parent dosages
    Z = pg.centered()  # (m, n)
    gv_parent = Z.T @ eff  # parental GEBV deviations
    mu = float(model.beta[0])

    ids = {str(s): i for i, s in enumerate(pg.samples)}
    if args.crosses:
        crosses, skipped = [], 0
        for ln in open(args.crosses):
            f = ln.split()
            if len(f) < 2:
                continue
            if f[0] in ids and f[1] in ids:
                crosses.append((f[0], f[1]))
            else:
                skipped += 1
        if skipped:
            import logging

            logging.getLogger("janusx_tpu.hybrid").warning(
                "%d cross lines skipped (parent IDs absent from the panel)",
                skipped,
            )
        if not crosses:
            raise SystemExit(
                f"no valid crosses in {args.crosses}: no line's parent IDs "
                f"both match the genotype panel samples"
            )
    else:
        names = [str(s) for s in pg.samples]
        crosses = list(itertools.combinations(names, 2))
    rows = []
    for p1, p2 in crosses:
        i, j = ids[p1], ids[p2]
        # E[g_F1] = (g_p1 + g_p2)/2  ->  additive gebv = mean of parents
        pred = mu + 0.5 * (gv_parent[i] + gv_parent[j])
        rows.append((p1, p2, pred))
    rows.sort(key=lambda r: -r[2])
    n_total = len(rows)
    if args.top and args.top > 0:
        rows = rows[: args.top]
    path = f"{prefix}.hybrid.tsv"
    with open(path, "wt") as fh:
        fh.write("parent1\tparent2\tpredicted\n")
        for p1, p2, v in rows:
            fh.write(f"{p1}\t{p2}\t{v:.4f}\n")
    print(f"{path}\t{len(rows)}/{n_total} crosses\t"
          f"best: {rows[0][0]} x {rows[0][1]} = {rows[0][2]:.3f}")
    return 0


def _alpha_full(model, n: int) -> np.ndarray:
    alpha = np.zeros(n)
    alpha[model.train_idx] = model.alpha
    return alpha
