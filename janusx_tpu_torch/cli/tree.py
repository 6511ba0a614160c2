"""`jx tree` — NJ / approximate-ML phylogeny (reference: script/tree.py).

Inputs: genotype files (-bfile/-vcf/-hmp/-file; IBS distances) or an
aligned FASTA (-fa; Jukes-Cantor distances). `-b B` adds bootstrap
support percentages on internal nodes (site resampling, NJ per
replicate). `--write-phylip` emits the distance matrix in PHYLIP format;
`-ml` refines by approximate maximum likelihood (CFN, NNI).
"""

from __future__ import annotations

import argparse

from janusx_tpu_torch.cli import common


def build_parser(prog="jx tree") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Neighbor-joining tree")
    common.add_genotype_args(p, required=False)
    p.add_argument("-fa", "--fasta", type=str, default=None,
                   help="aligned FASTA input (JC distances) instead of genotypes")
    common.add_qc_args(p)
    o = p.add_argument_group("Options")
    o.add_argument("-dist", "--write-dist", action="store_true",
                   help="also write the distance matrix (TSV)")
    o.add_argument("--write-phylip", action="store_true",
                   help="also write the distance matrix in PHYLIP format")
    o.add_argument("-b", "--bootstrap", type=int, nargs="?", const=100,
                   default=None, metavar="B",
                   help="resamples for internal-node support (bare -b = 100)")
    o.add_argument("--support", type=str, default="bootstrap",
                   choices=("bootstrap", "shlike"),
                   help="support algorithm when -ml and -b are given: "
                   "'bootstrap' refines every site-weight replicate "
                   "(global, slower); 'shlike' scores SH-like/RELL local "
                   "supports on the ML tree (reference --support)")
    o.add_argument("--profile", action="store_true",
                   help="report phase timings and save {prefix}.profile.tsv")
    o.add_argument("-nj", "--nj", nargs="?", const="exact", default=None,
                   choices=("exact", "bionj", "bionj-jc", "bionj-dist",
                            "bionj-binom", "bionj-auto", "approx"),
                   help="agglomeration algorithm: exact NJ (default), "
                   "BIONJ with a variance model (jc delta-method | "
                   "dist | binom; bionj = bionj-jc), or 'approx' = "
                   "RapidNJ-style pruned search (same min-Q joins, "
                   "O(n^2 log n) — use for large cohorts; reference "
                   "rapid-core mode)")
    o.add_argument("-asc", "--asc", action="store_true",
                   help="SNP ascertainment-bias pseudo correction for "
                   "-ml: k pseudo-constant sites per state enter the "
                   "likelihood as site WEIGHTS (k from "
                   "JANUSX_ASC_PSEUDO_CONST, default 1 — reference -asc)")
    common.add_compat_flags(p, [
        (("-chunksize", "--chunksize"), {"type": int},
         "genotypes are packed 2-bit resident here; no chunked decode "
         "stage to size"),
    ])
    o.add_argument("-ml", "--ml", action="store_true",
                   help="refine the NJ tree by approximate maximum "
                   "likelihood (CFN model, NNI search — reference "
                   "`jx tree -ml` / FastTree)")
    o.add_argument("-ml-sites", "--ml-sites", type=int, default=2000,
                   help="site budget for the ML refinement")
    o.add_argument("-ml-cat", "--ml-cat", type=int, default=1, metavar="N",
                   help="per-site rate categories for -ml (FastTree-CAT "
                   "style; 1 = uniform rates)")
    o.add_argument("-ml-no-spr", "--ml-no-spr", action="store_true",
                   help="disable SPR moves in the -ml search (NNI only)")
    o.add_argument("-ml-gamma", "--ml-gamma", action="store_true",
                   help="after the CAT search, rescale branch lengths to "
                        "the ML discrete-Gamma(20) likelihood and report "
                        "it (FastTree -gamma)")
    o.add_argument("-ml-no-me", "--ml-no-me", action="store_true",
                   help="start -ml from the raw NJ topology instead of "
                        "the minimum-evolution-NNI-improved one "
                        "(FastTree starts from an ME tree; this opts out)")
    o.add_argument("--approx", dest="approx_legacy", action="store_true",
                   default=False, help=argparse.SUPPRESS)  # reference
    # hidden legacy spelling of `-nj approx`
    o.add_argument("-seed", "--seed", type=int, default=0)
    common.add_out_args(p, default_prefix="jxtree")
    return p


def _write_phylip(path: str, D, labels) -> None:
    with open(path, "wt") as fh:
        fh.write(f"{len(labels)}\n")
        for i, lab in enumerate(labels):
            name = str(lab)[:10].ljust(10)
            fh.write(name + "  " + "  ".join(f"{v:.6f}" for v in D[i]) + "\n")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    common.warn_ignored_compat(parser, args)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "tree")

    import time

    import numpy as np

    phases: list = []
    t_phase = time.monotonic()

    def _mark(label: str) -> None:
        nonlocal t_phase
        now = time.monotonic()
        phases.append((label, now - t_phase))
        t_phase = now

    from janusx_tpu_torch.models.tree import (
        bootstrap_support, ibs_distance, neighbor_joining,
        read_fasta_alignment, weighted_jc_distance,
    )

    if args.approx_legacy and not args.nj:
        args.nj = "approx"
    if args.fasta:
        codes, labels = read_fasta_alignment(args.fasta)
        D = weighted_jc_distance(codes, np.ones(codes.shape[0]))
        distance = "jc"
        m, n = codes.shape
        samples = labels
    else:
        if not any((args.bfile, args.vcf, args.hmp, args.file)):
            raise SystemExit("a genotype input or -fa FASTA is required")
        from janusx_tpu_torch.io.gfreader import prepare_packed
        from janusx_tpu_torch.io.packed import QcParams

        pg = prepare_packed(
            common.resolve_genotype(args),
            QcParams(maf=args.maf, geno=args.geno, het=args.het),
        )
        D = ibs_distance(pg)
        codes = pg.dosages()
        distance = "ibs"
        m, n = pg.m, pg.n
        samples = [str(s) for s in pg.samples]
    _mark("read+distance")

    if args.nj and args.nj.startswith("bionj"):
        from janusx_tpu_torch.models.tree import bionj, bionj_stats

        var_mode = args.nj.split("-", 1)[1] if "-" in args.nj else "jc"
        n_states = 4 if args.fasta else 3
        Dv, V = bionj_stats(codes, n_states, var_mode=var_mode)
        newick = bionj(Dv, V, samples)
    elif args.nj == "approx":
        from janusx_tpu_torch.models.tree import rapid_neighbor_joining

        newick = rapid_neighbor_joining(D, samples)
    else:
        newick = neighbor_joining(D, samples)
    _mark("nj")
    base_nwk = newick  # unannotated topology; also the -ml start tree
    if args.bootstrap:
        newick = bootstrap_support(
            newick, codes, samples, n_boot=args.bootstrap,
            seed=args.seed, distance=distance,
        )
        _mark("nj-bootstrap")
    with open(prefix + ".nwk", "wt") as fh:
        fh.write(newick + "\n")
    if args.ml:
        from janusx_tpu_torch.models.mltree import (
            genotype_leaf_partials,
            ml_bootstrap_support,
            ml_refine_tree,
            to_newick,
        )

        if args.fasta:
            # 4-state JC partials from the nucleotide alignment
            sub = codes
            if sub.shape[0] > args.ml_sites:
                rng = np.random.default_rng(args.seed)
                rows = np.sort(rng.choice(sub.shape[0], args.ml_sites,
                                          replace=False))
                sub = sub[rows]
            parts = []
            for i in range(sub.shape[1]):
                P = np.ones((sub.shape[0], 4))
                known = sub[:, i] >= 0
                P[known] = 0.0
                P[known, sub[known, i]] = 1.0
                parts.append(P)
            k_states = 4
        else:
            parts = genotype_leaf_partials(
                codes, site_budget=args.ml_sites, seed=args.seed
            )
            k_states = 2
        if args.asc:
            # ascertainment-bias pseudo correction (reference -asc /
            # _apply_asc_pseudo_constant_sites): append k certain
            # constant sites PER STATE to every leaf partial, so the
            # SNP-only alignment stops implying infinite rates
            import os as _os

            k_pseudo = int(_os.environ.get("JANUSX_ASC_PSEUDO_CONST", "1"))
            if k_pseudo > 0:
                k_states = 4 if args.fasta else 2
                tail = np.zeros((k_states * k_pseudo, k_states))
                for st in range(k_states):
                    tail[st * k_pseudo:(st + 1) * k_pseudo, st] = 1.0
                parts = [np.vstack([P, tail]) for P in parts]
        # start from the user-selected (unannotated) NJ/BIONJ/approx
        # topology — recomputing exact NJ here would both ignore -nj and
        # redo the O(n^3) work -nj approx exists to avoid. Like FastTree,
        # the ML default start is that topology improved by
        # minimum-evolution NNIs on the distance matrix (-ml-no-me opts out)
        ml_start = base_nwk
        if not args.ml_no_me:
            from janusx_tpu_torch.models.mltree import me_nni_start

            ml_start = me_nni_start(base_nwk, D, samples)
            _mark("me-start")
        t = ml_refine_tree(ml_start, parts, samples, k=k_states,
                           rate_categories=args.ml_cat,
                           spr=not args.ml_no_spr)
        ml_nwk = to_newick(t)
        _mark("ml-refine")
        gamma_note = ""
        if args.ml_gamma:
            from janusx_tpu_torch.models.mltree import gamma20_rescale

            gll, g_alpha, g_scale = gamma20_rescale(
                t, t.partials, k=k_states)
            ml_nwk = to_newick(t)  # rescaled branch lengths
            gamma_note = (f"\tGamma20LogLk={gll:.2f}\talpha={g_alpha:.3f}"
                          f"\trescale={g_scale:.4f}")
            _mark("ml-gamma")
        if args.bootstrap:
            if args.support == "shlike":
                # SH-like/RELL local supports on the fitted ML tree
                # (reference --support shlike; FastTree SHSupport)
                from janusx_tpu_torch.models.mltree import (
                    shlike_support, to_newick_with_support,
                )

                sup = shlike_support(
                    t, t.partials, k=k_states, n_res=args.bootstrap,
                    seed=args.seed, rates=t.rates,
                )
                ml_nwk = to_newick_with_support(t, sup)
            else:
                # -b composes with -ml: replicates refine under weighted
                # site likelihoods; support maps onto the ML topology
                ml_nwk = ml_bootstrap_support(
                    ml_nwk, parts, samples, k=k_states,
                    n_boot=args.bootstrap, seed=args.seed,
                )
            _mark(f"ml-support-{args.support}")
        with open(prefix + ".ml.nwk", "wt") as fh:
            fh.write(ml_nwk + "\n")
        print(f"{prefix}.ml.nwk\tlogL={t.loglik:.2f}{gamma_note}")
    if args.write_dist:
        np.savetxt(prefix + f".{distance}.dist", D, fmt="%.6g", delimiter="\t")
        with open(prefix + f".{distance}.id", "wt") as fh:
            for s in samples:
                fh.write(f"{s}\n")
    if args.write_phylip:
        _write_phylip(prefix + ".phylip.dist", D, samples)
    if args.profile:
        _mark("write")
        with open(prefix + ".profile.tsv", "wt") as fh:
            fh.write("phase\tseconds\n")
            for label, secs in phases:
                fh.write(f"{label}\t{secs:.3f}\n")
        print(prefix + ".profile.tsv")
    print(f"{prefix}.nwk\t({n} samples, {m} sites)")
    return 0
