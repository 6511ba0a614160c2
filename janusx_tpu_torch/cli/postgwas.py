"""`jx postgwas` — Manhattan/QQ plots and top-hit tables from assoc TSVs
(reference: python/janusx/script/postgwas.py)."""

from __future__ import annotations

import argparse
import glob
import os


from janusx_tpu_torch.cli import common


def build_parser(prog="jx postgwas") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Post-GWAS plots + tables")
    p.add_argument("-i", "-gwasfile", "--gwasfile", "--input",
                   dest="input", type=str, required=True, nargs="+",
                   help="assoc TSV file(s) or glob(s) (reference also "
                        "spells this -gwasfile)")
    p.add_argument("-sig", "--sig", "-thr", "--thr", "-threshold",
                   "--threshold", dest="sig", type=float, default=None,
                   help="significance threshold p (default 0.05/m "
                   "Bonferroni) — reference -thr/-threshold aliases")
    p.add_argument("-top", "--top", type=int, default=20, help="top-hit table rows")
    p.add_argument("-pcol", "--pcol", "-pvalue", "--pvalue", dest="pcol",
                   type=str, default="pwald", help="p-value column name")
    p.add_argument("-chr", "--chr", dest="chrcol", type=str, default="chrom",
                   help="chromosome column name")
    p.add_argument("-pos", "--pos", dest="poscol", type=str, default="pos",
                   help="position column name")
    p.add_argument("-manh", "--manh", type=str, nargs="?", const="2",
                   default=None, metavar="RATIO",
                   help="enable Manhattan rendering with a width/height "
                        "aspect (e.g. 2, 3/2); when -manh or -qq is given "
                        "explicitly, only the enabled panels render "
                        "(reference -manh)")
    p.add_argument("-qq", "--qq", type=str, nargs="?", const="5/4",
                   default=None, metavar="RATIO",
                   help="enable QQ rendering with an aspect (reference -qq)")
    p.add_argument("-interval", "--interval", type=float, default=None,
                   help="chromosome-gap ratio in [0,1] for the Manhattan "
                        "x axis: gap = ratio * median(chrom length)/10 "
                        "(reference -interval; default: legacy 2%% gaps)")
    p.add_argument("-palette", "--palette", type=str, default=None,
                   help="per-chromosome colors: cmap name or ';'-list "
                        "(reference -palette)")
    p.add_argument("-scatter-size", "--scatter-size", dest="scatter_size",
                   type=float, default=None,
                   help="scatter point size (reference -scatter-size)")
    p.add_argument("-alpha", "--alpha", type=float, default=None,
                   help="scatter alpha (reference -alpha)")
    p.add_argument("-marker", "--marker", type=str, default=None,
                   help="matplotlib marker for scatter points")
    p.add_argument("-fontsize", "--fontsize", type=float, default=None,
                   help="base font size for all panels")
    p.add_argument("-fontstyle", "--fontstyle", "-fontstype", "--fontstype",
                   dest="fontfamily", type=str, default=None,
                   help=argparse.SUPPRESS)  # reference font-family knobs
    p.add_argument("-full", "--full", "-fullscatter", "--fullscatter",
                   dest="fullscatter", action="store_true",
                   help=argparse.SUPPRESS)  # reference downsampling
    # toggles; nothing is downsampled here, so these are no-ops
    p.add_argument("-anno", "--anno", "-a", type=int, nargs="?", const=10,
                   default=None, metavar="N",
                   help="annotate the top N hits on the Manhattan with "
                        "their nearest gene (needs -gff or -bed; "
                        "reference -anno/-a)")
    p.add_argument("-bed", "--bed", type=str, default=None,
                   help="BED-like interval annotation source (chrom start "
                        "end [name]) as an alternative to -gff "
                        "(reference -bed)")
    p.add_argument("-manh-merge", "--manh-merge", action="store_true",
                   help="one merged figure of stacked Manhattan panels "
                   "for all -i inputs (shared chromosome axis)")
    p.add_argument("-qq-merge", "--qq-merge", action="store_true",
                   help="one overlaid QQ figure for all -i inputs "
                   "(per-file lambda_GC in the legend)")
    p.add_argument("-circle", "--circle", action="store_true",
                   help="circular (Circos-style) Manhattan: one "
                   "concentric ring per -i input")
    p.add_argument("-circle-in", "--circle-in", dest="circle_dir",
                   action="store_const", const="in", default="out",
                   help="draw circular Manhattan values toward the center")
    p.add_argument("-circle-out", "--circle-out", dest="circle_dir",
                   action="store_const", const="out",
                   help="values away from the center (default)")
    p.add_argument("-circle-interval", "--circle-interval", type=float,
                   default=None,
                   help="inter-chromosome gap scale for -circle "
                        "(reference -circle-interval)")
    p.add_argument("-circle-lw", "--circle-lw", dest="circle_lw",
                   type=float, default=None,
                   help="ring/chord line width for -circle")
    p.add_argument("-interact", "--interact", nargs="+", default=None,
                   metavar=("FILE", "SPEC"),
                   help="interaction source for the circular Manhattan: "
                        "a GARFIELD rules TSV (rule endpoints become "
                        "chords) or a pair table with an optional "
                        "'snp;chrom;pos;pvalue;group1;group2' column "
                        "spec (reference -interact)")
    p.add_argument("-LDclump", "--LDclump", dest="ldclump", nargs=2,
                   default=None, metavar=("WINDOW", "R2"),
                   help="LD-clump significant hits: window (bp or e.g. "
                   "250kb) and r^2 cutoff; needs a genotype input for "
                   "r^2 against each index SNP")
    p.add_argument("-bimrange", "--bimrange", action="append", default=None,
                   metavar="CHR:START-END",
                   help="restrict plotted/processed rows to ranges "
                   "(repeatable; values < 1e5 are Mb)")
    p.add_argument("-ylim", "--ylim", nargs="+", type=float, default=None,
                   help="y-range for Manhattan/QQ: MAX or MIN MAX")
    p.add_argument("-fmt", "--fmt", dest="format", type=str, default="png",
                   choices=("png", "pdf", "svg", "tif"),
                   help="figure output format")
    p.add_argument("-gff", "--gff", type=str, default=None,
                   help="GFF3 file: annotate top hits with overlapping/nearest genes")
    p.add_argument("-ldblock", "--ldblock", type=str, default=None, metavar="CHR:START-END",
                   help="draw an LD r² heatmap for a region (needs a genotype input)")
    p.add_argument("-ldblock-all", "--ldblock-all", dest="ldblock_all",
                   type=str, nargs="?", const="2", default=None,
                   metavar="RATIO",
                   help="LD heatmap of ALL SNPs inside -bimrange with an "
                        "aspect ratio (reference -ldblock-all; needs "
                        "-bimrange and a genotype input)")
    p.add_argument("-ldblock-palette", "--ldblock-palette",
                   dest="ldblock_palette", type=str, default=None,
                   help="heatmap colormap: matplotlib name or "
                        "';'-separated ramp (reference -ldblock-palette)")
    p.add_argument("-region", "--region", type=str, default=None, metavar="CHR:START-END",
                   help="regional association + gene-model plot (needs -gff)")
    p.add_argument("-autoregion", "--autoregion", nargs="?", const=3, type=int,
                   default=None, metavar="K",
                   help="LocusZoom-style reports for the top K independent "
                        "loci (LD-colored when a genotype input is given)")
    p.add_argument("-region-window", "--region-window", type=int,
                   default=250_000, help="half-window around each locus (bp)")
    p.add_argument("-jobs", "--jobs", type=int, default=None,
                   help="process-pool size for per-file Manhattan/QQ "
                        "rendering (default: min(4, files, cpus))")
    p.add_argument("-report", "--report", action="store_true",
                   help="bundle Manhattan + QQ + top-hit table + locus "
                        "pages into one PDF per input file (uses "
                        "-autoregion settings for the locus pages)")
    p.add_argument("-hap", "--hap", type=str, default=None, metavar="CHR:POS[,CHR:POS...]",
                   help="haplotype phenotype plot at the given SNP position(s) "
                   "(needs a genotype input and -p)")
    p.add_argument("-p", "--pheno", type=str, default=None,
                   help="phenotype file (for -hap)")
    p.add_argument("-n", "--ncol", type=str, default=None,
                   help="trait selector for -hap")
    p.add_argument("-hap-mode", "--hap-mode", type=str, default="continuous",
                   choices=["continuous", "binomial"])
    from janusx_tpu_torch.cli.common import add_genotype_args

    g = add_genotype_args(p, required=False)
    common.add_out_args(p, default_prefix="postgwas")
    return p


def _read_assoc(path: str, pcol: str, chrcol: str = "chrom",
                poscol: str = "pos", ranges=None):
    import pandas as pd

    df = pd.read_csv(path, sep="\t")
    required = {chrcol, poscol, pcol}
    if not required.issubset(df.columns):
        # ValueError, not SystemExit: SystemExit escapes the mp.Pool worker
        # loop (which catches only Exception) and hangs pool.map forever
        raise ValueError(f"{path}: missing columns {required - set(df.columns)}")
    if chrcol != "chrom" or poscol != "pos":
        df = df.rename(columns={chrcol: "chrom", poscol: "pos"})
    if ranges:
        import numpy as np

        mask = np.zeros(len(df), bool)
        for spec in ranges:
            c, rest = str(spec).split(":", 1)
            a_s, b_s = rest.replace(":", "-").split("-", 1)
            a, b = float(a_s), float(b_s)
            lo = int(a * 1e6) if a < 1e5 else int(a)
            hi = int(b * 1e6) if b < 1e5 else int(b)
            mask |= ((df["chrom"].astype(str) == c.strip())
                     & (df["pos"] >= lo) & (df["pos"] <= hi)).to_numpy()
        df = df[mask]
        if not len(df):
            raise ValueError(f"{path}: no rows inside -bimrange")
    return df


def _tags_for(paths: list) -> list:
    """Per-input output tags; same-basename inputs from different dirs get
    the parent directory folded in so outputs never silently collide."""
    base = [
        os.path.basename(p).replace(".assoc.tsv", "").replace(".tsv", "")
        for p in paths
    ]
    seen: dict = {}
    for t in base:
        seen[t] = seen.get(t, 0) + 1
    out = []
    used: set = set()
    for p, t in zip(paths, base):
        if seen[t] > 1:
            parent = os.path.basename(os.path.dirname(os.path.abspath(p)))
            t = f"{parent}.{t}" if parent else t
        while t in used:
            t += "_dup"
        used.add(t)
        out.append(t)
    return out


def _parse_aspect(spec):
    """Aspect RATIO string ('2', '3/2', '5:4') -> float or None."""
    if spec is None:
        return None
    s = str(spec).replace(":", "/")
    if "/" in s:
        a, b = s.split("/", 1)
        return float(a) / float(b)
    return float(s)


def _anno_index(style):
    """Interval index from -gff or -bed (None when neither given)."""
    from janusx_tpu_torch.utils.gff import GffIndex

    if style.get("gff"):
        return GffIndex.from_file(style["gff"])
    if style.get("bed"):
        return GffIndex.from_bed(style["bed"])
    return None


def _render_one(task: tuple) -> tuple:
    """Manhattan + QQ + annotated top table for ONE assoc TSV.

    Top-level (picklable) so multiple files render in a process pool —
    reference postgwas parallel plotting (postgwas.py:581)."""
    (path, tag, pcol, prefix, sig, top_n, chrcol, poscol,
     ranges, fmt, ylim, style) = task
    import matplotlib

    matplotlib.use("Agg")
    if style.get("fontsize"):
        matplotlib.rcParams["font.size"] = float(style["fontsize"])
    if style.get("fontfamily"):
        matplotlib.rcParams["font.family"] = style["fontfamily"]
    from janusx_tpu_torch.plots.gwasplots import manhattan_plot, qq_plot

    df = _read_assoc(path, pcol, chrcol, poscol, ranges)
    gi = _anno_index(style)
    top = df.nsmallest(top_n, pcol).copy()
    if gi is not None:
        genes, dists = [], []
        for _, row in top.iterrows():
            g, d = gi.nearest(str(row["chrom"]), int(row["pos"]))
            genes.append("" if g is None else g.name)
            dists.append("" if d is None else d)
        top["gene"] = genes
        top["gene_dist"] = dists
    man = qq = None
    lam = float("nan")
    if style.get("render_manh", True):
        annotate = None
        if style.get("anno") and gi is not None and "gene" in top.columns:
            rows = top.head(int(style["anno"]))
            annotate = list(zip(rows["chrom"], rows["pos"], rows["gene"]))
        man = f"{prefix}.{tag}.manhattan.{fmt}"
        manhattan_plot(
            df["chrom"].to_numpy(), df["pos"].to_numpy(),
            df[pcol].to_numpy(), man, sig_line=sig, title=tag, ylim=ylim,
            ratio=style.get("manh_ratio"), palette=style.get("palette"),
            scatter_size=style.get("scatter_size"),
            alpha=style.get("alpha"), marker=style.get("marker"),
            gap_ratio=style.get("interval"), annotate=annotate,
        )
    if style.get("render_qq", True):
        qq = f"{prefix}.{tag}.qq.{fmt}"
        lam = qq_plot(df[pcol].to_numpy(), qq, title=tag, ylim=ylim,
                      ratio=style.get("qq_ratio"),
                      scatter_size=style.get("scatter_size"),
                      alpha=style.get("alpha"), marker=style.get("marker"))
    top_path = f"{prefix}.{tag}.top.tsv"
    top.to_csv(top_path, sep="\t", index=False)
    return tag, lam, man, qq, top_path


def _interact_chords(spec_args: list, assoc_df) -> list:
    """-interact FILE [SPEC] -> [(chrom1, pos1, chrom2, pos2)] chord
    pairs for the circular Manhattan. SPEC names the columns
    'snp;chrom;pos;pvalue;group1;group2' (reference GARFIELD-compatible
    default). A `rule` column marks a GARFIELD rules table whose
    endpoint tokens (and group1/group2 tokens without their own
    chrom/pos columns) resolve through the assoc table's snp column."""
    import pandas as pd

    path = spec_args[0]
    cols = (spec_args[1].split(";") if len(spec_args) > 1
            else ["snp", "chrom", "pos", "pvalue", "group1", "group2"])
    tbl = pd.read_csv(path, sep="\t")
    by_snp: dict = {}
    if "snp" in assoc_df.columns:
        snp = assoc_df["snp"].astype(str).to_numpy()
        ch = assoc_df["chrom"].astype(str).to_numpy()
        po = assoc_df["pos"].to_numpy(float)
        by_snp = {s: (c, p) for s, c, p in zip(snp, ch, po)}

    def resolve(tok):
        return by_snp.get(str(tok))

    chords: list = []
    if "rule" in tbl.columns:
        ops = {"AND", "OR", "XOR", "NOT", "AND-NOT", "&", "|", "^"}
        for rule in tbl["rule"].astype(str):
            toks = [t for t in rule.split() if t.upper() not in ops]
            pts = [resolve(t) for t in toks]
            pts = [p for p in pts if p is not None]
            for (c1, p1), (c2, p2) in zip(pts[:-1], pts[1:]):
                chords.append((c1, p1, c2, p2))
        return chords
    g1, g2 = cols[4], cols[5]
    if g1 not in tbl.columns or g2 not in tbl.columns:
        raise SystemExit(
            f"-interact: {path} has neither a 'rule' column nor the "
            f"'{g1}'/'{g2}' pair columns of the spec")
    c_snp, c_chr, c_pos = cols[0], cols[1], cols[2]
    if c_snp in tbl.columns and c_chr in tbl.columns and c_pos in tbl.columns:
        for _, r in tbl.iterrows():
            by_snp[str(r[c_snp])] = (str(r[c_chr]), float(r[c_pos]))
    for _, r in tbl.iterrows():
        a, b = resolve(r[g1]), resolve(r[g2])
        if a is not None and b is not None:
            chords.append((a[0], a[1], b[0], b[1]))
    return chords


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "postgwas")

    paths = []
    for pat in args.input:
        hits = sorted(glob.glob(pat))
        paths.extend(hits if hits else [pat])
    tags = _tags_for(paths)

    # every feature block below reads the assoc table with identical
    # arguments — parse each file once (pool workers read their own copy)
    assoc_cache: dict = {}

    def _read_cached(path):
        if path not in assoc_cache:
            assoc_cache[path] = _read_assoc(
                path, args.pcol, args.chrcol, args.poscol, args.bimrange)
        return assoc_cache[path]
    ylim = None
    if args.ylim:
        ylim = ((0.0, args.ylim[0]) if len(args.ylim) == 1
                else (args.ylim[0], args.ylim[1]))
    # -manh/-qq are reference-style panel selectors with aspect ratios:
    # if either is given explicitly, only the enabled panels render
    selective = args.manh is not None or args.qq is not None
    style = {
        "render_manh": (args.manh is not None) if selective else True,
        "render_qq": (args.qq is not None) if selective else True,
        "manh_ratio": _parse_aspect(args.manh),
        "qq_ratio": _parse_aspect(args.qq),
        "palette": args.palette, "scatter_size": args.scatter_size,
        "alpha": args.alpha, "marker": args.marker,
        "interval": args.interval, "fontsize": args.fontsize,
        "fontfamily": args.fontfamily, "anno": args.anno,
        "gff": args.gff, "bed": args.bed,
    }
    tasks = [
        (path, tag, args.pcol, prefix, args.sig, args.top,
         args.chrcol, args.poscol, args.bimrange, args.format, ylim, style)
        for path, tag in zip(paths, tags)
    ]
    jobs = args.jobs
    if jobs is None:
        jobs = min(4, len(tasks), os.cpu_count() or 1)
    outputs = []
    if jobs > 1 and len(tasks) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(jobs) as pool:
            results = pool.map(_render_one, tasks)
    else:
        results = [_render_one(t) for t in tasks]
    for tag, lam, man, qq, top_path in results:
        outputs += [x for x in (man, qq, top_path) if x]
        lead = man or qq or top_path
        lam_txt = f"lambda_GC={lam:.3f}\t" if qq else ""
        print(f"{tag}\t{lam_txt}{lead}")
    if args.manh_merge or args.qq_merge or args.circle:
        panels = []
        for path, tag in zip(paths, tags):
            df = _read_cached(path)
            panels.append((tag, df["chrom"].to_numpy(),
                           df["pos"].to_numpy(), df[args.pcol].to_numpy()))
        if args.manh_merge:
            from janusx_tpu_torch.plots.gwasplots import manhattan_merge_plot

            out = f"{prefix}.manhattan.merge.{args.format}"
            manhattan_merge_plot(panels, out, sig_line=args.sig, ylim=ylim)
            print(out)
        if args.qq_merge:
            from janusx_tpu_torch.plots.gwasplots import qq_merge_plot

            out = f"{prefix}.qq.merge.{args.format}"
            lams = qq_merge_plot(
                [(t, p) for t, _, _, p in panels], out, ylim=ylim)
            print(out + "\t" + " ".join(
                f"{t}:lambda={v:.3f}" for t, v in lams.items()))
        if args.circle:
            from janusx_tpu_torch.plots.gwasplots import circular_manhattan

            chords = None
            if args.interact:
                chords = _interact_chords(args.interact,
                                          _read_cached(paths[0]))
            out = f"{prefix}.circle.{args.format}"
            circular_manhattan(panels, out, sig_line=args.sig,
                               direction=args.circle_dir, chords=chords,
                               gap_ratio=args.circle_interval,
                               lw=args.circle_lw)
            print(out)
    if args.ldclump:
        from janusx_tpu_torch.models.ldprune import ld_clump

        win_s, r2_s = args.ldclump
        wl = str(win_s).lower()
        if wl.endswith("kb"):
            window = int(float(wl[:-2]) * 1e3)
        elif wl.endswith("mb"):
            window = int(float(wl[:-2]) * 1e6)
        else:
            window = int(float(wl))
        r2_cut = float(r2_s)
        pg_clump = None
        geno = common.resolve_genotype_optional(args)
        if geno is not None:
            from janusx_tpu_torch.io.gfreader import load_raw_packed
            from janusx_tpu_torch.io.packed import QcParams

            pg_clump = load_raw_packed(geno).prepare(
                QcParams(maf=0.0, geno=1.0))
        for path, tag in zip(paths, tags):
            df = _read_cached(path)
            m = max(int(df[args.pcol].notna().sum()), 1)
            thr = args.sig if args.sig is not None else 0.05 / m
            clumps = ld_clump(
                pg_clump, df["chrom"].to_numpy(), df["pos"].to_numpy(),
                df[args.pcol].to_numpy(), thr=thr, window_bp=window,
                r2_cut=r2_cut,
            )
            out = f"{prefix}.{tag}.clumped.tsv"
            snp_col = df["snp"] if "snp" in df.columns else None
            with open(out, "wt") as fh:
                fh.write("chrom\tpos\tsnp\tp\tn_members\tmembers\n")
                for c in clumps:
                    names = (
                        [str(snp_col.iloc[j]) for j in c["members"]]
                        if snp_col is not None else
                        [f"{df['chrom'].iloc[j]}:{df['pos'].iloc[j]}"
                         for j in c["members"]]
                    )
                    lead_name = names[0]
                    fh.write(
                        f"{c['chrom']}\t{c['pos']}\t{lead_name}\t"
                        f"{c['p']:.4e}\t{len(c['members'])}\t"
                        + ";".join(names) + "\n")
            print(f"{out}\t{len(clumps)} clumps (window={window}bp "
                  f"r2>={r2_cut}, thr={thr:.3g})")
    if args.ldblock_all and not args.ldblock:
        # reference -ldblock-all: the region comes from -bimrange
        if not args.bimrange:
            raise SystemExit("-ldblock-all requires -bimrange")
        spec = str(args.bimrange[0])
        c, rest = spec.split(":", 1)
        a_s, b_s = rest.replace(":", "-").split("-", 1)
        a, b = float(a_s), float(b_s)
        lo_ = int(a * 1e6) if a < 1e5 else int(a)
        hi_ = int(b * 1e6) if b < 1e5 else int(b)
        args.ldblock = f"{c.strip()}:{lo_}-{hi_}"
    if args.ldblock:
        import numpy as np

        from janusx_tpu_torch.io.gfreader import load_raw_packed
        from janusx_tpu_torch.io.packed import QcParams
        from janusx_tpu_torch.models.ldprune import r2_matrix
        from janusx_tpu_torch.plots.structure import ld_heatmap

        chrom, span = args.ldblock.split(":")
        lo, hi = (int(x) for x in span.split("-"))
        geno = common.resolve_genotype_optional(args)
        if geno is None:
            raise SystemExit("-ldblock needs a genotype input (-bfile/-vcf/...)")
        raw = load_raw_packed(geno)
        pg = raw.prepare(QcParams(maf=0.01, geno=0.2))
        sel = np.nonzero(
            (pg.sites.chrom.astype(str) == chrom)
            & (pg.sites.pos >= lo) & (pg.sites.pos <= hi)
        )[0]
        if len(sel) < 2:
            raise SystemExit(f"no markers in region {args.ldblock}")
        if len(sel) > 400:
            sel = sel[:: len(sel) // 400 + 1]
        r2 = r2_matrix(pg.take_snps(sel))
        path = f"{prefix}.ldblock.{chrom}_{lo}_{hi}.{args.format}"
        ld_heatmap(r2, path, title=f"{chrom}:{lo}-{hi} ({len(sel)} SNPs)",
                   cmap=args.ldblock_palette,
                   ratio=_parse_aspect(args.ldblock_all))
        print(path)
    if args.region:
        if not args.gff:
            raise SystemExit("-region needs -gff for the gene-model track")
        import numpy as np

        from janusx_tpu_torch.plots.geneplot import gene_model_plot

        chrom, span = args.region.split(":")
        lo, hi = (int(x) for x in span.split("-"))
        assoc = None
        if paths:
            df = _read_cached(paths[0])
            sub = df[(df["chrom"].astype(str) == chrom)
                     & (df["pos"] >= lo) & (df["pos"] <= hi)]
            if len(sub):
                assoc = (sub["pos"].to_numpy(),
                         -np.log10(np.maximum(sub[args.pcol].to_numpy(), 1e-300)))
        path = f"{prefix}.region.{chrom}_{lo}_{hi}.png"
        # -sig is a raw p-value everywhere; this panel's axis is -log10(p)
        sig_nlp = (
            None if args.sig is None
            else float(-np.log10(max(args.sig, 1e-300)))
        )
        ngenes = gene_model_plot(
            args.gff, chrom, lo, hi, path, assoc=assoc,
            sig_line=sig_nlp, title=f"{chrom}:{lo}-{hi}",
        )
        print(f"{path}\t{ngenes} gene models")
    locus_pages: dict = {}  # input path -> locus PNGs rendered THIS run
    if args.autoregion:
        import numpy as np

        from janusx_tpu_torch.plots.regionreport import pick_loci, region_report

        pg = None
        geno = common.resolve_genotype_optional(args)
        if geno is not None:
            from janusx_tpu_torch.io.gfreader import load_raw_packed
            from janusx_tpu_torch.io.packed import QcParams

            pg = load_raw_packed(geno).prepare(QcParams(maf=0.01, geno=0.2))
        for path, tag in zip(paths, tags):
            df = _read_cached(path)
            m = max(int(np.isfinite(df[args.pcol]).sum()), 1)
            # region_report's sig_line sits on the -log10 axis; -sig is a
            # raw p-value (same semantics as the Manhattan panel)
            sig_p = args.sig if args.sig is not None else 0.05 / m
            sig = -np.log10(max(sig_p, 1e-300))
            loci = pick_loci(
                df["chrom"].to_numpy(), df["pos"].to_numpy(),
                df[args.pcol].to_numpy(), n_loci=args.autoregion,
                window=args.region_window,
            )
            if not loci:
                print(f"{tag}\tno loci below 1e-4; no region reports")
            for chrom, center in loci:
                out = f"{prefix}.{tag}.locus.{chrom}_{center}.png"
                info = region_report(
                    df, chrom, center, out, pcol=args.pcol,
                    window=args.region_window, gff_path=args.gff, pg=pg,
                    sig_line=sig,
                )
                locus_pages.setdefault(path, []).append(out)
                print(f"{out}\tlead={info['lead']}\tgenes={info['n_genes']}"
                      f"\tsnps={info['n_snps']}")
    if args.report:
        # one multi-page PDF per input: Manhattan, QQ, top-hit table,
        # then any locus pages produced above (reference postgwas
        # region-report bundles)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.image as mpimg
        import matplotlib.pyplot as plt
        import pandas as pd
        from matplotlib.backends.backend_pdf import PdfPages

        for (path, *_), (tag, lam, man, qq, top_path) in zip(tasks, results):
            pdf_path = f"{prefix}.{tag}.report.pdf"
            # only locus pages rendered THIS run — a directory glob would
            # bundle stale pages from earlier runs with other settings
            locus_pngs = locus_pages.get(path, [])
            with PdfPages(pdf_path) as pdf:
                for img_path in [x for x in (man, qq) if x] + locus_pngs:
                    img = mpimg.imread(img_path)
                    h, w = img.shape[:2]
                    fig = plt.figure(figsize=(10, 10 * h / w))
                    ax = fig.add_axes([0, 0, 1, 1])
                    ax.imshow(img)
                    ax.axis("off")
                    pdf.savefig(fig)
                    plt.close(fig)
                top = pd.read_csv(top_path, sep="\t")
                fig, ax = plt.subplots(figsize=(10, 0.32 * len(top) + 1.2))
                ax.axis("off")
                cols = [c for c in top.columns if c not in ("allele0", "allele1")]
                cell = [[f"{v:.3g}" if isinstance(v, float) else str(v)
                         for v in row] for row in top[cols].itertuples(index=False)]
                tbl = ax.table(cellText=cell, colLabels=cols, loc="center")
                tbl.auto_set_font_size(False)
                tbl.set_fontsize(7)
                ax.set_title(f"{tag}: top hits (λ_GC={lam:.3f})", fontsize=10)
                pdf.savefig(fig)
                plt.close(fig)
            print(pdf_path)
    if args.hap:
        import numpy as np

        from janusx_tpu_torch.io.gfreader import load_raw_packed
        from janusx_tpu_torch.io.packed import QcParams
        from janusx_tpu_torch.io.pheno import load_phenotype
        from janusx_tpu_torch.plots.haplotype import haplotype_groups, plot_haplotype

        geno = common.resolve_genotype_optional(args)
        if geno is None or not args.pheno:
            raise SystemExit("-hap needs a genotype input and -p phenotype")
        raw = load_raw_packed(geno)
        pg = raw.prepare(QcParams(maf=0.0, geno=1.0))
        targets = []
        for tok in args.hap.split(","):
            chrom, pos = tok.split(":")
            hit = np.nonzero((pg.sites.chrom.astype(str) == chrom)
                             & (pg.sites.pos == int(pos)))[0]
            if not len(hit):
                raise SystemExit(f"-hap: no marker at {tok}")
            targets.append(int(hit[0]))
        sub = pg.take_snps(np.asarray(targets))
        alleles = list(zip(sub.sites.allele0, sub.sites.allele1))
        groups = haplotype_groups(sub.dosages(), alleles=alleles)
        ph = load_phenotype(args.pheno).select(common.parse_traits(args.ncol))
        y_all, _ = ph.align(pg.samples)
        for ti, trait in enumerate(ph.traits):
            path = f"{prefix}.hap.{trait}.png"
            res = plot_haplotype(
                y_all[:, ti], groups, path, mode=args.hap_mode,
                title=f"{trait} @ {args.hap}",
            )
            print(f"{path}\t{len(res['groups'])} haplotypes\t{res['test']}")
    return 0
