"""`jx postgarfield` — GARFIELD interaction visualization.

Reference: script/postgarfield.py — rule-score bars, interaction arcs
over a background GWAS Manhattan (-gwasfile, arcs connect rule endpoint
loci), circular Manhattan with interaction chords (-circle), and
GFF endpoint annotation (-gff).
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from janusx_tpu_torch.cli import common

_OPS = {"NOT", "AND", "XOR", "ANDN"}


def build_parser(prog="jx postgarfield") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="GARFIELD result plots")
    p.add_argument("-i", "--input", nargs="+", required=True,
                   help="rule table TSV(s) from `jx garfield`")
    p.add_argument("-top", "--top", type=int, default=20)
    p.add_argument("-gwasfile", "--gwasfile", nargs="+", default=None,
                   help="background GWAS TSV(s): Manhattan + interaction arcs")
    p.add_argument("-thr", "--thr", "-threshold", "--threshold",
                   dest="thr", type=float, default=None,
                   help="background GWAS significance line (raw p)")
    p.add_argument("-chr", "--chr", dest="chr_col", type=str, default="chrom")
    p.add_argument("-pos", "--pos", dest="pos_col", type=str, default="pos")
    p.add_argument("-pvalue", "--pvalue", type=str, default="pwald")
    p.add_argument("-snp", "--snp", dest="snp_col", type=str, default="snp")
    p.add_argument("-circle", "--circle", action="store_true",
                   help="circular Manhattan with interaction chords")
    p.add_argument("-interval", "--interval", type=float, default=0.5,
                   help="chromosome-gap ratio for the circular x axis [0,1]")
    p.add_argument("-gff", "--gff", type=str, default=None,
                   help="GFF3 for endpoint nearest-gene annotation")
    p.add_argument("-bed", "--bed", type=str, default=None,
                   help="BED-like intervals as the annotation source "
                        "instead of -gff (reference -bed)")
    p.add_argument("-fmt", "--fmt", dest="format", type=str, default="png",
                   choices=("png", "pdf", "svg", "tif"),
                   help="figure output format (reference -fmt)")
    p.add_argument("-fontsize", "--fontsize", type=float, default=None,
                   help="base font size")
    p.add_argument("-ylim", "--ylim", nargs="+", type=float, default=None,
                   help="y-range for the background Manhattan: MAX or "
                        "MIN MAX")
    p.add_argument("-circle-in", "--circle-in", dest="circle_dir",
                   action="store_const", const="in", default="out",
                   help="draw circular values toward the center")
    p.add_argument("-circle-out", "--circle-out", dest="circle_dir",
                   action="store_const", const="out",
                   help="values away from the center (default)")
    import argparse as _ap

    for names in (("-alpha", "--alpha"), ("-marker", "--marker"),
                  ("-palette", "--palette"),
                  ("-scatter-size", "--scatter-size"),
                  ("-circle-interval", "--circle-interval"),
                  ("-circle-lw", "--circle-lw"),
                  ("-fontstyle", "--fontstyle"),
                  ("-fontstype", "--fontstype")):
        p.add_argument(*names, type=str, default=None,
                       dest="cos_" + names[-1].strip("-").replace("-", "_"),
                       help=_ap.SUPPRESS)  # reference cosmetics accepted
    for names in (("-full", "--full"), ("-fullscatter", "--fullscatter")):
        p.add_argument(*names, action="store_true",
                       dest="cos_" + names[-1].strip("-").replace("-", "_"),
                       help=_ap.SUPPRESS)
    common.add_out_args(p, default_prefix="postgarfield")
    return p


def _rule_endpoints(rule: str) -> list:
    return [t for t in str(rule).split() if t not in _OPS]


def _genome_x(chrom, pos, gap_ratio=0.02):
    """Concatenated genome coordinate; returns (x, chrom_ticks, total)."""
    chrom = np.asarray(chrom, dtype=object).astype(str)
    pos = np.asarray(pos, np.float64)
    spans = {}
    for c in dict.fromkeys(chrom.tolist()):
        m = chrom == c
        spans[c] = (pos[m].min(), pos[m].max())
    total_bp = sum(b - a for a, b in spans.values())
    gap = gap_ratio * total_bp
    x = np.zeros(len(pos))
    ticks = []
    offset = 0.0
    for c, (a, b) in spans.items():
        m = chrom == c
        x[m] = offset + (pos[m] - a)
        ticks.append((c, offset + (b - a) / 2))
        offset += (b - a) + gap
    return x, ticks, offset - gap if spans else 0.0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "postgarfield")

    import matplotlib

    matplotlib.use("Agg")
    if args.fontsize:
        matplotlib.rcParams["font.size"] = float(args.fontsize)
    import matplotlib.pyplot as plt
    import pandas as pd

    gff = None
    if args.gff:
        from janusx_tpu_torch.utils.gff import GffIndex

        gff = GffIndex.from_file(args.gff)
    elif args.bed:
        from janusx_tpu_torch.utils.gff import GffIndex

        gff = GffIndex.from_bed(args.bed)

    gwas = None
    if args.gwasfile:
        gwas = pd.concat(
            [pd.read_csv(f, sep="\t") for f in args.gwasfile],
            ignore_index=True)
        snp_xy = {}
        gx, ticks, total = _genome_x(gwas[args.chr_col], gwas[args.pos_col])
        with np.errstate(divide="ignore"):
            glogp = -np.log10(np.clip(gwas[args.pvalue].to_numpy(float),
                                      1e-300, 1.0))
        for name, x in zip(gwas[args.snp_col].astype(str), gx):
            snp_xy[name] = x

    outputs = []
    for path in args.input:
        df = pd.read_csv(path, sep="\t")
        base = path.rsplit("/", 1)[-1].rsplit(".tsv", 1)[0]
        top = df.nlargest(args.top, "score")

        # 1) rule-score bars (significant rules highlighted)
        fig, ax = plt.subplots(figsize=(7, max(2.5, 0.3 * len(top))))
        colors = ["#C44E52" if p <= 0.05 else "#4C72B0" for p in top["pperm"]]
        ax.barh(range(len(top)), top["score"], color=colors)
        ax.set_yticks(range(len(top)))
        ax.set_yticklabels(top["rule"], fontsize=7)
        ax.invert_yaxis()
        ax.set_xlabel("rule score")
        ax.spines[["top", "right"]].set_visible(False)
        fig.tight_layout()
        out = f"{prefix}.{base}.rules.{args.format}"
        fig.savefig(out, dpi=150)
        plt.close(fig)
        outputs.append(out)

        # 2) endpoint annotation table
        if gff is not None or gwas is not None:
            rows = []
            pos_of = {}
            if gwas is not None:
                pos_of = {
                    str(s): (str(c), int(p)) for s, c, p in zip(
                        gwas[args.snp_col], gwas[args.chr_col],
                        gwas[args.pos_col])
                }
            for _, r in top.iterrows():
                for ep in _rule_endpoints(r["rule"]):
                    c_p = pos_of.get(ep)
                    gene = ""
                    if gff is not None and c_p is not None:
                        hits = gff.query(c_p[0], c_p[1])
                        if not hits:
                            g, _dist = gff.nearest(c_p[0], c_p[1])
                            hits = [g] if g is not None else []
                        gene = ",".join(h.name for h in hits[:2])
                    rows.append((r["rule"], ep,
                                 c_p[0] if c_p else "", c_p[1] if c_p else "",
                                 gene, r["score"], r["pperm"]))
            apath = f"{prefix}.{base}.endpoints.tsv"
            with open(apath, "wt") as fh:
                fh.write("rule\tendpoint\tchrom\tpos\tgenes\tscore\tpperm\n")
                for row in rows:
                    fh.write("\t".join(str(v) for v in row) + "\n")
            outputs.append(apath)

        # 3) linear Manhattan + interaction arcs
        if gwas is not None:
            fig, ax = plt.subplots(figsize=(10, 3.6))
            chrom_arr = gwas[args.chr_col].astype(str).to_numpy()
            colors2 = ("#9aa7bd", "#c5cdd9")
            for ci, c in enumerate(dict.fromkeys(chrom_arr.tolist())):
                m = chrom_arr == c
                ax.scatter(gx[m], glogp[m], s=3, lw=0, c=colors2[ci % 2])
            if args.thr:
                ax.axhline(-math.log10(args.thr), color="red", lw=0.7, ls="--")
            ymax = float(glogp.max()) if len(glogp) else 1.0
            for _, r in top.iterrows():
                eps = [snp_xy[e] for e in _rule_endpoints(r["rule"])
                       if e in snp_xy]
                for a, b in zip(eps[:-1], eps[1:]):
                    xm = 0.5 * (a + b)
                    h = ymax * (1.05 + 0.25 * abs(b - a) / max(total, 1.0))
                    t = np.linspace(0, 1, 40)
                    bez_x = (1 - t) ** 2 * a + 2 * (1 - t) * t * xm + t ** 2 * b
                    bez_y = 2 * (1 - t) * t * h
                    ax.plot(bez_x, glogp.max() * 0.02 + bez_y, lw=1.0,
                            color="#C44E52", alpha=0.75)
            ax.set_xticks([t for _, t in ticks])
            ax.set_xticklabels([c for c, _ in ticks], fontsize=8)
            ax.set_xlabel("Chromosome")
            ax.set_ylabel("-log10(p)")
            if args.ylim:
                ax.set_ylim(*((0.0, args.ylim[0]) if len(args.ylim) == 1
                              else (args.ylim[0], args.ylim[1])))
            ax.spines[["top", "right"]].set_visible(False)
            fig.tight_layout()
            out = f"{prefix}.{base}.arcs.{args.format}"
            fig.savefig(out, dpi=150)
            plt.close(fig)
            outputs.append(out)

            # 4) circular Manhattan with chords
            if args.circle:
                gap = max(0.0, min(1.0, args.interval)) * 0.05 + 0.005
                theta = gx / max(total, 1.0) * (2 * math.pi) * (1 - gap)
                r0, r1 = 0.55, 0.95
                frac = glogp / max(ymax, 1e-9)
                if args.circle_dir == "in":
                    frac = 1.0 - frac  # values grow toward the center
                rr = r0 + (r1 - r0) * frac
                fig, ax = plt.subplots(figsize=(6, 6),
                                       subplot_kw={"projection": "polar"})
                for ci, c in enumerate(dict.fromkeys(chrom_arr.tolist())):
                    m = chrom_arr == c
                    ax.scatter(theta[m], rr[m], s=2.5, lw=0,
                               c=colors2[ci % 2])
                for c, tk in ticks:
                    ax.text(tk / max(total, 1.0) * (2 * math.pi) * (1 - gap),
                            1.03, str(c), fontsize=7, ha="center")
                for _, r in top.iterrows():
                    eps = [snp_xy[e] for e in _rule_endpoints(r["rule"])
                           if e in snp_xy]
                    for a, b in zip(eps[:-1], eps[1:]):
                        ta = a / max(total, 1.0) * (2 * math.pi) * (1 - gap)
                        tb = b / max(total, 1.0) * (2 * math.pi) * (1 - gap)
                        t = np.linspace(0, 1, 50)
                        # chord through the center region (quadratic to r=0)
                        rad = (1 - t) ** 2 * r0 + t ** 2 * r0
                        ang = (1 - t) * ta + t * tb
                        ax.plot(ang, rad * (1 - 4 * 0.18 * t * (1 - t)),
                                lw=1.0, color="#C44E52", alpha=0.75)
                ax.set_xticks([])
                ax.set_yticks([])
                ax.spines["polar"].set_visible(False)
                out = f"{prefix}.{base}.circle.{args.format}"
                fig.savefig(out, dpi=150)
                plt.close(fig)
                outputs.append(out)

    print("\t".join(outputs))
    return 0
