"""`jx postgs` — post-GS summary and visualization.

Reference: python/janusx/script/postgs.py (-json summary, -effect model
effects with signed Manhattan, accuracy violins, accuracy-vs-runtime
scatter, pred-vs-obs) over bioplotkit/gsplot.py.
"""

from __future__ import annotations

import argparse
import json
import os

from janusx_tpu_torch.cli import common


def build_parser(prog="jx postgs") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="GS CV plots + tables")
    p.add_argument("-i", "-json", "--summary", "--json", dest="summary",
                   type=str, required=True,
                   help="{prefix}.gs.summary.json from `jx gs`")
    p.add_argument("-effect", "--effect", action="append", default=[],
                   metavar="FILE",
                   help="marker-effect TSV(s) ({prefix}.{trait}.{method}."
                        "effect.tsv) -> signed-effect Manhattan")
    p.add_argument("-effect-col", "--effect-col", type=str, default="effect",
                   help="effect column name in -effect files")
    p.add_argument("-oof", "--oof", action="append", default=[],
                   metavar="FILE",
                   help="{prefix}.{trait}.oof.tsv file(s) (observed + "
                        "out-of-fold CV predictions) -> pred-vs-obs plots")
    p.add_argument("-fmt", "--fmt", type=str, default="png",
                   help="comma list of image formats (png,pdf,svg)")
    # reference panel selectors: when any of -manh/-violin/-pcctime is
    # given, only the enabled JSON-driven panels render; the optional
    # spec is 'ratio [palette]' (e.g. -violin 1 tab10) and is accepted
    # for drop-in compatibility
    for flag in ("manh", "violin", "pcctime"):
        p.add_argument(f"-{flag}", f"--{flag}", dest=flag, nargs="*",
                       default=None, metavar="SPEC",
                       help=f"enable the {flag} panel (reference -{flag}; "
                            "optional 'ratio [palette]' spec)")
    p.add_argument("-palette", "--palette", "-pallete", "--pallete",
                   dest="palette", type=str, default=None,
                   help=argparse.SUPPRESS)  # reference global palette
    # (incl. its historical misspelling)
    p.add_argument("-scatter-size", "--scatter-size", dest="scatter_size",
                   type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("-full", "--full", "-fullscatter", "--fullscatter",
                   dest="fullscatter", action="store_true",
                   help=argparse.SUPPRESS)  # nothing is downsampled here
    common.add_out_args(p, default_prefix="postgs")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "postgs")

    from janusx_tpu_torch.plots.gsplots import (
        accuracy_runtime_scatter, accuracy_violin, cv_fold_bars,
        pred_vs_obs_plot, signed_effect_manhattan,
    )

    fmts = [f.strip().lstrip(".") for f in args.fmt.split(",") if f.strip()]

    def out(name: str) -> list:
        return [f"{prefix}.{name}.{f}" for f in fmts]

    summary = json.load(open(args.summary))
    rows = []
    violin_data = {}
    runtime_pts = []
    for trait, methods in summary.get("traits", {}).items():
        violin_data[trait] = {}
        for method, info in methods.items():
            cv = info.get("cv", {})
            folds = info.get("folds", [])
            rows.append(
                (trait, method, info.get("route", method),
                 cv.get("pearson"), cv.get("spearman"), cv.get("r2"))
            )
            if folds:
                for path in out(f"{trait}.{method}.cv"):
                    cv_fold_bars(folds, path, metric="pearson")
                violin_data[trait][method] = [
                    f.get("pearson", float("nan")) for f in folds]
            sec = info.get("cv_seconds")
            if sec is not None and cv.get("pearson") is not None:
                label = f"{trait}:{method}" if len(summary["traits"]) > 1 else method
                runtime_pts.append((label, float(sec), float(cv["pearson"])))
    selective = any(x is not None for x in (args.manh, args.violin,
                                            args.pcctime))
    want_violin = (args.violin is not None) if selective else True
    want_pcc = (args.pcctime is not None) if selective else True
    want_manh = (args.manh is not None) if selective else True
    if want_violin and any(violin_data.values()):
        for path in out("cv.violin"):
            accuracy_violin(violin_data, path)
    if want_pcc and runtime_pts:
        for path in out("cv.runtime"):
            accuracy_runtime_scatter(runtime_pts, path)

    for path in args.oof:
        import pandas as pd

        df = pd.read_csv(path, sep="\t", index_col=0)
        base = os.path.basename(path).replace(".oof.tsv", "")
        obs = df["observed"].to_numpy(float)
        for method in [c for c in df.columns if c != "observed"]:
            for opath in out(f"{base}.{method}.pred"):
                pred_vs_obs_plot(obs, df[method].to_numpy(float), opath,
                                 title=f"{base} {method}")

    for path in (args.effect if want_manh else []):
        import pandas as pd

        df = pd.read_csv(path, sep="\t")
        col = args.effect_col if args.effect_col in df.columns else (
            "effect" if "effect" in df.columns else df.columns[-1])
        base = os.path.basename(path).replace(".effect.tsv", "").replace(".tsv", "")
        for opath in out(f"{base}.effects"):
            signed_effect_manhattan(df["chrom"], df["pos"], df[col], opath,
                                    title=base)

    table = f"{prefix}.gs.metrics.tsv"
    with open(table, "wt") as fh:
        fh.write("trait\tmethod\troute\tpearson\tspearman\tr2\n")
        for r in rows:
            fh.write("\t".join("" if v is None else str(v) for v in r) + "\n")
    print(table)
    return 0
