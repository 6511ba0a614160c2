"""`jx gspredict` — apply a saved .jxmodel.npz to a new genotype panel."""

from __future__ import annotations

import argparse

from janusx_tpu_torch.cli import common


def build_parser(prog="jx gspredict") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Predict gebv from a saved model")
    p.add_argument("-model", "--model", type=str, required=True, help=".jxmodel.npz file")
    common.add_genotype_args(p)
    common.add_out_args(p, default_prefix="gspred")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)

    from janusx_tpu_torch.gs.model_io import load_marker_model, predict_new_panel
    from janusx_tpu_torch.io.gfreader import load_genotype_file

    model = load_marker_model(args.model)
    gd = load_genotype_file(common.resolve_genotype(args))
    pred, report = predict_new_panel(model, gd)
    path = prefix + ".gebv.tsv"
    with open(path, "wt") as fh:
        fh.write("sample\tgebv\n")
        for s, v in zip(gd.samples, pred):
            fh.write(f"{s}\t{v:.4f}\n")
    print(
        f"{path}\tmatched={report['matched']} swapped={report['swapped']}"
        f" mismatched={report['mismatched']} of {report['model_snps']}"
    )
    return 0
