"""`jx pca` — principal components (reference: python/janusx/script/pca.py).

Routes: eigh of the GRM (default), direct randomized SVD on packed
genotypes (-approx / -rsvd [power]), PCA of an existing GRM file (-k),
or visualization-only from existing results (-c). Writes
{prefix}.eigenvec / {prefix}.eigenval; -plot draws PC1/PC2 and PC1/PC3
scatters (grouped via -group/-palette), -plot3D a rotating PC1-3 GIF.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from janusx_tpu_torch.cli import common


def build_parser(prog="jx pca") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Genotype PCA")
    common.add_genotype_args(p, required=False)
    common.add_qc_args(p)
    o = p.add_argument_group("Options")
    o.add_argument("-k", "--grm", type=str, default=None, metavar="FILE",
                   help="existing GRM .npy (+ .id sidecar) to decompose "
                        "instead of building from genotypes")
    o.add_argument("-c", "--cov", "--qcov", dest="qcov", type=str,
                   default=None,
                   metavar="PREFIX",
                   help="existing PCA result prefix ({prefix}.eigenvec/"
                        ".eigenval): visualization only")
    o.add_argument("-dim", "--dim", type=int, default=10, help="number of PCs")
    o.add_argument("-approx", "--approx", action="store_true",
                   help="randomized SVD route (no dense GRM/eigh)")
    o.add_argument("-rsvd", "--rsvd", nargs="*", default=None, metavar="POWER",
                   help="alias of -approx; optional power-iteration count "
                        "('-rsvd', '-rsvd 3')")
    o.add_argument("-gk", "--method", type=int, default=1, choices=(1, 2))
    o.add_argument("-plot", "--plot", action="store_true",
                   help="PC1/PC2 and PC1/PC3 scatter plots")
    o.add_argument("-plot3D", "--plot3D", dest="plot3d", action="store_true",
                   help="rotating PC1-PC3 3D GIF")
    o.add_argument("-group", "--group", type=str, default=None, metavar="FILE",
                   help="two-column sample->group file (optional third column "
                        "= text annotation)")
    o.add_argument("-palette", "--palette", type=str, default="tab10",
                   help="cmap name or comma-separated colors for -group plots")
    common.add_out_args(p, default_prefix="jx")
    return p


def _read_groups(path: str, samples) -> tuple:
    gmap, lmap = {}, {}
    for line in open(path):
        f = line.split()
        if len(f) >= 2:
            gmap[f[0]] = f[1]
            if len(f) >= 3:
                lmap[f[0]] = f[2]
    groups = np.array([gmap.get(str(s), "NA") for s in samples], dtype=object)
    labels = [lmap.get(str(s), "") for s in samples] if lmap else None
    return groups, labels


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "pca")

    from janusx_tpu_torch.models.pca import pca_from_grm, rsvd_pca, write_pca_outputs

    if args.qcov:
        # visualization-only mode from existing results
        vecs = np.loadtxt(args.qcov + ".eigenvec", dtype=object)
        samples = vecs[:, 0]
        vecs = vecs[:, 1:].astype(np.float64)
        vals = np.loadtxt(args.qcov + ".eigenval", dtype=np.float64, ndmin=1)
    elif args.grm:
        K = np.load(args.grm)
        id_path = os.path.splitext(args.grm)[0] + ".id"
        samples = (np.array([l.split()[0] for l in open(id_path) if l.strip()],
                            dtype=object)
                   if os.path.exists(id_path)
                   else np.array([f"s{i}" for i in range(K.shape[0])], dtype=object))
        vals, vecs = pca_from_grm(K, n_pc=args.dim)
        write_pca_outputs(prefix, samples, vals, vecs)
    else:
        if not any((args.bfile, args.vcf, args.hmp, args.file)):
            raise SystemExit("one of a genotype input, -k GRM, or -c results "
                             "prefix is required")
        geno = common.resolve_genotype(args)
        from janusx_tpu_torch.io.gfreader import prepare_packed
        from janusx_tpu_torch.io.packed import QcParams
        from janusx_tpu_torch.models.grm import grm_from_packed

        pg = prepare_packed(
            geno, QcParams(maf=args.maf, geno=args.geno, het=args.het),
        )
        samples = pg.samples
        if args.approx or args.rsvd is not None:
            if args.rsvd:  # -rsvd N [tol]
                power = int(args.rsvd[0])
            elif args.rsvd is not None:  # bare -rsvd: reference default
                power = 3
            else:  # -approx: keep the model default
                power = 4
            vals, vecs = rsvd_pca(pg, n_pc=args.dim, method=args.method,
                                  power_iters=power)
        else:
            K = grm_from_packed(pg, method=args.method)
            vals, vecs = pca_from_grm(K, n_pc=args.dim)
        write_pca_outputs(prefix, samples, vals, vecs)

    if args.plot or args.plot3d or args.qcov:
        from janusx_tpu_torch.plots.structure import pc_scatter, pc_scatter3d_gif

        groups = labels = None
        if args.group:
            groups, labels = _read_groups(args.group, samples)
        if args.plot or args.qcov:
            if vecs.shape[1] >= 2:
                pc_scatter(vecs, prefix + ".pca.png", groups=groups,
                           labels=labels, pcs=(0, 1), palette=args.palette)
            if vecs.shape[1] >= 3:
                pc_scatter(vecs, prefix + ".pca13.png", groups=groups,
                           labels=labels, pcs=(0, 2), palette=args.palette)
        if args.plot3d and vecs.shape[1] >= 3:
            pc_scatter3d_gif(vecs, prefix + ".pca3d.gif", groups=groups,
                             palette=args.palette)
    print(f"{prefix}.eigenvec\t{prefix}.eigenval\t(top {len(vals)} PCs)")
    return 0
