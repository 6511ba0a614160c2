"""`jx fastpop` — ancestry decomposition (reference: script/fastpop.py,
python/janusx/fastpop)."""

from __future__ import annotations

import argparse

from janusx_tpu_torch.cli import common


def build_parser(prog="jx fastpop") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="ADMIXTURE-style ancestry inference")
    common.add_genotype_args(p)
    common.add_qc_args(p)
    o = p.add_argument_group("Options")
    o.add_argument("-K", "--npop", type=int, default=None,
                   help="number of ancestral populations (single K)")
    o.add_argument("-k", "--k", dest="kspec", type=str, default=None,
                   help="K spec (reference -k): single (8), range (1..10 or "
                        "1:10), stepped (1..10..3, 1:10:3), or list (1,5,8)")
    o.add_argument("-iter", "--iter", "-max-iter", "--max-iter", dest="iter",
                   type=int, default=300, help="max Adam iterations")
    o.add_argument("-lr", "--lr", type=float, default=None,
                   help="learning rate (default: 0.005 for adam-em per the "
                        "reference ADAMixtureConfig, 0.05 for adam)")
    o.add_argument("-tol", "--tol", type=float, default=1e-5,
                   help="convergence tolerance on the relative log-likelihood "
                        "improvement (reference -tol; 0 disables)")
    o.add_argument("-check", "--check", type=int, default=5,
                   help="log-likelihood convergence check interval in "
                        "iterations (reference -check; 0 disables)")
    o.add_argument("-solver", "--solver", type=str, default="adam-em",
                   choices=("auto", "adam", "adam-em"),
                   help="adam-em (default, reference semantics): per-iteration "
                        "EM targets fed through Adam moments as deltas; "
                        "adam: full-likelihood Adam on softmax/sigmoid logits")
    o.add_argument("-tag", "--tag", type=str, default=None,
                   help="extra tag inserted into output file names")
    o.add_argument("-cv", "--cv", action="store_true", help="also report CV deviance")
    o.add_argument("-seed", "--seed", type=int, default=42)
    o.add_argument("-plot", "--plot", action="store_true", help="write ancestry bar plot")
    o.add_argument("--no-plot", action="store_true",
                   help="skip plot rendering (reference --no-plot; plots are "
                        "opt-in here via -plot, so this just wins over it)")
    common.add_compat_thread_arg(p)
    common.add_out_args(p, default_prefix="fastpop")
    return p


def parse_k_spec(spec: str) -> list[int]:
    """Reference K spec (script/adamixture.py:1536-1543): single '8',
    range '1..10' / '1:10', stepped '1..10..3' / '1:10:3' / '1..10:3',
    or list '1,5,8'."""
    spec = spec.strip()
    if "," in spec:
        return [int(t) for t in spec.split(",") if t.strip()]
    parts = [t for t in spec.replace("..", ":").split(":") if t]
    if len(parts) == 1:
        return [int(parts[0])]
    lo, hi = int(parts[0]), int(parts[1])
    step = int(parts[2]) if len(parts) > 2 else 1
    if step < 1 or hi < lo:
        raise SystemExit(f"bad -k spec {spec!r}")
    return list(range(lo, hi + 1, step))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "fastpop")

    from janusx_tpu_torch.io.gfreader import prepare_packed
    from janusx_tpu_torch.io.packed import QcParams
    from janusx_tpu_torch.models.fastpop import (
        cv_error,
        train_admixture,
        write_admixture_outputs,
    )

    if (args.npop is None) == (args.kspec is None):
        raise SystemExit("specify exactly one of -K/--npop or -k/--k")
    ks = [args.npop] if args.npop is not None else parse_k_spec(args.kspec)
    dropped = [k for k in ks if k < 2]
    ks = [k for k in ks if k >= 2]
    if dropped:
        print(f"K < 2 has no ancestry decomposition; skipping K={dropped}")
    if not ks:
        raise SystemExit("-k/-K: need at least one K >= 2")
    if args.tag:
        prefix = f"{prefix}.{args.tag}"
    pg = prepare_packed(
        common.resolve_genotype(args),
        QcParams(maf=args.maf, geno=args.geno, het=args.het),
    )
    for k in ks:
        fit = train_admixture(
            pg, k, n_iter=args.iter, lr=args.lr, seed=args.seed,
            tol=args.tol, check_every=args.check, solver=args.solver,
        )
        write_admixture_outputs(prefix, pg.samples, fit)
        if args.plot and not args.no_plot:
            from janusx_tpu_torch.plots.structure import admixture_bars

            admixture_bars(fit.Q, f"{prefix}.{k}.structure.png")
        line = (f"K={k}\tloglik={fit.loglik:.2f}\titers={fit.n_iter}"
                f"\t{prefix}.{k}.Q")
        if args.cv:
            dev = cv_error(pg, k, seed=args.seed, n_iter=args.iter,
                           lr=args.lr, solver=args.solver)
            line += f"\tcv_deviance={dev:.5f}"
        print(line)
    return 0
