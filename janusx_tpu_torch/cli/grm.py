"""`jx grm` for the port — GRM build (reference: python/janusx/script/grm.py).

A copy of janusx_tpu/cli/grm.py (build_parser and main line for line) on
the port's models: the dense GRM and the -part/-part-group strips are
decoded and multiplied on the device. Outputs {out}/{prefix}.cGRM.npy
(+ .cGRM.id) for method 1, sGRM for method 2. `-sparse [CUTOFF]` emits
the CSC `.spgrm` (.jxgrm format) with off-diagonals |k| >= cutoff
(negative cutoff keeps everything). `-k dense.npy -sparse` converts an
existing dense GRM. `-txt` writes plain text instead of NPY.
`--distributed` builds the GRM over several processes (parallel.distributed,
gloo): JX_DIST_COORDINATOR (host:port), JX_DIST_NPROCS and JX_DIST_PROC_ID,
or a torchrun launch; only process 0 writes the outputs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from janusx_tpu_torch.cli import common


def build_parser(prog="jx grm") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Genomic relationship matrix")
    common.add_genotype_args(p, required=False)
    common.add_qc_args(p)
    o = p.add_argument_group("Options")
    o.add_argument("-k", "--dense-grm", type=str, default=None, metavar="FILE",
                   help="precomputed dense GRM .npy (+ .id); use with -sparse "
                        "to convert to .spgrm")
    o.add_argument("-m", "-gk", "--method", type=int, default=1, choices=(1, 2),
                   help="1 = centered (cGRM), 2 = standardized (sGRM)")
    o.add_argument("-sparse", "--sparse", nargs="?", const=0.05, type=float,
                   default=None, metavar="CUTOFF",
                   help="also write a thresholded sparse GRM (.spgrm CSC; "
                        "negative cutoff keeps all entries)")
    o.add_argument("-txt", "--txt", action="store_true",
                   help="write the dense GRM as plain text instead of .npy")
    o.add_argument("-part", "--part", nargs="+", default=None,
                   metavar=("N", "IDX"),
                   help="dense row-strip partitioning (reference -part): "
                   "`-part N IDX` builds only part IDX (1-based) of N "
                   "GCTA-like work-balanced lower-triangle parts; "
                   "`-part N` builds all N parts sequentially. Each part "
                   "writes {prefix}.{tag}.partK_N.npy with that strip's "
                   "rows x all samples — the full n x n matrix is never "
                   "resident on host")
    o.add_argument("-part-group", "--part-group", type=str, default=None,
                   metavar="FILE",
                   help="group strip build (reference -part-group): FILE "
                   "has two columns sample_id group_id; one strip "
                   "{prefix}.{tag}.group_{gid}.npy per group (rows = the "
                   "group's samples x all samples)")
    o.add_argument("--distributed", action="store_true",
                   help="multi-host build: initialize jax.distributed "
                        "(env-driven on TPU pods, or JX_DIST_COORDINATOR/"
                        "JX_DIST_NPROCS/JX_DIST_PROC_ID), read only this "
                        "host's SNP slice, and merge partial GRMs across "
                        "hosts (parallel.distributed.distributed_grm); "
                        "only process 0 writes outputs")
    p.add_argument("--stage-timing", action="store_true",
                   help="print a load/compute/write stage breakdown "
                        "(reference --stage-timing)")
    common.add_out_args(p, default_prefix="jx")
    return p


def _write_spgrm(prefix: str, tag: str, K: np.ndarray, samples, cutoff: float):
    import scipy.sparse

    from janusx_tpu_torch.io.jxgrm import write_jxgrm
    from janusx_tpu_torch.models.splmm import sparsify_grm

    if cutoff is not None and cutoff < 0:
        Ks = scipy.sparse.csc_matrix(K)
    else:
        Ks = sparsify_grm(K, cutoff).tocsc()
    path = f"{prefix}.{tag}.spgrm"
    write_jxgrm(path, Ks)
    with open(f"{prefix}.{tag}.spgrm.id", "wt") as fh:
        for s in samples:
            fh.write(f"{s}\n")
    n = K.shape[0]
    print(f"{path}\tnnz={Ks.nnz}\tdensity={Ks.nnz / max(1, n * n):.4g}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "grm")

    if args.dense_grm:
        if args.sparse is None:
            raise SystemExit("-k requires -sparse (dense -> .spgrm conversion)")
        K = np.load(args.dense_grm)
        id_path = os.path.splitext(args.dense_grm)[0] + ".id"
        if not os.path.exists(id_path):
            raise SystemExit(f"missing GRM id sidecar: {id_path}")
        with open(id_path) as fh:
            samples = [l.split()[0] for l in fh if l.strip()]
        if len(samples) != K.shape[0]:
            raise SystemExit(
                f"id sidecar {id_path} has {len(samples)} ids but the GRM "
                f"is {K.shape[0]}x{K.shape[1]} — stale sidecar would "
                f"misalign every downstream -spk analysis"
            )
        tag = "cGRM" if args.method == 1 else "sGRM"
        _write_spgrm(prefix, tag, K, samples, args.sparse)
        return 0

    if not any((args.bfile, args.vcf, args.hmp, args.file)):
        raise SystemExit("a genotype input (or -k dense GRM) is required")
    from janusx_tpu_torch.io.gfreader import prepare_packed
    from janusx_tpu_torch.io.packed import QcParams
    from janusx_tpu_torch.models.grm import grm_from_packed

    import time

    t0 = time.monotonic()
    pg = prepare_packed(
        common.resolve_genotype(args),
        QcParams(maf=args.maf, geno=args.geno, het=args.het),
    )
    t_load = time.monotonic() - t0
    tag = "cGRM" if args.method == 1 else "sGRM"
    if args.part or args.part_group:
        from janusx_tpu_torch.models.grm import (
            balanced_part_bounds, grm_strip_from_packed,
        )

        with open(f"{prefix}.{tag}.id", "wt") as fh:
            for s in pg.samples:
                fh.write(f"{s}\n")
        if args.part:
            n_parts = int(args.part[0])
            want = (int(args.part[1]) if len(args.part) > 1 else None)
            bounds = balanced_part_bounds(pg.n, n_parts)
            for k, (s0, e0) in enumerate(bounds, start=1):
                if want is not None and k != want:
                    continue
                strip = grm_strip_from_packed(
                    pg, np.arange(s0, e0), method=args.method)
                out = f"{prefix}.{tag}.part{k}_{n_parts}.npy"
                np.save(out, strip)
                print(f"{out}\trows {s0}..{e0 - 1} x {pg.n}")
        else:
            groups: dict[str, list] = {}
            pos = {str(s): i for i, s in enumerate(pg.samples)}
            with open(args.part_group) as fh:
                for line in fh:
                    toks = line.split()
                    if len(toks) >= 2 and toks[0] in pos:
                        groups.setdefault(toks[1], []).append(pos[toks[0]])
            if not groups:
                raise SystemExit("-part-group: no listed sample matched "
                                 "the genotype panel")
            # largest groups first (the reference sorts by descending
            # size so the big strips land early)
            for gid in sorted(groups, key=lambda g: -len(groups[g])):
                rows = np.sort(np.asarray(groups[gid], np.int64))
                strip = grm_strip_from_packed(pg, rows, method=args.method)
                out = f"{prefix}.{tag}.group_{gid}.npy"
                np.save(out, strip)
                print(f"{out}\t{len(rows)} x {pg.n}")
        return 0
    t0 = time.monotonic()
    if args.distributed:
        from janusx_tpu_torch.parallel import distributed as dist

        # the env-variable path below covers explicit multi-process
        # launches; under torchrun (MASTER_ADDR, RANK, WORLD_SIZE set)
        # initialize needs no args
        coord = os.environ.get("JX_DIST_COORDINATOR")
        dist.initialize(
            coordinator=coord,
            num_processes=(int(os.environ["JX_DIST_NPROCS"])
                           if coord else None),
            process_id=(int(os.environ["JX_DIST_PROC_ID"])
                        if coord else None),
        )
        K = dist.distributed_grm(pg, method=args.method)
        if dist.process_index() != 0:
            return 0  # only the lead process writes outputs
    else:
        K = grm_from_packed(pg, method=args.method)
    t_compute = time.monotonic() - t0
    t0 = time.monotonic()
    if args.txt:
        np.savetxt(f"{prefix}.{tag}.txt", K, fmt="%.6g", delimiter="\t")
        out = f"{prefix}.{tag}.txt"
    else:
        np.save(f"{prefix}.{tag}.npy", K)
        out = f"{prefix}.{tag}.npy"
    with open(f"{prefix}.{tag}.id", "wt") as fh:
        for s in pg.samples:
            fh.write(f"{s}\n")
    print(f"{out}\t({K.shape[0]} x {K.shape[1]}, {pg.m} SNPs)")
    if args.stage_timing:
        t_write = time.monotonic() - t0
        print(f"stage-timing\tload={t_load:.2f}s\t"
              f"grm={t_compute:.2f}s\twrite={t_write:.2f}s")
    if args.sparse is not None:
        _write_spgrm(prefix, tag, K, pg.samples, args.sparse)
    return 0
