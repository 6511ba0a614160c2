"""`jx fastq2count` — RNA-seq reads-to-expression pipeline with durable
resume (reference: src/workflow/fastq2count/)."""

from __future__ import annotations

import argparse
import json
import os

from janusx_tpu_torch.cli import common

FASTQ2COUNT_TOOLS = ("fastp", "hisat2", "hisat2-build", "samtools", "featureCounts")


def build_parser(prog="jx fastq2count") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog,
        description="fastp -> hisat2 index/align -> featureCounts (+FPKM/TPM)",
    )
    p.add_argument("-i", "--in", "--fastq-dir", dest="fastq_dir", required=True,
                   help="dir of paired FASTQs (recursive; R1/R2 or _1/_2 naming)"
                        " — with -from-step 4, the 04_mapping dir of BAMs")
    p.add_argument("-r", "--reference", required=True, help="reference FASTA")
    p.add_argument("-a", "--annotation", required=True, help="GTF/GFF annotation")
    p.add_argument("-w", "--workdir", required=True, help="pipeline work dir")
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("-strandness", "--strandness", default=None,
                   help="hisat2 --rna-strandness (RF/FR; default unstranded)")
    p.add_argument("-feature-type", "--feature-type", default="exon",
                   help="featureCounts -t (default exon)")
    p.add_argument("-gene-attr", "--gene-attr", default="gene_id",
                   help="featureCounts -g (default gene_id)")
    p.add_argument("-from-step", "--from-step", type=int, default=1,
                   help="resume from step 1..4 (clean/index/align/count)")
    p.add_argument("-to-step", "--to-step", type=int, default=4,
                   help="stop after step 1..4")
    p.add_argument("-check", "--check-only", action="store_true",
                   help="preflight external tools and exit")
    p.add_argument("-dry-run", "--dry-run", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    common.setup_logging(args.verbose, os.path.join(args.workdir, "f2c"),
                         "fastq2count")

    from janusx_tpu_torch.pipeline.executor import PipelineOptions, check_tool
    from janusx_tpu_torch.pipeline.fastq2count import (
        TOTAL_STEPS,
        Fastq2CountConfig,
        discover_samples,
        infer_samples_from_bam,
        run,
    )

    probes = [check_tool(t) for t in FASTQ2COUNT_TOOLS]
    for pr in probes:
        mark = "ok" if pr["found"] else "MISSING"
        print(f"{pr['tool']}\t{mark}\t{pr.get('version') or ''}")
    if args.check_only:
        return 0
    missing = [pr["tool"] for pr in probes if not pr["found"]]
    if missing and not args.dry_run:
        raise SystemExit(f"missing tools: {missing}")

    lo, hi = args.from_step, args.to_step
    if not (1 <= lo <= hi <= TOTAL_STEPS):
        raise SystemExit(
            f"step range must satisfy 1 <= from <= to <= {TOTAL_STEPS} "
            f"(got {lo}..{hi})"
        )
    if lo >= 4:
        samples = infer_samples_from_bam(args.fastq_dir)
    else:
        samples = discover_samples(args.fastq_dir)
    if not samples:
        raise SystemExit(f"no paired FASTQs found in {args.fastq_dir}")

    cfg = Fastq2CountConfig(
        ref_fasta=args.reference, annotation=args.annotation,
        workdir=args.workdir, samples=samples, threads=args.threads,
        strandness=args.strandness, feature_type=args.feature_type,
        gene_attr=args.gene_attr,
        options=PipelineOptions(dry_run=args.dry_run),
    )
    reports = run(cfg, from_step=lo, to_step=hi)
    print(json.dumps(reports, indent=1))
    return 0 if all(not r["failed"] for r in reports.values()) else 1
