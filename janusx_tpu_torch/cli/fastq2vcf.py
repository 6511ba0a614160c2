"""`jx fastq2vcf` — reads-to-variants pipeline with durable resume
(reference: src/workflow/fastq2vcf/)."""

from __future__ import annotations

import argparse
import glob
import json
import os

from janusx_tpu_torch.cli import common


def build_parser(prog="jx fastq2vcf") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog, description="fastp -> bwa/samblaster -> gatk -> beagle"
    )
    p.add_argument("-fq", "--fastq-dir", type=str, required=True,
                   help="dir of paired FASTQs named {sample}_1.* / {sample}_2.*")
    p.add_argument("-ref", "--ref", type=str, required=True, help="reference FASTA")
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("-beagle", "--beagle-jar", type=str, default=None)
    p.add_argument("-check", "--check-only", action="store_true",
                   help="preflight external tools and exit")
    p.add_argument("-dry-run", "--dry-run", action="store_true")
    common.add_out_args(p, default_prefix="f2v")
    return p


def _discover_samples(fq_dir: str):
    samples = []
    for fq1 in sorted(glob.glob(os.path.join(fq_dir, "*_1.*"))):
        base = os.path.basename(fq1)
        # pair on the LAST '_1.' of the BASENAME only: a full-path replace
        # also rewrites '_1.' in directory names or earlier in the file
        # name, mispairing or dropping valid samples
        sid, _, tail = base.rpartition("_1.")
        fq2 = os.path.join(os.path.dirname(fq1), f"{sid}_2.{tail}")
        if os.path.exists(fq2):
            samples.append({"id": sid, "fq1": fq1, "fq2": fq2})
    return samples


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "fastq2vcf")

    from janusx_tpu_torch.pipeline.executor import FASTQ2VCF_TOOLS, check_tool
    from janusx_tpu_torch.pipeline.fastq2vcf import Fastq2VcfConfig, build_pipeline

    probes = [check_tool(t) for t in FASTQ2VCF_TOOLS]
    for pr in probes:
        mark = "ok" if pr["found"] else "MISSING"
        print(f"{pr['tool']}\t{mark}\t{pr.get('version') or ''}")
    if args.check_only:
        return 0
    missing = [pr["tool"] for pr in probes if not pr["found"]
               if pr["tool"] != "beagle"]
    if missing and not args.dry_run:
        raise SystemExit(f"missing tools: {missing}")

    samples = _discover_samples(args.fastq_dir)
    if not samples:
        raise SystemExit(f"no paired FASTQs found in {args.fastq_dir}")
    cfg = Fastq2VcfConfig(
        ref_fasta=args.ref, out_dir=args.out, samples=samples,
        threads=args.threads, beagle_jar=args.beagle_jar,
    )
    per_sample, cohort = build_pipeline(cfg)
    per_sample.options.dry_run = args.dry_run
    cohort.options.dry_run = args.dry_run
    rep1 = per_sample.run()
    rep2 = cohort.run() if not rep1["failed"] else None
    print(json.dumps({"per_sample": rep1, "cohort": rep2}, indent=1))
    return 0 if not rep1["failed"] else 1
