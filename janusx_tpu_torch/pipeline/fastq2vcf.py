"""fastq2vcf: short-read alignment + variant-calling pipeline definition.

Mirrors the reference's six-step chain
(JanusX src/workflow/fastq2vcf/mod.rs:26-37:
fastp -> bwa mem | samblaster -> sort -> HaplotypeCaller -> combine/
genotype -> beagle imputation), expressed as janusx_tpu.pipeline steps
with durable JSON resume. Commands are templates over per-sample items
{id, fq1, fq2}; the reference genome and output dir come from the config.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from janusx_tpu_torch.pipeline.executor import Pipeline, PipelineOptions, Step


@dataclass
class Fastq2VcfConfig:
    ref_fasta: str
    out_dir: str
    samples: list  # [{"id":..., "fq1":..., "fq2":...}]
    threads: int = 4
    beagle_jar: str | None = None
    scheduler: str = "local"


def build_pipeline(cfg: Fastq2VcfConfig) -> Pipeline:
    od = cfg.out_dir
    t = cfg.threads

    def clean(i):
        return (
            f"fastp -i {i['fq1']} -I {i['fq2']} "
            f"-o {od}/{i['id']}.R1.fq.gz -O {od}/{i['id']}.R2.fq.gz "
            f"-j {od}/{i['id']}.fastp.json -h /dev/null -w {t}"
        )

    def align(i):
        rg = f"@RG\\tID:{i['id']}\\tSM:{i['id']}\\tPL:ILLUMINA"
        return (
            f"bwa mem -t {t} -R '{rg}' {cfg.ref_fasta} "
            f"{od}/{i['id']}.R1.fq.gz {od}/{i['id']}.R2.fq.gz "
            f"| samblaster | samtools sort -@ {t} -o {od}/{i['id']}.bam - "
            f"&& samtools index {od}/{i['id']}.bam"
        )

    def call(i):
        return (
            f"gatk HaplotypeCaller -R {cfg.ref_fasta} -I {od}/{i['id']}.bam "
            f"-O {od}/{i['id']}.g.vcf.gz -ERC GVCF"
        )

    all_gvcfs = lambda: " ".join(
        f"-V {od}/{s['id']}.g.vcf.gz" for s in cfg.samples
    )

    def combine(_i):
        return (
            f"gatk CombineGVCFs -R {cfg.ref_fasta} {all_gvcfs()} "
            f"-O {od}/combined.g.vcf.gz && "
            f"gatk GenotypeGVCFs -R {cfg.ref_fasta} -V {od}/combined.g.vcf.gz "
            f"-O {od}/raw.vcf.gz"
        )

    def impute(_i):
        jar = cfg.beagle_jar or "beagle.jar"
        return (
            f"java -jar {jar} gt={od}/raw.vcf.gz out={od}/imputed nthreads={t}"
        )

    # every artifact a later step consumes must be a declared output, or a
    # kill between sub-commands lets output-skip mark the step complete
    # with the tail artifact missing (e.g. .bam present, .bam.bai not)
    steps = [
        Step("clean", clean,
             lambda i: [f"{od}/{i['id']}.R1.fq.gz", f"{od}/{i['id']}.R2.fq.gz"]),
        Step("align", align,
             lambda i: [f"{od}/{i['id']}.bam", f"{od}/{i['id']}.bam.bai"]),
        Step("call", call, lambda i: [f"{od}/{i['id']}.g.vcf.gz"]),
        Step("genotype", combine, lambda i: [f"{od}/raw.vcf.gz"]),
        Step("impute", impute, lambda i: [f"{od}/imputed.vcf.gz"]),
    ]
    # genotype/impute run once (single pseudo-item)
    per_sample = Pipeline(
        name="fastq2vcf",
        steps=steps[:3],
        items=cfg.samples,
        state_path=os.path.join(od, "fastq2vcf.state.json"),
        options=PipelineOptions(scheduler=cfg.scheduler),
    )
    cohort = Pipeline(
        name="fastq2vcf-cohort",
        steps=steps[3:],
        items=[{"id": "cohort"}],
        state_path=os.path.join(od, "fastq2vcf.cohort.state.json"),
        options=PipelineOptions(scheduler=cfg.scheduler),
    )
    return per_sample, cohort


def run(cfg: Fastq2VcfConfig):
    os.makedirs(cfg.out_dir, exist_ok=True)
    per_sample, cohort = build_pipeline(cfg)
    rep1 = per_sample.run()
    if rep1["failed"]:
        return {"per_sample": rep1, "cohort": None}
    rep2 = cohort.run()
    return {"per_sample": rep1, "cohort": rep2}
