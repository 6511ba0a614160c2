"""External bioinformatics pipeline orchestration (fastq2vcf/fastq2count)."""

from janusx_tpu_torch.pipeline.executor import Pipeline, Step, PipelineOptions

__all__ = ["Pipeline", "Step", "PipelineOptions"]
