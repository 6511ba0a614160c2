"""fastq2count: RNA-seq reads-to-expression-matrix pipeline definition.

Mirrors the reference's four-step chain
(JanusX src/workflow/fastq2count/mod.rs + cmd.rs:
fastp -> hisat2 index (splice-site/exon aware when the extract scripts
exist) -> hisat2 align | samtools sort/index -> featureCounts +
FPKM/TPM tables), expressed as janusx_tpu.pipeline steps with durable
JSON resume. The reference shells out to a helper python script for the
FPKM/TPM normalization; here it is a library function in this module
(invoked as ``python -m janusx_tpu.pipeline.fastq2count`` inside the
count step so the artifacts stay declared step outputs for resume).

Layout under the workdir (reference directory contract):
  01_cleandata/{sample}.R{1,2}.clean.fastq.gz   02_qc/{sample}.{html,json}
  03_index/reference.*                          04_mapping/{sample}.bam
  05_counts/gene_counts.txt (+ .fpkm.tsv / .tpm.tsv)
"""

from __future__ import annotations

import os
import re
import shlex
import sys
from dataclasses import dataclass, field

from janusx_tpu_torch.pipeline.executor import Pipeline, PipelineOptions, Step

FASTQ_SUFFIXES = (".fastq.gz", ".fq.gz", ".fastq", ".fq")
TOTAL_STEPS = 4


@dataclass
class Fastq2CountConfig:
    ref_fasta: str
    annotation: str  # GTF/GFF for the splice-aware index + featureCounts
    workdir: str
    samples: list  # [{"id":..., "fq1":..., "fq2":...}]
    threads: int = 4
    strandness: str | None = None  # hisat2 --rna-strandness (RF/FR/...)
    feature_type: str = "exon"  # featureCounts -t
    gene_attr: str = "gene_id"  # featureCounts -g
    scheduler: str = "local"
    options: PipelineOptions | None = field(default=None)


def _q(p: str) -> str:
    return shlex.quote(str(p))


def discover_samples(fastq_dir: str) -> list:
    """Recursive paired-FASTQ discovery (reference classify_fastq_pairs):
    strip a known FASTQ suffix, split the stem on [._-], take the LAST
    read token (1/2/R1/R2) as the mate marker and everything before it
    as the sample id. Duplicate mates for one sample are an error."""
    files = []
    for root, _dirs, names in os.walk(fastq_dir):
        for nm in sorted(names):
            if nm.endswith(FASTQ_SUFFIXES):
                files.append(os.path.join(root, nm))
    pairs: dict = {}
    for path in sorted(files):
        stem = os.path.basename(path)
        for suf in FASTQ_SUFFIXES:
            if stem.endswith(suf):
                stem = stem[: -len(suf)]
                break
        tokens = re.split(r"[._-]", stem)
        read_idx = None
        kind = None
        for i in range(len(tokens) - 1, -1, -1):
            tok = tokens[i].upper()
            if tok in ("1", "R1"):
                read_idx, kind = i, "fq1"
                break
            if tok in ("2", "R2"):
                read_idx, kind = i, "fq2"
                break
        if read_idx is None:
            continue  # unpaired/unrecognized naming: skipped, like the ref
        sid = "_".join(t for t in tokens[:read_idx] if t)
        if not sid:
            continue
        entry = pairs.setdefault(sid, {})
        if kind in entry:
            raise ValueError(
                f"Duplicate {kind.upper()} for sample `{sid}`: {path}"
            )
        entry[kind] = path
    samples = []
    for sid in sorted(pairs):
        e = pairs[sid]
        if "fq1" in e and "fq2" in e:
            samples.append({"id": sid, "fq1": e["fq1"], "fq2": e["fq2"]})
    return samples


def infer_samples_from_bam(mapping_dir: str) -> list:
    """Step-4-only entry: sample set = *.bam basenames in 04_mapping
    (reference infer_samples_from_bam)."""
    out = []
    if os.path.isdir(mapping_dir):
        for nm in sorted(os.listdir(mapping_dir)):
            if nm.endswith(".bam") and not nm.endswith(".bam.bai"):
                sid = nm[: -len(".bam")]
                if sid:
                    out.append({"id": sid, "fq1": "", "fq2": ""})
    return out


def _dirs(workdir: str) -> dict:
    return {
        "clean": os.path.join(workdir, "01_cleandata"),
        "qc": os.path.join(workdir, "02_qc"),
        "index": os.path.join(workdir, "03_index"),
        "map": os.path.join(workdir, "04_mapping"),
        "counts": os.path.join(workdir, "05_counts"),
    }


def build_pipelines(cfg: Fastq2CountConfig) -> list:
    """Four stages in run order, alternating per-sample / cohort scope:
    [(step_no, Pipeline)] — callers slice by -from-step/-to-step."""
    d = _dirs(cfg.workdir)
    t = max(1, cfg.threads)
    idx_pref = os.path.join(d["index"], "reference")
    opts = cfg.options or PipelineOptions(scheduler=cfg.scheduler)

    def clean(i):
        return (
            f"mkdir -p {_q(d['clean'])} {_q(d['qc'])} && "
            f"fastp -i {_q(i['fq1'])} -I {_q(i['fq2'])} "
            f"-o {_q(d['clean'])}/{i['id']}.R1.clean.fastq.gz "
            f"-O {_q(d['clean'])}/{i['id']}.R2.clean.fastq.gz "
            f"--html {_q(d['qc'])}/{i['id']}.html "
            f"--json {_q(d['qc'])}/{i['id']}.json -w {t}"
        )

    def index(_i):
        # splice-site/exon tracks when the hisat2 extract scripts exist
        # (reference cmd_hisat2_index conditional); the .index.ok marker
        # is only touched after a successful build, so output-skip can
        # never accept a partial index
        ss, exon = f"{idx_pref}.ss", f"{idx_pref}.exon"
        ann = _q(cfg.annotation)
        return (
            f"mkdir -p {_q(d['index'])} && rm -f {_q(idx_pref)}.index.ok && "
            f"SP=$(command -v hisat2_extract_splice_sites.py || command -v extract_splice_sites.py || true); "
            f"EX=$(command -v hisat2_extract_exons.py || command -v extract_exons.py || true); "
            f'if [ -n "$SP" ] && [ -n "$EX" ]; then "$SP" {ann} > {_q(ss)} && "$EX" {ann} > {_q(exon)}; '
            f"else : > {_q(ss)}; : > {_q(exon)}; fi && "
            f"if [ -s {_q(ss)} ] && [ -s {_q(exon)} ]; then "
            f"hisat2-build -p {t} --ss {_q(ss)} --exon {_q(exon)} {_q(cfg.ref_fasta)} {_q(idx_pref)}; "
            f"else hisat2-build -p {t} {_q(cfg.ref_fasta)} {_q(idx_pref)}; fi && "
            f"touch {_q(idx_pref)}.index.ok"
        )

    strand = ""
    if cfg.strandness and cfg.strandness.strip().lower() != "none":
        strand = f"--rna-strandness {_q(cfg.strandness.strip())} "

    def align(i):
        bam = f"{d['map']}/{i['id']}.bam"
        return (
            f"mkdir -p {_q(d['map'])} && "
            f"hisat2 -p {t} --new-summary {strand}-x {_q(idx_pref)} "
            f"-1 {_q(d['clean'])}/{i['id']}.R1.clean.fastq.gz "
            f"-2 {_q(d['clean'])}/{i['id']}.R2.clean.fastq.gz "
            f"2> {_q(d['map'])}/{i['id']}.hisat2.log "
            f"| samtools sort -@ {t} -o {_q(bam)} - && "
            f"samtools index -@ {t} {_q(bam)}"
        )

    counts = os.path.join(d["counts"], "gene_counts.txt")
    fpkm = os.path.join(d["counts"], "gene_counts.fpkm.tsv")
    tpm = os.path.join(d["counts"], "gene_counts.tpm.tsv")

    def count(_i):
        bams = " ".join(
            _q(f"{d['map']}/{s['id']}.bam") for s in cfg.samples
        )
        return (
            f"mkdir -p {_q(d['counts'])} && "
            f"featureCounts -T {t} -p -t {_q(cfg.feature_type)} "
            f"-g {_q(cfg.gene_attr)} -a {_q(cfg.annotation)} "
            f"-o {_q(counts)} {bams} && "
            f"{_q(sys.executable)} -m janusx_tpu_torch.pipeline.fastq2count "
            f"{_q(counts)} {_q(fpkm)} {_q(tpm)}"
        )

    def per_sample(no, name, cmd, outs):
        return no, Pipeline(
            name=f"fastq2count-{name}", steps=[Step(name, cmd, outs)],
            items=cfg.samples,
            state_path=os.path.join(cfg.workdir, f"fastq2count.{name}.state.json"),
            options=opts,
        )

    def cohort(no, name, cmd, outs):
        return no, Pipeline(
            name=f"fastq2count-{name}", steps=[Step(name, cmd, outs)],
            items=[{"id": "cohort"}],
            state_path=os.path.join(cfg.workdir, f"fastq2count.{name}.state.json"),
            options=opts,
        )

    return [
        per_sample(1, "clean", clean, lambda i: [
            f"{d['clean']}/{i['id']}.R1.clean.fastq.gz",
            f"{d['clean']}/{i['id']}.R2.clean.fastq.gz",
            f"{d['qc']}/{i['id']}.json",
        ]),
        cohort(2, "index", index, lambda i: [f"{idx_pref}.index.ok"]),
        per_sample(3, "align", align, lambda i: [
            f"{d['map']}/{i['id']}.bam", f"{d['map']}/{i['id']}.bam.bai",
        ]),
        cohort(4, "count", count, lambda i: [counts, fpkm, tpm]),
    ]


def run(cfg: Fastq2CountConfig, from_step: int = 1, to_step: int = TOTAL_STEPS):
    os.makedirs(cfg.workdir, exist_ok=True)
    reports = {}
    for no, pipe in build_pipelines(cfg):
        if no < from_step or no > to_step:
            continue
        rep = pipe.run()
        reports[pipe.steps[0].name] = rep
        if rep["failed"]:
            break
    return reports


def fpkm_tpm_from_featurecounts(counts_path: str, fpkm_out: str, tpm_out: str) -> None:
    """FPKM/TPM tables from a featureCounts output file (replaces the
    reference's metrics helper script, cmd_featurecounts_and_metrics).

    featureCounts layout: '#' comment line, then a header
    ``Geneid Chr Start End Strand Length <bam> ...``; sample names are
    the bam basenames. FPKM = c * 1e9 / (L * total); TPM = rpk * 1e6 /
    sum(rpk) with rpk = c / L."""
    import numpy as np

    genes, lengths, rows, samples = [], [], [], []
    with open(counts_path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if not samples:
                if parts[0] != "Geneid":
                    raise ValueError(
                        f"{counts_path}: not a featureCounts table "
                        f"(header starts with {parts[0]!r})"
                    )
                samples = [
                    os.path.basename(c)[:-4]
                    if c.endswith(".bam") else os.path.basename(c)
                    for c in parts[6:]
                ]
                continue
            genes.append(parts[0])
            lengths.append(float(parts[5]))
            rows.append([float(x) for x in parts[6:]])
    if not samples:
        raise ValueError(f"{counts_path}: empty featureCounts table")
    C = np.asarray(rows, np.float64).reshape(len(genes), len(samples))
    L = np.asarray(lengths, np.float64)[:, None]
    L = np.where(L > 0, L, np.nan)  # zero-length features -> NaN rows
    total = C.sum(axis=0, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        fpkm = C * 1e9 / (L * np.where(total > 0, total, np.nan))
        rpk = C / L
        rpk_sum = np.nansum(rpk, axis=0, keepdims=True)
        tpm = rpk * 1e6 / np.where(rpk_sum > 0, rpk_sum, np.nan)
    for path, M in ((fpkm_out, fpkm), (tpm_out, tpm)):
        tmp = path + ".tmp"
        with open(tmp, "wt") as fh:
            fh.write("Geneid\t" + "\t".join(samples) + "\n")
            for g, row in zip(genes, M):
                fh.write(g + "\t" + "\t".join(f"{v:.6g}" for v in row) + "\n")
        os.replace(tmp, path)


if __name__ == "__main__":  # count-step normalization entry
    fpkm_tpm_from_featurecounts(sys.argv[1], sys.argv[2], sys.argv[3])
