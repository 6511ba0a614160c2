#!/usr/bin/env python3
"""Smoke run of janusx_tpu_torch (the PyTorch + CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero; nothing is caught):
 1. require a CUDA card; print ``nvidia-smi`` name and power limit; turn
    TF32 off (the reference's f32 matmuls are full precision);
 2. build the hand-written kernels from csrc/ and print the build seconds
    and each kernel instance's registers and spill bytes (ptxas -v), K2 by
    mode, p and traits per block, while a thread writes phase 5's panel
    (joined before the first timed launch);
 3. K1 decode+rotate on the card in both modes vs its plain PyTorch
    versions at the main path's launch shape (one resident superblock:
    M = 299,008 SNP rows, n = 1410), at the -lowrank route's launch shape
    (the same M and n, N = k = 1000 orthonormal columns), at one 2048-row
    block, at a ragged shape (M = 1000, n = 997) and at a 2048-row block on
    a random U, rtol 1e-5 / atol 1e-4, "high" also within matrix-relative
    1e-5 of "highest" on the random U (the gap on an eigenbasis is printed
    beside the plain versions'); the worst column of "highest", both modes'
    times and the library yardstick (cuBLAS f32 on the decoded block);
 4. K2 λ-lattice on the card in both modes (JX_TPU_GRID_MXU_PREC highest
    and default), each vs its own plain version (G = 256, n = 1410:
    B = 299,008 and B = 2048 with p = 1, B = 2048 with p = 3; ragged
    B = 1000, G = 200, n = 997, p = 2; over a trait axis T = 4 at
    B = 299,008, p = 1, and ragged T = 3 at B = 1000, G = 200, n = 997,
    p = 2): the same finite/inf pattern, finite cells within rtol 1e-4 /
    atol 1e-3, >= 99 % in the same argmin cell at p = 1 (> 50 % at p > 1,
    beside the share of the plain version on the CPU), λ* within 2.02 grid
    spacings, beta/se at each λ* within rtol 2e-3 (beta's absolute floor
    2e-3 se), each trait of a trait-axis launch equal to its single-trait
    launch; "default" also vs the "highest" plain version under K2's
    bounds (finite/inf flips counted and printed); both modes' times at
    T = 1 and T = 4 beside the library yardstick (the grams alone as one
    torch.matmul, f32 or bf16); then N1, the null REML fit's kernel, at the
    dense cell's shape (n = 5,000, p = 1; 1 and 4 lanes) against its plain
    version: log10 λ within 1e-6, -REML and ML within rel 1e-10, both
    timed by CUDA events over 20 calls, beside its bound (the operands read
    once) and the chain of dependent evaluations it waits on;
 5. the main path: a synthetic PLINK panel (1,940 samples, 1,410
    phenotyped, in sibships of 5; 600,000 SNPs, MAF ~ U[0.05, 0.5], 2 %
    missing; the trait is 20 planted QTLs of 3 % variance each + a 20 %
    polygenic background + 20 % noise) through ``jx gwas -lmm -force-model``
    (janusx_tpu_torch.cli.main); checks the TSV, the p-values, λ_null, QTL
    recovery, and that both kernels launched; holds the null fit's launch
    of N1 against its plain version on the phase's own rotated state, as
    phase 4 does; prints per-stage seconds;
 6. cross-check: the first 16,384 QC'd SNPs rescanned on the CPU (plain
    versions) with the same basis: max Δ(-log10 p) <= 0.05, the same top
    5, λ_null within 2e-3; then phase 5's trait rescanned on the card
    through ``lmm_scan`` (no CLI, no QC) in "highest" (Δ(-log10 p) <= 5e-3)
    and with JX_TPU_GRID_MXU_PREC=default (<= 0.05, the same top 5; the
    maximum printed beside the reference's 0.016 on the mouse data);
 7. the trait-level path on the same panel: five traits (phase 5's, three
    more polygenic ones, one of noise that the switch test sends to LM)
    through ``jx gwas -lm -lmm -lmm2 -fvlmm -trait-level`` without
    -force-model, scanning chromosomes 1-5 (``-bimrange``); checks that the noise trait ran as LM, that K1 and K2
    launched once per superblock for the whole trait batch, N1's first
    one-trait and first trait-batch launch against its plain version on
    the phase's own rotated states, that the trait-level TSVs are
    rectangular, that phase 5's trait agrees with phase 5's TSV (Δ(-log10 p) <= 5e-3), and a CPU rescan of the first
    16,384 SNPs of every trait and model (Δ(-log10 p) <= 0.05, same top 5);
 8. the other routes on a -bimrange window of ~29,600 SNPs: ``-lmm
    -scan-method brent`` against phase 5's grid rows (Δ(-log10 p) <=
    5e-3), and ``-lm2 -fvlmm2 -farmcpu -algwas`` with a covariate file
    against CPU rescans (the first 4,096 window SNPs for the interaction
    scans, the whole window for FarmCPU and for ALGWAS's stage-2 scan on
    the markers its stage 1 selected on the card; Δ(-log10 p) <= 0.05,
    same top 5);
 9. the sparse and low-rank routes on phase 5's panel and trait: ``jx gwas
    -lowrank 1000 -splmm -splmm-exact`` (no -force-model, so the low-rank
    LMM->LM switch runs); checks the TSVs, that K1 launched once per
    resident superblock of the -lowrank scan (and K2 never), and CPU
    rescans with the same basis / sparse GRM: the first 16,384 SNPs for
    -lowrank and -splmm-exact, every SNP for -splmm (its γ is calibrated
    on 500 markers drawn from the whole panel), Δ(-log10 p) <= 0.05, same
    top 5, λ_null within 2e-3; prints per-stage seconds, the sparse GRM's
    nnz share and largest component, the rank k, each route's λ_null, and
    -splmm-exact against phase 5's dense -lmm at the planted QTLs;
10. each phase's wall, a JSON line with each kernel's numbers (time,
    plain time, bound and what bounds it, library time; K1's "high" mode
    and its -lowrank shape, K2's "default" mode and its trait axis in both
    modes beside them; G1's and G2's chain alone and their sweep at every
    QC'd SNP of the panel; the launches of each path), then the result
    line;
11. (run before phase 10's lines) genomic selection on phase 5's panel,
    whose 530 unphenotyped samples are the test set: ``jx gs -BLUP -rrBLUP
    -GBLUPad -cv 5 -effect -save-model`` on test0 (the routes GBLUP(add),
    rrBLUP, GBLUP(ad); 530 finite GEBV rows; an HE pre-fit; CV pearson >=
    0.4; the test GEBVs correlate with the simulated genetic values at
    least 0.5 and at least as well as the mean phenotype of the phenotyped
    sibs), ``-BLUP --rrblup-solver pcg -select max`` on phase 7's five
    traits (every trait on rrBLUP(PCG) at its own HE pre-fit λ, or at the
    fixed λ = 1 where the pre-fit hit σg = 0; the TOP files; weights
    summing to 1), ``-hash 2048 -BLUP`` on test0 (every QC'd SNP hashed),
    ``jx gspredict`` with the saved rrBLUP model (the test samples within
    1e-3 sd(GEBV) of the GEBV TSV's rrBLUP column), and the first 16,384
    SNPs through the same GS run, with 2 CV folds, on the card and on the
    CPU (the same routes, λ rel 1e-4, GEBVs rtol 1e-4 / atol 1e-6, CV pearson and HE h2
    within 1e-4); prints each CLI's wall, the run's and each method's
    seconds, and CUDA-event times of one HE stream pass, one marker-effect
    pass and one PCG solve at the run's shapes; neither kernel launches;
12. (run before phase 10's lines) population structure and QC on phase 5's
    panel: ``jx grm --stage-timing -sparse 0.05`` (K symmetric, the
    planted sibships' mean K in [0.45, 0.55] and the mean between them
    within 0.01 of 0, the .spgrm equal to sparsify_grm of the dense K) and
    ``jx grm -part 4`` (the stacked strips equal K's rows within rtol 1e-6,
    floor 1e-6 x mean diagonal); ``jx pca`` by ``-k`` the GRM, by
    ``-bfile`` (the same eigenvalues within rtol 1e-6) and by ``-rsvd``
    (against the exact route: printed only, as the panel has no population
    structure); ``jx gstats -site -ind -king -ldscore 100`` (exactly the
    3,880 full-sib pairs, mean φ within 0.02 of 0.25, an unrelated set of
    one sample per sibship, the site table equal to bitcodec.row_stats at
    %.6g); ``jx fvlmm2 -i`` with ``-k`` the GRM over pairs of planted QTLs
    and of random SNPs in every operator, with and without '!', and one
    unknown name (the TSV layout, the .skip table, at least half of the
    planted literals at joint p < 1e-6, the TSV equal to a rerun of the
    scan on the card at its printed digits); and the card against the CPU
    on the first 16,384 SNPs: the GRM rtol 1e-6 (floor 1e-6 x mean
    diagonal), RSVD eigenvalues rtol 1e-4 with the PC subspaces within 0.01
    rad, the LD scores rtol 1e-5, and the combo scan at the same basis and
    null λ rtol 1e-6 on beta, se and p; prints each CLI's wall and grm's
    stage seconds; neither kernel launches;
13. (run before phase 10's lines) the Bayes methods of ``jx gs`` on the
    first 50,000 SNPs of phase 5's panel (a 50K-array panel): ``jx gs
    -BLUP -BayesB -cv 5`` and ``jx gs -BayesA -BayesCpi -cv 0`` on test0,
    400 iterations each; checks 530 finite GEBV rows per method, BayesB's
    CV pearson at least BLUP's - 0.05, that G1 launched once per iteration
    of each BayesB / BayesCpi fit and G2 once per iteration of the BayesA
    fit (and K1, K2 never), with the plain sweeps made to raise while the
    CLIs run; then G1 (BayesB and BayesCpi) and G2 against their plain
    versions for one sweep from a mid-chain state with the same draws at
    the BayesB fit's shape, block by block (δ identical but for flips
    within 1e-3 of the threshold in log-odds, β, var_b and r within rtol
    1e-4 for G1 and 1e-3 for G2, the one-launch sweep equal to the
    block-by-block launches bit for bit),
    and CUDA-event times of one sweep of each at the BayesB run's shape
    (beside its plain version), with n = 32 samples (the chain alone) and
    at every QC'd SNP of the 600,000; prints each method's fit and CV
    seconds;
14. (run before phase 10's lines) population structure on a 1,940 x
    100,000 panel of three Balding-Nichols populations (F_ST 0.1) with 20 %
    admixed samples: ``jx fastpop -K 3`` (adam-em; the Q recovers the
    planted proportions at r >= 0.95 after the best label permutation)
    and ``jx tree`` on the panel's first 970 samples (each population's
    pure samples form a clade free of the other populations' pure samples,
    by the copied ``_tree_splits``);
    then the card against the CPU on its first 16,384 SNPs: the IBS
    distance bit-equal, and fastpop's Q and P at 10 iterations of its
    default solver within atol 1e-4; no kernel launches;
15. (run before phase 10's lines) GARFIELD, WGCNA, the in-memory API and
    the benchmark CLIs: a trait of an AND of two hom-alt indicators (SNPs
    on chromosomes 1 and 10, each hom-alt in ~20 % of phase 5's phenotyped
    samples) through ``jx garfield -depth 2 -beam 64 -perm 100`` at every
    QC'd SNP (the top rule's indicator correlates r >= 0.9 with the planted
    rule, p = 1/101), ``-width 256 -grm`` (the planted rule in the top 5)
    and ``-w 500 -bimrange 1:0.1-1.6`` on the panel's chromosome 1 (the
    window TSV's layout), each
    with its stage seconds and no kernel launch; ``garfield_scan`` on the
    first 16,384 SNPs on the card and on the CPU from one seed (-perm 20:
    scores and null maxima rtol 1e-5, p-values equal, the same rules off
    ties) and CUDA-event times of one search at full width and of its
    parts; WGCNA on a 400 x 5,000 expression matrix of 8 planted modules
    (cor, pick_soft_threshold, adj, tom, cluster: ARI >= 0.9 over the
    planted genes, the TOM card vs CPU rtol 1e-5 / atol 1e-6) and cor +
    tom at 20,000 genes; ASSOC lm/lmm/fvlmm/splmm on the first 50,000 QC'd
    SNPs with phase 5's GRM (lmm against phase 5's TSV: Δ(-log10 p) <=
    0.05 and the same top 5; card vs CPU on 4,096 SNPs: lm beta/se rtol
    1e-6, lmm Δ(-log10 p) <= 5e-3) and GenomicSelection("BayesB") (G1
    launched once per iteration); ``jx benchmark -repeats 1`` (K1 and K2
    launched inside lmm_scan and K1 inside fvlmm_scan, G2 400 times per
    bayesa fit), ``jx gblupbench``, ``jx bayesbench -iters 400 -burnin
    100`` (G1/G2 launches = iterations x methods) and ``jx garfieldbench
    --and-het-max 1``, each JSON read back and printed. The first launch
    of each kernel at each shape inside GenomicSelection, ``jx benchmark``
    and ``jx bayesbench`` is kept and, after the path, held against the
    plain version on the same inputs at phases 3, 4 and 13's tolerances
    (K1 rtol 1e-5 / atol 1e-4; K2 its own mode's cell and λ* bounds, each
    argmin cell the plain version's or a near-tie within the cell
    tolerance; G1/G2 one sweep block by block from the launch's state, the
    launch's result equal to the block-by-block launches bit for bit).
16. (run before phase 10's lines) the genotype tools and ``jx ggval`` on
    phase 5's panel: ``jx env`` (lists JX_TPU_PLATFORM), ``jx sim`` at its
    defaults, ``jx view`` of the panel and of phase 12's GRM, ``jx refcheck
    -bfile -p``; ``jx gformat -chr 1`` (chromosome 1, the source of the
    one-chromosome tools: ~31,580 SNPs), then ``jx gformat -prune 50 5
    0.2`` on it on the card and on the CPU (every in-window pair on the
    same side of the threshold on both but those whose CPU r² lies within
    1e-5 of it, and with none across it the kept lists identical; the
    whole panel's greedy host walk takes longer than the phase may, see
    scripts/tools_full_width.py), its first 4,096 SNPs to ``-fmt vcf`` and
    ``-fmt hmp`` and back (codes bit-equal), ``jx gmerge`` of its two
    sample halves (the whole, byte for byte); ``jx hybrid`` predict ``-top
    1000`` on the whole panel with its stage seconds, on the first 16,384
    SNPs on the card and on the CPU (every cross among the first 200
    samples within rtol 1e-4 / atol 1e-6) and build mode on 20 x 20
    parents of chromosome 1 to plink (bit-equal to rint((clip(g1) +
    clip(g2)) / 2), the missing calls in place); no kernel launches in
    these. Then ``jx ggval gwas gs gs-vcf gs-hmp grm-pca`` at its defaults
    (every check PASS), with K1 and K2 launched inside its ``jx gwas -lmm``
    and each first launch per shape held against its plain version as in
    phase 15; prints each command's wall beside the card's name and power
    limit, and the phase's wall against its 150 s budget.
17. (run before phase 10's lines) k-mer GWAS at full width: 300 haploid
    genomes of 500 kb (one random reference, 6,000 biallelic sites at least
    64 bases apart, alt frequency ~ U[0.05, 0.5]) as FASTA files, a trait of
    5 planted sites at 16 % of the variance each, a 10 % polygenic
    background and noise; ``jx kmer -k 31 -min-count 1 -stream-db`` over
    them (the first 3 tables equal a plain numpy count of the genome's
    canonical 31-mers), ``jx kmerge -freq 0.05`` (the presence of every
    k-mer that spans a site equals the planted genotypes) and ``jx kstats
    -kbin``, these three in child processes of the port's dispatcher on a
    thread started beside the kernels' build (they launch no kernel, and
    the build leaves most host cores idle; KmerPipeline); then ``jx gwas
    -lmm -force-model`` in process on the merged panel: K1 and
    K2 launched once per resident superblock, each first launch per shape
    held against its plain version as in phase 15, a CPU rescan of the
    first 16,384 k-mers with the same basis (Δ(-log10 p) <= 0.05, the same
    top 5 tests, a site's k-mers counted as one, λ_null within 2e-3), every
    planted site at p < 1e-6 at a k-mer that spans it and the top hit on a
    planted site; the same scan as a web UI job (ui.server in a thread, a
    POST to /submit; its child runs janusx_tpu_torch.cli.main on the card,
    ends ok, and its TSV is the in-process run's within Δ(-log10 p) 5e-3);
    and the native CPU baseline (utils/baseline_cpu.py, built by g++ beside
    nvcc) against the card's brent scan on phase 5's first 2,048 QC'd SNPs
    (the two λ* within twice the Brent tolerance, beta/se within rtol 2e-2
    of the port's f64 epilogue at the baseline's λ*, Δ(-log10 p) < 5e-2)
    with both SNPs/s; prints each command's wall and the phase's against its 150 s
    budget;
18. (run before phase 10's lines) the multi-device path on the one card.
    (b) starts first and runs beside (a): two tests/torch_dist_worker.py
    processes joined by gloo run ``distributed_grm`` on phase 5's QC'd
    panel and ``distributed_scan`` of ``lmm_scan`` with phase 6's basis and
    trait (saved as .npy), and two ``jx grm --distributed`` processes
    build the GRM; the GRMs within rtol 1e-5 / atol 1e-4 of the
    single-process ones (tests/test_sharding.py:537), the scan within (a)'s
    bounds; each child has a time limit. (a) a mesh of two shards on the
    card: the sharded GRM (one cross-shard sum) within rtol 1e-5 / atol
    1e-5 of one device's, its f32 accumulator within the same bound of the
    f64 build; ``lmm_scan`` and ``lmm_scan_multi`` (T = 4) against one
    device (beta/se rtol 2e-3 / atol 1e-6, Δ(-log10 p) <= 5e-3,
    tests/test_sharding.py:82-84, 145; whether bit-equal printed) and
    phase 5's TSV, K1 and K2 launched once per shard per superblock, each
    shard's first launch per shape held against its plain version;
    lm, fvlmm, -lowrank, -splmm, -splmm-exact, -lm2, -fvlmm2 and ALGWAS on
    phase 8's window with the mesh against one device; ``jx gwas
    -bimrange WINDOW -lm -lmm -fvlmm`` on phase 15's chromosome-1 panel
    with JX_TPU_DEVICES=2 and the dispatcher seeing two devices, against
    the same command on one device; prints the phase's wall against its
    90 s budget.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

N_SAMPLES = 1940  # the HS1940 mouse panel
N_PHENO = 1410
M_SNPS = 600_000
CHUNK = 50_000
FAMILY = 5  # children per sibship
SEGMENT = 2_000  # SNPs between recombinations
N_QTL = 20
CROSS_SNPS = 16_384
GRID = 256
TRAITS = ("test0", "t1", "t2", "t3", "flat")  # the trait-level phenotype
MODELS = ("lm", "lmm", "lmm2", "fvlmm")
WINDOW = "1:0.1-1.6"  # -bimrange of phase 8: ~29,580 SNPs of chromosome 1
TRAIT_LEVEL_CHROMS = 5  # phase 7 scans chromosomes 1-5 of 19 (~158,000 SNPs)
LOWRANK_Q = 1000  # -lowrank's kinship SNPs in phase 9: rank k = 1000 < n
HEADER = "chrom\tpos\tsnp\tallele0\tallele1\taf\tmiss\tbeta\tse\tchisq\tpwald"
# the scan and Gibbs kernels' wrappers (ops/kernels.py launch_counts), each
# with no launch; the null fit's kernel, which launches wherever a dense null
# model is fitted, is read apart (null_fit_launches)
NO_LAUNCHES = dict.fromkeys(("decode_rotate", "grid_neg_reml_lattice", "gibbs_sweep_marker",
                             "gibbs_sweep_block_mvn"), 0)


def scan_launches() -> dict:
    """ops/kernels.py's launch counts of NO_LAUNCHES' kernels."""
    from janusx_tpu_torch.ops import kernels

    counts = kernels.launch_counts()
    return {k: counts[k] for k in NO_LAUNCHES}


def null_fit_launches() -> tuple[int, int]:
    """(launches of the null fit's kernel, fits through its plain version)
    since the last kernels.reset_launches()."""
    from janusx_tpu_torch.ops import kernels
    from janusx_tpu_torch.utils import trace

    return kernels.launch_counts()["null_reml_brent"], trace.counts().get("null_fit.plain", 0)


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ timing
def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    calls, from CUDA events around the whole run."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ------------------------------------------------------------ phases 2-4
def ptxas_summary(log: str) -> str:
    """The compiler's resource report (-Xptxas -v) as one entry per kernel
    instance: registers and spill bytes (stores/loads), K2 named by its
    mode, p and traits per block, G1/G2's serial pass by its path (and
    G1's C = 128 case) and their pre-passes; then any wgmma warning as
    printed."""
    import re

    out, warn, name, spill = [], [], "?", "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k1 = re.search(r"decode_rotate_wgmmaILb([01])E", m.group(1))
            k2 = re.search(r"lattice_wgmmaILi(\d)ELi(\d)ELb([01])E", m.group(1))
            g = re.search(r"gibbs_sweep_kernelILi([12])ELb([01])ELi([012])E", m.group(1))
            gp = re.search(r"gibbs_(marker|mvn)_prep_kernel", m.group(1))
            name = (f"K1 {'high' if k1.group(1) == '1' else 'highest'}" if k1 else
                    f"K2 {'default' if k2.group(3) == '1' else 'highest'} "
                    f"p{k2.group(1)} TT{k2.group(2)}" if k2 else
                    f"G{g.group(1)}{' C128' if g.group(2) == '1' else ''} "
                    f"{('cluster', 'grid', 'chunked')[int(g.group(3))]}" if g else
                    f"G{1 if gp.group(1) == 'marker' else 2} pre-pass" if gp else m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name} {m.group(1)} regs spill {spill}")
        if "wgmma" in ln and ("arning" in ln or "serialized" in ln) and ln.strip() not in warn:
            warn.append(ln.strip())
    return "; ".join(out + warn)


def _basis(n: int, seed: int, traits: int = 1):
    """An eigenbasis and ``traits`` traits on it (the first as it always
    was; the others from their own generator)."""
    from janusx_tpu_torch.core.spectral import eigh_grm

    rng = np.random.default_rng(seed)
    g = rng.binomial(2, rng.uniform(0.05, 0.5, 3000)[:, None], size=(3000, n))
    gc = g - g.mean(axis=1, keepdims=True)
    # a trait with a polygenic component on the basis' own SNPs (h2 ~ 0.3),
    # so the REML profile has an interior optimum, as real traits do
    ys = [3.0 + gc.T @ rng.normal(0.0, 0.02, 3000) + rng.normal(size=n)]
    more = np.random.default_rng(seed + 1000)
    ys += [3.0 + gc.T @ more.normal(0.0, 0.02, 3000) + more.normal(size=n)
           for _ in range(traits - 1)]
    return eigh_grm(gc.T @ gc / 3000.0, diag_ridge=1e-6), ys, rng


def _packed_block(M: int, n: int, seed: int, dev):
    """(packed (M, ceil(n/4)) u8, mean (M,) f32), drawn on the device:
    dosages of SNPs with MAF ~ U[0.05, 0.5] and 2 % missing; lanes k >= n
    hold the pad code 3. The mean is each row's mean over its valid
    samples, as QC computes it, so the centered rows are orthogonal to the
    constant vector (the centered GRM's null eigenvector, whose grid weight
    at λ = 1e-5 is ~1e5). A main-path block is ~420 M draws."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    p = 0.05 + 0.45 * torch.rand((M, 1), generator=g, device=dev)
    nb = -(-n // 4)
    u = lambda: torch.rand((M, 4 * nb), generator=g, device=dev)
    codes = (u() < p).to(torch.uint8) + (u() < p).to(torch.uint8)
    codes[(u() < 0.02) | (torch.arange(4 * nb, device=dev) >= n)] = 3
    q = codes.view(M, nb, 4)
    packed = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)
    valid = codes < 3
    mean = (codes * valid).sum(1, dtype=torch.float64) / valid.sum(1).clamp(min=1)
    return packed.contiguous(), mean.float()


def check_k1(dev, M: int, n: int, U_np, seed: int, timed: bool,
             random_u: bool = False):
    """K1 in both modes against its plain versions: "highest" against
    decode_rotate_plain, "high" against decode_rotate_high_plain, each
    within rtol 1e-5 / atol 1e-4, and, on a random U, "high" within
    matrix-relative 1e-5 of "highest". Returns {mode: (max_err, ms,
    plain_ms)} and, timed, the library yardstick under "library": one cuBLAS
    f32 GEMM (TF32 off) of the decoded block by U, the product K1 computes
    (the port never calls it)."""
    import torch

    from janusx_tpu_torch.ops import kernels
    from janusx_tpu_torch.ops.decode import decode_centered

    pk, mn = _packed_block(M, n, seed, dev)
    U = torch.as_tensor(np.ascontiguousarray(U_np), dtype=torch.float32, device=dev)
    U_split = kernels.split_u(U)  # once per basis, as the scan makes it
    plains = {"highest": kernels.decode_rotate_plain,
              "high": kernels.decode_rotate_high_plain}
    res, got = {}, {}
    worst = None
    for prec, plain in plains.items():
        got[prec] = kernels.decode_rotate(pk, mn, U, prec=prec, U_split=U_split)
        want = plain(pk, mn, U)
        torch.cuda.synchronize()
        err = (got[prec] - want).abs()
        ok = bool((err <= 1e-4 + 1e-5 * want.abs()).all())
        max_err = float(err.max())
        require(ok, f"K1 {prec} M={M} n={n} N={U.shape[1]}: outside rtol 1e-5 / atol 1e-4 "
                    f"(max |err| {max_err:.3g})")
        if prec == "highest":
            col_err = err.max(dim=0).values
            j = int(torch.argmax(col_err))
            # the centered GRM's near-constant eigenvector: D u and
            # mean (V u) cancel there, so its error is absolute
            c = int(torch.argmax(U.mean(dim=0).abs()))
            worst = (j, float(col_err[j]), c, float(col_err[c]))
        del want, err
        ms = pl = None
        if timed:
            ms = cuda_ms(lambda: kernels.decode_rotate(pk, mn, U, prec=prec, U_split=U_split))
            pl = cuda_ms(lambda: plain(pk, mn, U))
        res[prec] = (max_err, ms, pl)
    # matrix-relative gap of "high" to "highest": the reference's bound is
    # 1e-5 (tests/test_pallas.py:134), set on a random U. On an eigenbasis
    # the bf16x3 algorithm itself lands further off (its dropped terms add
    # up coherently in the near-constant column): there the gap is reported
    # beside the plain versions' own, and the elementwise checks above
    # already bound it by that gap plus both kernels' errors
    top = float(got["highest"].abs().max())
    rel = float((got["high"] - got["highest"]).abs().max()) / top
    rel_p = float((plains["high"](pk, mn, U) - plains["highest"](pk, mn, U))
                  .abs().max()) / top
    if random_u:
        require(rel < 1e-5, f"K1 high M={M} n={n}: {rel:.3g} from highest, "
                            "matrix-relative, on a random U")
    lib = ""
    if timed:
        decoded = decode_centered(pk, mn, torch.float32)[:, :n].contiguous()
        res["library"] = cuda_ms(lambda: decoded @ U)
        lib = f"; library (cuBLAS f32 on the decoded block) {res['library']:.4f} ms"
        del decoded
    t = lambda r: f", kernel {r[1]:.4f} ms, plain {r[2]:.4f} ms" if timed else ""
    say(f"phase 3 K1 decode_rotate M={M} n={n} N={U.shape[1]}: ok; highest max|err|="
        f"{res['highest'][0]:.3g}"
        f"{t(res['highest'])}; worst column {worst[0]} ({worst[1]:.3g}), near-constant "
        f"column {worst[2]} ({worst[3]:.3g}); high max|err|={res['high'][0]:.3g}"
        f"{t(res['high'])}, {rel:.3g} from highest, matrix-relative (plain "
        f"versions {rel_p:.3g}){lib}")
    return res


def _k2_bounds(what: str, got, want, grid, rots, Gr, own: bool, same_min: float = 0.99):
    """K2's bounds of ``got`` (T, B, G) against ``want``: λ* within 2.02
    grid spacings with > 50 % in the same argmin grid cell, beta/se at each
    λ* within rtol 2e-3 (beta's absolute floor 2e-3 se). ``own`` (against
    the mode's own plain version, which differs in summation order only)
    adds the same finite/inf pattern, finite cells within rtol 1e-4 / atol
    1e-3 and at least ``same_min`` in the same argmin cell. Against the other mode's
    plain version the pattern differs by construction where r'Wr or the
    Schur complement is a near-cancellation that one bf16 pass turns
    negative (at the grid's smallest λ): those cells are counted and the
    first is printed. Without ``rots`` (None) the beta/se check is left
    out. Returns (max |err| over cells finite in both, detail)."""
    import torch

    from janusx_tpu_torch.core.reml import argmin_parabolic, final_stats_f32

    T, B, G = got.shape
    fin = torch.isfinite(want) & torch.isfinite(got)
    flip = torch.isfinite(got) != torch.isfinite(want)
    flips = "finite/inf pattern equal"
    if bool(flip.any()):
        i = int(torch.nonzero(flip.reshape(-1))[0])
        t, b, g = i // (B * G), i // G % B, i % G
        flips = (f"finite/inf pattern differs in {int(flip.sum())} of {flip.numel()} cells, "
                 f"first (trait {t}, SNP {b}, λ cell {g}): {float(got[t, b, g]):.7g} vs "
                 f"{float(want[t, b, g]):.7g}")
        require(not own, f"{what}: {flips}")
    err = (got[fin] - want[fin]).abs()
    max_err = float(err.max()) if bool(fin.any()) else 0.0
    rel = float((err / want[fin].abs()).max()) if bool(fin.any()) else 0.0
    lg_k = argmin_parabolic(got.reshape(T * B, G), grid).reshape(T, B)
    lg_p = argmin_parabolic(want.reshape(T * B, G), grid).reshape(T, B)
    h = float(grid[1] - grid[0])
    dlg = (lg_k - lg_p).abs()
    # "identical" = the same argmin grid cell; the parabolic refinement
    # then still moves with the last f32 bits of the three cells it reads
    same = float((torch.argmin(got, -1) == torch.argmin(want, -1)).double().mean())
    detail = (f"{flips}, max|err| {max_err:.3g} (rel {rel:.3g}), λ* max move "
              f"{float(dlg.max()) / h:.3g} spacings, same argmin cell {same:.2%}, "
              f"λ* equal to 1e-6 {float((dlg < 1e-6).double().mean()):.1%}")
    if own:
        require(bool((err <= 1e-3 + 1e-4 * want[fin].abs()).all()),
                f"{what}: finite cells outside rtol 1e-4 / atol 1e-3; {detail}")
        require(same >= same_min, f"{what}: under {same_min:.0%} in the same argmin cell; "
                                  f"{detail}")
    require(bool((dlg <= 2.02 * h).all()), f"{what}: λ* moved > 2.02 spacings; {detail}")
    require(same > 0.5, f"{what}: too few identical argmin cells; {detail}")
    for t, rot in enumerate(rots or ()):
        b_k, se_k, _ = final_stats_f32(rot, Gr, lg_k[t], False)
        b_p, se_p, _ = final_stats_f32(rot, Gr, lg_p[t], False)
        # rtol 2e-3 (tests/test_pallas.py:102-110); a beta that is ~0 against
        # its own standard error gets the absolute floor 2e-3 * se (z within 2e-3)
        for a, b, nm, floor in ((b_k, b_p, "beta", 2e-3 * se_p), (se_k, se_p, "se", 1e-6)):
            ok = torch.isfinite(b)
            require(torch.equal(torch.isfinite(a), ok), f"{what}: {nm} NaN lanes differ")
            bad = (a - b).abs() > floor + 2e-3 * b.abs()
            i = int(torch.argmax(((a - b).abs() / b.abs()).nan_to_num(0.0)))
            require(not bool(bad[ok].any()),
                    f"{what} trait {t}: {nm} at λ* outside rtol 2e-3 in {int(bad[ok].sum())} "
                    f"lanes; worst lane {i}: {float(a[i]):.6g} vs {float(b[i]):.6g}, λ* "
                    f"{float(lg_k[t, i]):.6f} vs {float(lg_p[t, i]):.6f}; {detail}")
    return max_err, detail


def _grams_library_ms(Gr, W, YX, T: int, p: int, prec: str) -> float:
    """The library yardstick of K2: its grams alone as one torch.matmul of
    the stacked products ((1 + p + T) B, n) against Wᵀ, f32 with TF32 off
    for "highest", bf16 for "default" (the port never calls it)."""
    import torch

    n = Gr.shape[1]
    A = torch.cat([Gr * Gr] + [Gr * YX[T + q, :n] for q in range(p)]
                  + [Gr * YX[t, :n] for t in range(T)])
    Wt = W[:, :n].T
    if prec == "default":
        A, Wt = A.to(torch.bfloat16), Wt.to(torch.bfloat16)
    ms = cuda_ms(lambda: torch.matmul(A, Wt))
    del A
    return ms


def check_k2(dev, basis, ys, rng, B: int, G: int, p: int, seed: int, timed: bool):
    """K2 in both modes for the traits ``ys``, which share the basis, the
    covariates and the grid: one trait in the single-trait layout, several
    in one trait-axis launch (whose plain version is the reference's loop
    over traits). Each mode against its own plain version (_k2_bounds with
    ``own``), "default" also against the "highest" plain version under K2's
    bounds; each trait of a trait-axis launch must equal the single-trait
    launch on that trait bit for bit. Returns {mode: (max |err|, ms,
    plain ms, library ms)}."""
    import torch

    from janusx_tpu_torch import config
    from janusx_tpu_torch.core.reml import grid_shared, make_grid, make_rotated
    from janusx_tpu_torch.models.lmm import _lattice_operands, _lattice_operands_multi
    from janusx_tpu_torch.ops import kernels

    n, T = basis.n, len(ys)
    cov = rng.normal(size=(n, p - 1)) if p > 1 else None
    rots = [make_rotated(basis, y, cov, device=dev) for y in ys]
    grid = make_grid(G, dev)
    shs = [grid_shared(rot, grid) for rot in rots]
    W, YX, SH = (_lattice_operands(shs[0], rots[0]) if T == 1
                 else _lattice_operands_multi(shs, rots))
    W_split = kernels.split_w(W)  # once per scan, as the scan makes it
    pk, mn = _packed_block(B, n, seed, dev)
    # Gr in the scan's layout: rows padded to 16 bytes (decode_rotate's
    # row_align=4), which K2 reads without a copy
    Gr = torch.empty((B, -(-n // 4) * 4), dtype=torch.float32, device=dev)[:, :n]
    Gr.copy_(kernels.decode_rotate_plain(pk, mn, torch.as_tensor(
        np.ascontiguousarray(basis.U), dtype=torch.float32, device=dev)))
    args = (Gr, W, YX, SH, p, config.GRAM_RIDGE, float(n))
    highest = kernels.grid_neg_reml_lattice_plain(*args).reshape(T, B, G)
    # >= 99 % of SNPs in the same argmin cell on the main path's p = 1; with
    # more covariates the share two f32 summation orders keep is printed
    # beside it: the plain version on the CPU against the one on the card
    same_min, control = 0.99, ""
    if p > 1:
        cpu = kernels.grid_neg_reml_lattice_plain(
            *(a.cpu() if torch.is_tensor(a) else a for a in args)).reshape(T, B, G)
        share = float((torch.argmin(cpu, -1) == torch.argmin(highest.cpu(), -1))
                      .double().mean())
        same_min = 0.5
        control = (f"; the highest plain version on the CPU and on the card share the "
                   f"argmin cell in {share:.2%}")
        del cpu
    res = {}
    for prec in kernels.GRID_PRECS:
        what = f"K2 {prec} T={T} p={p}"
        got = kernels.grid_neg_reml_lattice(*args, prec=prec, W_split=W_split).reshape(T, B, G)
        want = (highest if prec == "highest" else
                kernels.grid_neg_reml_lattice_plain(*args, prec=prec).reshape(T, B, G))
        torch.cuda.synchronize()
        max_err, detail = _k2_bounds(what, got, want, grid, rots, Gr, own=True,
                                     same_min=same_min)
        detail += control
        if prec == "default":
            _, vs = _k2_bounds(f"{what} against the highest plain version", got, highest,
                               grid, rots, Gr, own=False)
            detail += f"; against the highest plain version: {vs}"
        del want
        if T > 1:
            for t in range(T):
                YX1 = torch.cat([YX[t:t + 1], YX[T:]]).contiguous()
                one = kernels.grid_neg_reml_lattice(Gr, W, YX1, SH[t], p, config.GRAM_RIDGE,
                                                    float(n), prec=prec, W_split=W_split)
                require(torch.equal(got[t], one), f"{what}: trait {t} differs from its "
                                                  "single-trait launch")
            detail += "; each trait equal to its single-trait launch"
        del got
        ms = plain = lib = None
        if timed:
            ms = cuda_ms(lambda: kernels.grid_neg_reml_lattice(*args, prec=prec,
                                                               W_split=W_split))
            plain = cuda_ms(lambda: kernels.grid_neg_reml_lattice_plain(*args, prec=prec))
            lib = _grams_library_ms(Gr, W, YX, T, p, prec)
        say(f"phase 4 K2 grid_neg_reml_lattice {prec} T={T} B={B} G={G} n={n} p={p}: ok, "
            f"{detail}" + (f", kernel {ms:.4f} ms, plain {plain:.4f} ms, library (grams "
                           f"only) {lib:.4f} ms" if timed else ""))
        res[prec] = (max_err, ms, plain, lib)
    return res


# ------------------------------------------------------------ phase 5
def write_panel(d: str, m: int, seed: int = 20261016):
    """Synthetic PLINK panel + phenotype file, generated in 50k-SNP chunks.

    Samples come in sibships (FAMILY children of two unrelated parents,
    one recombination per SEGMENT SNPs), so the GRM carries relatedness as
    in a real panel and the null REML has an interior optimum. Returns
    (prefix, pheno_path, qtl_ids, expected_kept): expected_kept counts the
    SNPs that pass the default QC (MAF >= 0.02, missing <= 0.05) on the
    phenotyped samples, computed here directly from the genotypes.

    Beside the trait test0 it draws, from its own generator, three more
    traits for the trait-level phenotype (write_traits), each with a 40 %
    polygenic background. Last it returns each sample's simulated genetic
    value of test0 (g_bg + g_qtl), which genomic selection predicts."""
    from janusx_tpu_torch.io import bitcodec
    from janusx_tpu_torch.io.gdata import SiteInfo
    from janusx_tpu_torch.io.plink import write_plink

    rng = np.random.default_rng(seed)
    n = N_SAMPLES
    fam = np.arange(n) // FAMILY
    phen = np.sort(rng.choice(n, N_PHENO, replace=False))
    cross = min(CROSS_SNPS, m)
    qtl = np.sort(np.concatenate([
        rng.choice(cross, 8, replace=False),
        rng.choice(np.arange(cross, m), N_QTL - 8, replace=False)]))
    qtl_eff = rng.choice([-1.0, 1.0], N_QTL) * np.sqrt(0.03)  # ~3 % each
    packed = np.empty((m, bitcodec.n_bytes(n)), np.uint8)
    g_bg = np.zeros(n)
    g_qtl = np.zeros(n)
    more = np.random.default_rng(seed + 1)
    g_more = np.zeros((n, 3))
    kept = 0
    for s in range(0, m, CHUNK):
        e = min(s + CHUNK, m)
        k = e - s
        p = rng.uniform(0.05, 0.5, k).astype(np.float32)[:, None]
        # parental haplotypes: columns 4f + (0, 1) father, 4f + (2, 3) mother
        haps = (rng.random((k, 4 * (fam[-1] + 1)), dtype=np.float32) < p).astype(np.uint8)
        g = np.empty((k, n), np.uint8)
        for r0 in range(0, k, SEGMENT):
            r1 = min(r0 + SEGMENT, k)
            pat = 4 * fam + rng.integers(0, 2, n)
            mat = 4 * fam + 2 + rng.integers(0, 2, n)
            g[r0:r1] = haps[r0:r1, pat] + haps[r0:r1, mat]
        miss = rng.random((k, n), dtype=np.float32) < 0.02
        packed[s:e] = bitcodec.pack_codes(np.where(miss, np.uint8(3), g))
        x = np.where(miss, np.float32(0.0), (g - 2 * p) / np.sqrt(2 * p * (1 - p)))
        g_bg += x.T @ rng.normal(0.0, np.sqrt(0.2 / m), k).astype(np.float32)
        g_more += x.T @ more.normal(0.0, np.sqrt(0.4 / m), (k, 3)).astype(np.float32)
        for qi in np.nonzero((qtl >= s) & (qtl < e))[0]:
            g_qtl += qtl_eff[qi] * x[qtl[qi] - s]
        nm = (~miss[:, phen]).sum(axis=1)
        alt = np.where(miss[:, phen], 0, g[:, phen]).sum(axis=1, dtype=np.int64)
        af = alt / np.maximum(2.0 * nm, 1.0)
        kept += int(((1.0 - nm / N_PHENO <= 0.05) & (np.minimum(af, 1 - af) >= 0.02)
                     & (nm > 0)).sum())
    chrom = (np.arange(m) * 19 // m + 1).astype(str).astype(object)
    sites = SiteInfo(chrom=chrom, pos=np.arange(1, m + 1, dtype=np.int64) * 50,
                     snp=np.array([f"snp{i}" for i in range(m)], object),
                     allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    samples = np.array([f"ind{j}" for j in range(n)], object)
    prefix = os.path.join(d, "panel")
    write_plink(prefix, packed, n, sites, samples)
    y = 10.0 + g_bg + g_qtl + rng.normal(0.0, np.sqrt(0.2), n)
    is_phen = np.zeros(n, bool)
    is_phen[phen] = True
    pheno = prefix + ".pheno"
    with open(pheno, "wt") as fh:
        fh.write("ID\ttest0\n")
        for j in range(n):
            fh.write(f"ind{j}\t{y[j]:.6f}\n" if is_phen[j] else f"ind{j}\tNA\n")
    Y = np.column_stack([y, 10.0 + g_more + more.normal(0.0, np.sqrt(0.6), (n, 3))])
    Y[~is_phen] = np.nan
    return prefix, pheno, {f"snp{i}" for i in qtl}, kept, Y, g_bg + g_qtl


def read_tsv(path: str):
    with open(path) as fh:
        header = fh.readline().rstrip("\n")
        rows = [ln.rstrip("\n").split("\t") for ln in fh]
    return header, rows


def run_cli(argv, phase: str):
    """A ``jx`` module through the port's CLI with every launch count (and
    null_fit.*) set to 0 just before: returns (what it printed, wall
    seconds, NO_LAUNCHES' launches)."""
    from janusx_tpu_torch.cli.main import main as cli_main
    from janusx_tpu_torch.ops import kernels
    from janusx_tpu_torch.utils import trace

    kernels.reset_launches()
    trace.reset("null_fit.")
    buf = io.StringIO()
    t1 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    wall = time.monotonic() - t1
    launches = scan_launches()
    printed = buf.getvalue().strip()
    say(f"{phase} cli: rc={rc} wall={wall:.2f} s :: " + printed.replace("\n", " | "))
    require(rc == 0, f"{phase}: {argv[0]} CLI returned {rc}")
    return printed, wall, launches


def stage_line(summary, runs=None) -> str:
    """The run's shared stage seconds, then each run's own."""
    parts = [f"{k}={v:.3f}" for k, v in summary["stages"].items()]
    for r in summary["runs"] if runs is None else runs:
        if r["stages"]:
            parts.append(f"[{r['trait']} {r['requested']}] " + ", ".join(
                f"{k}={v:.3f}" for k, v in r["stages"].items()))
    return "; ".join(parts)


def agree(card_p, cpu_p, what: str, bound: float) -> float:
    """max Δ(-log10 p) <= bound and the same top 5; returns the max."""
    lp_card, lp_cpu = -np.log10(np.asarray(card_p)), -np.log10(np.asarray(cpu_p))
    require(bool(np.all(np.isfinite(lp_card))), f"{what}: non-finite p-values")
    dmax = float(np.max(np.abs(lp_card - lp_cpu)))
    require(dmax <= bound, f"{what}: max Δ(-log10 p) {dmax:.4g} > {bound}")
    top = lambda lp: set(np.argsort(-lp, kind="stable")[:5])
    require(top(lp_card) == top(lp_cpu), f"{what}: top-5 SNPs differ")
    return dmax


def p_col(rows, header: str, col: str = "pwald") -> np.ndarray:
    i = header.split("\t").index(col)
    return np.array([float(r[i]) for r in rows])


def read_head(path: str, k: int):
    """The header and the first k rows of a TSV."""
    with open(path) as fh:
        header = fh.readline().rstrip("\n")
        rows = [fh.readline().rstrip("\n").split("\t") for _ in range(k)]
    return header, [r for r in rows if r != [""]]


def write_panel_async(d: str, m: int):
    """Start write_panel(d, m) on a thread, so that the host writes phase
    5's panel while nvcc builds the kernels; returns a function that waits
    for it and returns (write_panel's result, its seconds)."""
    out = {}

    def run():
        t0 = time.monotonic()
        try:
            out["panel"] = write_panel(d, m)
        except BaseException as e:  # raised again by the join below
            out["error"] = e
        out["s"] = time.monotonic() - t0

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def join():
        th.join()
        if "error" in out:
            raise out["error"]
        return out["panel"], out["s"]

    return join


def run_main_path(d: str, m: int, panel):
    """Panel -> CLI -> checks, on ``panel`` = (write_panel's result, its
    seconds). Returns (prefix, pheno, rows, summary, launches, qtl_ids, Y,
    the genetic values)."""
    (prefix, pheno, qtl_ids, kept, Y, gv), secs = panel
    say(f"phase 5 panel: {N_SAMPLES} samples ({N_PHENO} phenotyped) x {m} SNPs "
        f"written in {secs:.2f} s, beside the kernels' build; {kept} SNPs pass QC")
    out = os.path.join(d, "out")
    with held_null_fits() as held_fits:
        printed, _, launches = run_cli(["gwas", "-bfile", prefix, "-p", pheno, "-lmm",
                                        "-force-model", "-n", "0", "-o", out], "phase 5")
    # the reference's run line: trait, model, n=, m=, seconds, TSV
    fields = printed.splitlines()[-1].split("\t")
    require(len(fields) == 6 and fields[2].startswith("n=") and fields[4].endswith("s"),
            f"run line {fields}")
    require(launches["decode_rotate"] > 0 and launches["grid_neg_reml_lattice"] > 0
            and launches["gibbs_sweep_marker"] == launches["gibbs_sweep_block_mvn"] == 0,
            f"launches {launches}: K1 and K2 must launch, the Gibbs sweeps not")
    card_fits, plain_fits = null_fit_launches()
    require(card_fits >= 1 and plain_fits == 0, f"phase 5 null fits: {card_fits} launches "
            f"of null_reml_brent, {plain_fits} through the plain version")
    launches = {**launches, "null_reml_brent": card_fits}
    hold_null_fits(held_fits, "phase 5")
    header, rows = read_tsv(os.path.join(out, "jx.test0.LMM.assoc.tsv"))
    require(header == HEADER, f"TSV header {header!r}")
    require(len(rows) == kept, f"TSV has {len(rows)} rows, {kept} SNPs pass QC")
    pw = np.array([float(r[10]) for r in rows])
    require(bool(np.all(np.isfinite(pw) & (pw > 0) & (pw <= 1))), "non-finite p-values")
    sig = sum(1 for r in rows if r[2] in qtl_ids and float(r[10]) < 5e-8)
    require(sig >= N_QTL // 2, f"only {sig}/{N_QTL} planted QTLs reach p < 5e-8")
    with open(os.path.join(out, "jx.gwas.summary.json")) as fh:
        summary = json.load(fh)
    lam = summary["runs"][0]["lambda_null"]
    require(lam is not None and np.isfinite(lam) and lam > 0, f"λ_null {lam}")
    st = dict(summary["stages"], **summary["runs"][0]["stages"])
    scan = st["scan"]
    say("phase 5 stages (s): " + ", ".join(f"{k}={v:.3f}" for k, v in st.items())
        + f"; scan {len(rows) / scan:.0f} SNPs/s; {sig}/{N_QTL} QTLs at p < 5e-8; "
        f"launches {launches}")
    return prefix, pheno, rows, summary, launches, qtl_ids, Y, gv


def cross_check(prefix: str, pheno: str, rows, summary) -> dict:
    """The first CROSS_SNPS QC'd SNPs rescanned with the plain versions on
    the CPU, from the same cached GRM and the same eigendecomposition.
    Returns the CPU side (the analysis samples' packed genotypes and basis,
    the full sample set's packed genotypes and GRM) for the later phases'
    rescans."""
    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.io.gfreader import load_raw_packed
    from janusx_tpu_torch.io.packed import QcParams
    from janusx_tpu_torch.io.pheno import load_phenotype
    from janusx_tpu_torch.models.lmm import lmm_scan
    from janusx_tpu_torch.models.scan_common import analysis_sample_index
    from janusx_tpu_torch.utils.cache import load_or_build_grm

    t0 = time.monotonic()
    raw = load_raw_packed(prefix)
    y_all, _ = load_phenotype(pheno).select(["0"]).align(raw.samples)
    keep = analysis_sample_index(y_all[:, 0])
    qc = QcParams()
    full = raw.prepare(qc)
    K = load_or_build_grm(prefix, full, qc.maf, qc.geno)
    pg = raw.prepare(qc, sample_idx=keep)
    basis = eigh_grm(K[np.ix_(keep, keep)], diag_ridge=1e-6)
    k = min(CROSS_SNPS, pg.m)
    head = pg.take_snps(np.arange(k))
    res, null = lmm_scan(head, basis, y_all[keep, 0], device="cpu")
    card = rows[:k]
    require([r[2] for r in card] == list(res.sites.snp), "cross-check SNP rows differ")
    dmax = agree([float(r[10]) for r in card], res.pwald, "phase 6 cross-check", 0.05)
    lam_card = summary["runs"][0]["lambda_null"]
    rel = abs(null.lbd - lam_card) / lam_card
    require(rel <= 2e-3, f"cross-check λ_null {null.lbd:.6g} vs {lam_card:.6g}")
    say(f"phase 6 cross-check {k} SNPs on cpu: max Δ(-log10 p)={dmax:.3g}, top-5 equal, "
        f"λ_null card={lam_card:.6g} cpu={null.lbd:.6g} (rel {rel:.2g}); "
        f"{time.monotonic() - t0:.2f} s")
    return dict(keep=keep, pg=pg, head=head, basis=basis, y=y_all[keep, 0], full=full, K=K)


def write_traits(prefix: str, Y, cpu) -> tuple:
    """The trait-level phenotype: phase 5's trait test0, three more
    polygenic traits and one with no polygenic signal, all on the same
    phenotyped samples. The last is noise, drawn until the LMM->LM switch
    test sends it to LM, as it does 95 % of pure-noise draws. Returns the
    file and the traits (N_SAMPLES, 5)."""
    from janusx_tpu_torch.workflows.gwas import lmm_to_lm_switch_p

    rng = np.random.default_rng(7)
    keep = cpu["keep"]
    while True:
        flat = np.where(np.isnan(Y[:, 0]), np.nan, 10.0 + rng.normal(size=len(Y)))
        if lmm_to_lm_switch_p(cpu["basis"], flat[keep], None) >= 0.05:
            break
    Y = np.column_stack([Y, flat])
    path = prefix + ".traits.pheno"
    with open(path, "wt") as fh:
        fh.write("ID\t" + "\t".join(TRAITS) + "\n")
        for j, row in enumerate(Y):
            fh.write(f"ind{j}\t" + "\t".join("NA" if np.isnan(v) else f"{v:.6f}"
                                              for v in row) + "\n")
    return path, Y


def run_trait_level(d: str, prefix: str, Y, rows5, cpu) -> dict:
    """Phase 7: ``jx gwas -lm -lmm -lmm2 -fvlmm -trait-level`` over five
    traits (no -force-model), scanning the panel's first TRAIT_LEVEL_CHROMS
    chromosomes (-bimrange; the GRM from the whole panel). Returns the
    launches."""
    from janusx_tpu_torch.models import fvlmm, lm, lmm
    from janusx_tpu_torch.models.lmm import lattice_superblock

    t0 = time.monotonic()
    pheno, Y = write_traits(prefix, Y, cpu)
    out = os.path.join(d, "out7")
    chroms = [str(c) for c in range(1, TRAIT_LEVEL_CHROMS + 1)]
    ranges = [a for c in chroms for a in ("-bimrange", f"{c}:0-{M_SNPS * 50 / 1e6:g}")]
    rows5 = [r for r in rows5 if r[0] in chroms]
    with held_null_fits() as held_fits:
        _, wall, launches = run_cli(["gwas", "-bfile", prefix, "-p", pheno, "-lm", "-lmm",
                                     "-lmm2", "-fvlmm", "-trait-level", *ranges, "-o", out],
                                    "phase 7")
    with open(os.path.join(out, "jx.gwas.summary.json")) as fh:
        summary = json.load(fh)
    runs = {(r["trait"], r["requested"]): r for r in summary["runs"]}
    require(len(runs) == len(TRAITS) * len(MODELS), f"runs {sorted(runs)}")
    flat = [runs[(TRAITS[-1], m)]["model"] for m in MODELS]
    require(flat == ["lm"] * 4, f"the trait with no polygenic signal ran {flat}, not LM")
    for t in TRAITS[:-1]:
        ran = [runs[(t, m)]["model"] for m in MODELS]
        require(ran == list(MODELS), f"trait {t} ran {ran}")
    # one K1 launch per superblock for the whole trait batch: the T = 4
    # lattice route (lmm, lmm2) in its own superblocks, fvlmm in one
    m = len(rows5)
    sb4 = -(-m // lattice_superblock(N_PHENO, GRID, 2048, traits=4))
    want = {**NO_LAUNCHES, "decode_rotate": 2 * sb4 + -(-m // (1 << 20)),
            "grid_neg_reml_lattice": 2 * sb4}
    require(launches == want, f"launches {launches}, expected {want} (one per "
                              f"superblock for all {len(TRAITS) - 1} traits)")
    card_fits, plain_fits = null_fit_launches()
    require(card_fits >= 1 and plain_fits == 0, f"phase 7 null fits: {card_fits} launches "
            f"of null_reml_brent, {plain_fits} through the plain version")
    launches = {**launches, "null_reml_brent": card_fits}
    hold_null_fits(held_fits, "phase 7")
    # rectangular trait-level TSVs, grouped by header
    for name in ("traitlevel", "traitlevel.lmm2"):
        with open(os.path.join(out, f"jx.{name}.assoc.tsv")) as fh:
            ncol = fh.readline().count("\t")
            bad = sum(1 for ln in fh if ln.count("\t") != ncol)
        require(bad == 0, f"jx.{name}.assoc.tsv: {bad} rows of another width")
    # the trait-level LMM of phase 5's trait against phase 5's own TSV
    header, rows = read_tsv(os.path.join(out, "jx.test0.LMM.assoc.tsv"))
    require([r[2] for r in rows] == [r[2] for r in rows5], "test0 SNP rows differ")
    d5 = agree(p_col(rows, header), [float(r[10]) for r in rows5],
               "phase 7 test0 vs phase 5", 5e-3)
    say(f"phase 7 stages (s): {stage_line(summary)}")
    # CPU rescan of the first CROSS_SNPS SNPs of every model
    t1 = time.monotonic()
    keep, head, basis = cpu["keep"], cpu["head"], cpu["basis"]
    k = head.m
    Yk = Y[keep]
    Ym = Yk[:, :-1]
    lms = lm.lm_scan_multi(head, Yk, device="cpu")
    lmm2s = lmm.lmm_scan_multi(head, basis, Ym, lmm2=True, device="cpu")[0]
    fvs = fvlmm.fvlmm_scan_multi(head, basis, Ym, device="cpu")[0]
    worst = 0.0
    for ti, t in enumerate(TRAITS):
        # the switched trait's runs are its LM scan under each model's tag
        mixed = (lambda res: lms[ti]) if t == TRAITS[-1] else (lambda res: res[ti])
        for tag, r in (("LM", lms[ti]), ("LMM", mixed(lmm2s)), ("LMM2", mixed(lmm2s)),
                       ("FvLMM", mixed(fvs))):
            header, rows = read_head(os.path.join(out, f"jx.{t}.{tag}.assoc.tsv"), k)
            require([x[2] for x in rows] == list(r.sites.snp), f"{t} {tag}: SNP rows differ")
            for col in ("pwald", "plrt"):
                if col in header.split("\t"):
                    worst = max(worst, agree(p_col(rows, header, col), getattr(r, col),
                                             f"phase 7 {t} {tag} {col}", 0.05))
    say(f"phase 7 trait-level: {len(TRAITS)} traits x {len(MODELS)} models on chromosomes "
        f"1-{TRAIT_LEVEL_CHROMS} ({m} SNPs), "
        f"{TRAITS[-1]} switched to LM, launches {launches} ({sb4} T=4 superblocks), "
        f"test0 vs phase 5 max Δ(-log10 p)={d5:.3g}; cpu rescan of {k} SNPs, every "
        f"model: max Δ(-log10 p)={worst:.3g}, top-5 equal ({time.monotonic() - t1:.2f} s); "
        f"cli {wall:.2f} s, phase {time.monotonic() - t0:.2f} s")
    return launches


def run_routes(d: str, prefix: str, pheno: str, rows5, qtl_ids, Y, cpu) -> dict:
    """Phase 8: the other routes on a -bimrange window of ~30,000 SNPs:
    -lmm -scan-method brent held to phase 5's grid rows, then -lm2 -fvlmm2
    -farmcpu with a covariate file, held to CPU rescans."""
    from janusx_tpu_torch.io.pheno import load_covariates
    from janusx_tpu_torch.models import farmcpu, gxe

    t0 = time.monotonic()
    out = os.path.join(d, "out8b")
    _, wall, launches = run_cli(["gwas", "-bfile", prefix, "-p", pheno, "-lmm",
                                 "-scan-method", "brent", "-bimrange", WINDOW, "-n", "0",
                                 "-o", out], "phase 8 brent")
    require(launches["decode_rotate"] > 0 and launches["grid_neg_reml_lattice"] == 0,
            f"brent launches {launches}")
    header, rows = read_tsv(os.path.join(out, "jx.test0.LMM.assoc.tsv"))
    grid = {r[2]: float(r[10]) for r in rows5}
    require(len(rows) > M_SNPS // 60 and all(r[2] in grid for r in rows),
            f"the window holds {len(rows)} SNPs of phase 5's")
    db = agree(p_col(rows, header), [grid[r[2]] for r in rows],
               "phase 8 brent vs grid", 5e-3)
    say(f"phase 8 brent: {len(rows)} SNPs, max Δ(-log10 p) vs phase 5's grid "
        f"{db:.3g}, launches {launches}, cli {wall:.2f} s")

    rng = np.random.default_rng(8)
    cov_path = prefix + ".cov"
    with open(cov_path, "wt") as fh:
        fh.write("ID\tc0\tc1\n")
        fh.writelines(f"ind{j}\t{a:.6f}\t{1.5 + b:.6f}\n"
                      for j, (a, b) in enumerate(rng.normal(size=(N_SAMPLES, 2))))
    out = os.path.join(d, "out8g")
    _, wall_g, _ = run_cli(["gwas", "-bfile", prefix, "-p", pheno, "-lm2", "-fvlmm2",
                            "-farmcpu", "-algwas", "-c", cov_path, "-bimrange", WINDOW,
                            "-n", "0", "-o", out], "phase 8 lm2/fvlmm2/farmcpu/algwas")
    keep, pg, basis = cpu["keep"], cpu["pg"], cpu["basis"]
    # a set, not np.isin: on object arrays np.isin compares element by element
    window = {r[2] for r in rows}
    idx = np.array([i for i, snp in enumerate(pg.sites.snp) if snp in window])
    win = pg.take_snps(idx)
    cov = load_covariates(cov_path, np.array([f"ind{j}" for j in range(N_SAMPLES)],
                                             object))[keep]
    y = Y[keep, 0]
    k = min(4096, win.m)
    head = win.take_snps(np.arange(k))
    cpu_res = {"LM2": gxe.gxe_scan(head, y, cov[:, 1], cov[:, :1], device="cpu")[0],
               "FvLMM2": gxe.gxe_scan(head, y, cov[:, 1], cov[:, :1], basis=basis,
                                      device="cpu")[0],
               "FarmCPU": farmcpu.farmcpu_scan(win, y, cov).result}
    worst = 0.0
    for tag, res in cpu_res.items():
        path = os.path.join(out, f"jx.test0.{tag}.assoc.tsv")
        header, rows = read_tsv(path) if tag == "FarmCPU" else read_head(path, k)
        require([r[2] for r in rows] == list(res.sites.snp), f"{tag}: SNP rows differ")
        cols = [c for c in ("pwald", "pwald_i1", "p_int_joint", "p_joint")
                if c in header.split("\t")]
        for col in cols:
            cpu_p = res.pwald if col == "pwald" else res.extra_cols[col]
            worst = max(worst, agree(p_col(rows, header, col), cpu_p,
                                     f"phase 8 {tag} {col}", 0.05))
        if tag == "FarmCPU":
            sig = sum(1 for r in rows if r[2] in qtl_ids and float(r[10]) < 5e-8)
    with open(os.path.join(out, "jx.gwas.summary.json")) as fh:
        summary = json.load(fh)
    say(f"phase 8 stages (s): {stage_line(summary)}")
    say(f"phase 8 lm2/fvlmm2/farmcpu: {win.m} SNPs; cpu rescan (gxe {k} SNPs, farmcpu "
        f"the window) max Δ(-log10 p)={worst:.3g}, top-5 equal; FarmCPU {sig} planted "
        f"QTLs at p < 5e-8; cli {wall_g:.2f} s")
    check_algwas(os.path.join(out, "jx.test0.ALGWAS.assoc.tsv"), win, y, cov, qtl_ids)
    say(f"phase 8 done in {time.monotonic() - t0:.2f} s")
    return launches


def check_algwas(path: str, win, y, cov, qtl_ids) -> None:
    """ALGWAS on phase 8's window: stage 1 (the FISTA path on the card,
    its (m, n) f32 block resident) run again through ``algwas_scan`` gives
    the CLI's TSV; its stage 2 (the conditional LM scan with the selected
    markers as covariates) rescanned on the CPU from the same selection
    agrees within Δ(-log10 p) 0.05 with the same top 5."""
    from janusx_tpu_torch.models import algwas, farmcpu, lm

    header, rows = read_tsv(path)
    require([r[2] for r in rows] == list(win.sites.snp), "ALGWAS: SNP rows differ")
    tsv = p_col(rows, header)
    t1 = time.monotonic()
    card = algwas.algwas_scan(win, y, cov)  # ends in a host copy of its path
    wall = time.monotonic() - t1
    sel = card.selected
    require(0 < len(sel) <= 200, f"ALGWAS selected {len(sel)} markers")
    d_card = agree(card.result.pwald, tsv, "phase 8 ALGWAS rerun vs TSV", 1e-4)
    cov2 = np.concatenate([cov, farmcpu._decode_rows(win, sel).T], axis=1)
    cpu = lm.lm_scan(win, y, cov2, device="cpu")
    cpu.pwald[sel] = farmcpu._qtn_pvalues(win, y, cov, sel)[2]
    d_cpu = agree(tsv, cpu.pwald, "phase 8 ALGWAS stage 2 cpu rescan", 0.05)
    hits = sum(1 for i in sel if win.sites.snp[i] in qtl_ids)
    steps = int(np.isfinite(card.ebic_path).sum())
    say(f"phase 8 algwas: {win.m} SNPs, stage 1 on the card selected {len(sel)} markers "
        f"({hits} planted QTLs) over {steps} of {len(card.ebic_path)} path steps under "
        f"the cap; rerun vs TSV max Δ(-log10 p)={d_card:.3g}; stage 2 cpu rescan max "
        f"Δ(-log10 p)={d_cpu:.3g}, top-5 equal; algwas_scan {wall:.2f} s")



def run_lowrank_sparse(d: str, prefix: str, pheno: str, rows5, qtl_ids, cpu) -> dict:
    """Phase 9: ``jx gwas -lowrank 1000 -splmm -splmm-exact`` on phase 5's
    panel and trait, without -force-model. Returns the launches."""
    from janusx_tpu_torch.models import fastlmm, splmm
    from janusx_tpu_torch.models.lmm import lattice_superblock
    from janusx_tpu_torch.models.sparse_spectral import BlockSpectralK
    from janusx_tpu_torch.io.packed import QcParams
    from janusx_tpu_torch.utils.cache import load_or_build_sparse_grm

    t0 = time.monotonic()
    out = os.path.join(d, "out9")
    _, wall, launches = run_cli(["gwas", "-bfile", prefix, "-p", pheno, "-lowrank",
                                 str(LOWRANK_Q), "-splmm", "-splmm-exact", "-n", "0",
                                 "-o", out], "phase 9")
    with open(os.path.join(out, "jx.gwas.summary.json")) as fh:
        summary = json.load(fh)
    runs = {r["requested"]: r for r in summary["runs"]}
    require([runs[m]["model"] for m in ("lowrank", "splmm", "splmm-exact")]
            == ["lowrank", "splmm", "splmm-exact"], f"phase 9 runs {list(runs.values())}")
    m = len(rows5)
    supers = -(-m // lattice_superblock(N_PHENO, GRID, 2048))
    require(launches == {**NO_LAUNCHES, "decode_rotate": supers},
            f"phase 9 launches {launches}, expected K1 once per -lowrank superblock "
            f"({supers}) and no K2")
    tsv = {}
    for tag in ("FaSTLMM", "SparseLMM", "SparseLMM2"):
        header, rows = read_tsv(os.path.join(out, f"jx.test0.{tag}.assoc.tsv"))
        require(header == HEADER and [r[2] for r in rows] == [r[2] for r in rows5],
                f"{tag}: header or SNP rows differ from phase 5's")
        tsv[tag] = p_col(rows, header)
        require(bool(np.all(np.isfinite(tsv[tag]) & (tsv[tag] > 0))), f"{tag}: bad p")
    say(f"phase 9 stages (s): {stage_line(summary)}")

    # the CPU side, from the same basis and the same (cached) sparse GRM
    t1 = time.monotonic()
    keep, head, y = cpu["keep"], cpu["head"], cpu["y"]
    k = head.m
    lrb = fastlmm.lowrank_basis_from_snps(cpu["pg"], q=LOWRANK_Q)
    qc = QcParams()
    Ksp = load_or_build_sparse_grm(prefix, cpu["full"], qc.maf, qc.geno, 0.05)
    Ksub = Ksp[keep][:, keep].tocsc()
    comps = BlockSpectralK.from_sparse(Ksub)
    res = {"FaSTLMM": fastlmm.fastlmm_scan(head, lrb, y, device="cpu"),
           "SparseLMM2": splmm.splmm_exact_scan(head, Ksub, y, device="cpu"),
           "SparseLMM": splmm.splmm_grammar_scan(cpu["pg"], Ksub, y, device="cpu")}
    worst, lams = 0.0, {}
    for (tag, (r, null)), route in zip(res.items(), ("lowrank", "splmm-exact", "splmm")):
        lam = null.lbd if tag == "FaSTLMM" else null["lambda_null"]
        lam_card = runs[route]["lambda_null"]
        require(abs(lam - lam_card) <= 2e-3 * lam_card,
                f"{tag}: λ_null card {lam_card:.6g}, cpu {lam:.6g}")
        lams[route] = lam_card
        n_cmp = r.m
        worst = max(worst, agree(tsv[tag][:n_cmp], r.pwald, f"phase 9 {tag} cpu rescan",
                                 0.05))
    # the exact sparse model against phase 5's dense LMM at the planted QTLs
    # (different kinships: printed only)
    dense = np.array([float(r[10]) for r in rows5])
    at = np.array([r[2] in qtl_ids for r in rows5])
    lp = lambda p: -np.log10(p[at])
    sig = {t: int((tsv[t][at] < 5e-8).sum()) for t in tsv}
    say(f"phase 9 lowrank/splmm: rank k={lrb.k} from {LOWRANK_Q} SNPs; sparse GRM (0.05) on "
        f"the {len(keep)} analysis samples: nnz share {Ksub.nnz / len(keep) ** 2:.5f}, "
        f"largest component {comps.max_comp}; λ_null lowrank {lams['lowrank']:.6g}, "
        f"splmm {lams['splmm']:.6g}, splmm-exact {lams['splmm-exact']:.6g}; K1 launches "
        f"{launches['decode_rotate']} ({supers} superblocks); cpu rescan (lowrank and "
        f"splmm-exact {k} SNPs, splmm all {m}) max Δ(-log10 p)={worst:.3g}, top-5 equal "
        f"({time.monotonic() - t1:.2f} s); planted QTLs at p < 5e-8: {sig} (dense lmm "
        f"{int((dense[at] < 5e-8).sum())}); splmm-exact vs dense lmm at the QTLs: "
        f"-log10 p {np.round(lp(tsv['SparseLMM2']), 2).tolist()} vs "
        f"{np.round(lp(dense), 2).tolist()}; cli {wall:.2f} s, phase "
        f"{time.monotonic() - t0:.2f} s")
    return launches


# ------------------------------------------------------------ phase 11
# in the order jx gs runs them (cli/gs.py _METHOD_FLAGS)
GS_ROUTES = {"BLUP": "GBLUP(add)", "GBLUPad": "GBLUP(ad)", "rrBLUP": "rrBLUP"}


def read_gs(out: str, trait: str | None = None):
    """A ``jx gs`` run's summary and, for ``trait``, its GEBV TSV as
    (sample ids, method columns, (samples, methods) values)."""
    with open(os.path.join(out, "jxgs.gs.summary.json")) as fh:
        summary = json.load(fh)
    if trait is None:
        return summary, None
    header, rows = read_tsv(os.path.join(out, f"jxgs.{trait}.gebv.tsv"))
    return summary, ([r[0] for r in rows], header.split("\t")[1:],
                     np.array([[float(v) for v in r[1:]] for r in rows]))


def gs_seconds(summary) -> str:
    """The run's total seconds, then each method's fit and CV seconds."""
    return "; ".join([f"total {summary['total_seconds']:.3f}"] + [
        f"{t} {mm} fit {info['fit_seconds']:.3f} cv {info['cv_seconds']:.3f}"
        for t, per in summary["traits"].items() for mm, info in per.items()])


def gs_device_times(pg, K, keep, y, lbd: float, dev) -> str:
    """CUDA-event times of the GS device steps at the run's shapes: one HE
    stream pass (every QC'd SNP, 4,096-SNP blocks, 16 probes and the
    residual), one marker-effect pass (2,048-SNP blocks) and one PCG solve
    of (K_tt + λI) at the default tol and iteration cap."""
    import torch

    from janusx_tpu_torch import config
    from janusx_tpu_torch.gs.blup import _marker_effects_resident
    from janusx_tpu_torch.models.grm import _snp_scales
    from janusx_tpu_torch.models.he import _he_stream_pass
    from janusx_tpu_torch.ops.cg import cg_solve
    from janusx_tpu_torch.utils import devcache

    mean, inv_sd, _ = _snp_scales(pg, 1)
    # each step's bound: its products (2 operations per multiply-add) at
    # the f32 peak outside the tensor cores (TF32 is off), or each input
    # read once and each output written once, whichever is longer
    f32 = lambda flops, nbytes: "bound {:.4f} ms ({})".format(*bound(flops, nbytes, F32_PEAK))
    n = pg.n_samples
    out = []
    for blk in (4096, 2048):
        shape = (-(-pg.m // blk), blk)
        pk = devcache.device_packed_blocks(pg, shape, dev, lane_align=4)
        mn = devcache.to_device_blocks(mean, shape, 0.0, torch.float32, dev)
        n_pad = pk.shape[-1] * 4
        rows_in = pk.numel() + 4 * mn.numel()  # packed bytes and one f32 per SNP
        if blk == 4096:
            iv = devcache.to_device_blocks(inv_sd, shape, 0.0, torch.float32, dev)
            V = torch.randn((n_pad, 17), device=dev)
            ms = cuda_ms(lambda: _he_stream_pass(pk, mn, iv, V), iters=5, warmup=1)
            # C V, Cᵀ(C V) and the squared column sums
            b = f32(pg.m * n * (2 * 17 * 2 + 2),
                    rows_in + 4 * iv.numel() + 4 * V.numel() + 8 * n_pad * 18)
            out.append(f"HE stream pass {ms:.3f} ms, {b} ({shape[0]} blocks x {blk} SNPs, "
                       f"{n_pad} sample lanes, 17 columns)")
        else:
            a = torch.randn(n_pad, device=dev)
            ms = cuda_ms(lambda: _marker_effects_resident(pk, mn, a), iters=5, warmup=1)
            b = f32(2.0 * pg.m * n, rows_in + 4 * n_pad + 4 * pg.m)
            out.append(f"marker-effect pass {ms:.3f} ms, {b} ({shape[0]} blocks x {blk} SNPs)")
    Ktt = torch.as_tensor(K[np.ix_(keep, keep)], dtype=torch.float32, device=dev)
    r = torch.as_tensor(y - y.mean(), dtype=torch.float32, device=dev)
    diag = torch.diagonal(Ktt) + lbd
    solve = lambda: cg_solve(lambda v: Ktt @ v + lbd * v, r, diag_precond=diag,
                             tol=config.knob("JX_TPU_CG_TOL"),
                             max_iter=config.knob("JX_TPU_CG_MAX_ITER"))
    res = solve()
    ms = cuda_ms(solve, iters=3, warmup=1)
    n_t, its = len(keep), int(res.iters)
    b = f32(2.0 * n_t * n_t * (its + 1), 4 * (n_t * n_t + 3 * n_t))
    out.append(f"PCG solve {ms:.3f} ms, {b} (n_t={n_t}, λ={lbd:.4g}, {its} "
               f"iterations, rel res {float(res.rel_res):.3g})")
    return "; ".join(out)


def run_gs_phase(d: str, prefix: str, pheno: str, gv, cpu, dev, smi: str) -> dict:
    """Phase 11: ``jx gs`` and ``jx gspredict`` on phase 5's panel, then
    the GS run on the first CROSS_SNPS SNPs on the card and on the CPU.
    Returns the kernel launches of the phase (both 0: GS reaches no
    kernel)."""
    from janusx_tpu_torch.gs.workflow import GsConfig, run_gs
    from janusx_tpu_torch.io.gfreader import load_raw_packed
    from janusx_tpu_torch.io.packed import QcParams
    from janusx_tpu_torch.io.plink import write_plink
    from janusx_tpu_torch.ops import kernels
    from janusx_tpu_torch.utils.cache import load_or_build_grm

    t0 = time.monotonic()
    total = dict(NO_LAUNCHES)

    def cli(argv, what):
        _, wall, launches = run_cli(argv, f"phase 11 {what}")
        for k, v in launches.items():
            total[k] += v
        return wall

    # 1. test0: three routes, CV, exports
    out1 = os.path.join(d, "gs1")
    wall1 = cli(["gs", "-bfile", prefix, "-p", pheno, *(f"-{m}" for m in GS_ROUTES), "-cv",
                 "5", "-effect", "-save-model", "-o", out1], "test0")
    s1, (ids, cols, G) = read_gs(out1, "test0")
    routes = {mm: info["route"] for mm, info in s1["traits"]["test0"].items()}
    require(routes == GS_ROUTES, f"phase 11 routes {routes}")
    n_test = N_SAMPLES - N_PHENO
    require(cols == list(GS_ROUTES) and G.shape == (n_test, 3) and bool(np.isfinite(G).all()),
            f"phase 11 GEBV TSV: columns {cols}, shape {G.shape}")
    require("test0" in s1.get("he_prefit", {}), "phase 11: no HE pre-fit for test0")
    # The founders are unrelated and their SNPs independent, so all GS can
    # learn of a sample comes through its sibs. At h2 = 0.8 a CV fold keeps
    # Bin(4, 0.58) phenotyped sibs of a sample in training, and the best
    # predictor of its phenotype from them reaches r ~ 0.48; hence 0.4 here.
    # The test samples keep Bin(4, 0.73) and are held to the genetic value:
    # at least 0.5 and at least the pedigree-only predictor, the mean
    # phenotype of their phenotyped sibs.
    cv = {mm: s1["traits"]["test0"][mm]["cv"]["pearson"] for mm in GS_ROUTES}
    require(cv["BLUP"] >= 0.4, f"phase 11 BLUP CV pearson {cv['BLUP']:.4f} < 0.4")
    test_idx = np.array([int(s[3:]) for s in ids])  # the samples are ind<j>
    r_true = {mm: float(np.corrcoef(G[:, i], gv[test_idx])[0, 1]) for i, mm in enumerate(cols)}
    y_full = np.full(N_SAMPLES, np.nan)
    y_full[cpu["keep"]] = cpu["y"]
    fam = np.arange(N_SAMPLES) // FAMILY
    sibs = np.array([np.nanmean(y_full[fam == fam[j]]) for j in test_idx])
    has = np.isfinite(sibs)
    r_sib = float(np.corrcoef(sibs[has], gv[test_idx][has])[0, 1])
    require(min(r_true.values()) >= max(0.5, r_sib),
            f"phase 11 test GEBVs vs simulated genetic values: {r_true} (sib means {r_sib:.4f})")
    he1 = s1["he_prefit"]["test0"]
    say(f"phase 11 test0: routes {routes}; {len(ids)} test GEBVs, CV pearson "
        + ", ".join(f"{mm} {v:.4f}" for mm, v in cv.items())
        + "; corr(test GEBV, genetic value) "
        + ", ".join(f"{mm} {v:.4f}" for mm, v in r_true.items())
        + f" (sib means {r_sib:.4f}, {int(has.sum())} samples); HE h2 {he1['h2']} ({he1['boundary']}); REML λ {s1['traits']['test0']['BLUP']['lambda_']:.5g}"
        f"; seconds: {gs_seconds(s1)}; cli {wall1:.2f} s")

    # 2. the five traits of phase 7 on the PCG route with the TOP bundle
    out2 = os.path.join(d, "gs2")
    wall2 = cli(["gs", "-bfile", prefix, "-p", prefix + ".traits.pheno", "-BLUP",
                 "--rrblup-solver", "pcg", "-select", "max", "-o", out2], "five traits")
    s2, _ = read_gs(out2)
    lams = {}
    for t in TRAITS:
        info, he = s2["traits"][t]["BLUP"], s2["he_prefit"][t]
        require(info["route"] == "rrBLUP(PCG)", f"phase 11 {t} route {info['route']}")
        # the workflow's rule (gs/workflow.py:395, :577-585): the pre-fit's
        # λ = ve/vg, or the fixed λ = 1 where it hit σg = 0
        own = he["vg"] > 1e-12
        require(own or he["boundary"] == "sigma_g_zero", f"phase 11 {t}: HE pre-fit {he}")
        require(own or t == TRAITS[-1], f"phase 11 polygenic trait {t} hit σg = 0: {he}")
        want = he["ve"] / he["vg"] if own else 1.0
        require(abs(info["lambda_pcg"] - want) <= 1e-12 * want,
                f"phase 11 {t}: λ_pcg {info['lambda_pcg']} vs {want}")
        lams[t] = f"{info['lambda_pcg']:.4g} ({'HE' if own else 'fixed'}, h2 {he['h2']}, " \
                  f"CV pearson {info['cv']['pearson']:.4f})"
    for f in ("weights.tsv", "rank.tsv", "jxmodel.npz"):
        require(os.path.exists(os.path.join(out2, f"jxgs.gs.TOP.{f}")), f"no TOP {f}")
    w = s2["top"]["weights"]
    require(abs(sum(w) - 1.0) <= 1e-9, f"phase 11 TOP weights {w}")
    say(f"phase 11 five traits (rrBLUP(PCG), -select max): λ " + ", ".join(
        f"{t} {v}" for t, v in lams.items()) + f"; TOP weights {np.round(w, 4).tolist()} "
        f"({s2['top']['n_iter']} Newton iterations, converged {s2['top']['converged']}); "
        f"seconds: {gs_seconds(s2)}; cli {wall2:.2f} s")

    # 3. the signed-hash sketch
    out3 = os.path.join(d, "gs3")
    wall3 = cli(["gs", "-bfile", prefix, "-p", pheno, "-hash", "2048", "-BLUP", "-o", out3],
                "hash")
    s3, _ = read_gs(out3, "test0")
    m_qc = cpu["full"].m
    require(s3["hash"]["kept_snps"] == m_qc == s3["m_snps"],
            f"phase 11 hash kept {s3['hash']['kept_snps']} of {m_qc} QC'd SNPs")
    say(f"phase 11 -hash 2048: {m_qc} SNPs hashed (scale {s3['hash']['scale']:.5g}), route "
        f"{s3['traits']['test0']['BLUP']['route']}, CV pearson "
        f"{s3['traits']['test0']['BLUP']['cv']['pearson']:.4f}; seconds: {gs_seconds(s3)}; "
        f"cli {wall3:.2f} s")

    # 4. gspredict with the saved rrBLUP model, against its GEBV column
    out4 = os.path.join(d, "gp")
    model = os.path.join(out1, "jxgs.test0.rrBLUP.jxmodel.npz")
    wall4 = cli(["gspredict", "-model", model, "-bfile", prefix, "-o", out4], "gspredict")
    _, rows = read_tsv(os.path.join(out4, "gspred.gebv.tsv"))
    pred = {r[0]: float(r[1]) for r in rows}
    rr = G[:, cols.index("rrBLUP")]
    dmax = float(np.max(np.abs(np.array([pred[s] for s in ids]) - rr)))
    bound = 1e-3 * float(np.std(rr))
    require(dmax <= bound, f"phase 11 gspredict vs the GEBV TSV: {dmax:.3g} > {bound:.3g}")
    say(f"phase 11 gspredict: {len(pred)} samples; the {len(ids)} test samples within "
        f"{dmax:.3g} of the GEBV TSV's rrBLUP column (bound 1e-3 sd = {bound:.3g}; both "
        f"printed to 4 decimals); cli {wall4:.2f} s")

    # 5. the first CROSS_SNPS SNPs through the same GS run on the card and the CPU
    raw = load_raw_packed(prefix)
    sub = os.path.join(d, "cross")
    write_plink(sub, raw.packed[:CROSS_SNPS], raw.n_samples,
                raw.sites.take(np.arange(CROSS_SNPS)), raw.samples)
    res, secs = {}, {}
    platform = os.environ["JX_TPU_PLATFORM"]
    for plat in ("cuda", "cpu"):
        os.environ["JX_TPU_PLATFORM"] = plat
        kernels.reset_launches()
        t1 = time.monotonic()
        res[plat] = run_gs(GsConfig(
            genotype=sub, phenotype=pheno, out_prefix=os.path.join(d, f"gs_{plat}", "jxgs"),
            methods=tuple(GS_ROUTES), cv=2, export_effects=True, save_models=True))
        secs[plat] = time.monotonic() - t1
        for k, v in scan_launches().items():
            total[k] += v
    os.environ["JX_TPU_PLATFORM"] = platform
    (rc, sc), (rp, sp) = res["cuda"], res["cpu"]
    worst = {"lambda": 0.0, "gebv": 0.0, "pearson": 0.0, "h2": 0.0}
    for mm in GS_ROUTES:
        a, b = rc["test0"][mm], rp["test0"][mm]
        require(a.route == b.route, f"phase 11 cross {mm}: route {a.route} vs {b.route}")
        ia, ib = a.model_info, b.model_info
        # λ of the kernel fits; GBLUP(ad)'s σe²/σa² from its AI-REML
        la = ia["lambda_"] if "lambda_" in ia else ia["sigma2"]["residual"] / ia["sigma2"]["add"]
        lb = ib["lambda_"] if "lambda_" in ib else ib["sigma2"]["residual"] / ib["sigma2"]["add"]
        worst["lambda"] = max(worst["lambda"], abs(la - lb) / abs(lb))
        err = np.abs(a.test_pred - b.test_pred)
        require(bool(np.all(err <= 1e-6 + 1e-4 * np.abs(b.test_pred))),
                f"phase 11 cross {mm}: GEBVs outside rtol 1e-4 / atol 1e-6 "
                f"(max |err| {float(err.max()):.3g})")
        worst["gebv"] = max(worst["gebv"], float((err / np.abs(b.test_pred)).max()))
        worst["pearson"] = max(worst["pearson"],
                               abs(a.cv_mean["pearson"] - b.cv_mean["pearson"]))
    h2 = lambda s: s["he_prefit"]["test0"]["vg"] / (s["he_prefit"]["test0"]["vg"]
                                                     + s["he_prefit"]["test0"]["ve"])
    worst["h2"] = abs(h2(sc) - h2(sp))
    require(worst["lambda"] <= 1e-4 and worst["pearson"] <= 1e-4 and worst["h2"] <= 1e-4,
            f"phase 11 cross: card vs cpu {worst}")
    say(f"phase 11 cross {CROSS_SNPS} SNPs, card vs cpu: the same routes; max λ rel "
        f"{worst['lambda']:.3g}, GEBV rel {worst['gebv']:.3g}, CV pearson "
        f"{worst['pearson']:.3g}, HE h2 {worst['h2']:.3g}; run_gs card {secs['cuda']:.2f} s "
        f"({gs_seconds(sc)}), cpu {secs['cpu']:.2f} s ({gs_seconds(sp)})")
    require(total == NO_LAUNCHES, f"phase 11: a kernel launched on the GS path: {total}")

    # device times of the GS steps at the run's shapes
    qc = QcParams()
    K = load_or_build_grm(prefix, cpu["full"], qc.maf, qc.geno)
    lam0 = s2["traits"]["test0"]["BLUP"]["lambda_pcg"]
    times = gs_device_times(cpu["full"], K, cpu["keep"], cpu["y"], lam0, dev)
    say(f"phase 11 device times ({smi}): {times}")
    say(f"phase 11 done in {time.monotonic() - t0:.2f} s")
    return total


# ------------------------------------------------------------ phase 12
LD_WIN = 100  # -ldscore's SNP window
SIB_PAIRS = N_SAMPLES // FAMILY * (FAMILY * (FAMILY - 1) // 2)  # 388 x 10 = 3,880


def printed_close(got: float, want: float, rtol: float) -> bool:
    """``got`` within rtol of ``want`` printed at %.6g: plus one unit of
    its sixth significant digit."""
    unit = 10.0 ** (np.floor(np.log10(abs(want))) - 5) if want else 0.0
    return abs(got - want) <= rtol * abs(want) + unit


def combo_expressions(path: str, qtl_ids, pg) -> list:
    """``jx fvlmm2 -i``'s file: eight expressions over pairs of planted QTLs
    (every operator, with and without '!'), four over random QC'd SNPs and
    one with an unknown name, which the CLI skips. Returns the lines."""
    q = sorted(qtl_ids, key=lambda s: int(s[3:]))[:16]
    pool = sorted(set(pg.sites.snp) - set(qtl_ids), key=lambda s: int(s[3:]))
    r = [pool[i] for i in np.random.default_rng(12).choice(len(pool), 8, replace=False)]
    lines = [f"{q[0]}&{q[1]}", f"{q[2]}|{q[3]}", f"{q[4]}*{q[5]}", f"{q[6]}^{q[7]}",
             f"!{q[8]}&{q[9]}", f"{q[10]}|!{q[11]}", f"{q[12]}^!{q[13]}", f"!{q[14]}&!{q[15]}",
             f"{r[0]}&{r[1]}", f"{r[2]}|!{r[3]}", f"{r[4]}*{r[5]}", f"!{r[6]}^{r[7]}",
             f"nosuch&{r[0]}"]
    with open(path, "wt") as fh:
        fh.write("\n".join(lines) + "\n")
    return lines


def run_structure_phase(d: str, prefix: str, pheno: str, qtl_ids, cpu, dev) -> dict:
    """Phase 12: ``jx grm``, ``jx pca``, ``jx gstats`` and ``jx fvlmm2 -i``
    on phase 5's panel, then the card against the CPU on its first
    CROSS_SNPS SNPs. Returns the kernel launches (both 0: none of these
    paths reaches a kernel)."""
    import scipy.sparse

    from janusx_tpu_torch.cli.fvlmm2 import TSV_COLUMNS
    from janusx_tpu_torch.cli.gstats import _site_ldscores
    from janusx_tpu_torch.core import reml
    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.io import bitcodec
    from janusx_tpu_torch.io.gfreader import load_raw_packed
    from janusx_tpu_torch.io.jxgrm import read_jxgrm
    from janusx_tpu_torch.io.plink import write_plink
    from janusx_tpu_torch.models import combo
    from janusx_tpu_torch.models.grm import grm_from_packed
    from janusx_tpu_torch.models.pca import rsvd_pca
    from janusx_tpu_torch.models.splmm import sparsify_grm

    t0 = time.monotonic()
    total = dict(NO_LAUNCHES)
    walls = {}

    def cli(argv, what):
        printed, wall, launches = run_cli(argv, f"phase 12 {what}")
        for k, v in launches.items():
            total[k] += v
        walls[what] = wall
        return printed

    out, n = os.path.join(d, "out12"), N_SAMPLES
    fam = np.arange(n) // FAMILY
    head = cpu["full"].take_snps(np.arange(CROSS_SNPS))

    # 1. jx grm: the dense K, its .spgrm, then -part 4
    printed = cli(["grm", "-bfile", prefix, "--stage-timing", "-sparse", "0.05", "-o", out],
                  "grm")
    stages = next(ln for ln in printed.splitlines() if ln.startswith("stage-timing"))
    kpath = os.path.join(out, "jx.cGRM.npy")
    K = np.load(kpath)
    require(K.shape == (n, n) and bool(np.isfinite(K).all()), f"phase 12 K {K.shape}")
    dmean = float(np.mean(np.diag(K)))
    asym = float(np.abs(K - K.T).max())
    require(asym <= 1e-6 * dmean, f"phase 12 K asymmetric by {asym:.3g}")
    sib = (fam[:, None] == fam[None, :]) & ~np.eye(n, dtype=bool)
    within, between = float(K[sib].mean()), float(K[fam[:, None] != fam[None, :]].mean())
    require(0.45 <= within <= 0.55 and abs(between) <= 0.01,
            f"phase 12 K: sibship mean {within:.4f}, between sibships {between:.4g}")
    # .jxgrm stores the lower triangle, diagonal included
    L = read_jxgrm(os.path.join(out, "jx.cGRM.spgrm"), symmetrize=False).tocsc()
    want = scipy.sparse.tril(sparsify_grm(K, 0.05), format="csc")
    want.sort_indices()
    require(np.array_equal(L.indptr, want.indptr) and np.array_equal(L.indices, want.indices)
            and np.array_equal(L.data, want.data),
            "phase 12 .spgrm differs from sparsify_grm of the dense K")
    cli(["grm", "-bfile", prefix, "-part", "4", "-o", out, "-prefix", "part"], "grm -part 4")
    S = np.vstack([np.load(os.path.join(out, f"part.cGRM.part{k}_4.npy")) for k in range(1, 5)])
    err = float(np.max(np.abs(S - K) - 1e-6 * np.abs(K))) if S.shape == K.shape else np.inf
    require(err <= 1e-6 * dmean, f"phase 12 -part 4 strips vs K: {err:.3g} over rtol 1e-6")
    Kc, Kh = (grm_from_packed(head, device=x) for x in (dev, "cpu"))
    e_grm = float(np.max(np.abs(Kc - Kh) / (np.abs(Kh) + np.mean(np.diag(Kh)))))
    require(e_grm <= 1e-6, f"phase 12 GRM card vs cpu {e_grm:.3g}")
    say(f"phase 12 grm: {stages.replace(chr(9), ' ')}; K {n}x{n}, asymmetry {asym:.3g}, "
        f"sibship mean {within:.4f}, between {between:.4g}; .spgrm nnz {L.nnz} (lower "
        f"triangle) = sparsify_grm; -part 4 strips vs K max |err| - 1e-6|K| = {err:.3g}; "
        f"card vs cpu on {CROSS_SNPS} SNPs max rel {e_grm:.3g}; cli {walls['grm']:.2f} s, "
        f"-part 4 {walls['grm -part 4']:.2f} s")

    # 2. jx pca: -k the GRM, the same by -bfile, and -rsvd
    for tag, what, argv in (("pk", "-k", ["-k", kpath]), ("pe", "-bfile", ["-bfile", prefix]),
                            ("pr", "-rsvd", ["-bfile", prefix, "-rsvd"])):
        cli(["pca", *argv, "-dim", "10", "-o", out, "-prefix", tag], f"pca {what}")
    ev = {t: np.loadtxt(os.path.join(out, f"{t}.eigenval")) for t in ("pk", "pe", "pr")}
    pcs = {t: np.loadtxt(os.path.join(out, f"{t}.eigenvec"), dtype=str) for t in ev}
    for t in ev:
        require(ev[t].shape == (10,) and pcs[t].shape == (n, 11)
                and bool(np.all(np.diff(ev[t]) <= 0)),
                f"phase 12 pca {t}: {ev[t].shape} values, {pcs[t].shape} PC table")
    require(all(printed_close(a, b, 1e-6) for a, b in zip(ev["pe"], ev["pk"])),
            f"phase 12 pca -bfile vs -k eigenvalues {ev['pe']} vs {ev['pk']}")
    angle = lambda A, B: float(np.arccos(np.clip(np.linalg.svd(
        np.linalg.qr(A)[0].T @ np.linalg.qr(B)[0], compute_uv=False).min(), -1.0, 1.0)))
    vec = lambda t: pcs[t][:, 1:].astype(float)
    a_exact = angle(vec("pr"), vec("pe"))
    (vc, Vc), (vh, Vh) = (rsvd_pca(head, n_pc=10, power_iters=3, method=1, device=x)
                          for x in (dev, "cpu"))
    e_rsvd, a_rsvd = float(np.max(np.abs(vc - vh) / np.abs(vh))), angle(Vc, Vh)
    require(e_rsvd <= 1e-4 and a_rsvd <= 0.01,
            f"phase 12 rsvd card vs cpu: eigenvalues rel {e_rsvd:.3g}, PC subspace "
            f"{a_rsvd:.3g} rad")
    say(f"phase 12 pca: top eigenvalues {np.round(ev['pe'][:3], 4).tolist()} .. "
        f"{ev['pe'][-1]:.4f}, -bfile = -k within rtol 1e-6; -rsvd vs exact (printed only): "
        f"eigenvalues {np.round(ev['pr'] / ev['pe'], 4).tolist()} of exact, largest principal "
        f"angle {a_exact:.3g} rad; rsvd card vs cpu on {CROSS_SNPS} SNPs: eigenvalues rel "
        f"{e_rsvd:.3g}, largest principal angle {a_rsvd:.3g} rad; cli -k {walls['pca -k']:.2f} s, "
        f"-bfile {walls['pca -bfile']:.2f} s, -rsvd {walls['pca -rsvd']:.2f} s")

    # 3. jx gstats: site and sample tables, LD scores, KING
    cli(["gstats", "-bfile", prefix, "-site", "-ind", "-king", "-ldscore", str(LD_WIN),
         "-o", out, "-prefix", "st"], "gstats")
    _, rows = read_tsv(os.path.join(out, "st.king.pairs.tsv"))
    ind = lambda s: int(s[3:])  # the samples are ind<j>
    pairs = {(ind(a), ind(b)) for a, b, _ in rows}
    sibs = {(i, j) for i in range(n) for j in range(i + 1, (fam[i] + 1) * FAMILY)}
    phi = np.array([float(r[2]) for r in rows])
    require(len(rows) == SIB_PAIRS and pairs == sibs,
            f"phase 12 KING: {len(rows)} pairs, {len(pairs & sibs)} of the {SIB_PAIRS} sib pairs")
    require(abs(phi.mean() - 0.25) <= 0.02, f"phase 12 KING mean φ {phi.mean():.4f}")
    with open(os.path.join(out, "st.king.unrelated.id")) as fh:
        unrel = [ind(ln.strip()) for ln in fh if ln.strip()]
    require(len(unrel) == n // FAMILY and len(set(fam[unrel])) == n // FAMILY,
            f"phase 12 KING unrelated set of {len(unrel)}")
    header, site = read_tsv(os.path.join(out, "st.site.stats.tsv"))
    raw = load_raw_packed(prefix)
    nm, alt, het = bitcodec.row_stats(raw.packed, n)
    with np.errstate(divide="ignore", invalid="ignore"):
        af = np.where(nm > 0, alt / (2.0 * nm), np.nan)
        cols = (af, np.minimum(af, 1 - af), 1.0 - nm / n, np.where(nm > 0, het / nm, np.nan))
    require(header.split("\t")[5:] == ["af", "maf", "miss", "het", "ldscore"]
            and len(site) == raw.m and all(r[5:9] == [f"{c[i]:.6g}" for c in cols]
                                           for i, r in enumerate(site)),
            "phase 12 gstats site table differs from bitcodec.row_stats")
    sub = os.path.join(d, "ld16k")
    write_plink(sub, raw.packed[:CROSS_SNPS], n, raw.sites.take(np.arange(CROSS_SNPS)),
                raw.samples)
    ld_c, ld_h = (_site_ldscores(load_raw_packed(sub), "variants", LD_WIN, device=x)
                  for x in (dev, "cpu"))
    e_ld = float(np.max(np.abs(ld_c - ld_h) / np.abs(ld_h)))
    require(e_ld <= 1e-5, f"phase 12 LD scores card vs cpu rel {e_ld:.3g}")
    inner = CROSS_SNPS - LD_WIN  # whole windows in both the panel and its first 16,384
    require(all(printed_close(a, float(r[9]), 1e-5) for a, r in zip(ld_c[:inner], site)),
            "phase 12 LD scores of the first SNPs differ from the site table")
    say(f"phase 12 gstats: KING {len(rows)} pairs = the {SIB_PAIRS} full-sib pairs, mean φ "
        f"{phi.mean():.4f} (min {phi.min():.4f}), unrelated set {len(unrel)}; site table "
        f"({raw.m} rows) = bitcodec.row_stats; LD scores (window {LD_WIN}) mean "
        f"{ld_c.mean():.4f}, card vs cpu on {CROSS_SNPS} SNPs max rel {e_ld:.3g}, = the "
        f"table's first {inner}; cli {walls['gstats']:.2f} s")

    # 4. jx fvlmm2 -i with -k the GRM
    path = os.path.join(d, "pairs.txt")
    exprs = combo_expressions(path, qtl_ids, cpu["pg"])
    cli(["fvlmm2", "-bfile", prefix, "-p", pheno, "-i", path, "-k", kpath, "-o", out,
         "-prefix", "fx"], "fvlmm2 -i")
    header, rows = read_tsv(os.path.join(out, "fx.test0.fvlmm2.tsv"))
    require(header == "\t".join(TSV_COLUMNS) and [r[2] for r in rows] == exprs[:12]
            and all(len(r) == len(TSV_COLUMNS) and r[4] == "" for r in rows),
            f"phase 12 fvlmm2 TSV: {header!r}, {[r[2] for r in rows]}")
    skip = read_tsv(os.path.join(out, "fx.fvlmm2.skip"))
    require(skip == ("line\texpr\treason",
                     [["13", exprs[12], "SNP token 'nosuch' was not found"]]),
            f"phase 12 fvlmm2 .skip table {skip}")
    lit = [float(r[c]) for r in rows[:8] for c in (9, 10)]
    hits = sum(p < 1e-6 for p in lit)
    require(hits >= len(lit) // 2, f"phase 12 fvlmm2: {hits} of {len(lit)} planted literals "
                                   "at joint p < 1e-6")
    keep, pg, y = cpu["keep"], cpu["pg"], cpu["y"]
    basis = eigh_grm(K[np.ix_(keep, keep)], diag_ridge=1e-6)
    specs, _ = combo.parse_interaction_file(path, combo.build_name_map(pg.sites))
    card, null = combo.fvlmm_joint_combo_scan(pg, basis, y, None, specs, device=dev)
    cols = ("beta_combo_joint", "se_combo_joint", "p_combo_joint", "p_lit1_joint",
            "p_lit2_joint")
    require(all(printed_close(c[k], float(r[TSV_COLUMNS.index(k)]), 1e-6)
                for c, r in zip(card, rows) for k in cols),
            "phase 12 fvlmm2: the TSV differs from the scan rerun on the card")
    own = combo.fvlmm_joint_combo_scan(pg, basis, y, None, specs[:1], device="cpu")[1]
    # the CPU rescan at the card's null λ: the combo design carries its
    # intercept twice (make_rotated prepends one), so the null -REML is flat
    # to ~1e-7 near its optimum and two Brent runs stop ~1e-5 apart in log10 λ
    fit = reml.fit_null_reml
    reml.fit_null_reml = lambda rot, *a, **k: null
    try:
        host, _ = combo.fvlmm_joint_combo_scan(pg, basis, y, None, specs, device="cpu")
    finally:
        reml.fit_null_reml = fit
    e_combo = max(abs(c[k] - h[k]) / abs(h[k]) for c, h in zip(card, host) for k in cols)
    require(e_combo <= 1e-6, f"phase 12 fvlmm2 card vs cpu rel {e_combo:.3g}")
    say(f"phase 12 fvlmm2 -i: {len(rows)} expressions ({len(skip[1])} skipped), planted "
        f"literals at joint p < 1e-6: {hits} of {len(lit)} (p {[f'{v:.3g}' for v in lit]}), "
        f"combo p {[f'{float(r[7]):.3g}' for r in rows]}; λ_null {null.lbd:.6g} (the cpu's own "
        f"{own.lbd:.6g}, Δlog10 {abs(own.log10_lbd - null.log10_lbd):.3g}); card vs cpu at "
        f"that λ max rel {e_combo:.3g}; cli {walls['fvlmm2 -i']:.2f} s")
    require(total == NO_LAUNCHES, f"phase 12: a kernel launched on the structure path: {total}")
    say(f"phase 12 done in {time.monotonic() - t0:.2f} s")
    return total


# ------------------------------------------------------------ phase 13
BAYES_SNPS = 50_000  # a 50K-array panel, the size BGLR-style BayesB users fit
BAYES_ITERS = 400  # jx gs --bayes-iters default


@contextlib.contextmanager
def plain_sweeps_forbidden():
    """Make the plain Gibbs sweeps raise while a card path runs, so the
    path provably goes through G1 and G2 only."""
    from janusx_tpu_torch.ops import kernels

    names = ("gibbs_sweep_marker_plain", "gibbs_sweep_block_mvn_plain",
             "gibbs_sweep_marker_hoisted_plain", "gibbs_sweep_block_mvn_hoisted_plain")
    saved = [getattr(kernels, n) for n in names]

    def refuse(*a, **k):
        raise SmokeFailure("a plain Gibbs sweep ran on the card path")

    for n in names:
        setattr(kernels, n, refuse)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(kernels, n, fn)


def standardized(pg, keep, dev, block: int = 8192):
    """The analysis samples' standardized (n, m) f32 matrix on the card, as
    the GS workflow builds its features (gs/workflow.py: centered dosage
    times 1/sqrt(2 af (1 - af)), 0 where missing), decoded per SNP block."""
    import torch

    from janusx_tpu_torch.ops import decode

    var = 2.0 * pg.af * (1.0 - pg.af)
    inv_sd = np.where(var > 0, 1.0 / np.sqrt(np.maximum(var, 1e-300)), 0.0)
    cols = torch.as_tensor(np.asarray(keep, np.int64), device=dev)
    Z = torch.empty((len(keep), pg.m), dtype=torch.float32, device=dev)
    for s in range(0, pg.m, block):
        e = min(s + block, pg.m)
        pk = torch.as_tensor(pg.packed[s:e], device=dev)
        mn = torch.as_tensor(pg.mean[s:e], dtype=torch.float32, device=dev)
        iv = torch.as_tensor(inv_sd[s:e], dtype=torch.float32, device=dev)
        Z[:, s:e] = decode.decode_standardized(pk, mn, iv).index_select(1, cols).T
    return Z


def gibbs_state(Zb, x2, y, dev):
    """A chain's state and scalars at its start, as gs/bayes.py:_chain
    sets them: (beta, var_b, r, scal)."""
    import torch

    n = Zb.shape[2]
    y32 = torch.as_tensor(y, dtype=torch.float32, device=dev)
    var_y = torch.var(y32)
    s0_b = var_y * 0.5 / (x2.sum() / n) * 7.0 / 0.5
    vb_fill = s0_b / 7.0
    scal = torch.stack([var_y * 0.5, vb_fill, torch.tensor(0.5, device=dev), s0_b, vb_fill])
    beta = torch.zeros(x2.shape, device=dev)
    return beta, vb_fill.expand(x2.shape).clone(), y32 - y32.mean(), scal


FLIP_MARGIN = 1e-3  # |log-odds - logit(u)| within which a δ may flip by rounding


def first_flip(x2_b, vb_in, scal, rn, ru, bk, bp, dk, dp):
    """The first marker of one block whose δ differs, with its distance to
    the threshold: the log-odds of inclusion minus logit(u), from the mean
    that the including side drew (its β minus sqrt(var) rn). Up to that
    marker both sides held the same state, so the margin is the one both
    compared against; later markers of the block start from different
    states. Returns (marker, margin), or None."""
    diff = (dk != dp).nonzero().flatten()
    if not len(diff):
        return None
    j = int(diff[0])
    ve, pi = float(scal[0]), float(scal[2])
    b, vb = float(bk[j] if dk[j] > 0 else bp[j]), float(vb_in[j])
    var = 1.0 / (float(x2_b[j]) / ve + 1.0 / vb)
    mean = b - np.sqrt(var) * float(rn[j])
    logit = np.log(pi) - np.log1p(-pi) + 0.5 * (mean * mean / var + np.log(var) - np.log(vb))
    u = float(ru[j])
    return j, float(logit - (np.log(u) - np.log1p(-u)))


def gibbs_sweep(fn, method, Zb, Gb, x2, scal, bs, state, d):
    """One sweep of G1 or G2 (``fn``: the kernel or its plain version) over
    the blocks ``bs`` of ``state`` = [beta, var_b, r] with the draws ``d`` =
    (_, rn, ru, rca, rci) (G2 reads rn as z and rca as rchi); returns G1's
    δ."""
    st = [state[0][bs], state[1][bs]]
    if method == "A":
        fn(Zb[bs], Gb[bs], x2[bs], *st, d[1][bs], d[3][bs], state[2], scal)
        return None
    return fn(Zb[bs], Gb[bs], x2[bs], *st, d[1][bs], d[2][bs], d[3][bs], d[4][bs], state[2],
              scal, method)


def gibbs_blockwise(Zb, Gb, x2, scal, method, state, d, fused, d_fused, what: str) -> dict:
    """One sweep with the draws ``d`` from ``state`` (advanced in place),
    the kernel block by block beside its plain version: each block's plain
    sweep starts from the kernel's state before that block, so a difference
    stays in its block. Held: δ identical but for flips within FLIP_MARGIN
    of the threshold (each printed with its margin; that block is compared
    up to its first flip and its residual is not, as the rest of the block
    starts from other states); β, var_b and the block's residual within
    rtol 1e-4 (G1) and 1e-3 (G2), floors of the same share of each one's
    largest value; and ``fused`` (the state after one launch over every
    block, with its δ ``d_fused``) equal to the block-by-block launches bit
    for bit. Returns the largest |β| difference, the plain sweep's ms (CUDA
    events around each block's plain call, summed), the flips and the
    markers left uncompared."""
    import torch

    from janusx_tpu_torch.ops import kernels

    nb, C, _ = Zb.shape
    name = "gibbs_sweep_block_mvn" if method == "A" else "gibbs_sweep_marker"
    rtol = 1e-3 if method == "A" else 1e-4
    res = {"max_abs_err": 0.0, "plain_ms": 0.0, "flips": [], "uncompared": 0}

    def close(got, want, what):
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        require(err <= rtol * top or bool(((got - want).abs()
                                           <= rtol * want.abs() + rtol * top).all()), what
                + f" off by {err:.3g}")
        return err

    kernel = getattr(kernels, name)
    plain = getattr(kernels, name + "_plain")
    sweep = lambda fn, bs, st: gibbs_sweep(fn, method, Zb, Gb, x2, scal, bs, st, d)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    deltas = []
    for b in range(nb):
        bs = slice(b, b + 1)
        vb_in = state[1][b].clone()
        side = [state[0].clone(), state[1].clone(), state[2].clone()]
        dk = sweep(kernel, bs, state)
        t0.record()
        dp = sweep(plain, bs, side)
        t1.record()
        torch.cuda.synchronize()
        res["plain_ms"] += t0.elapsed_time(t1)
        upto = C
        if dk is not None:
            deltas.append(dk)
            flip = first_flip(x2[b], scal[1].expand(C) if method == "Cpi" else vb_in,
                              scal, d[1][b], d[2][b], state[0][b], side[0][b], dk[0], dp[0])
            if flip:
                upto, margin = flip
                require(abs(margin) <= FLIP_MARGIN,
                        f"{what} G1 {method} block {b} marker {upto}: δ differs at "
                        f"log-odds {margin:.3g} from the threshold")
                res["flips"].append((b, upto, margin))
                res["uncompared"] += C - upto
            require(torch.equal(dk[0, :upto], dp[0, :upto]), f"{what} G1 δ")
        at = f"{what} {name} {method} block {b}"
        res["max_abs_err"] = max(res["max_abs_err"], close(
            state[0][b, :upto], side[0][b, :upto], at + " beta"))
        close(state[1][b, :upto], side[1][b, :upto], at + " var_b")
        if upto == C:
            close(state[2], side[2], at + " r")
    require(all(torch.equal(a, b) for a, b in zip(fused, state)) and (
        d_fused is None or torch.equal(d_fused, torch.cat(deltas))),
        f"{what} {name} {method}: one launch over every block differs from the "
        f"block-by-block launches")
    return res


def check_gibbs(Z, y, dev) -> dict:
    """G1 (BayesB and BayesCpi) and G2 against their plain versions for one
    sweep at the main path's shape (the (n, m) matrix Z of the final fit),
    from a mid-chain state (two kernel sweeps from the chain's start) and
    the same draws, by gibbs_blockwise; the kernel also runs once over
    every block (one launch, as the path runs it). Returns
    gibbs_blockwise's record per method (B, Cpi, A)."""
    from janusx_tpu_torch.gs.bayes import GeneratorDraws, block_markers
    from janusx_tpu_torch.ops import kernels

    Zb, Gb, x2 = block_markers(Z)
    nb, C, _ = Zb.shape
    out = {}
    for method in ("B", "Cpi", "A"):
        kernel = (kernels.gibbs_sweep_block_mvn if method == "A"
                  else kernels.gibbs_sweep_marker)
        draws = GeneratorDraws(17, dev, 5.0)
        beta, var_b, r, scal = gibbs_state(Zb, x2, y, dev)
        state = [beta, var_b, r]
        for _ in range(2):
            gibbs_sweep(kernel, method, Zb, Gb, x2, scal, slice(None), state,
                        draws.sweep(nb, C, method))
        d = draws.sweep(nb, C, method)
        fused = [t.clone() for t in state]
        d_fused = gibbs_sweep(kernel, method, Zb, Gb, x2, scal, slice(None), fused, d)
        out[method] = gibbs_blockwise(Zb, Gb, x2, scal, method, state, d, fused, d_fused,
                                      "phase 13")
    return out


# the dependent path of one block of the serial pass (csrc/gibbs.cu's
# note): FP32 arithmetic at 4 cycles, a shuffle at 24 (latencies assumed,
# not measured here)
FP32_CYCLES, SHFL_CYCLES = 4, 24


def chain_floor_ms(kind: str, nb: int, C: int, S: int, P: int, mhz: float) -> float:
    """The chain-floor model of one sweep (a model on the assumed latencies
    above, not a measurement): per block the dependent instructions
    of the serial path (this CTA's Z1 r in four accumulators over its half
    of S samples, the sum of the P partials, G1's C marker steps of five
    FP32 operations and a shuffle or G2's 128 x 128 product in 16-long
    chains and a tree of eight, the residual update), times their
    latencies, times nb, at ``mhz``."""
    arith = -(-S // 8) + 3 + -(-P // 2) + 1 + -(-C // 16) + 4
    shfl = 1 + 3
    if kind == "marker":
        arith, shfl = arith + 1 + 5 * C, shfl + C
    else:
        arith += 16 + 3 + 1
    return nb * (arith * FP32_CYCLES + shfl * SHFL_CYCLES) / (mhz * 1e3)


def gibbs_times(Z, y, dev, mhz: float = 0.0) -> dict:
    """CUDA-event ms of one sweep of each kernel on the (n, m) matrix Z (5
    after 1), with the bytes and operations of one sweep for the bound.
    With ``mhz`` (the SM clock) also each kernel's pre-pass and serial pass
    timed apart (the serial pass from the pre-pass's records of the state
    it starts from), the serial pass's plan and chain-floor model, and G2's
    yardstick: torch.linalg.cholesky_ex + torch.cholesky_inverse of the
    (nb, C, C) batch of Cb, the pre-pass's factorizations by the library
    (cholesky_ex: torch.linalg.cholesky would wait for the host to read its
    error flags on every call), the median of five windows of 5 calls after
    3."""
    import torch

    from janusx_tpu_torch.gs.bayes import GeneratorDraws, block_markers
    from janusx_tpu_torch.ops import kernels

    Zb, Gb, x2 = block_markers(Z)
    nb, C, n = Zb.shape
    draws = GeneratorDraws(5, dev, 5.0)
    _, rn, ru, rca, rci = draws.sweep(nb, C, "B")
    beta, var_b, r, scal = gibbs_state(Zb, x2, y, dev)
    g1 = lambda **kw: kernels.gibbs_sweep_marker(Zb, Gb, x2, beta, var_b, rn, ru, rca, rci, r,
                                                 scal, "B", **kw)
    g2 = lambda **kw: kernels.gibbs_sweep_block_mvn(Zb, Gb, x2, beta, var_b, rn, rca, r, scal,
                                                    **kw)
    m_pad = nb * C
    # each operand read once and each result written once; the operations:
    # Z1 r and the residual update (4 m n), the right-hand-side updates of
    # G1 (2 m C) or the Cholesky, G1 b_old and two solves of G2 per block
    g1_bytes = 4 * (m_pad * n + m_pad * C + 7 * m_pad + 3 * m_pad + 2 * n)
    g2_bytes = 4 * (m_pad * n + m_pad * C + 5 * m_pad + 2 * m_pad + 2 * n)
    g1_flops = 4.0 * m_pad * n + 2.0 * m_pad * C
    g2_flops = 4.0 * m_pad * n + nb * (2.0 * C ** 3 / 3 + 4.0 * C * C)
    out = {}
    for name, kind, fn, flops, nbytes in (
            ("gibbs_sweep_marker", "marker", g1, g1_flops, g1_bytes),
            ("gibbs_sweep_block_mvn", "mvn", g2, g2_flops, g2_bytes)):
        t = out[name] = {"ms": cuda_ms(fn, iters=5, warmup=1),
                         "bound": bound(flops, nbytes, F32_PEAK)}
        if not mhz:
            continue
        sc = kernels.gibbs_scratch(kind, nb, C, dev)
        t["prepass_ms"] = cuda_ms(lambda: fn(phases=1, scratch=sc), iters=5, warmup=1)
        t["serial_ms"] = cuda_ms(lambda: fn(phases=2, scratch=sc), iters=5, warmup=1)
        t["plan"] = kernels.gibbs_plan(kind, n, C)
        t["chain_floor_ms"] = chain_floor_ms(kind, nb, C, t["plan"]["S"], t["plan"]["P"], mhz)
    if mhz:
        dinv = torch.where(x2 > 0, scal[0] / var_b.clamp_min(1e-12), 1.0)
        Cb = Gb + torch.diag_embed(dinv) + 1e-4 * torch.eye(C, device=dev)
        lib = lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(Cb)[0])
        windows = [cuda_ms(lib, iters=5, warmup=3) for _ in range(5)]
        out["gibbs_sweep_block_mvn"]["library_ms"] = float(np.median(windows))
        out["gibbs_sweep_block_mvn"]["library_windows"] = windows
    return out


def gibbs_path_times(m: int, dev) -> dict:
    """The serial pass's two paths side by side: CUDA-event ms of one sweep
    of each kernel at n_c, the largest n the plan puts on the cluster path,
    and at n_c + 1, where it takes the cooperative grid (gibbs_times), on m
    standard-normal markers and a trait made on the card from a seed.
    Returns {kernel: {"n_c", "cluster_ms", "grid_ms"}}."""
    import torch

    from janusx_tpu_torch.ops import kernels

    out = {}
    for name, kind in (("gibbs_sweep_marker", "marker"), ("gibbs_sweep_block_mvn", "mvn")):
        n_c = kernels.gibbs_cluster_limit(kind)
        t = out[name] = {"n_c": n_c}
        for path, n in (("cluster", n_c), ("grid", n_c + 1)):
            require(kernels.gibbs_plan(kind, n, 128)["path"] == path,
                    f"phase 13 {kind} at n = {n}: not the {path} path")
            g = torch.Generator(device=dev).manual_seed(n)
            Z = torch.randn((n, m), generator=g, device=dev)
            y = (Z[:, :1000].sum(1) * 0.02 + torch.randn(n, generator=g, device=dev)).cpu()
            t[path + "_ms"] = gibbs_times(Z, y.numpy(), dev)[name]["ms"]
            del Z
            torch.cuda.empty_cache()
    return out


def run_bayes_phase(d: str, prefix: str, pheno: str, cpu, dev, smi: str):
    """Phase 13: ``jx gs -BLUP -BayesB -cv 5`` and ``-BayesA -BayesCpi
    -cv 0`` on a BAYES_SNPS-SNP subset of phase 5's panel, G1 and G2 against
    their plain versions, and their times. Returns (the launches of the
    phase's CLI runs, the kernels' numbers)."""
    import torch

    from janusx_tpu_torch.io.gfreader import load_raw_packed
    from janusx_tpu_torch.io.plink import write_plink
    from janusx_tpu_torch.ops import kernels

    t0 = time.monotonic()
    raw = load_raw_packed(prefix)
    sub = os.path.join(d, "bayes")
    write_plink(sub, raw.packed[:BAYES_SNPS], raw.n_samples,
                raw.sites.take(np.arange(BAYES_SNPS)), raw.samples)
    total = dict(NO_LAUNCHES)
    n_test = N_SAMPLES - N_PHENO

    def cli(argv, what, want):
        with plain_sweeps_forbidden():
            _, wall, launches = run_cli(argv, f"phase 13 {what}")
        require(launches == {**NO_LAUNCHES, **want},
                f"phase 13 {what}: launches {launches}, expected {want} (one per iteration "
                f"and fit)")
        for k, v in launches.items():
            total[k] += v
        return wall

    out1, out2 = os.path.join(d, "bayes1"), os.path.join(d, "bayes2")
    iters = ["--bayes-iters", str(BAYES_ITERS), "--bayes-burnin", str(BAYES_ITERS // 2)]
    wall1 = cli(["gs", "-bfile", sub, "-p", pheno, "-BLUP", "-BayesB", "-cv", "5", *iters,
                 "-o", out1], "-BLUP -BayesB -cv 5",
                {"gibbs_sweep_marker": BAYES_ITERS * 6})
    wall2 = cli(["gs", "-bfile", sub, "-p", pheno, "-BayesA", "-BayesCpi", "-cv", "0", *iters,
                 "-o", out2], "-BayesA -BayesCpi -cv 0",
                {"gibbs_sweep_marker": BAYES_ITERS, "gibbs_sweep_block_mvn": BAYES_ITERS})
    s1, (ids1, cols1, G1) = read_gs(out1, "test0")
    s2, (ids2, cols2, G2) = read_gs(out2, "test0")
    for cols, G, want in ((cols1, G1, ["BLUP", "BayesB"]), (cols2, G2, ["BayesA", "BayesCpi"])):
        require(cols == want and G.shape == (n_test, len(want)) and bool(np.isfinite(G).all()),
                f"phase 13 GEBV TSV: columns {cols}, shape {G.shape}")
    require(ids1 == ids2, "phase 13: the two runs' test samples differ")
    cv = {mm: s1["traits"]["test0"][mm]["cv"]["pearson"] for mm in ("BLUP", "BayesB")}
    require(cv["BayesB"] >= cv["BLUP"] - 0.05,
            f"phase 13 CV pearson BayesB {cv['BayesB']:.4f} < BLUP {cv['BLUP']:.4f} - 0.05")
    corr = float(np.corrcoef(np.column_stack([G1, G2]).T)[1:, 0].min())
    say(f"phase 13 jx gs on {s1['m_snps']} QC'd SNPs x {N_PHENO} phenotyped ({n_test} test): "
        f"CV pearson BLUP {cv['BLUP']:.4f}, BayesB {cv['BayesB']:.4f}; the Bayes test GEBVs "
        f"correlate with BLUP's at least {corr:.4f}; seconds: {gs_seconds(s1)}; "
        f"{gs_seconds(s2)}; cli {wall1:.2f} s and {wall2:.2f} s; launches {total}")

    # the kernels against their plain versions at the final fit's shape, and
    # their times
    keep, y = cpu["keep"], cpu["y"]
    Z = standardized(cpu["full"].take_snps(np.arange(s1["m_snps"])), keep, dev)
    check = check_gibbs(Z, y, dev)
    for method, c in check.items():
        say(f"phase 13 {'G2' if method == 'A' else 'G1'} Bayes{method} vs plain, one sweep at m "
            f"= {s1['m_snps']}, n = {N_PHENO}: max |Δβ| {c['max_abs_err']:.3g}, plain "
            f"{c['plain_ms']:.1f} ms; δ flips (block, marker, log-odds margin) {c['flips']}, "
            f"{c['uncompared']} markers uncompared after them")
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    times = gibbs_times(Z, y, dev, mhz)
    chain = gibbs_times(Z[:32], y[:32], dev)  # one CTA: the chain alone
    del Z
    torch.cuda.empty_cache()
    big = gibbs_times(standardized(cpu["full"], keep, dev), y, dev)
    torch.cuda.empty_cache()
    paths = gibbs_path_times(s1["m_snps"], dev)
    for name, t in times.items():
        t["chain_ms"], t["m_all_ms"] = chain[name]["ms"], big[name]["ms"]
        t["m_all_bound"] = big[name]["bound"]
        t["paths"] = paths[name]
        # G1's row is BayesB's (the sweep timed above); its error covers BayesCpi too
        c = [check["A"]] if name == "gibbs_sweep_block_mvn" else [check["B"], check["Cpi"]]
        t["max_abs_err"] = max(x["max_abs_err"] for x in c)
        t["plain_ms"] = c[0]["plain_ms"]
        t["delta_flips"] = sum(len(x["flips"]) for x in c)
        lib = (f", torch.linalg.cholesky_ex + cholesky_inverse of the Cb batch "
               f"{t['library_ms']:.4f} ms (median of the windows "
               f"{[round(w, 4) for w in t['library_windows']]})" if "library_ms" in t else "")
        say(f"phase 13 {name} ({smi}): one sweep at m = {s1['m_snps']}, n = {N_PHENO}: "
            f"{t['ms']:.4f} ms; pre-pass {t['prepass_ms']:.4f} + serial pass "
            f"{t['serial_ms']:.4f} ms ({t['plan']['path']} path, P = {t['plan']['P']} CTAs of "
            f"S = {t['plan']['S']} samples){lib}; plain {t['plain_ms']:.1f} ms, bound "
            f"{t['bound'][0]:.4f} ms ({t['bound'][1]}), chain-floor model (latencies assumed: "
            f"FP32 {FP32_CYCLES}, shuffle {SHFL_CYCLES} cycles) {t['chain_floor_ms']:.4f} "
            f"ms at {mhz:.0f} MHz; the chain alone, n = 32: {t['chain_ms']:.4f} ms; at m = "
            f"{cpu['full'].m}: {t['m_all_ms']:.3f} ms (bound {t['m_all_bound'][0]:.4f} ms); "
            f"the serial pass's paths at m = {s1['m_snps']} on random markers: the cluster at "
            f"n = {t['paths']['n_c']} {t['paths']['cluster_ms']:.4f} ms, the grid at n = "
            f"{t['paths']['n_c'] + 1} {t['paths']['grid_ms']:.4f} ms")
    say(f"phase 13 done in {time.monotonic() - t0:.2f} s")
    return total, times


# ------------------------------------------------------------ phase 14
POP_SNPS = 100_000  # an LD-pruned ADMIXTURE input's size
POP_K = 3
POP_FST = 0.1
TREE_SAMPLES = 970  # jx tree's leaves: the panel's first half


def write_pop_panel(d: str, seed: int = 20261017):
    """A PLINK panel of N_SAMPLES samples x POP_SNPS SNPs from POP_K
    Balding-Nichols populations at F_ST POP_FST (ancestral frequencies
    U[0.05, 0.95]): 80 % of the samples pure (population j mod K), 20 %
    admixed with Dirichlet(1) proportions; 1 % missing. Returns (prefix,
    the planted proportions (n, K), the pure samples' population or -1)."""
    from janusx_tpu_torch.io import bitcodec
    from janusx_tpu_torch.io.gdata import SiteInfo
    from janusx_tpu_torch.io.plink import write_plink

    rng = np.random.default_rng(seed)
    n, m, K = N_SAMPLES, POP_SNPS, POP_K
    pop = np.arange(n) % K
    admixed = rng.random(n) < 0.2
    Q = np.eye(K)[pop]
    Q[admixed] = rng.dirichlet(np.ones(K), size=int(admixed.sum()))
    pop[admixed] = -1
    a = (1 - POP_FST) / POP_FST
    packed = np.empty((m, bitcodec.n_bytes(n)), np.uint8)
    for s in range(0, m, 20_000):
        e = min(s + 20_000, m)
        anc = rng.uniform(0.05, 0.95, e - s)[:, None]
        F = rng.beta(anc * a, (1 - anc) * a, size=(e - s, K))
        p = (F @ Q.T).astype(np.float32)  # (k, n): each allele drawn at p
        g = ((rng.random(p.shape, dtype=np.float32) < p).astype(np.uint8)
             + (rng.random(p.shape, dtype=np.float32) < p))
        g[rng.random(g.shape, dtype=np.float32) < 0.01] = 3
        packed[s:e] = bitcodec.pack_codes(g)
    sites = SiteInfo(chrom=(np.arange(m) * 19 // m + 1).astype(str).astype(object),
                     pos=np.arange(1, m + 1, dtype=np.int64) * 30,
                     snp=np.array([f"p{i}" for i in range(m)], object),
                     allele0=np.array(["A"] * m, object), allele1=np.array(["G"] * m, object))
    prefix = os.path.join(d, "pops")
    write_plink(prefix, packed, n, sites, np.array([f"ind{j}" for j in range(n)], object))
    return prefix, Q, pop


def run_pop_phase(d: str, dev) -> dict:
    """Phase 14: ``jx fastpop -K 3`` and ``jx tree`` on a three-population
    panel, then the card against the CPU on its first CROSS_SNPS SNPs.
    Returns the kernel launches (all 0: neither reaches a kernel)."""
    import itertools

    from janusx_tpu_torch.cli.fastpop import build_parser
    from janusx_tpu_torch.io import bitcodec
    from janusx_tpu_torch.io.gfreader import load_raw_packed, prepare_packed
    from janusx_tpu_torch.io.plink import write_plink
    from janusx_tpu_torch.io.packed import QcParams
    from janusx_tpu_torch.models.fastpop import train_admixture
    from janusx_tpu_torch.models.tree import _tree_splits, ibs_distance

    t0 = time.monotonic()
    prefix, Q, pop = write_pop_panel(d)
    say(f"phase 14 panel: {N_SAMPLES} x {POP_SNPS} SNPs, {POP_K} populations at F_ST "
        f"{POP_FST}, {int((pop < 0).sum())} admixed, written in {time.monotonic() - t0:.2f} s")
    total = dict(NO_LAUNCHES)
    out = os.path.join(d, "pop")
    printed, wall_fp, launches = run_cli(["fastpop", "-bfile", prefix, "-K", str(POP_K),
                                          "-o", out], "phase 14 fastpop")
    total.update({k: total[k] + v for k, v in launches.items()})
    with open(os.path.join(out, f"fastpop.{POP_K}.Q")) as fh:
        Qh = np.array([[float(v) for v in ln.split()] for ln in fh])
    require(Qh.shape == Q.shape and bool(np.allclose(Qh.sum(1), 1.0, atol=1e-5)),
            f"phase 14 .Q shape {Qh.shape}")
    r_q = max(float(np.corrcoef(Qh[:, list(p)].ravel(), Q.ravel())[0, 1])
              for p in itertools.permutations(range(POP_K)))
    require(r_q >= 0.95, f"phase 14 fastpop: Q against the planted proportions r = {r_q:.4f}")
    # jx tree on the panel's first TREE_SAMPLES samples: its host NJ is
    # O(n³), ~100 s at all 1,940, which the smoke's time limit cannot spare
    raw = load_raw_packed(prefix)
    sub = os.path.join(d, "pops_tree")
    write_plink(sub, bitcodec.subset_columns(raw.packed, raw.n_samples, np.arange(TREE_SAMPLES)),
                TREE_SAMPLES, raw.sites, raw.samples[:TREE_SAMPLES])
    printed_t, wall_t, launches = run_cli(["tree", "-bfile", sub, "-o", out], "phase 14 tree")
    total.update({k: total[k] + v for k, v in launches.items()})
    with open(os.path.join(out, "jxtree.nwk")) as fh:
        splits = _tree_splits(fh.read().strip())
    leaves = {f"ind{j}" for j in range(TREE_SAMPLES)}
    tpop = pop[:TREE_SAMPLES]
    clades = []
    for k in range(POP_K):
        mine = {f"ind{j}" for j in np.flatnonzero(tpop == k)}
        others = {f"ind{j}" for j in np.flatnonzero((tpop >= 0) & (tpop != k))}
        fits = [side for s in splits for side in (s, leaves - s)
                if mine <= side and not (others & side)]
        require(fits, f"phase 14 tree: population {k}'s pure samples form no clean clade")
        clades.append(min(len(s) for s in fits))
    say(f"phase 14 fastpop -K {POP_K} (adam-em): Q vs planted r = {r_q:.4f} (best label "
        f"permutation); {printed.splitlines()[-1]}; cli {wall_fp:.2f} s. jx tree: each "
        f"population's pure samples form a clade free of the others' (smallest such clade "
        f"{clades} leaves for {[int((tpop == k).sum()) for k in range(POP_K)]} pure samples "
        f"of the first {TREE_SAMPLES}); cli {wall_t:.2f} s")

    # the card against the CPU on the first CROSS_SNPS SNPs
    args = build_parser().parse_args(["-bfile", prefix, "-K", str(POP_K)])
    pg = prepare_packed(prefix, QcParams(maf=args.maf, geno=args.geno, het=args.het))
    pg = pg.take_snps(np.arange(min(CROSS_SNPS, pg.m)))
    D = {dv: ibs_distance(pg, device=dv) for dv in (dev, "cpu")}
    require(bool(np.array_equal(D[dev], D["cpu"])), "phase 14: IBS card vs cpu not bit-equal")
    # the CLI's solver (adam-em); tests/test_torch_cuda.py holds both
    fits = [train_admixture(pg, POP_K, n_iter=10, solver=args.solver, seed=args.seed,
                            device=dv) for dv in (dev, "cpu")]
    dq = float(np.abs(fits[0].Q - fits[1].Q).max())
    dp = float(np.abs(fits[0].P - fits[1].P).max())
    require(max(dq, dp) <= 1e-4, f"phase 14 fastpop card vs cpu: max |ΔQ| {dq}, |ΔP| {dp}")
    say(f"phase 14 card vs cpu on {pg.m} SNPs: IBS bit-equal; fastpop ({args.solver}) at 10 "
        f"iterations max |ΔQ| {dq:.3g}, |ΔP| {dp:.3g}")
    require(total == NO_LAUNCHES, f"phase 14: a kernel launched: {total}")
    say(f"phase 14 done in {time.monotonic() - t0:.2f} s")
    return total


# ------------------------------------------------------------ phase 15
EPI_HOM = 0.2  # the planted markers' hom-alt frequency: the AND is carried by ~4 %
EPI_PERM = 100
WGCNA_N, WGCNA_GENES, WGCNA_BIG, WGCNA_MODULES = 400, 5_000, 20_000, 8
API_SNPS = 50_000  # a 50K array
API_CROSS = 4_096
BENCH_ITERS = 400  # bayes_fit's default chain, which jx benchmark's bayesa fits


@contextlib.contextmanager
def probe(targets: dict):
    """Wrap each function ``targets[name] = (owner, attribute)`` so that its
    calls, their seconds (the card synchronized before and after) and the
    kernel launches inside them add up under ``name``; yields those records."""
    import torch

    from janusx_tpu_torch.ops import kernels

    rec = {name: {"calls": 0, "s": 0.0, "launches": dict(NO_LAUNCHES)} for name in targets}
    saved = []
    for name, (owner, attr) in targets.items():
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _r=rec[name], **k):
            torch.cuda.synchronize()
            before, t0 = scan_launches(), time.monotonic()
            try:
                return _fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                _r["calls"] += 1
                _r["s"] += time.monotonic() - t0
                for key, v in scan_launches().items():
                    _r["launches"][key] += v - before[key]

        saved.append((owner, attr, fn))
        setattr(owner, attr, wrapped)
    try:
        yield rec
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


HELD_PER_KERNEL = 3  # launches kept per kernel and path, the first at each shape


class _Held:
    """A kernel wrapper that, while a path runs, keeps a copy of the
    arguments and results of its first ``per_shape`` launches at each
    shape and mode (at most HELD_PER_KERNEL shapes), for hold_launches().
    Its launch count is the wrapper's own: the wrapper counts under its
    name in utils.trace's table, which launch_counts() reads."""

    def __init__(self, fn, kept: list, per_shape: int = 1):
        import inspect

        self.fn, self.kept, self.__name__ = fn, kept, fn.__name__
        self.sig, self.keys, self.per_shape = inspect.signature(fn), {}, per_shape

    def __call__(self, *a, **k):
        import torch

        from janusx_tpu_torch.ops import kernels

        args = self.sig.bind(*a, **k)
        args.apply_defaults()
        key = tuple(tuple(v.shape) if torch.is_tensor(v) else v
                    for n, v in args.arguments.items() if not n.endswith("_split"))
        if (not a[0].is_cuda or self.keys.get(key, 0) >= self.per_shape
                or sum(self.keys.values()) >= HELD_PER_KERNEL * self.per_shape):
            return self.fn(*a, **k)
        copy = {n: v.clone() if torch.is_tensor(v) else v for n, v in args.arguments.items()}
        before = scan_launches()[self.__name__]
        out = self.fn(*a, **k)
        if scan_launches()[self.__name__] > before:
            self.keys[key] = self.keys.get(key, 0) + 1
            after = {n: args.arguments[n].clone() for n in ("beta", "var_b", "r")
                     if n in args.arguments}
            self.kept.append((self.__name__, copy, None if out is None else out.clone(), after))
        return out


@contextlib.contextmanager
def held(per_shape: int = 1):
    """Every kernel wrapper replaced by a _Held one while the block runs;
    yields the list of kept launches (name, arguments, result, the Gibbs
    state after): the first ``per_shape`` launches at each shape (phase
    18's shards launch at one shape each)."""
    from janusx_tpu_torch.ops import kernels

    kept, names = [], list(NO_LAUNCHES)
    saved = [getattr(kernels, n) for n in names]
    for n, fn in zip(names, saved):
        setattr(kernels, n, _Held(fn, kept, per_shape))
    try:
        yield kept
    finally:
        for n, fn in zip(names, saved):
            setattr(kernels, n, fn)


def hold_launches(kept: list, path: str, dev, phase: str = "phase 15") -> dict:
    """Each launch that held() kept, against its plain version on the same
    inputs, at phases 3, 4 and 13's tolerances: K1 rtol 1e-5 / atol 1e-4;
    K2 against its own mode's plain version by _k2_bounds (beta/se at λ*
    need the scan's rotation, which the launch does not see: phase 4 holds
    them), where each SNP's argmin cell is the plain version's or a near-
    tie, one whose plain value lies within the cell tolerance (rtol 1e-4 /
    atol 1e-3) of the plain minimum (jx benchmark's simulated trait leaves
    ~1.4 % of its SNPs with such flat profiles); G1 and G2 one sweep from the launch's state with its draws, by
    gibbs_blockwise, the launch's own result equal to the block-by-block
    launches bit for bit. Prints a line per launch; returns the largest
    |error| per kernel."""
    import torch

    from janusx_tpu_torch.core.reml import make_grid
    from janusx_tpu_torch.ops import kernels

    errs = {}
    for name, a, out, after in kept:
        what = f"{phase} {path} {name}"
        if name == "decode_rotate":
            plain = (kernels.decode_rotate_plain if a["prec"] == "highest"
                     else kernels.decode_rotate_high_plain)
            want = plain(a["packed"], a["mean"], a["U"])
            err = (out - want).abs()
            e = float(err.max())
            require(bool((err <= 1e-4 + 1e-5 * want.abs()).all()),
                    f"{what} {a['prec']}: outside rtol 1e-5 / atol 1e-4 (max |err| {e:.3g})")
            detail = (f"{a['prec']} M={out.shape[0]} n={a['U'].shape[0]} N={out.shape[1]}: "
                      f"max |err| {e:.3g}")
            del want, err
        elif name == "grid_neg_reml_lattice":
            Gr, SH, p = a["Gr"], a["SH"], a["p"]
            want = kernels.grid_neg_reml_lattice_plain(Gr, a["W"], a["YX"], SH, p, a["ridge"],
                                                       a["nf"], a["prec"])
            T, (B, G) = (1 if SH.dim() == 2 else SH.shape[0]), (Gr.shape[0], a["W"].shape[0])
            got, want = out.reshape(T, B, G), want.reshape(T, B, G)
            e, vs = _k2_bounds(f"{what} {a['prec']}", got, want, make_grid(G, dev), None, Gr,
                               own=True, same_min=0.5)
            # a SNP whose argmin cell moved: the plain value at the kernel's
            # cell within the cell tolerance of the plain minimum (a flat
            # profile's near-tie)
            low = want.min(-1).values
            moved = torch.argmin(got, -1) != torch.argmin(want, -1)
            gap = (want.gather(-1, torch.argmin(got, -1)[..., None])[..., 0] - low)[moved]
            require(bool((gap <= 1e-3 + 1e-4 * low[moved].abs()).all()),
                    f"{what}: an argmin cell moved to a cell beyond the cell tolerance of the "
                    f"plain minimum; {vs}")
            detail = (f"{a['prec']} T={T} B={B} G={G} n={Gr.shape[1]} p={p}: {vs}; "
                      f"{int(moved.sum())} argmin cells moved, each to a near-tie (largest gap "
                      f"{float(gap.max()) if bool(moved.any()) else 0.0:.3g})")
            del got, want
        else:
            method = a.get("method", "A")
            keys = (("rn", "ru", "rca", "rci") if method != "A" else ("z", None, "rchi", None))
            d = (None, *(a[x] if x else None for x in keys))
            state = [a["beta"], a["var_b"], a["r"]]
            fused = [after["beta"], after["var_b"], after["r"]]
            res = gibbs_blockwise(a["Zb"], a["Gb"], a["x2"], a["scal"], method, state, d, fused,
                                  out, what)
            e = res["max_abs_err"]
            nb, C, n = a["Zb"].shape
            detail = (f"Bayes{method} {nb} blocks of {C} x n={n}: max |Δβ| {e:.3g}, δ flips "
                      f"(block, marker, log-odds margin) {res['flips']}, {res['uncompared']} "
                      f"markers uncompared after them, the launch equal to the block-by-block "
                      f"launches")
        errs[name] = max(errs.get(name, 0.0), e)
        say(f"{what} vs plain at the path's launch shape, {detail}")
    torch.cuda.empty_cache()
    return errs


def garfield_targets() -> dict:
    """The stages of ``jx garfield``, for probe()."""
    from janusx_tpu_torch.io import gfreader
    from janusx_tpu_torch.models import garfield, grm

    return {"load": (gfreader, "load_raw_packed"), "qc": (gfreader.RawPacked, "prepare"),
            "grm": (grm, "grm_from_packed"), "b_build": (garfield, "hom_alt_matrix"),
            "residualize": (garfield, "_residualize"),
            "preselect": (garfield, "preselect_features"), "search": (garfield, "_beam_search"),
            "tsv": (garfield, "write_garfield_tsv")}


def stages(rec) -> str:
    return ", ".join(f"{k}={r['s']:.3f}" + (f" ({r['calls']} calls)" if r["calls"] > 1 else "")
                     for k, r in rec.items() if r["calls"])


def write_epi_pheno(d: str, cpu):
    """The planted rule: the AND of the hom-alt indicators of two QC'd SNPs,
    one on chromosome 1 among the first CROSS_SNPS and one on chromosome 10,
    each with the hom-alt frequency nearest EPI_HOM among the phenotyped
    samples; the trait is 2 rule + N(0, 0.8²) (tests/test_garfield_algwas.py:
    11-30). Returns (the phenotype file, the rule on the phenotyped samples,
    the trait on them, the two SNPs' names)."""
    pg = cpu["pg"]
    chrom = pg.sites.chrom.astype(str)
    lo = int(np.flatnonzero(chrom == "10")[0])
    picks = []
    for s, e in ((0, min(CROSS_SNPS, pg.m)), (lo, lo + 20_000)):
        f = (pg.dosages(s, e) == 2).mean(axis=1)
        picks.append(s + int(np.argmin(np.abs(f - EPI_HOM))))
    rule = (pg.dosages(picks[0], picks[0] + 1)[0] == 2) & (pg.dosages(picks[1], picks[1] + 1)[0]
                                                           == 2)
    y = 2.0 * rule + np.random.default_rng(15).normal(0.0, 0.8, pg.n)
    yall = np.full(N_SAMPLES, np.nan)
    yall[cpu["keep"]] = y
    path = os.path.join(d, "epi.pheno")
    with open(path, "wt") as fh:
        fh.write("ID\tepi\n" + "".join(f"ind{j}\t{'NA' if np.isnan(v) else f'{v:.6f}'}\n"
                                       for j, v in enumerate(yall)))
    return path, rule.astype(float), y, [str(pg.sites.snp[i]) for i in picks]


def rule_vector(text: str, pg, index: dict) -> np.ndarray:
    """A rule of a ``jx garfield`` TSV ("snpA AND NOT snpB", ...) evaluated
    on ``pg``'s samples."""
    hom = lambda name: pg.dosages(index[name], index[name] + 1)[0] == 2
    toks = text.split()
    neg = toks[0] == "NOT"
    toks = toks[1:] if neg else toks
    v, i = hom(toks[0]) ^ neg, 1
    while i < len(toks):
        op = toks[i]
        if op == "AND" and toks[i + 1] == "NOT":
            op, i = "ANDN", i + 1
        b = hom(toks[i + 1])
        v = v & b if op == "AND" else v & ~b if op == "ANDN" else v ^ b
        i += 2
    return v.astype(float)


def same_rules(card, cpu_res, H) -> int:
    """Scores and permutation maxima rtol 1e-5, the same p-values, and the
    same rules off ties (a rule whose score lies more than 1e-6 from every
    other's: the same indicator vector, or its complement for a literal or
    an XOR, whose complement scores alike). Returns the rules compared."""
    sc, sh = (np.array([r.score for r in res.rules]) for res in (card, cpu_res))
    require(sc.shape == sh.shape and bool(np.allclose(sc, sh, rtol=1e-5, atol=0)),
            f"phase 15 garfield card vs cpu: rule scores differ beyond rtol 1e-5")
    require(bool(np.allclose(card.perm_max_scores, cpu_res.perm_max_scores, rtol=1e-5, atol=0)),
            "phase 15 garfield card vs cpu: permutation maxima differ beyond rtol 1e-5")
    require(bool(np.array_equal(card.pvalues, cpu_res.pvalues)), "phase 15: p-values differ")

    def vec(ru):
        b = H[ru.snps[0]]
        v = 1 - b if ru.ops[0] == "NOT" else b
        for op, s in zip(ru.ops[1:], ru.snps[1:]):
            v = v & H[s] if op == "AND" else v & (1 - H[s]) if op == "ANDN" else v ^ H[s]
        return v

    n = 0
    for i, s in enumerate(sh):
        if not np.all(np.abs(np.delete(sh, i) - s) > 1e-6 * s):
            continue
        a, b = vec(card.rules[i]), vec(cpu_res.rules[i])
        twin = all(op == "XOR" for op in cpu_res.rules[i].ops[1:])
        require(bool(np.array_equal(a, b)) or (twin and bool(np.array_equal(a, 1 - b))),
                f"phase 15 garfield card vs cpu: rule {i} differs: {card.rules[i]} vs "
                f"{cpu_res.rules[i]}")
        n += 1
    require(n > 0, "phase 15 garfield card vs cpu: no rule off ties")
    return n


def garfield_search_times(cpu, y, dev) -> dict:
    """CUDA-event times at every QC'd SNP of the panel: the B build, the
    depth-1 pass, one (64 seeds x m) extension with its top-k, one whole
    search (depth 2, beam 64) and the host's share of it."""
    import torch

    from janusx_tpu_torch.models import garfield as gf

    pg = cpu["pg"]
    B = gf.hom_alt_matrix(pg, device=dev)
    t = gf._residualize(y, None)
    t2, n = float(t @ t), pg.n
    tj = torch.as_tensor(t, dtype=torch.float32, device=dev)
    seeds = B[:64].clone()
    mark = gf._marker_sums(B, tj)
    out = dict(
        m=pg.m,
        b_build=cuda_ms(lambda: gf.hom_alt_matrix(pg, device=dev), iters=2, warmup=1),
        depth1=cuda_ms(lambda: gf._single_scores(B, t, t2, "corr", n), iters=3, warmup=1),
        extension=cuda_ms(lambda: gf._extension_top(seeds, B, tj, t2, float(n), "corr", mark, 5,
                                                    4), iters=3, warmup=1),
        search=cuda_ms(lambda: gf._beam_search(B, t, 2, 64, 5), iters=3, warmup=1))
    del B, seeds
    torch.cuda.empty_cache()
    out["host"] = out["search"] - out["depth1"] - out["extension"]
    # the least the card could take for one extension as it is formulated:
    # B (f32) read once at 3.35 TB/s against the two f32 products' 2 x 2 S
    # n m operations at the f32 rate outside the tensor cores (TF32 is off)
    nm = float(n) * pg.m
    out["bound"] = bound(2 * 2.0 * 64 * nm, 4.0 * nm, F32_PEAK)
    # and as an exact tensor-core formulation could: the carrier counts, a
    # product of 0/1 matrices, on int8 at 1,979 TOP/s; the t-weighted
    # product as three bf16 pieces of t (K1's split; B is exact in bf16) at
    # 989 TFLOP/s; B read once as int8
    tc_ms = (2.0 * 64 * nm / 1979e12 + 3 * 2.0 * 64 * nm / 989e12) * 1e3
    out["tc_bound"] = max((tc_ms, "operations"), (nm / 3.35e12 * 1e3, "bytes"))
    return out


def run_garfield(d, prefix, cpu, dev, smi) -> dict:
    """``jx garfield``: whole-genome, -width 256 -grm, and a window scan;
    then the card against the CPU on the first CROSS_SNPS SNPs and one
    search's times at full width. Returns the launches of the three CLIs."""
    from janusx_tpu_torch.io.gfreader import load_raw_packed
    from janusx_tpu_torch.io.plink import write_plink
    from janusx_tpu_torch.models.garfield import garfield_scan, hom_alt_matrix

    pheno, rule, y, names = write_epi_pheno(d, cpu)
    pg, keep = cpu["pg"], cpu["keep"]
    index = {s: i for i, s in enumerate(pg.sites.snp)}
    total = dict(NO_LAUNCHES)
    say(f"phase 15 planted rule: {names[0]} AND {names[1]} (hom-alt AND hom-alt), carried by "
        f"{int(rule.sum())} of {pg.n} phenotyped samples")

    def cli(argv, what, bfile=prefix):
        with probe(garfield_targets()) as rec:
            _, wall, launches = run_cli(["garfield", "-bfile", bfile, "-p", pheno, *argv],
                                        f"phase 15 garfield {what}")
        require(launches == NO_LAUNCHES, f"phase 15 garfield {what}: a kernel launched: "
                f"{launches}")
        for key, v in launches.items():
            total[key] += v
        say(f"phase 15 garfield {what}: wall {wall:.2f} s; stages (s): {stages(rec)}")
        return os.path.join(argv[argv.index("-o") + 1], "garfield.epi.garfield")

    out = cli(["-depth", "2", "-beam", "64", "-perm", str(EPI_PERM), "-o",
               os.path.join(d, "gf1")], "-depth 2 -beam 64 -perm 100")
    header, rows = read_tsv(out + ".tsv")
    require(header == "rule\tdepth\tsupport\tscore\tpperm" and len(rows) == 50,
            f"phase 15 garfield TSV: {header!r}, {len(rows)} rows")
    r = float(np.corrcoef(rule_vector(rows[0][0], pg, index), rule)[0, 1])
    require(r >= 0.9 and abs(float(rows[0][4]) - 1 / (EPI_PERM + 1)) < 1e-6,
            f"phase 15 garfield top rule {rows[0]}: r = {r:.4f} with the planted rule")
    say(f"phase 15 garfield whole-genome at {pg.m} QC'd SNPs: top rule '{rows[0][0]}' score "
        f"{rows[0][3]}, support {rows[0][2]}, p {rows[0][4]}, r = {r:.4f} with the planted rule")

    out = cli(["-width", "256", "-grm", "-o", os.path.join(d, "gf2")], "-width 256 -grm")
    _, rows = read_tsv(out + ".tsv")
    rs = [float(np.corrcoef(rule_vector(row[0], pg, index), rule)[0, 1]) for row in rows[:5]]
    require(max(rs) >= 0.9, f"phase 15 garfield -width 256 -grm: top-5 r {rs}")
    k = int(np.argmax(rs))
    say(f"phase 15 garfield -width 256 -grm: the planted rule at rank {k + 1} ('{rows[k][0]}', "
        f"score {rows[k][3]}, p {rows[k][4]}, r = {rs[k]:.4f}); top-5 r {np.round(rs, 4)}")

    # the window scan on the panel's chromosome 1 alone: the same SNPs pass
    # the same per-SNP QC, which then spares ~20 s of the whole panel's
    raw = load_raw_packed(prefix)
    chr1 = np.flatnonzero(raw.sites.chrom.astype(str) == "1")
    sub = os.path.join(d, "chr1")
    write_plink(sub, raw.packed[chr1], raw.n_samples, raw.sites.take(chr1), raw.samples)
    out = cli(["-w", "500", "-bimrange", WINDOW, "-o", os.path.join(d, "gf3")],
              f"-w 500 -bimrange {WINDOW} (chromosome 1)", bfile=sub)
    header, rows = read_tsv(out + ".windows.tsv")
    require(header == "chrom\tstart\tend\trule\tdepth\tsupport\tscore\tpperm" and rows
            and all(len(row) == 8 and row[0] == "1" and int(row[2]) - int(row[1]) == 500_000
                    for row in rows), f"phase 15 window TSV {header!r}, {rows[:2]}")
    say(f"phase 15 garfield window TSV: {len(rows)} rows over "
        f"{len({(row[1], row[2]) for row in rows})} windows of 500 kb")

    # the card against the CPU on the first CROSS_SNPS SNPs, from one seed
    head = cpu["head"]
    t0 = time.monotonic()
    res = {str(dv): garfield_scan(head, y, depth=2, beam=64, n_perm=20, seed=0, device=dv)
           for dv in (dev, "cpu")}
    H = hom_alt_matrix(head, device="cpu").numpy().astype(np.uint8)
    n_off = same_rules(res[str(dev)], res["cpu"], H)
    say(f"phase 15 garfield card vs cpu at {head.m} SNPs, -perm 20: {len(res['cpu'].rules)} rule "
        f"scores and 20 null maxima within rtol 1e-5, p-values equal, {n_off} rules off ties "
        f"the same; {time.monotonic() - t0:.2f} s")
    tm = garfield_search_times(cpu, y, dev)
    say(f"phase 15 garfield device times ({smi}) at m = {tm['m']}, n = {pg.n}: B build "
        f"{tm['b_build']:.3f} ms, depth-1 pass {tm['depth1']:.3f} ms, one extension of 64 "
        f"seeds with its top-k {tm['extension']:.3f} ms (bound of its f32 formulation "
        f"{tm['bound'][0]:.3f} ms, {tm['bound'][1]}; of an exact tensor-core formulation "
        f"{tm['tc_bound'][0]:.3f} ms, {tm['tc_bound'][1]}), one search (depth 2, beam 64) "
        f"{tm['search']:.3f} ms, of it host and transfers {tm['host']:.3f} ms")
    return total


def planted_expression(genes: int, seed: int):
    """(WGCNA_N, genes) expression: WGCNA_MODULES modules of 300-600 genes
    (scaled with ``genes`` / WGCNA_GENES), each gene its module's eigengene
    with loading U[0.8, 0.95] (module membership kME >= 0.8) plus noise;
    the other genes noise. Returns (expression, labels with -1 for noise)."""
    rng = np.random.default_rng(seed)
    scale = genes // WGCNA_GENES
    sizes = rng.integers(300, 601, WGCNA_MODULES) * scale
    labels = np.full(genes, -1)
    labels[:sizes.sum()] = np.repeat(np.arange(WGCNA_MODULES), sizes)
    labels = labels[rng.permutation(genes)]
    E = rng.normal(size=(WGCNA_N, WGCNA_MODULES))
    a = rng.uniform(0.8, 0.95, genes)
    X = rng.normal(size=(WGCNA_N, genes)) * np.sqrt(1 - a * a)
    on = labels >= 0
    X[:, on] += a[on] * E[:, labels[on]]
    X[:, ~on] = rng.normal(size=(WGCNA_N, int((~on).sum())))
    return X, labels


def adjusted_rand(a, b) -> float:
    """Adjusted Rand index of two labelings (numpy; no sklearn)."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    C = np.zeros((ai.max() + 1, bi.max() + 1))
    np.add.at(C, (ai, bi), 1)
    pairs = lambda x: (x * (x - 1) / 2).sum()
    sa, sb, tot = pairs(C.sum(1)), pairs(C.sum(0)), len(a) * (len(a) - 1) / 2
    exp = sa * sb / tot
    return float((pairs(C) - exp) / ((sa + sb) / 2 - exp))


def run_wgcna(dev, smi) -> None:
    """The WGCNA helpers on a planted 400 x 5,000 expression matrix (one
    blockwiseModules block), the TOM on the card against the CPU, and the
    cor + TOM seconds at 5,000 and 20,000 genes."""
    from janusx_tpu_torch.gtools import adj, cluster, cor, pick_soft_threshold, tom

    X, planted = planted_expression(WGCNA_GENES, seed=20261018)
    t0 = time.monotonic()
    sim = cor(X)
    t_cor = time.monotonic() - t0
    # the soft power: pick_soft_threshold's is printed; the adjacency takes
    # adj's default 6, because the scale-free fit that ranks the powers
    # (_scale_free_fit, the reference's, kept line for line) bins the
    # connectivities by quantile, so p(k) is flat and R² ~ 0 at every power
    power, table = pick_soft_threshold(sim, range(1, 21))
    A = adj(sim)
    t0 = time.monotonic()
    D = tom(A)
    t_tom = time.monotonic() - t0
    labels, info = cluster(D, num_modules=WGCNA_MODULES, return_info=True)
    on = planted >= 0
    ari = adjusted_rand(planted[on], labels[on])
    require(ari >= 0.9, f"phase 15 WGCNA: ARI {ari:.4f} over the planted modules' genes")
    D_cpu = tom(A, device="cpu")
    require(bool(np.allclose(D, D_cpu, rtol=1e-5, atol=1e-6)),
            f"phase 15 WGCNA: TOM card vs cpu max |Δ| {np.abs(D - D_cpu).max():.3g}")
    say(f"phase 15 WGCNA {WGCNA_N} x {WGCNA_GENES}: pick_soft_threshold power {power} (R² "
        f"{dict((p, r) for p, r, _ in table)[power]:.3f}; adj at 6), {labels.max()} modules "
        f"({info['module_method']}), ARI {ari:.4f} over {int(on.sum())} planted genes, TOM "
        f"card vs cpu max |Δ| {np.abs(D - D_cpu).max():.3g}; cor {t_cor:.3f} s + tom "
        f"{t_tom:.3f} s ({smi})")
    del sim, A, D, D_cpu
    X, _ = planted_expression(WGCNA_BIG, seed=20261019)
    t0 = time.monotonic()
    sim = cor(X)
    t_cor = time.monotonic() - t0
    A = adj(sim)
    del sim
    t0 = time.monotonic()
    D = tom(A)
    t_tom = time.monotonic() - t0
    require(D.shape == (WGCNA_BIG, WGCNA_BIG) and bool(np.isfinite(D[::97]).all()),
            "phase 15 WGCNA at 20,000 genes: TOM not finite")
    say(f"phase 15 WGCNA {WGCNA_N} x {WGCNA_BIG}: cor {t_cor:.3f} s + tom {t_tom:.3f} s ({smi})")


def run_api(cpu, rows5, dev) -> dict:
    """ASSOC on the first API_SNPS QC'd SNPs with phase 5's GRM (lmm held to
    phase 5's TSV), card against CPU on API_CROSS SNPs, and
    GenomicSelection("BayesB"), whose first G1 launch is held against its
    plain version. Returns (the launches of the API calls, hold_launches'
    errors)."""
    import torch

    from janusx_tpu_torch.api import ASSOC, GenomicSelection
    from janusx_tpu_torch.ops import kernels

    keep, y = cpu["keep"], cpu["y"]
    pg = cpu["pg"].take_snps(np.arange(API_SNPS))
    G = pg.dosages().T.astype(np.float64)
    G[G < 0] = np.nan
    K = cpu["K"][np.ix_(keep, keep)]
    kernels.reset_launches()
    res, walls = {}, {}
    for model in ("lm", "lmm", "fvlmm", "splmm"):
        t0 = time.monotonic()
        res[model] = ASSOC(model, device=dev).fit(y, K=K)._assoc_arrays(G)
        walls[model] = time.monotonic() - t0
        require(bool(np.isfinite(res[model][2]).all()), f"phase 15 ASSOC {model}: p not finite")
    require([r[2] for r in rows5[:API_SNPS]] == list(pg.sites.snp), "phase 15: SNP rows differ")
    dmax = agree(res["lmm"][2], [float(r[10]) for r in rows5[:API_SNPS]],
                 "phase 15 ASSOC lmm vs phase 5's TSV", 0.05)
    lm_cpu = ASSOC("lm", device="cpu").fit(y, K=K)._assoc_arrays(G[:, :API_CROSS])
    for got, want, what in zip(res["lm"][:2], lm_cpu[:2], ("beta", "se")):
        require(bool(np.allclose(got[:API_CROSS], want, rtol=1e-6, atol=0)),
                f"phase 15 ASSOC lm {what} card vs cpu")
    lmm_cpu = ASSOC("lmm", device="cpu").fit(y, K=K)._assoc_arrays(G[:, :API_CROSS])
    d_cc = float(np.abs(np.log10(res["lmm"][2][:API_CROSS]) - np.log10(lmm_cpu[2])).max())
    require(d_cc <= 5e-3, f"phase 15 ASSOC lmm card vs cpu: max Δ(-log10 p) {d_cc}")
    say(f"phase 15 ASSOC on {API_SNPS} SNPs x {pg.n}: lmm vs phase 5's TSV max Δ(-log10 p) "
        f"{dmax:.4g} (bound 0.05), top-5 equal; card vs cpu on {API_CROSS} SNPs: lm beta/se "
        f"rtol 1e-6, lmm max Δ(-log10 p) {d_cc:.3g}; walls (s): "
        + ", ".join(f"{k}={v:.2f}" for k, v in walls.items()))
    ymask = y.copy()
    ymask[::5] = np.nan
    t0 = time.monotonic()
    with held() as kept:
        gebv = GenomicSelection("BayesB", device=dev).fit(G, ymask).predict()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = scan_launches()
    require(launches == {**NO_LAUNCHES, "gibbs_sweep_marker": BENCH_ITERS},
            f"phase 15 GenomicSelection BayesB: launches {launches}")
    require(gebv.shape == (pg.n,) and bool(np.isfinite(gebv).all()), "phase 15 GS: GEBVs")
    r = float(np.corrcoef(gebv[::5], y[::5])[0, 1])
    say(f"phase 15 GenomicSelection('BayesB') on {API_SNPS} SNPs: {pg.n} finite GEBVs, r = "
        f"{r:.4f} with the {len(y[::5])} masked phenotypes, {launches['gibbs_sweep_marker']} G1 "
        f"launches; {wall:.2f} s")
    return launches, hold_launches(kept, "GenomicSelection", dev)


def run_benchmarks(d, dev) -> tuple:
    """``jx benchmark -repeats 1``, ``jx gblupbench``, ``jx bayesbench -iters
    400 -burnin 100`` and ``jx garfieldbench`` at their defaults; their JSON
    and the kernels each launched, the launches of ``jx benchmark`` and ``jx
    bayesbench`` held against their plain versions at the CLI's shapes
    (hold_launches). Returns (the launches by CLI, the errors by CLI)."""
    from janusx_tpu_torch.gs import bayes
    from janusx_tpu_torch.models import fvlmm, lmm

    paths, errs = {}, {}
    out = os.path.join(d, "bench")
    with probe({"lmm_scan": (lmm, "lmm_scan"), "fvlmm_scan": (fvlmm, "fvlmm_scan"),
                "bayes_fit": (bayes, "bayes_fit")}) as rec, held() as kept:
        _, wall, paths["benchmark"] = run_cli(["benchmark", "-repeats", "1", "-o", out],
                                              "phase 15 benchmark")
    with open(os.path.join(out, "bench.benchmark.json")) as fh:
        js = json.load(fh)
    mods = [r["module"] for r in js["results"]]
    require(mods == ["grm", "lmm_scan", "fvlmm_scan", "splmm_scan", "gblup_fit",
                     "bayesa_fit_400it"], f"phase 15 benchmark modules {mods}")
    kl, kf, kb = (rec[k]["launches"] for k in ("lmm_scan", "fvlmm_scan", "bayes_fit"))
    require(kl["decode_rotate"] > 0 and kl["grid_neg_reml_lattice"] > 0
            and kf["decode_rotate"] > 0, f"phase 15 benchmark: K1/K2 in lmm {kl}, fvlmm {kf}")
    require(kb == {**NO_LAUNCHES, "gibbs_sweep_block_mvn": BENCH_ITERS * rec["bayes_fit"]["calls"]}
            and paths["benchmark"]["gibbs_sweep_marker"] == 0,
            f"phase 15 benchmark: bayesa launches {kb} over {rec['bayes_fit']['calls']} fits")
    say(f"phase 15 benchmark n={js['n']} m={js['m']}: " + "; ".join(
        f"{r['module']} {r['seconds']} s" + (f" ({r['rate']} {r['unit']})" if "rate" in r else "")
        for r in js["results"]) + f"; launches lmm {kl}, fvlmm {kf}, bayes_fit "
        f"{rec['bayes_fit']['calls']} fits {kb}; cli {wall:.2f} s")
    errs["benchmark"] = hold_launches(kept, "benchmark", dev)
    require(set(errs["benchmark"]) == {"decode_rotate", "grid_neg_reml_lattice",
                                       "gibbs_sweep_block_mvn"},
            f"phase 15 benchmark: held launches of {sorted(errs['benchmark'])}")

    out = os.path.join(d, "gblupbench")
    _, wall, paths["gblupbench"] = run_cli(["gblupbench", "-o", out], "phase 15 gblupbench")
    with open(os.path.join(out, "gblupbench.gblupbench.json")) as fh:
        js = json.load(fh)
    require([r["route"] for r in js["routes"]] == ["GBLUP", "rrBLUP-PCG"]
            and paths["gblupbench"] == NO_LAUNCHES, f"phase 15 gblupbench {js['routes']}")
    say(f"phase 15 gblupbench n={js['n']} m={js['m']} grm {js['grm_seconds']} s: "
        + "; ".join(f"{r['route']} cv {r['cv_seconds']} s fit {r['fit_seconds']} s cv_r "
                    f"{r['cv_pearson']} test_r {r['test_pearson']}" for r in js["routes"])
        + f"; cli {wall:.2f} s")

    out = os.path.join(d, "bayesbench")
    with held() as kept:
        _, wall, paths["bayesbench"] = run_cli(
            ["bayesbench", "-iters", str(BENCH_ITERS), "-burnin", "100", "-o", out],
            "phase 15 bayesbench")
    with open(os.path.join(out, "bayesbench.bayesbench.json")) as fh:
        js = json.load(fh)
    want = {**NO_LAUNCHES, "gibbs_sweep_marker": 2 * BENCH_ITERS,
            "gibbs_sweep_block_mvn": BENCH_ITERS}  # x 1 chain: B and Cpi on G1, A on G2
    require([r["method"] for r in js["methods"]] == ["BLUP", "BayesA", "BayesB", "BayesCpi"]
            and paths["bayesbench"] == want, f"phase 15 bayesbench launches "
            f"{paths['bayesbench']}, expected {want}")
    say(f"phase 15 bayesbench n={js['n']} m={js['m']} iters={js['iters']}: " + "; ".join(
        f"{r['method']} fit {r['fit_seconds']} s test_r {r['test_pearson']}"
        for r in js["methods"]) + f"; launches {paths['bayesbench']}; cli {wall:.2f} s")
    methods = sorted(a.get("method", "A") for _, a, _, _ in kept)
    require(methods == ["A", "B", "Cpi"], f"phase 15 bayesbench: held sweeps of {methods}")
    errs["bayesbench"] = hold_launches(kept, "bayesbench", dev)

    # --and-het-max 1: at its default 0.05 no site of the outbred simulated
    # panel qualifies as a gate member, and every rep skips its search
    out = os.path.join(d, "garfieldbench")
    _, wall, paths["garfieldbench"] = run_cli(["garfieldbench", "--and-het-max", "1", "-o", out],
                                              "phase 15 garfieldbench")
    with open(os.path.join(out, "garfieldbench.garfieldbench.json")) as fh:
        js = json.load(fh)
    require(len(js["reps"]) == 5 and paths["garfieldbench"] == NO_LAUNCHES,
            f"phase 15 garfieldbench: {len(js['reps'])} reps")
    say(f"phase 15 garfieldbench n={js['n']} m={js['m']}: power {js['power']}, validated "
        f"{js['validated_power']}, search seconds {[r['seconds'] for r in js['reps']]}; "
        f"cli {wall:.2f} s")
    return paths, errs


def run_epistasis_phase(d, prefix, rows5, cpu, dev, smi) -> tuple:
    """Phase 15: GARFIELD, WGCNA, the in-memory API and the benchmark CLIs.
    Returns (the launches by path, the held launches' errors by path)."""
    t0 = time.monotonic()
    paths = {"garfield": run_garfield(d, prefix, cpu, dev, smi)}
    run_wgcna(dev, smi)
    paths["api"], api_errs = run_api(cpu, rows5, dev)
    bench, errs = run_benchmarks(d, dev)
    paths.update(bench)
    errs["api"] = api_errs
    say(f"phase 15 done in {time.monotonic() - t0:.2f} s")
    return paths, errs


# ------------------------------------------------------------ phase 16
TOOLS_CHROM = "1"  # gformat -prune, the format round trips, gmerge and hybrid build
CONV_SNPS = 4_096  # the VCF/HapMap round trips: chromosome 1's first SNPs
PRUNE = ("50", "5", "0.2")
NEAR_R2 = 1e-5  # a prune decision on a pair this close to the threshold may differ
HYBRID_TOP = 1000
HYBRID_PARENTS = 20  # build mode: 20 x 20 parents
HYBRID_CROSS = 200  # predict card vs CPU: every cross among the first 200 samples
TOOLS_BUDGET_S = 150.0


@contextlib.contextmanager
def r2_probe(window: int):
    """Wrap ldprune._r2_host: its calls and seconds, and of each chunk the
    band of r² that one prune window can read (0 < j - i < window), as a
    (rows, window - 1) array padded with NaN."""
    from janusx_tpu_torch.models import ldprune

    fn, rec = ldprune._r2_host, {"calls": 0, "s": 0.0, "bands": []}

    def wrapped(packed, mean, pairwise, dev):
        t1 = time.monotonic()
        r2 = fn(packed, mean, pairwise, dev)
        rec["s"] += time.monotonic() - t1
        k = r2.shape[0]
        band = np.full((k, window - 1), np.nan, np.float32)
        for off in range(1, min(window, k)):
            band[:k - off, off - 1] = np.diagonal(r2, off)
        rec["bands"].append(band)
        rec["calls"] += 1
        return r2

    ldprune._r2_host = wrapped
    try:
        yield rec
    finally:
        ldprune._r2_host = fn


def read_codes(prefix: str):
    """(unpacked codes (m, n) with 3 = missing, sites, samples) of a
    genotype file through the port's reader."""
    from janusx_tpu_torch.io import bitcodec
    from janusx_tpu_torch.io.gfreader import load_raw_packed

    raw = load_raw_packed(prefix)
    return bitcodec.unpack_codes(raw.packed, raw.n_samples), raw.sites, raw.samples


def same_sites(a, b) -> bool:
    return all(np.array_equal(np.asarray(getattr(a, f)).astype(str),
                              np.asarray(getattr(b, f)).astype(str))
               for f in ("chrom", "pos", "snp", "allele0", "allele1"))


def read_hybrid(path: str) -> dict:
    _, rows = read_tsv(path)
    return {(r[0], r[1]): float(r[2]) for r in rows}


def run_hybrid(d: str, prefix: str, pheno: str, chr1: str, cli) -> None:
    """``jx hybrid``: predict -top 1000 on the whole panel with its stage
    seconds; predict on the first CROSS_SNPS SNPs on the card and on the CPU
    (every cross among the first HYBRID_CROSS samples, within rtol 1e-4 /
    atol 1e-6); build mode on 20 x 20 parents of chromosome 1 to -fmt plink,
    read back bit-exact against rint((clip(g1) + clip(g2)) / 2)."""
    from janusx_tpu_torch.gs import blup
    from janusx_tpu_torch.io import bitcodec, gfreader, packed
    from janusx_tpu_torch.io.gfreader import load_raw_packed
    from janusx_tpu_torch.io.plink import write_plink
    from janusx_tpu_torch.models import grm

    out = os.path.join(d, "tools")
    targets = {"load_qc": (gfreader, "prepare_packed"), "grm": (grm, "grm_from_packed"),
               "fit_gblup": (blup, "fit_gblup"), "marker_effects": (blup, "marker_effects"),
               "centered": (packed.PackedGenotypes, "centered")}
    with probe(targets) as rec:
        printed, wall = cli(["hybrid", "-bfile", prefix, "-p", pheno, "-top", str(HYBRID_TOP),
                             "-o", out, "-prefix", "hy"], "hybrid predict")
    header, rows = read_tsv(os.path.join(out, "hy.hybrid.tsv"))
    v = np.array([float(r[2]) for r in rows])
    n_all = N_SAMPLES * (N_SAMPLES - 1) // 2
    require(header == "parent1\tparent2\tpredicted" and len(rows) == HYBRID_TOP
            and bool(np.all(np.isfinite(v))) and bool(np.all(np.diff(v) <= 0))
            and f"{HYBRID_TOP}/{n_all} crosses" in printed,
            f"phase 16 hybrid predict: {len(rows)} rows, {printed!r}")
    rest = wall - sum(r["s"] for r in rec.values())
    say(f"phase 16 hybrid predict {N_SAMPLES} parents x {M_SNPS} SNPs, {n_all} crosses, "
        f"top {HYBRID_TOP} in [{v[-1]:.4f}, {v[0]:.4f}]; stages (s): {stages(rec)}, crosses "
        f"+ sort + TSV {rest:.3f}; cli {wall:.2f} s")

    # the first CROSS_SNPS SNPs, card against CPU
    raw = load_raw_packed(prefix)
    head = os.path.join(d, "tools_head")
    write_plink(head, raw.packed[:CROSS_SNPS], raw.n_samples,
                raw.sites.take(np.arange(CROSS_SNPS)), raw.samples)
    crosses = os.path.join(d, "tools_crosses.tsv")
    with open(crosses, "wt") as fh:
        fh.writelines(f"ind{i}\tind{j}\n" for i in range(HYBRID_CROSS)
                      for j in range(i + 1, HYBRID_CROSS))
    got, secs = {}, {}
    platform = os.environ["JX_TPU_PLATFORM"]
    for plat in ("cuda", "cpu"):
        os.environ["JX_TPU_PLATFORM"] = plat
        _, secs[plat] = cli(["hybrid", "-bfile", head, "-p", pheno, "-crosses", crosses,
                             "-top", "0", "-o", out, "-prefix", f"hy_{plat}"],
                            f"hybrid predict head {plat}")
        got[plat] = read_hybrid(os.path.join(out, f"hy_{plat}.hybrid.tsv"))
    os.environ["JX_TPU_PLATFORM"] = platform
    keys = sorted(got["cpu"])
    require(sorted(got["cuda"]) == keys and len(keys) == HYBRID_CROSS * (HYBRID_CROSS - 1) // 2,
            "phase 16 hybrid head: the crosses differ")
    a = np.array([got["cuda"][k] for k in keys])
    b = np.array([got["cpu"][k] for k in keys])
    err = np.abs(a - b)
    require(bool(np.all(err <= 1e-6 + 1e-4 * np.abs(b))),
            f"phase 16 hybrid head card vs cpu: outside rtol 1e-4 / atol 1e-6 "
            f"(max |err| {float(err.max()):.3g})")
    say(f"phase 16 hybrid predict on {CROSS_SNPS} SNPs, {len(keys)} crosses, card vs cpu: "
        f"max |Δ| {float(err.max()):.3g} (printed to 4 decimals; bound rtol 1e-4 / atol 1e-6); "
        f"cli card {secs['cuda']:.2f} s, cpu {secs['cpu']:.2f} s")

    # build mode on chromosome 1
    ids = [f"ind{j}" for j in range(2 * HYBRID_PARENTS)]
    lists = []
    for k in range(2):
        lists.append(os.path.join(d, f"tools_p{k + 1}.txt"))
        with open(lists[-1], "wt") as fh:
            fh.write("\n".join(ids[k * HYBRID_PARENTS:(k + 1) * HYBRID_PARENTS]) + "\n")
    _, wall_b = cli(["hybrid", "-bfile", chr1, "-p1", lists[0], "-p2", lists[1], "-fmt", "plink",
                     "-o", out, "-prefix", "hb"], "hybrid build")
    codes, sites, _ = read_codes(chr1)
    g = np.where(codes == bitcodec.CODE_MISSING, -1.0, codes.astype(np.float32))
    g1, g2 = g[:, :HYBRID_PARENTS], g[:, HYBRID_PARENTS:2 * HYBRID_PARENTS]
    want = np.rint((np.clip(g1, 0, 2)[:, :, None] + np.clip(g2, 0, 2)[:, None, :]) * 0.5)
    miss = (g1 < 0)[:, :, None] | (g2 < 0)[:, None, :]
    want = np.where(miss, bitcodec.CODE_MISSING, want).reshape(len(g), -1).astype(np.uint8)
    hb, hsites, hsamples = read_codes(os.path.join(out, "hb"))
    require(bool(np.array_equal(hb, want)) and same_sites(hsites, sites)
            and list(hsamples[:2]) == ["ind0@ind20", "ind0@ind21"],
            f"phase 16 hybrid build: the hybrids differ from rint((clip(g1) + clip(g2)) / 2) "
            f"in {int((hb != want).sum())} calls")
    say(f"phase 16 hybrid build {HYBRID_PARENTS} x {HYBRID_PARENTS} on chromosome "
        f"{TOOLS_CHROM} ({len(g)} SNPs) to plink: bit-equal to rint((clip(g1) + clip(g2)) / 2), "
        f"{int(miss.sum())} missing calls in place; cli {wall_b:.2f} s")


def run_gformat(d: str, chr1: str, cli) -> None:
    """``jx gformat -prune 50 5 0.2`` on chromosome 1 on the card and on the
    CPU: every in-window pair on the same side of the threshold on both but
    those whose CPU r² lies within NEAR_R2 of it, and with no pair across
    it the kept SNP lists identical. Then chromosome 1's first CONV_SNPS
    SNPs to -fmt vcf and -fmt hmp and back: codes bit-equal to the source's."""
    out = os.path.join(d, "tools")
    thr, window = float(PRUNE[2]), int(PRUNE[0])
    kept, rec, walls = {}, {}, {}
    platform = os.environ["JX_TPU_PLATFORM"]
    for plat in ("cuda", "cpu"):
        os.environ["JX_TPU_PLATFORM"] = plat
        with r2_probe(window) as rec[plat]:
            _, walls[plat] = cli(["gformat", "-bfile", chr1, "-prune", *PRUNE, "-o", out,
                                  "-prefix", f"pr_{plat}"], f"gformat -prune {plat}")
        with open(os.path.join(out, f"pr_{plat}.bim")) as fh:
            kept[plat] = [ln.split("\t")[1] for ln in fh]
    os.environ["JX_TPU_PLATFORM"] = platform
    require(len(rec["cuda"]["bands"]) == len(rec["cpu"]["bands"]) > 0,
            "phase 16 gformat -prune: the card and the cpu read different r² chunks")
    bc, bp = np.concatenate(rec["cuda"]["bands"]), np.concatenate(rec["cpu"]["bands"])
    valid = ~np.isnan(bp)
    near = valid & (np.abs(bp - thr) <= NEAR_R2)
    across = valid & ((bc > thr) != (bp > thr))
    require(not bool((across & ~near).any()),
            f"phase 16 gformat -prune: {int((across & ~near).sum())} in-window pairs on "
            f"opposite sides of r² {thr} on the card and the cpu, beyond {NEAR_R2} of it")
    require(kept["cuda"] == kept["cpu"] or bool(across.any()),
            f"phase 16 gformat -prune: card keeps {len(kept['cuda'])}, cpu "
            f"{len(kept['cpu'])} SNPs, with every pair on the same side of the threshold")
    with open(chr1 + ".bim") as fh:
        m1 = sum(1 for _ in fh)
    dr2 = float(np.nanmax(np.abs(bc - bp)))
    say(f"phase 16 gformat -prune {' '.join(PRUNE)} on chromosome {TOOLS_CHROM} ({m1} SNPs): "
        f"card keeps {len(kept['cuda'])}, cpu {len(kept['cpu'])}, the lists "
        f"{'identical' if kept['cuda'] == kept['cpu'] else 'differ'}; {int(valid.sum())} "
        f"in-window pairs, {int((bp > thr).sum())} above r² {thr}, {int(near.sum())} within "
        f"{NEAR_R2} of it, {int(across.sum())} across it; max |Δr²| card vs cpu {dr2:.3g}; "
        f"r² chunks card {rec['cuda']['calls']} in {rec['cuda']['s']:.3f} s of cli "
        f"{walls['cuda']:.2f} s, cpu {rec['cpu']['calls']} in {rec['cpu']['s']:.3f} s of cli "
        f"{walls['cpu']:.2f} s")

    # chromosome 1's first CONV_SNPS SNPs to VCF and HapMap, and back
    codes, sites, samples = read_codes(chr1)
    last = int(sites.pos[CONV_SNPS - 1])
    conv = []
    for fmt, path in (("vcf", "cv.vcf.gz"), ("hmp", "ch.hmp.txt")):
        _, wall = cli(["gformat", "-bfile", chr1, "-chr", TOOLS_CHROM, "-to-bp", str(last),
                       "-fmt", fmt, "-o", out, "-prefix", path.split(".")[0]], f"gformat {fmt}")
        t1 = time.monotonic()
        back, bsites, bsamples = read_codes(os.path.join(out, path))
        read_s = time.monotonic() - t1
        require(bool(np.array_equal(back, codes[:CONV_SNPS]))
                and same_sites(bsites, sites.take(np.arange(CONV_SNPS)))
                and list(map(str, bsamples)) == list(map(str, samples)),
                f"phase 16 gformat -fmt {fmt}: read back, the codes differ from the source's "
                f"in {int((back != codes[:CONV_SNPS]).sum()) if back.shape == (CONV_SNPS, codes.shape[1]) else 'shape'}")
        conv.append(f"{fmt} written in {wall:.2f} s, read back in {read_s:.2f} s")
    say(f"phase 16 gformat -fmt vcf / hmp of chromosome {TOOLS_CHROM}'s first {CONV_SNPS} SNPs "
        f"x {len(samples)} samples, read back bit-equal: " + "; ".join(conv))


def run_gmerge(d: str, chr1: str, cli) -> None:
    """``jx gmerge`` of chromosome 1's two sample halves: equal to the whole,
    bit for bit (.bed and .bim bytes, the sample IDs)."""
    from janusx_tpu_torch.io import bitcodec
    from janusx_tpu_torch.io.gfreader import load_raw_packed
    from janusx_tpu_torch.io.plink import write_plink

    out = os.path.join(d, "tools")
    raw = load_raw_packed(chr1)
    half = raw.n_samples // 2
    halves = []
    for k, cols in enumerate((np.arange(half), np.arange(half, raw.n_samples))):
        halves.append(os.path.join(out, f"half{k + 1}"))
        write_plink(halves[-1], bitcodec.subset_columns(raw.packed, raw.n_samples, cols),
                    len(cols), raw.sites, raw.samples[cols])
    printed, wall = cli(["gmerge", "-bfile", *halves, "-fmt", "plink", "-o", out, "-prefix",
                         "merged"], "gmerge")
    merged = os.path.join(out, "merged")
    same = {ext: open(merged + ext, "rb").read() == open(chr1 + ext, "rb").read()
            for ext in (".bed", ".bim")}
    ids = lambda pre: [ln.split()[1] for ln in open(pre + ".fam")]
    require(all(same.values()) and ids(merged) == ids(chr1),
            f"phase 16 gmerge: the merged halves differ from the whole ({same})")
    say(f"phase 16 gmerge of chromosome {TOOLS_CHROM}'s halves ({half} + "
        f"{raw.n_samples - half} samples x {raw.m} SNPs): .bed and .bim equal to the whole "
        f"byte for byte; {printed.splitlines()[-1]}; cli {wall:.2f} s")


def run_tools_phase(d: str, prefix: str, pheno: str, grm_npy: str, dev, smi: str) -> tuple:
    """Phase 16: the genotype tools and ``jx ggval`` on phase 5's panel.
    Returns ({"ggval": its launches}, {"ggval": its held launches' errors})."""
    from janusx_tpu_torch import config

    t0 = time.monotonic()
    total, walls = dict(NO_LAUNCHES), {}

    def cli(argv, what):
        printed, wall, launches = run_cli(argv, f"phase 16 {what}")
        for k, v in launches.items():
            total[k] += v
        walls[what] = wall
        return printed, wall

    out = os.path.join(d, "tools")
    printed, _ = cli(["env"], "env")
    require(all(f"\n{k}" in printed for k in config.KNOBS) and "JX_TPU_PLATFORM" in printed,
            "phase 16 jx env: a knob of the port is not listed")
    printed, _ = cli(["sim", "-o", os.path.join(d, "sim")], "sim")
    require(all(os.path.exists(os.path.join(d, "sim", "sim" + ext))
                for ext in (".bed", ".bim", ".fam", ".pheno", ".qtl.tsv")),
            f"phase 16 jx sim: outputs missing ({printed!r})")
    printed, _ = cli(["view", prefix], "view panel")
    require(f"format=bed\tsamples={N_SAMPLES}\tsnps={M_SNPS}" in printed,
            f"phase 16 jx view panel: {printed[:200]!r}")
    printed, _ = cli(["view", grm_npy], "view grm")
    require(printed.startswith(f"npy\t({N_SAMPLES}, {N_SAMPLES})\tfloat64"),
            f"phase 16 jx view grm: {printed[:200]!r}")
    printed, _ = cli(["refcheck", "-bfile", prefix, "-p", pheno], "refcheck")
    require(f"genotype\t{M_SNPS} SNPs x {N_SAMPLES} samples" in printed
            and f"matched={N_SAMPLES}" in printed and f"trait\ttest0\tn={N_PHENO}" in printed
            and "WARNING" not in printed, f"phase 16 jx refcheck: {printed!r}")

    # chromosome 1 of the panel, the source of the one-chromosome tools
    cli(["gformat", "-bfile", prefix, "-chr", TOOLS_CHROM, "-o", out, "-prefix", "chr1"],
        "gformat -chr")
    chr1 = os.path.join(out, "chr1")
    run_gformat(d, chr1, cli)
    run_gmerge(d, chr1, cli)
    run_hybrid(d, prefix, pheno, chr1, cli)
    require(total == NO_LAUNCHES, f"phase 16: a kernel launched outside jx ggval: {total}")

    # jx ggval's card suites at their defaults, the kernels held
    with held() as kept:
        printed, wall, launches = run_cli(["ggval", "gwas", "gs", "gs-vcf", "gs-hmp", "grm-pca",
                                           "-o", os.path.join(d, "ggval")], "phase 16 ggval")
    walls["ggval"] = wall
    checks = [ln for ln in printed.splitlines() if ln.rstrip().endswith(("PASS", "FAIL"))
              or "  FAIL  " in ln]
    tail = printed.splitlines()[-1]
    n_ok, n_all = (int(x) for x in tail.split()[0].split("/"))
    require(checks and all(ln.rstrip().endswith("PASS") for ln in checks)
            and n_ok == n_all == len(checks), f"phase 16 ggval: {tail}; "
            + " | ".join(ln for ln in checks if not ln.rstrip().endswith("PASS")))
    require(launches["decode_rotate"] > 0 and launches["grid_neg_reml_lattice"] > 0
            and launches["gibbs_sweep_marker"] == launches["gibbs_sweep_block_mvn"] == 0,
            f"phase 16 ggval: launches {launches}")
    say(f"phase 16 ggval gwas gs gs-vcf gs-hmp grm-pca: {tail.strip()}; launches {launches}; "
        f"cli {wall:.2f} s")
    errs = hold_launches(kept, "ggval", dev, phase="phase 16")
    require(set(errs) == {"decode_rotate", "grid_neg_reml_lattice"},
            f"phase 16 ggval: held launches of {sorted(errs)}")
    wall = time.monotonic() - t0
    say(f"phase 16 walls ({smi}): " + ", ".join(f"{k}={v:.2f}" for k, v in walls.items())
        + f"; phase {wall:.2f} s of its {TOOLS_BUDGET_S:.0f} s budget")
    say(f"phase 16 done in {wall:.2f} s")
    return {"ggval": launches}, {"ggval": errs}


def check_kernels(dev, join_panel) -> dict:
    """Phases 2-4: build, then each kernel against its plain version. The
    phase 5 panel being written beside the build is waited for before the
    first timed launch (``join_panel``'s result goes into the returned dict
    as "panel")."""
    from janusx_tpu_torch import config
    from janusx_tpu_torch.models.lmm import lattice_superblock
    from janusx_tpu_torch.ops import kernels

    so, build_s = kernels.build()
    say(f"phase 2 build: {build_s:.2f} s -> {os.path.relpath(so, ROOT)}; "
        + ptxas_summary(so.with_suffix(".log").read_text()))
    panel = join_panel()

    # the main path launches each kernel once per resident superblock of
    # SNPs; the 2048-row block is the reference's per-block launch shape
    rows = lattice_superblock(N_PHENO, GRID, config.DEFAULT_SNP_BLOCK)
    basis, ys, rng = _basis(N_PHENO, seed=1, traits=4)
    basis_r, ys_r, rng_r = _basis(997, seed=2, traits=3)
    # -lowrank rotates by its k-column kinship basis: orthonormal columns
    U_lr = np.linalg.qr(np.random.default_rng(15).normal(size=(N_PHENO, LOWRANK_Q)))[0]
    k1 = [check_k1(dev, rows, N_PHENO, basis.U, seed=11, timed=True),
          check_k1(dev, rows, N_PHENO, U_lr, seed=15, timed=True),
          check_k1(dev, 2048, N_PHENO, basis.U, seed=12, timed=True),
          check_k1(dev, 1000, 997, basis_r.U, seed=13, timed=False),
          check_k1(dev, 2048, N_PHENO, rng.normal(size=(N_PHENO, N_PHENO)) / N_PHENO ** 0.5,
                   seed=14, timed=False, random_u=True)]
    k2 = [check_k2(dev, basis, ys[:1], rng, rows, GRID, 1, seed=21, timed=True),
          check_k2(dev, basis, ys[:1], rng, 2048, GRID, 1, seed=22, timed=True),
          check_k2(dev, basis, ys[:1], rng, 2048, GRID, 3, seed=23, timed=False)]
    k2.append(check_k2(dev, basis_r, ys_r[:1], rng_r, 1000, 200, 2, seed=24, timed=False))
    # the trait axis: T = 4 at the single-trait superblock's launch shape
    # (the T = 4 scan's own superblocks are smaller), and ragged T = 3
    k2t = [check_k2(dev, basis, ys, rng, rows, GRID, 1, seed=25, timed=True),
           check_k2(dev, basis_r, ys_r, rng_r, 1000, 200, 2, seed=26, timed=False)]
    null_fit = check_null_fit(dev)
    k1_err = {m: max(r[m][0] for r in k1) for m in ("highest", "high")}
    k2_err = {m: max(r[m][0] for r in k2 + k2t) for m in kernels.GRID_PRECS}
    # the least time the card could take: bf16 tensor-core passes at 989
    # TFLOP/s (six per product in "highest", K1's "high" three, K2's
    # "default" one), or each operand read and each output written once at
    # 3.35 TB/s, whichever is longer
    n, R = N_PHENO, 2 * 1 + 2 * 1 + 3
    k1_bytes = lambda N: rows * (-(-n // 4) + 4 + 4 * N) + 4 * n * N
    k2_bytes = lambda T: 4 * (rows * n + GRID * n + (T + 1) * n + T * R * GRID + T * rows * GRID)
    k2_flops = lambda T, passes: 2.0 * (2 + T) * rows * GRID * n * passes
    return dict(panel=panel, null_fit=null_fit,
                k1_err=k1_err["highest"], k1_ms=k1[0]["highest"][1],
                k1_plain=k1[0]["highest"][2], k1_lib=k1[0]["library"],
                k1_bound=bound(2.0 * rows * n * n * 6, k1_bytes(n)),
                k1_lr_err=k1[1]["highest"][0], k1_lr_ms=k1[1]["highest"][1],
                k1_lr_plain=k1[1]["highest"][2], k1_lr_lib=k1[1]["library"],
                k1_lr_bound=bound(2.0 * rows * n * LOWRANK_Q * 6, k1_bytes(LOWRANK_Q)),
                k1_high_err=k1_err["high"], k1_high_ms=k1[0]["high"][1],
                k1_high_plain=k1[0]["high"][2],
                k1_high_bound=bound(2.0 * rows * n * n * 3, k1_bytes(n)),
                k2_err=k2_err["highest"], k2=k2[0], k2t=k2t[0],
                k2_default_err=k2_err["default"],
                k2_bound={(T, m): bound(k2_flops(T, 6 if m == "highest" else 1), k2_bytes(T))
                          for T in (1, 4) for m in kernels.GRID_PRECS})


NULL_FIT_N = 5000  # the dense cells' phenotyped samples (jxbench-5k-500k)


def check_null_fit(dev) -> dict:
    """Phase 4's end: N1 ``null_reml_brent`` (csrc/nullfit.cu) at the dense
    cells' shape, n = 5,000 and p = 1, with 1 and 4 lanes (a single-trait
    step and a four-trait step), against its plain version lane by lane
    (core/reml.fit_null_reml_plain: the torch Brent): log10 λ within 1e-6
    (NULL_BRENT_TOL: -REML is flat to its f64 rounding over ~1e-6 of log10 λ
    near its optimum, so two sum orders stop the Brent apart), -REML within
    rel 1e-10 of the plain optimum and ML within rel 1e-10 of the plain ML at
    the kernel's λ (the f64 sums in another order). Times
    both by CUDA events over 20 calls (the plain version syncs the host once
    an iteration). The bound: every operand read once at 3.35 TB/s; the
    chain: the Brent's evaluations, each a block reduction that waits on
    the one before (counted on the plain version, whose last evaluation,
    on a converged lane, is discarded)."""
    import torch

    from janusx_tpu_torch import config
    from janusx_tpu_torch.core import reml
    from janusx_tpu_torch.ops import kernels
    from janusx_tpu_torch.ops.brent import brent_minimize_batched

    n, out = NULL_FIT_N, {}
    rng = np.random.default_rng(31)
    # a GRM-like spectrum, the rotated intercept, traits of h² 0.2-0.8
    s = np.sort(rng.gamma(0.6, 1.7, n))[::-1].copy() + 1e-3
    x = 1.0 + 0.1 * rng.normal(size=n)
    t64 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=dev)
    rots = []
    for h2 in (0.25, 0.4, 0.55, 0.7):
        yr = rng.normal(size=n) * np.sqrt(h2 * s + 1.0 - h2)
        rots.append(reml.RotatedData(s=t64(s), Xr=t64(x[:, None]), yr=t64(yr),
                                     PXX=t64(x[:, None] ** 2), PXy=t64((x * yr)[:, None]),
                                     Pyy=t64(yr * yr)))
    calls = [0]

    def counted(t, rot=rots[0]):
        calls[0] += 1
        return reml.neg_reml_null(t, rot)

    brent_minimize_batched(counted, config.LOG10_LAMBDA_LOW, config.LOG10_LAMBDA_HIGH,
                           config.NULL_BRENT_TOL, config.NULL_BRENT_MAX_ITER, batch_shape=(1,),
                           device=dev)
    for T in (1, 4):
        lanes = rots[:T]
        dx, rel = null_fit_gap(reml.fit_null_reml_multi(lanes), lanes, f"phase 4 T={T}")
        PXy = torch.stack([r.PXy for r in lanes])
        Pyy = torch.stack([r.Pyy for r in lanes])
        ms = cuda_ms(lambda: kernels.null_reml_brent(rots[0].s, rots[0].PXX, PXy, Pyy))
        plain = cuda_ms(lambda: [reml.fit_null_reml_plain(r) for r in lanes], warmup=1)
        nbytes = 8 * (n + n + T * n + T * n) + 8 * 3 * T
        out[T] = dict(ms=ms, plain_ms=plain, bound=bound(0.0, nbytes), dx=dx, rel=rel)
        say(f"phase 4 N1 null_reml_brent n={n} p=1 T={T}: ok, max |Δ log10 λ| {dx:.3g}, "
            f"rel -REML/ML {rel:.3g}; kernel {ms:.4f} ms, plain (torch Brent, lane by lane) "
            f"{plain:.4f} ms, bound {out[T]['bound'][0]:.6f} ms ({out[T]['bound'][1]}); "
            f"the chain: {calls[0] - 1} dependent evaluations, "
            f"{1e3 * ms / (calls[0] - 1):.2f} us each")
    out["evaluations"] = calls[0] - 1
    return out


def null_fit_gap(got, rots, what: str, args=()) -> tuple[float, float]:
    """The null fit's kernel, fits ``got`` of the states ``rots``, against
    its plain version (core/reml.fit_null_reml_plain, with ``args``) on the
    same states, as check_null_fit holds it: log10 λ within 1e-6, -REML
    within rel 1e-10 of the plain optimum and ML within rel 1e-10 of the
    plain ML at the kernel's λ. Returns (max |Δ log10 λ|, max rel)."""
    import torch

    from janusx_tpu_torch.core import reml

    want = [reml.fit_null_reml_plain(r, *args) for r in rots]
    dx = max(abs(g.log10_lbd - w.log10_lbd) for g, w in zip(got, want))
    rel = 0.0
    for g, w, r in zip(got, want, rots):
        # ML is not flat at the REML optimum: compared at the kernel's λ
        lg = torch.tensor([g.log10_lbd], dtype=torch.float64, device=r.s.device)
        ml = float(reml.ml_null(lg, r)[0])
        rel = max(rel, abs(g.reml - w.reml) / abs(w.reml), abs(g.ml - ml) / abs(ml))
    require(dx <= 1e-6 and rel <= 1e-10,
            f"{what} N1 null_reml_brent: |Δ log10 λ| {dx:.3g} (bound 1e-6), "
            f"rel -REML/ML {rel:.3g} (bound 1e-10)")
    return dx, rel


@contextlib.contextmanager
def held_null_fits():
    """core/reml's launch of the null fit's kernel wrapped while the block
    runs; yields the list of (states, their fits, the Brent's arguments) of
    its first launch with one lane and its first with more."""
    from janusx_tpu_torch.core import reml

    kept, fn = [], reml._fit_null_card

    def keep(rots, *args):
        fits = fn(rots, *args)
        if all((len(k[0]) > 1) != (len(rots) > 1) for k in kept):
            kept.append((list(rots), fits, args))
        return fits

    reml._fit_null_card = keep
    try:
        yield kept
    finally:
        reml._fit_null_card = fn


def hold_null_fits(kept: list, phase: str) -> None:
    """Each launch held_null_fits() kept against the plain version on the
    path's own rotated states (null_fit_gap); prints a line per launch."""
    require(bool(kept), f"{phase}: no launch of null_reml_brent was kept")
    for rots, fits, args in kept:
        dx, rel = null_fit_gap(fits, rots, phase, args)
        say(f"{phase} N1 null_reml_brent vs plain on the path's own states, T={len(rots)} "
            f"n={rots[0].n} p={rots[0].p}: max |Δ log10 λ| {dx:.3g}, rel -REML/ML {rel:.3g}")


F32_PEAK = 67e12  # the H100's f32 rate outside the tensor cores


def bound(flops: float, nbytes: float, peak: float = 989e12) -> tuple:
    """(milliseconds, "operations" or "bytes"): the larger of flops at
    ``peak`` (by default the H100's bf16 tensor-core rate) and bytes at its
    memory rate."""
    ops_ms, mem_ms = flops / peak * 1e3, nbytes / 3.35e12 * 1e3
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


def rescan_default(rows5, cpu, dev) -> float:
    """Phase 5's trait rescanned on the card through ``lmm_scan`` (no CLI,
    no QC) on the same packed panel and basis, once in "highest" and then
    with JX_TPU_GRID_MXU_PREC=default, the reference's one-pass lattice:
    held to phase 5's TSV within Δ(-log10 p) 0.05 with the same top 5.
    Returns the observed maximum."""
    import torch

    from janusx_tpu_torch.models.lmm import lmm_scan
    from janusx_tpu_torch.ops import kernels

    walls, res = {}, {}
    for prec in ("highest", "default", "highest"):
        os.environ["JX_TPU_GRID_MXU_PREC"] = prec
        kernels.reset_launches()
        t0 = time.monotonic()
        res[prec], _ = lmm_scan(cpu["pg"], cpu["basis"], cpu["y"], device=dev)
        torch.cuda.synchronize()
        walls[prec] = time.monotonic() - t0  # the second "highest" scan is warm
        require(scan_launches()["grid_neg_reml_lattice"] > 0, f"{prec} rescan: K2 never launched")
    os.environ.pop("JX_TPU_GRID_MXU_PREC")
    require(list(res["default"].sites.snp) == [r[2] for r in rows5],
            "default rescan: SNP rows differ from phase 5's TSV")
    tsv = [float(r[10]) for r in rows5]
    d_hi = agree(res["highest"].pwald, tsv, "phase 5 highest rescan", 5e-3)
    dmax = agree(res["default"].pwald, tsv, "phase 5 default rescan", 0.05)
    say(f"phase 5 default rescan: {len(rows5)} SNPs through lmm_scan with "
        f"JX_TPU_GRID_MXU_PREC=default against phase 5's TSV: max Δ(-log10 p)={dmax:.3g} "
        f"(the reference measured 0.016 on the mouse data), top-5 equal; highest "
        f"rescan {d_hi:.3g}; scan wall highest {walls['highest']:.3f} s, default "
        f"{walls['default']:.3f} s")
    return dmax


# ------------------------------------------------------------ phase 17
KMER_K = 31
KMER_SAMPLES = 300
KMER_GENOME = 500_000  # bases of the simulated reference
KMER_SITES = 6_000  # biallelic sites, each >= KMER_SPACING bases from the next
KMER_SPACING = 64  # so that no 31-mer spans two sites
KMER_FREQ = "0.05"  # jx kmerge -freq: presence rate in [0.05, 0.95]
KMER_CAUSAL, KMER_H_CAUSAL, KMER_H_POLY = 5, 0.16, 0.10
KMER_COUNTED = 3  # samples whose jx kmer table is held to a plain count
BASELINE_SNPS = 2_048
KMER_BUDGET_S = 150.0
BASES = np.frombuffer(b"ACGT", np.uint8)


def native_builds() -> list:
    """Start the g++ builds of the host libraries that phase 17 runs (the
    k-mer counter and the CPU baseline scan), with the copies' own flags;
    check_native() waits for them and raises on a failed build."""
    src = lambda name: os.path.join(ROOT, "native", name)
    cc = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]
    cmds = {"jxkmer": cc + ["-pthread", src("jxkmer.cpp"), "-o", src("libjxkmer.so")],
            "jxbaseline": cc + [src("jxbaseline.cpp"), "-o", src("libjxbaseline.so"),
                                "-lpthread"]}
    return [(name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for name, cmd in cmds.items()]


def check_native(procs) -> None:
    for name, proc in procs:
        out, _ = proc.communicate(timeout=300)
        require(proc.returncode == 0, f"phase 17: g++ build of native/{name}.cpp failed: {out}")
    from janusx_tpu_torch.models import kmer
    from janusx_tpu_torch.utils import baseline_cpu

    require(kmer.available() and baseline_cpu.available(),
            "phase 17: a native library did not load after its build")


def simulate_genomes(d: str, n: int, length: int, sites: int, seed: int,
                     spacing: int = KMER_SPACING):
    """A random reference of ``length`` bases with ``sites`` biallelic sites
    at least ``spacing`` bases apart, alt frequency ~ U[0.05, 0.5]; one
    haploid FASTA per sample, ``g<j>.fa``. Returns (the FASTA paths, the
    reference as 0-3 codes, the site positions, the alt bases, the (sites,
    n) 0/1 genotypes)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, length).astype(np.uint8)
    gaps = rng.integers(spacing, (length - 200) // sites, sites)
    pos = 100 + np.cumsum(gaps) - gaps[0]
    require(pos[-1] < length - 100, "phase 17: the sites do not fit the genome")
    alt = ((ref[pos] + rng.integers(1, 4, sites)) % 4).astype(np.uint8)
    geno = (rng.random((sites, n)) < rng.uniform(0.05, 0.5, sites)[:, None]).astype(np.uint8)
    paths = []
    for j in range(n):
        s = ref.copy()
        s[pos] = np.where(geno[:, j] == 1, alt, ref[pos])
        body = BASES[s].tobytes()
        paths.append(os.path.join(d, f"g{j}.fa"))
        with open(paths[-1], "wb") as fh:
            fh.write(b">chr1\n" + b"\n".join(body[i:i + 80] for i in range(0, length, 80))
                     + b"\n")
    return paths, ref, pos, alt, geno


def canonical_codes(seq: np.ndarray, k: int) -> np.ndarray:
    """Canonical 2-bit codes (A=0 C=1 G=2 T=3, the first base highest) of
    every k-mer along the last axis of a 0-3 base array: the smaller of the
    k-mer's and its reverse complement's (the counter's, models/kmer.py
    decode_kmer)."""
    w = seq.shape[-1] - k + 1
    fwd = np.zeros(seq.shape[:-1] + (w,), np.uint64)
    rev = np.zeros_like(fwd)
    for i in range(k):
        fwd = (fwd << np.uint64(2)) | seq[..., i:i + w].astype(np.uint64)
        rev = (rev << np.uint64(2)) | (3 - seq[..., k - 1 - i:k - 1 - i + w]).astype(np.uint64)
    return np.minimum(fwd, rev)


def kmer_codes(strings, k: int) -> np.ndarray:
    """2-bit codes of k-mer strings (jx kmerge's SNP IDs)."""
    lut = np.zeros(256, np.uint64)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint64)
    b = lut[np.frombuffer("".join(strings).encode(), np.uint8).reshape(-1, k)]
    out = np.zeros(len(b), np.uint64)
    for i in range(k):
        out = (out << np.uint64(2)) | b[:, i]
    return out


def site_kmer_codes(ref, pos, alt, k: int):
    """For each site, the canonical codes of the k windows that span it,
    with the ref base and with the alt base: two (sites, k) arrays."""
    win = ref[pos[:, None] + np.arange(-k + 1, k)[None, :]]  # (sites, 2k - 1)
    out = []
    for base in (ref[pos], alt):
        w = win.copy()
        w[:, k - 1] = base
        out.append(canonical_codes(w, k))
    return out


def kmer_rows(codes: np.ndarray, row_codes: np.ndarray) -> np.ndarray:
    """The row of each code among ``row_codes`` (-1 where absent)."""
    order = np.argsort(row_codes)
    i = np.clip(np.searchsorted(row_codes[order], codes), 0, len(order) - 1)
    return np.where(row_codes[order][i] == codes, order[i], -1)


def write_kmer_trait(path: str, geno, seed: int):
    """KMER_CAUSAL sites at KMER_H_CAUSAL of the variance each, a polygenic
    background of KMER_H_POLY over the other sites, the rest noise.
    Returns the causal sites."""
    rng = np.random.default_rng(seed)
    z = (geno - geno.mean(1, keepdims=True)) / np.maximum(geno.std(1, keepdims=True), 1e-9)
    q = np.sort(rng.choice(len(geno), KMER_CAUSAL, replace=False))
    rest = np.setdiff1d(np.arange(len(geno)), q)
    poly = z[rest].T @ rng.normal(size=len(rest))
    y = (np.sqrt(KMER_H_CAUSAL) * z[q].sum(0) + np.sqrt(KMER_H_POLY) * poly / poly.std()
         + np.sqrt(1 - KMER_CAUSAL * KMER_H_CAUSAL - KMER_H_POLY)
         * rng.normal(size=geno.shape[1]))
    with open(path, "w") as fh:
        fh.write("ID\ttrait\n" + "".join(f"g{j}\t{v:.6f}\n" for j, v in enumerate(y)))
    return q


def check_kmer_counts(kdir: str, ref, pos, alt, geno, k: int, samples: int) -> int:
    """Each of the first ``samples`` jx kmer tables equals a plain numpy
    count of its genome's canonical k-mers; returns the k-mers compared."""
    from janusx_tpu_torch.models.kmer import load_kmer_db

    total = 0
    for j in range(samples):
        s = ref.copy()
        s[pos] = np.where(geno[:, j] == 1, alt, ref[pos])
        want, cnt = np.unique(canonical_codes(s, k), return_counts=True)
        codes, counts, kk = load_kmer_db(os.path.join(kdir, f"kmer.g{j}.k{k}.jxkdb"))
        require(kk == k and np.array_equal(np.asarray(codes), want)
                and np.array_equal(np.asarray(counts), cnt),
                f"phase 17: jx kmer's table of g{j} differs from a plain count")
        total += len(want)
    return total


def check_presence(prefix: str, ref, pos, alt, geno, k: int):
    """jx kmerge's presence matrix against the planted genotypes at every
    k-mer that spans one site: present exactly in the samples that carry
    the k-mer's allele. Returns (the k-mer codes of the matrix rows, the
    (m, n) presence, the (sites, 2k) row of each spanning k-mer or -1, the
    k-mers compared)."""
    from janusx_tpu_torch.io import bin01

    with open(prefix + ".bim") as fh:
        snp = [ln.split("\t")[1] for ln in fh]
    codes = kmer_codes(snp, k)
    P = bin01.read_bin01(prefix + ".bin").dense() > 0
    require(P.shape == (len(snp), geno.shape[1]), f"phase 17: presence matrix {P.shape}")
    refk, altk = site_kmer_codes(ref, pos, alt, k)
    rows = kmer_rows(np.concatenate([refk, altk], 1).reshape(-1), codes).reshape(len(pos), -1)
    carrier = np.concatenate([np.repeat((geno == 0)[:, None], k, 1),
                              np.repeat((geno == 1)[:, None], k, 1)], 1)  # (sites, 2k, n)
    hit = rows >= 0
    bad = int((P[rows[hit]] != carrier[hit]).any(1).sum())
    require(bad == 0, f"phase 17: {bad} spanning k-mers' presence differs from the genotypes")
    return codes, P, rows, int(hit.sum())


def pattern_groups(P: np.ndarray) -> np.ndarray:
    """A group id per row of a (m, n) presence matrix: rows of the same or
    the complementary pattern (a site's ref and alt k-mers) share one,
    since they carry one test."""
    return np.unique(P ^ P[:, :1], axis=0, return_inverse=True)[1].reshape(-1)


def agree_groups(card_p, cpu_p, groups, what: str, bound: float) -> float:
    """max Δ(-log10 p) <= bound and the same top 5 tests, each group of
    tied k-mers one test; returns the max."""
    lp_card, lp_cpu = -np.log10(np.asarray(card_p)), -np.log10(np.asarray(cpu_p))
    require(bool(np.all(np.isfinite(lp_card))), f"{what}: non-finite p-values")
    dmax = float(np.max(np.abs(lp_card - lp_cpu)))
    require(dmax <= bound, f"{what}: max Δ(-log10 p) {dmax:.4g} > {bound}")

    def top(lp):
        best = np.full(groups.max() + 1, -np.inf)
        np.maximum.at(best, groups, lp)
        return set(np.argsort(-best, kind="stable")[:5])

    require(top(lp_card) == top(lp_cpu), f"{what}: top-5 tests differ")
    return dmax


def run_webui_job(d: str, prefix: str, pheno: str, rows, smi: str) -> float:
    """``jx gwas -lmm -force-model`` on the k-mer panel as a web UI job:
    its child runs the port's dispatcher on the card; its TSV holds
    ``rows``' SNPs within Δ(-log10 p) 5e-3. Returns the job's wall."""
    import urllib.parse
    import urllib.request

    from janusx_tpu_torch.ui.server import serve

    work = os.path.join(d, "ui")
    os.makedirs(work)
    srv, state = serve(work, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        args = f"-bfile {prefix} -p {pheno} -lmm -force-model -o {work}/out"
        body = urllib.parse.urlencode({"module": "gwas", "args": args, "csrf": state.csrf})
        with urllib.request.urlopen(urllib.request.Request(base + "/submit", data=body.encode(),
                                                           method="POST"), timeout=30) as r:
            require(r.status == 200, f"phase 17 web UI submit: HTTP {r.status}")
        t0 = time.monotonic()
        while True:
            with urllib.request.urlopen(base + "/api/jobs", timeout=30) as r:
                jobs = json.loads(r.read().decode())
            if jobs and jobs[0]["status"] != "running":
                break
            require(time.monotonic() - t0 < 300, "phase 17 web UI job still running after 300 s")
            time.sleep(0.5)
    finally:
        srv.shutdown()
        for job in state.jobs.values():  # a job past its time is stopped
            job.cancel()
    job = state.jobs[jobs[0]["id"]]
    require(jobs[0]["status"] == "ok", f"phase 17 web UI job {jobs[0]}: {job.log_tail()[-2000:]}")
    require(job.proc.args[1:3] == ["-m", "janusx_tpu_torch.cli.main"],
            f"phase 17 web UI job ran {job.proc.args}")
    header, got = read_tsv(os.path.join(work, "out", "jx.trait.LMM.assoc.tsv"))
    require(header == HEADER and [r[2] for r in got] == [r[2] for r in rows],
            "phase 17 web UI job: its TSV's rows differ from the in-process run's")
    lp = lambda rr: -np.log10(np.array([float(r[10]) for r in rr]))
    dmax = float(np.max(np.abs(lp(got) - lp(rows))))
    require(dmax <= 5e-3, f"phase 17 web UI job vs in process: max Δ(-log10 p) {dmax:.3g}")
    wall = job.finished - job.started
    say(f"phase 17 web UI job ({smi}): gwas -lmm through ui.server's child "
        f"({' '.join(job.proc.args[1:4])}), status ok, {len(got)} rows, max Δ(-log10 p) vs the "
        f"in-process run {dmax:.3g}; job wall {wall:.2f} s")
    return wall


def run_baseline(cpu, dev, smi: str) -> None:
    """The native CPU baseline (utils/baseline_cpu.py, the reference's
    vs_baseline denominator) against the port's brent scan on the card
    over phase 5's first BASELINE_SNPS QC'd SNPs, basis and trait, under
    tests/test_baseline_cpu.py's bounds: beta/se rtol 2e-2 and Δ(-log10 p)
    < 5e-2. Both are Brent chains that stop within SCAN_BRENT_TOL in log10
    λ, and where a beta is ~1 % of its se that stopping point alone moves
    it by more than 2 % of itself; so the two λ* are held within twice the
    tolerance, and beta/se against the port's f64 epilogue at the
    baseline's own λ*. Prints both SNPs/s."""
    import torch

    from janusx_tpu_torch import config
    from janusx_tpu_torch.core import stats
    from janusx_tpu_torch.core.reml import beta_se_snp_batch, make_rotated
    from janusx_tpu_torch.models.lmm import lmm_scan
    from janusx_tpu_torch.utils import baseline_cpu

    head = cpu["head"].take_snps(np.arange(BASELINE_SNPS))
    Gc = head.centered()
    threads = os.cpu_count() or 1
    t0 = time.monotonic()
    lg, beta, se = baseline_cpu.baseline_scan(cpu["basis"], cpu["y"], Gc, n_threads=threads)
    host_s = time.monotonic() - t0
    walls = []
    for _ in range(2):  # the second scan is warm; lmm2 adds each SNP's λ*
        t0 = time.monotonic()
        res, _ = lmm_scan(head, cpu["basis"], cpu["y"], method="brent", lmm2=True, device=dev)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    require(bool(np.isfinite(beta).all() and np.isfinite(se).all()), "baseline: non-finite")
    dlg = float(np.max(np.abs(lg - np.log10(res.lbd))))
    require(dlg <= 2 * config.SCAN_BRENT_TOL,
            f"phase 17 baseline: λ* {dlg:.3g} from the card's in log10, beyond twice the Brent "
            f"tolerance {config.SCAN_BRENT_TOL}")
    f64 = torch.float64
    rot = make_rotated(cpu["basis"], cpu["y"], None, device=dev)
    Gr = torch.as_tensor(Gc, dtype=f64, device=dev) @ torch.as_tensor(cpu["basis"].U, dtype=f64,
                                                                       device=dev)
    at = [x.cpu().numpy() for x in beta_se_snp_batch(torch.as_tensor(lg, dtype=f64, device=dev),
                                                      rot, Gr)]
    for what, a, b in (("beta", beta, at[0]), ("se", se, at[1])):
        bad = np.abs(a - b) > 1e-8 + 2e-2 * np.abs(b)
        require(not bad.any(), f"phase 17 baseline {what}: {int(bad.sum())} SNPs outside rtol "
                f"2e-2 of the port's f64 epilogue at the baseline's λ*")
    rel = max(float(np.max(np.abs(a - b) / np.abs(b))) for a, b in ((beta, at[0]), (se, at[1])))
    moved = int((np.abs(beta - res.beta) > 1e-8 + 2e-2 * np.abs(res.beta)).sum())
    dlp = float(np.nanmax(np.abs(np.log10(stats.pwald_from_beta_se(beta, se))
                                 - np.log10(res.pwald))))
    require(dlp < 5e-2, f"phase 17 baseline vs card brent: max Δ(-log10 p) {dlp:.3g}")
    say(f"phase 17 baseline ({smi}): native CPU scan of {BASELINE_SNPS} SNPs x n="
        f"{cpu['basis'].n} on {threads} host threads {host_s:.3f} s = "
        f"{BASELINE_SNPS / host_s:.0f} SNPs/s (rotation included); the card's brent scan "
        f"{walls[1]:.3f} s warm ({walls[0]:.3f} s cold) = {BASELINE_SNPS / walls[1]:.0f} SNPs/s; "
        f"λ* within {dlg:.3g} in log10, beta/se at the baseline's λ* within rel {rel:.3g}, "
        f"{moved} betas beyond rtol 2e-2 of the card's at its own λ*, max Δ(-log10 p) {dlp:.3g}")


class KmerPipeline:
    """Phase 17's host pipeline, started beside the kernels' build, whose
    nvcc processes and panel writer leave most of the host's cores idle:
    the native builds checked, the genomes and the trait written, then
    ``jx kmer``, ``jx kmerge`` and ``jx kstats`` each in a child process of
    the port's dispatcher (they run no kernel). join() returns what phase
    17 needs; stop() ends a child still running when the smoke fails
    first."""

    def __init__(self, d: str, natives):
        self.kd, self.natives = os.path.join(d, "kmer"), natives
        self.out, self.proc, self.stopped = {}, None, False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _cli(self, name: str, argv) -> None:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            x for x in (ROOT, os.environ.get("PYTHONPATH")) if x))
        t0 = time.monotonic()
        self.proc = subprocess.Popen([sys.executable, "-m", "janusx_tpu_torch.cli.main", *argv],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                     cwd=self.kd, env=env)
        stdout, stderr = self.proc.communicate()
        require(self.proc.returncode == 0 and not self.stopped,
                f"phase 17 {name}: rc {self.proc.returncode}: {stderr[-2000:]}")
        self.out[name] = (stdout.strip(), time.monotonic() - t0)

    def _run(self) -> None:
        try:
            check_native(self.natives)
            os.makedirs(self.kd)
            t0 = time.monotonic()
            paths, *self.out["panel"] = simulate_genomes(self.kd, KMER_SAMPLES, KMER_GENOME,
                                                         KMER_SITES, seed=20261018)
            self.out["pheno"] = os.path.join(self.kd, "trait.pheno")
            self.out["causal"] = write_kmer_trait(self.out["pheno"], self.out["panel"][3],
                                                  seed=20261019)
            self.out["write"] = time.monotonic() - t0
            self._cli("kmer", ["kmer", "-i", *paths, "-k", str(KMER_K), "-min-count", "1",
                               "-stream-db", "-t", str(os.cpu_count() or 1), "-o", "k"])
            dbs = [os.path.join("k", f"kmer.g{j}.k{KMER_K}.jxkdb") for j in range(KMER_SAMPLES)]
            self._cli("kmerge", ["kmerge", "-i", *dbs, "-freq", KMER_FREQ, "-o", "m"])
            self._cli("kstats", ["kstats", "-kbin", os.path.join("m", "kmerged"), "-o", "s"])
        except BaseException as e:  # raised again by join()
            self.out["error"] = e

    def join(self) -> dict:
        self.thread.join()
        if "error" in self.out:
            raise self.out["error"]
        return self.out

    def stop(self) -> None:
        self.stopped = True
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
        self.thread.join()


def run_kmer_phase(pipeline: KmerPipeline, cpu, dev, smi: str) -> tuple:
    """Phase 17: k-mer GWAS at full width, a web UI job and the native CPU
    baseline. Returns ({"kmer": the gwas run's launches}, {"kmer": its
    held launches' errors})."""
    from janusx_tpu_torch import config
    from janusx_tpu_torch.core.spectral import eigh_grm
    from janusx_tpu_torch.io.gfreader import load_raw_packed
    from janusx_tpu_torch.io.packed import QcParams
    from janusx_tpu_torch.io.pheno import load_phenotype
    from janusx_tpu_torch.models.lmm import lattice_superblock, lmm_scan
    from janusx_tpu_torch.models.scan_common import analysis_sample_index
    from janusx_tpu_torch.utils.cache import load_or_build_grm

    t0 = time.monotonic()
    got = pipeline.join()
    kd, pheno, causal = pipeline.kd, got["pheno"], got["causal"]
    ref, pos, alt, geno = got["panel"]
    walls = {"wait": time.monotonic() - t0}
    say(f"phase 17 panel: {KMER_SAMPLES} haploid genomes of {KMER_GENOME} bases with "
        f"{KMER_SITES} sites written in {got['write']:.2f} s; trait: {KMER_CAUSAL} sites at "
        f"{KMER_H_CAUSAL:.0%} each, {KMER_H_POLY:.0%} polygenic")
    for name in ("kmer", "kmerge", "kstats"):
        printed, wall = got[name]
        lines = printed.splitlines()
        shown = lines[:3] + ([f"... {len(lines) - 3} more lines"] if len(lines) > 3 else [])
        say(f"phase 17 {name} cli (a child process, beside phases 2-16): wall={wall:.2f} s :: "
            + " | ".join(shown))
    require(len(got["kstats"][0].splitlines()) == KMER_SAMPLES + 1,
            "phase 17 kstats: not a row per sample")
    n_counted = check_kmer_counts(os.path.join(kd, "k"), ref, pos, alt, geno, KMER_K,
                                  KMER_COUNTED)
    prefix = os.path.join(kd, "m", "kmerged")
    codes, P, site_rows, n_spanning = check_presence(prefix, ref, pos, alt, geno, KMER_K)
    say(f"phase 17 k-mers: {len(codes)} segregating 31-mers; the tables of {KMER_COUNTED} "
        f"samples ({n_counted} k-mers) equal a plain count; the presence of all {n_spanning} "
        f"k-mers that span a site equals the planted genotypes")

    out = os.path.join(kd, "g")
    with held() as kept:
        printed, walls["gwas"], launches = run_cli(
            ["gwas", "-bfile", prefix, "-p", pheno, "-lmm", "-force-model", "-o", out],
            "phase 17 gwas")
    header, rows = read_tsv(os.path.join(out, "jx.trait.LMM.assoc.tsv"))
    with open(os.path.join(out, "jx.gwas.summary.json")) as fh:
        summary = json.load(fh)
    require(header == HEADER and len(rows) > 0.9 * len(codes), f"phase 17 TSV: {len(rows)} rows")
    require(all(r[0] == "K" and r[3:5] == ["absent", "present"] for r in rows),
            "phase 17 TSV: not the k-mer panel's chromosome and alleles")
    sb = lattice_superblock(KMER_SAMPLES, GRID, config.DEFAULT_SNP_BLOCK)
    n_sb = -(-len(rows) // sb)
    require(launches["decode_rotate"] == launches["grid_neg_reml_lattice"] == n_sb
            and launches["gibbs_sweep_marker"] == launches["gibbs_sweep_block_mvn"] == 0,
            f"phase 17 launches {launches}: K1 and K2 once per resident superblock of {sb} "
            f"rows ({n_sb})")
    errs = hold_launches(kept, "kmer", dev, phase="phase 17")
    require(set(errs) == {"decode_rotate", "grid_neg_reml_lattice"},
            f"phase 17: held launches of {sorted(errs)}")
    say(f"phase 17 gwas stages (s): {stage_line(summary)}; {len(rows)} k-mers x n={KMER_SAMPLES}, "
        f"launches {launches} ({n_sb} superblock(s) of up to {sb} rows)")

    # the CPU rescan of the first CROSS_SNPS k-mers with the same basis
    t1 = time.monotonic()
    raw = load_raw_packed(prefix)
    y_all, _ = load_phenotype(pheno).select(["0"]).align(raw.samples)
    keep = analysis_sample_index(y_all[:, 0])
    qc = QcParams()
    K = load_or_build_grm(prefix, raw.prepare(qc), qc.maf, qc.geno)
    pg = raw.prepare(qc, sample_idx=keep)
    basis = eigh_grm(K[np.ix_(keep, keep)], diag_ridge=1e-6)
    k = min(CROSS_SNPS, pg.m)
    res, null = lmm_scan(pg.take_snps(np.arange(k)), basis, y_all[keep, 0], device="cpu")
    require([r[2] for r in rows[:k]] == list(res.sites.snp), "phase 17 rescan: SNP rows differ")
    row_of = kmer_rows(kmer_codes([r[2] for r in rows], KMER_K), codes)
    require(bool((row_of >= 0).all()), "phase 17: a TSV k-mer is not in the kmerge matrix")
    groups = pattern_groups(P[row_of[:k]])
    dmax = agree_groups([float(r[10]) for r in rows[:k]], res.pwald, groups,
                        "phase 17 cpu rescan", 0.05)
    lam = summary["runs"][0]["lambda_null"]
    rel = abs(null.lbd - lam) / lam
    require(rel <= 2e-3, f"phase 17 rescan λ_null {null.lbd:.6g} vs {lam:.6g}")
    say(f"phase 17 cpu rescan of {k} k-mers: max Δ(-log10 p)={dmax:.3g}, top-5 tests equal, "
        f"λ_null card={lam:.6g} cpu={null.lbd:.6g} (rel {rel:.2g}); "
        f"{time.monotonic() - t1:.2f} s")

    # recovery: each planted site reaches p < 1e-6 at a k-mer that spans it,
    # and the top hit spans a planted site
    p = np.array([float(r[10]) for r in rows])
    p_row = np.full(len(codes), np.inf)
    p_row[row_of] = p
    site_p = np.where(site_rows >= 0, p_row[np.maximum(site_rows, 0)], np.inf).min(1)
    top_row = row_of[int(np.argmin(p))]
    top_sites = np.nonzero((site_rows == top_row).any(1))[0]
    require(bool((site_p[causal] < 1e-6).all()),
            f"phase 17 recovery: planted sites' best p {site_p[causal].tolist()}")
    require(len(top_sites) == 1 and top_sites[0] in causal,
            f"phase 17 recovery: the top hit spans sites {top_sites.tolist()}")
    say(f"phase 17 recovery: planted sites' best p {np.array2string(site_p[causal], precision=3)}"
        f"; the top hit (p={p.min():.3g}) spans planted site {int(top_sites[0])}")

    walls["webui_job"] = run_webui_job(kd, prefix, pheno, rows, smi)
    t1 = time.monotonic()
    run_baseline(cpu, dev, smi)
    walls["baseline"] = time.monotonic() - t1
    wall = time.monotonic() - t0
    say(f"phase 17 walls ({smi}): " + ", ".join(f"{a}={b:.2f}" for a, b in walls.items())
        + f"; phase {wall:.2f} s of its {KMER_BUDGET_S:.0f} s budget; beside phases 2-16: "
        + ", ".join(f"{a}={got[a][1]:.2f}" for a in ("kmer", "kmerge", "kstats")))
    return {"kmer": launches}, {"kmer": errs}


# ------------------------------------------------------------ phase 18
MESH_SHARDS = 2  # the mesh of phase 18: two shards, both on the one card
MESH_BUDGET_S = 90.0
CHILD_TIMEOUT_S = 240.0  # each child process of phase 18 (b)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_worker():
    """tests/torch_dist_worker.py as a module (its save_packed)."""
    import importlib.util

    path = os.path.join(ROOT, "tests", "torch_dist_worker.py")
    spec = importlib.util.spec_from_file_location("torch_dist_worker", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return path, mod


class DistChildren:
    """Phase 18 (b): two tests/torch_dist_worker.py processes and two
    ``jx grm --distributed`` processes, each pair a gloo group on a free
    port of its own, all four on the one card, started together so that
    they run beside phase 18 (a). ``wait`` gives each child its time
    limit and raises if one times out or exits non-zero; ``stop`` kills
    whatever still runs."""

    def __init__(self, d: str, prefix: str, cpu):
        worker, mod = _dist_worker()
        self.d = os.path.join(d, "dist")
        inputs = os.path.join(self.d, "in")
        t0 = time.monotonic()
        mod.save_packed(os.path.join(inputs, "full"), cpu["full"])
        mod.save_packed(os.path.join(inputs, "sub"), cpu["pg"])
        np.savez(os.path.join(inputs, "scan.npz"), U=cpu["basis"].U, S=cpu["basis"].S,
                 y=cpu["y"])
        self.save_s = time.monotonic() - t0
        # the children run where the smoke runs (main sets JX_TPU_PLATFORM=cuda)
        env = dict(os.environ, JX_TPU_HISTORY_DB="0",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.grm_out = os.path.join(self.d, "grm")
        p1, p2 = _free_port(), _free_port()
        self.t0 = time.monotonic()
        self.procs = []
        for i in range(2):
            self._start(f"worker{i}", [sys.executable, worker, str(i), "2", str(p1),
                                       self.d, inputs], env)
        for i in range(2):
            self._start(f"grm{i}", [sys.executable, "-m", "janusx_tpu_torch.cli.main", "grm",
                                    "-bfile", prefix, "--distributed", "-o", self.grm_out],
                        dict(env, JX_DIST_COORDINATOR=f"127.0.0.1:{p2}", JX_DIST_NPROCS="2",
                             JX_DIST_PROC_ID=str(i)))

    def _start(self, name, argv, env):
        log = open(os.path.join(self.d, name + ".log"), "w")
        self.procs.append((name, subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                                                  env=env, cwd=ROOT), log))

    def wait(self) -> dict:
        """Each child's output, once all have exited 0; raises otherwise."""
        out = {}
        for name, proc, log in self.procs:
            left = CHILD_TIMEOUT_S - (time.monotonic() - self.t0)
            try:
                rc = proc.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"phase 18 child {name} ran past {CHILD_TIMEOUT_S:.0f} s")
            log.close()
            with open(log.name) as fh:
                out[name] = fh.read()
            require(rc == 0, f"phase 18 child {name} exited {rc}: {out[name][-2000:]}")
        out["wall"] = time.monotonic() - self.t0
        return out

    def stop(self) -> None:
        for _, proc, log in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def _sharded_close(one, two, what: str) -> bool:
    """beta/se rtol 2e-3 / atol 1e-6 and Δ(-log10 p) <= 5e-3
    (tests/test_sharding.py:82-84, 145); returns whether the two are
    equal bit for bit."""
    for f in ("beta", "se"):
        a, b = getattr(one, f), getattr(two, f)
        require(np.array_equal(np.isnan(a), np.isnan(b)), f"{what}: {f} NaN lanes differ")
        ok = np.isfinite(a)
        bad = np.abs(b[ok] - a[ok]) > 1e-6 + 2e-3 * np.abs(a[ok])
        require(not bad.any(), f"{what}: {int(bad.sum())} {f} lanes beyond rtol 2e-3 / atol 1e-6")
    ok = np.isfinite(one.pwald) & (one.pwald > 0)
    dl = float(np.max(np.abs(np.log10(two.pwald[ok]) - np.log10(one.pwald[ok]))))
    require(dl <= 5e-3, f"{what}: max Δ(-log10 p) {dl:.3g} > 5e-3")
    return all(np.array_equal(getattr(one, f), getattr(two, f), equal_nan=True)
               for f in ("beta", "se", "pwald"))


def _mesh_scans(mesh, dev, cpu, Y, rows5) -> tuple:
    """Phase 18 (a) on the whole panel: the sharded GRM (f64 and f32),
    lmm_scan and lmm_scan_multi with the mesh against one device. Returns
    (launches by path, held errors by path, the one-device lmm_scan)."""
    from janusx_tpu_torch.models import grm as grm_mod
    from janusx_tpu_torch.models.lmm import lattice_superblock, lmm_scan, lmm_scan_multi
    from janusx_tpu_torch.ops import kernels

    full, K = cpu["full"], cpu["K"]
    t1 = time.monotonic()
    calls = grm_mod.reduce_shards.calls
    Km = grm_mod.grm_from_packed(full, mesh=mesh)
    require(grm_mod.reduce_shards.calls - calls == 1, "phase 18 GRM: not one cross-shard sum")
    gap = float(np.max(np.abs(Km - K) - 1e-5 * np.abs(K)))
    require(gap <= 1e-5, f"phase 18 sharded GRM vs one device: {gap:.3g} over rtol 1e-5")
    # the f32 accumulator: the reference has no test of it; rtol 1e-5 /
    # atol 1e-5 (tests/test_sharding.py:46) bounds ~20 f32 superblock adds
    K32 = grm_mod.grm_from_packed(full, dtype=np.float32, mesh=mesh)
    gap32 = float(np.max(np.abs(K32 - K) - 1e-5 * np.abs(K)))
    require(gap32 <= 1e-5, f"phase 18 f32-accumulated GRM vs f64: {gap32:.3g} over rtol 1e-5")
    say(f"phase 18 GRM on {MESH_SHARDS} shards at {full.m} SNPs x {full.n}: one cross-shard "
        f"sum, max |K - K_1| {float(np.max(np.abs(Km - K))):.3g}; f32 accumulator max |K - K64| "
        f"{float(np.max(np.abs(K32 - K))):.3g}; {time.monotonic() - t1:.2f} s")

    pg, basis, y = cpu["pg"], cpu["basis"], cpu["y"]
    paths, errs, same, ones = {}, {}, {}, {}
    for name, T in (("mesh_lmm", 1), ("mesh_lmm_multi", 4)):
        t1 = time.monotonic()
        if T == 1:
            run = lambda **kw: [lmm_scan(pg, basis, y, **kw)[0]]
        else:
            run = lambda **kw: lmm_scan_multi(pg, basis, Y[cpu["keep"]][:, :T], **kw)[0]
        one = ones[name] = run(device=dev)
        kernels.reset_launches()
        with held(per_shape=MESH_SHARDS) as kept:
            two = run(mesh=mesh)
        paths[name] = scan_launches()
        sb = -(-pg.m // lattice_superblock(N_PHENO, GRID, 2048, traits=T))
        want = {**NO_LAUNCHES, "decode_rotate": MESH_SHARDS * sb,
                "grid_neg_reml_lattice": MESH_SHARDS * sb}
        require(paths[name] == want, f"phase 18 {name} launches {paths[name]}, expected {want} "
                                     f"(once per shard per superblock)")
        errs[name] = hold_launches(kept, name, dev, "phase 18")
        same[name] = all([_sharded_close(a, b, f"phase 18 {name} trait {t}")
                          for t, (a, b) in enumerate(zip(one, two))])
        d5 = agree(two[0].pwald, [float(r[10]) for r in rows5],
                   f"phase 18 {name} test0 vs phase 5's TSV", 5e-3)
        say(f"phase 18 {name}: T={T}, {pg.m} SNPs in {sb} superblocks, launches {paths[name]}; "
            f"vs one device within rtol 2e-3 / Δ(-log10 p) 5e-3, bit for bit equal: "
            f"{same[name]}; test0 vs phase 5's TSV max Δ(-log10 p) {d5:.3g}; "
            f"{time.monotonic() - t1:.2f} s")
    return paths, errs, ones["mesh_lmm"]


def _mesh_window(mesh, dev, cpu, prefix) -> None:
    """Phase 18 (a) on phase 8's window: every other route with the mesh
    against one device."""
    from janusx_tpu_torch.io.pheno import load_covariates
    from janusx_tpu_torch.models import algwas, fastlmm, fvlmm, gxe, lm, splmm
    from janusx_tpu_torch.workflows.gwas import _range_mask

    t1 = time.monotonic()
    pg, basis, y, keep = cpu["pg"], cpu["basis"], cpu["y"], cpu["keep"]
    win = pg.take_snps(_range_mask(pg.sites, (WINDOW,)))
    cov = load_covariates(prefix + ".cov", np.array([f"ind{j}" for j in range(N_SAMPLES)],
                                                    object))[keep]
    Kk = cpu["K"][np.ix_(keep, keep)]
    lrb = fastlmm.lowrank_basis_from_snps(pg, q=LOWRANK_Q)
    routes = {
        "lm": lambda **kw: lm.lm_scan(win, y, **kw),
        "fvlmm": lambda **kw: fvlmm.fvlmm_scan(win, basis, y, **kw)[0],
        "lowrank": lambda **kw: fastlmm.fastlmm_scan(win, lrb, y, **kw)[0],
        "splmm": lambda **kw: splmm.splmm_grammar_scan(win, Kk, y, **kw)[0],
        "splmm-exact": lambda **kw: splmm.splmm_exact_scan(win, Kk, y, **kw)[0],
        "lm2": lambda **kw: gxe.gxe_scan(win, y, cov[:, 1], cov[:, :1], **kw)[0],
        "fvlmm2": lambda **kw: gxe.gxe_scan(win, y, cov[:, 1], cov[:, :1], basis=basis,
                                            **kw)[0],
        "algwas": lambda **kw: algwas.algwas_scan(win, y, cov, **kw),
    }
    same = {}
    for name, run in routes.items():
        one, two = run(device=dev), run(mesh=mesh)
        if name == "algwas":
            # a selected QTN is its own covariate: its lane's beta is 0/0 in
            # f32, held by its refit p-value only
            require(np.array_equal(one.selected, two.selected),
                    f"phase 18 algwas selected {two.selected} vs {one.selected}")
            keep_lanes = np.ones(win.m, bool)
            keep_lanes[one.selected] = False
            one, two = (_lanes(r.result, keep_lanes) for r in (one, two))
        same[name] = _sharded_close(one, two, f"phase 18 window {name}")
    say(f"phase 18 window {WINDOW} ({win.m} SNPs): lm, fvlmm, lowrank, splmm, splmm-exact, "
        f"lm2, fvlmm2, algwas with the mesh within rtol 2e-3 / Δ(-log10 p) 5e-3 of one "
        f"device; bit for bit equal: {same}; {time.monotonic() - t1:.2f} s")


def _lanes(res, mask):
    from types import SimpleNamespace

    return SimpleNamespace(beta=res.beta[mask], se=res.se[mask], pwald=res.pwald[mask])


def _mesh_cli(d, pheno, dev) -> dict:
    """``jx gwas -bimrange WINDOW -lm -lmm -fvlmm`` on phase 15's chromosome
    1 panel, with JX_TPU_DEVICES=2 and the dispatcher seeing two devices
    (both the card), against the same command on one device."""
    from janusx_tpu_torch.parallel import mesh as mesh_mod

    t1 = time.monotonic()
    chr1 = os.path.join(d, "chr1")
    require(os.path.exists(chr1 + ".bed"), "phase 18: phase 15's chromosome-1 panel is missing")
    argv = ["gwas", "-bfile", chr1, "-p", pheno, "-bimrange", WINDOW, "-lm", "-lmm", "-fvlmm",
            "-n", "0", "-o"]
    _, wall1, _ = run_cli(argv + [os.path.join(d, "out18one")], "phase 18 one device")
    seam, os.environ["JX_TPU_DEVICES"] = mesh_mod.visible_devices, str(MESH_SHARDS)
    mesh_mod.visible_devices = lambda: [dev] * MESH_SHARDS
    try:
        _, wall2, launches = run_cli(argv + [os.path.join(d, "out18mesh")], "phase 18 mesh")
    finally:
        mesh_mod.visible_devices = seam
        del os.environ["JX_TPU_DEVICES"]
    # lm: no kernel; lmm: K1 + K2 per shard; fvlmm: K1 per shard
    want = {**NO_LAUNCHES, "decode_rotate": 2 * MESH_SHARDS,
            "grid_neg_reml_lattice": MESH_SHARDS}
    require(launches == want, f"phase 18 cli launches {launches}, expected {want}")
    worst = 0.0
    for tag in ("LM", "LMM", "FvLMM"):
        header, a = read_tsv(os.path.join(d, "out18one", f"jx.test0.{tag}.assoc.tsv"))
        header2, b = read_tsv(os.path.join(d, "out18mesh", f"jx.test0.{tag}.assoc.tsv"))
        require(header == header2 and [r[2] for r in a] == [r[2] for r in b],
                f"phase 18 cli {tag}: header or SNP rows differ")
        worst = max(worst, agree(p_col(b, header), p_col(a, header),
                                 f"phase 18 cli {tag}", 5e-3))
        # the TSV prints beta at 4 decimal places: one unit of the last is
        # the absolute floor of a rounding flip
        beta = [p_col(x, header, "beta") for x in (a, b)]
        bad = np.abs(beta[1] - beta[0]) > 1e-4 + 2e-3 * np.abs(beta[0])
        require(not bad.any(), f"phase 18 cli {tag}: {int(bad.sum())} betas beyond rtol 2e-3 "
                               f"/ atol 1e-4")
    say(f"phase 18 cli -bimrange {WINDOW} -lm -lmm -fvlmm on chromosome 1: mesh of "
        f"{MESH_SHARDS} (JX_TPU_DEVICES={MESH_SHARDS}) launches {launches}, TSVs within beta "
        f"rtol 2e-3 / atol 1e-4 (the printed 4 decimals) and max Δ(-log10 p) {worst:.3g} of "
        f"one device's; walls one {wall1:.2f} s, "
        f"mesh {wall2:.2f} s; {time.monotonic() - t1:.2f} s")
    return launches


def _check_children(children: DistChildren, d, cpu, one) -> None:
    """Phase 18 (b)'s results: the workers' GRM and scan, and ``jx grm
    --distributed``'s .npy, against the single-process runs."""
    out = children.wait()
    for name in ("worker0", "worker1"):
        line = next((ln for ln in out[name].splitlines() if ln.startswith("DIST_OK")), None)
        require(line is not None, f"phase 18 {name}: no DIST_OK: {out[name][-1500:]}")
        say(f"phase 18 two processes over gloo, {line}")
    res = np.load(os.path.join(children.d, "dist_result.npz"))
    K = cpu["K"]
    gap = float(np.max(np.abs(res["K"] - K) - 1e-5 * np.abs(K)))
    require(gap <= 1e-4, f"phase 18 distributed_grm vs one process: {gap:.3g} over rtol 1e-5 "
                         f"/ atol 1e-4")
    from types import SimpleNamespace

    two = SimpleNamespace(beta=res["beta"], se=res["se"], pwald=res["pwald"])
    same = _sharded_close(one[0], two, "phase 18 distributed_scan vs one process")
    K12 = np.load(os.path.join(d, "out12", "jx.cGRM.npy"))
    Kc = np.load(os.path.join(children.grm_out, "jx.cGRM.npy"))
    gapc = float(np.max(np.abs(Kc - K12) - 1e-5 * np.abs(K12)))
    require(gapc <= 1e-4, f"phase 18 jx grm --distributed vs phase 12's jx grm: {gapc:.3g}")
    say(f"phase 18 distributed: GRM max |K - K_1| {float(np.max(np.abs(res['K'] - K))):.3g}, "
        f"scan of {len(two.beta)} SNPs within rtol 2e-3 / Δ(-log10 p) 5e-3 of one process "
        f"(bit for bit: {same}); jx grm --distributed rank 0's .npy max |K - K_12| "
        f"{float(np.max(np.abs(Kc - K12))):.3g}; inputs saved in {children.save_s:.2f} s, the "
        f"four children {out['wall']:.2f} s beside (a)")


def run_mesh_phase(d, prefix, pheno, rows5, Y, cpu, dev, smi) -> tuple:
    """Phase 18: the multi-device path on the one card. (b)'s four child
    processes start first and run beside (a): a mesh of MESH_SHARDS shards
    on the card through the GRM, the LMM scans, every other route on phase
    8's window and the dispatcher. Returns (launches by path, held errors
    by path)."""
    import torch

    from janusx_tpu_torch.parallel.mesh import Mesh

    t0 = time.monotonic()
    children = DistChildren(d, prefix, cpu)
    try:
        mesh = Mesh([dev] * MESH_SHARDS)
        paths, errs, one = _mesh_scans(mesh, dev, cpu, Y, rows5)
        _mesh_window(mesh, dev, cpu, prefix)
        paths["mesh_cli"] = _mesh_cli(d, pheno, dev)
        t1 = time.monotonic()
        _check_children(children, d, cpu, one)
        wait = time.monotonic() - t1
    finally:
        children.stop()
    torch.cuda.empty_cache()
    wall = time.monotonic() - t0
    say(f"phase 18 ({smi}): waited {wait:.2f} s for (b) after (a); phase {wall:.2f} s of its "
        f"{MESH_BUDGET_S:.0f} s budget")
    return paths, errs


# ------------------------------------------------------------ main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from janusx_tpu_torch import config

    dev = torch.device("cuda", 0)
    os.environ["JX_TPU_PLATFORM"] = "cuda"
    os.environ["JX_TPU_HISTORY_DB"] = "0"  # no run-history database outside the run
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    say(smi)
    config.set_full_f32_matmul()  # TF32 off: full-f32 matmuls, as the reference
    say(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"cuda {torch.version.cuda}; TF32 off")

    natives = native_builds()  # phase 17's host libraries, built beside nvcc
    try:
        with tempfile.TemporaryDirectory(prefix="jx_smoke_") as d:
            pipeline = KmerPipeline(d, natives)
            try:
                return run_phases(d, dev, smi, pipeline)
            finally:
                pipeline.stop()
    finally:
        for _, proc in natives:
            proc.wait()


def run_phases(d: str, dev, smi: str, pipeline: KmerPipeline) -> int:
    """Phases 2-18, then phase 10's lines."""
    import torch

    t0 = time.monotonic()
    k = check_kernels(dev, write_panel_async(d, M_SNPS))
    walls = {"kernels": time.monotonic() - t0}
    t0 = time.monotonic()
    prefix, pheno, rows, summary, launches, qtl_ids, Y, gv = run_main_path(d, M_SNPS,
                                                                           k["panel"])
    cpu = cross_check(prefix, pheno, rows, summary)
    rescan_default(rows, cpu, dev)
    walls["lmm"] = time.monotonic() - t0
    t0 = time.monotonic()
    paths = {"lmm": launches,
             "trait_level": run_trait_level(d, prefix, Y, rows, cpu)}
    walls["trait_level"] = time.monotonic() - t0
    t0 = time.monotonic()
    paths["brent"] = run_routes(d, prefix, pheno, rows, qtl_ids, Y, cpu)
    walls["routes"] = time.monotonic() - t0
    t0 = time.monotonic()
    paths["lowrank"] = run_lowrank_sparse(d, prefix, pheno, rows, qtl_ids, cpu)
    walls["lowrank_sparse"] = time.monotonic() - t0
    t0 = time.monotonic()
    paths["gs"] = run_gs_phase(d, prefix, pheno, gv, cpu, dev, smi)
    walls["gs"] = time.monotonic() - t0
    t0 = time.monotonic()
    paths["structure"] = run_structure_phase(d, prefix, pheno, qtl_ids, cpu, dev)
    walls["structure"] = time.monotonic() - t0
    t0 = time.monotonic()
    paths["bayes"], gibbs = run_bayes_phase(d, prefix, pheno, cpu, dev, smi)
    walls["bayes"] = time.monotonic() - t0
    t0 = time.monotonic()
    paths["population"] = run_pop_phase(d, dev)
    walls["population"] = time.monotonic() - t0
    t0 = time.monotonic()
    epi_paths, held_errs = run_epistasis_phase(d, prefix, rows, cpu, dev, smi)
    paths.update(epi_paths)
    walls["epistasis"] = time.monotonic() - t0
    t0 = time.monotonic()
    tool_paths, tool_errs = run_tools_phase(d, prefix, pheno,
                                            os.path.join(d, "out12", "jx.cGRM.npy"), dev, smi)
    paths.update(tool_paths)
    held_errs.update(tool_errs)
    walls["tools"] = time.monotonic() - t0
    t0 = time.monotonic()
    kmer_paths, kmer_errs = run_kmer_phase(pipeline, cpu, dev, smi)
    paths.update(kmer_paths)
    held_errs.update(kmer_errs)
    walls["kmer"] = time.monotonic() - t0
    t0 = time.monotonic()
    mesh_paths, mesh_errs = run_mesh_phase(d, prefix, pheno, rows, Y, cpu, dev, smi)
    paths.update(mesh_paths)
    held_errs.update(mesh_errs)
    walls["mesh"] = time.monotonic() - t0
    say("phase walls (s): " + ", ".join(f"{a}={b:.2f}" for a, b in walls.items()))
    by_path = lambda name: {p: c[name] for p, c in paths.items()}
    # the largest |error| of the path's own launches against the plain
    # version (hold_launches), by phase 15's, 16's and 17's paths that launched the kernel
    held_by = lambda name: {p: e[name] for p, e in held_errs.items() if name in e}
    k2, k2d = k["k2"]["highest"], k["k2"]["default"]
    k2t, k2td = k["k2t"]["highest"], k["k2t"]["default"]
    nf = k["null_fit"]

    src = "janusx_tpu_torch/csrc/"
    ref = "janusx_tpu/ops/pallas_kernels.py:"
    say(json.dumps({"kernels": [
        {"name": "decode_rotate", "route": "cuda", "source": src + "rotate.cu",
         "replaces": ref + "104", "launches": launches["decode_rotate"],
         "max_abs_err": k["k1_err"], "ms": k["k1_ms"], "plain_ms": k["k1_plain"],
         "bound_ms": k["k1_bound"][0], "bound_by": k["k1_bound"][1],
         "library_ms": k["k1_lib"],
         # the same kernel in its "high" (bf16x3) mode, off the main path's default
         "high_max_abs_err": k["k1_high_err"], "high_ms": k["k1_high_ms"],
         "high_plain_ms": k["k1_high_plain"], "high_bound_ms": k["k1_high_bound"][0],
         # at the -lowrank route's launch shape (N = k columns)
         "lowrank_max_abs_err": k["k1_lr_err"], "lowrank_ms": k["k1_lr_ms"],
         "lowrank_plain_ms": k["k1_lr_plain"], "lowrank_bound_ms": k["k1_lr_bound"][0],
         "lowrank_bound_by": k["k1_lr_bound"][1], "lowrank_library_ms": k["k1_lr_lib"],
         "launches_by_path": by_path("decode_rotate"),
         "held_max_abs_err_by_path": held_by("decode_rotate")},
        {"name": "grid_neg_reml_lattice", "route": "cuda", "source": src + "lattice.cu",
         "replaces": ref + "232", "launches": launches["grid_neg_reml_lattice"],
         "max_abs_err": k["k2_err"], "ms": k2[1], "plain_ms": k2[2],
         "bound_ms": k["k2_bound"][1, "highest"][0],
         "bound_by": k["k2_bound"][1, "highest"][1], "library_ms": k2[3],
         # the reference's one-pass mode (JX_TPU_GRID_MXU_PREC=default)
         "default_max_abs_err": k["k2_default_err"], "default_ms": k2d[1],
         "default_plain_ms": k2d[2], "default_bound_ms": k["k2_bound"][1, "default"][0],
         "default_bound_by": k["k2_bound"][1, "default"][1], "default_library_ms": k2d[3],
         # over a trait axis of 4 (its plain version: the reference's loop,
         # one single-trait lattice per trait), in both modes
         "t4_ms": k2t[1], "t4_plain_ms": k2t[2], "t4_library_ms": k2t[3],
         "t4_bound_ms": k["k2_bound"][4, "highest"][0],
         "t4_default_ms": k2td[1], "t4_default_plain_ms": k2td[2],
         "t4_default_library_ms": k2td[3],
         "t4_default_bound_ms": k["k2_bound"][4, "default"][0],
         "launches_by_path": by_path("grid_neg_reml_lattice"),
         "held_max_abs_err_by_path": held_by("grid_neg_reml_lattice")},
        *({"name": name, "route": "cuda", "source": src + "gibbs.cu",
           "replaces": "janusx_tpu/gs/bayes.py:" + line, "launches": paths["bayes"][name],
           "max_abs_err": g["max_abs_err"], "ms": g["ms"], "plain_ms": g["plain_ms"],
           "bound_ms": g["bound"][0], "bound_by": g["bound"][1],
           # G2's: the pre-pass's factorizations by torch.linalg (a yardstick)
           "library_ms": g.get("library_ms"),
           # the pre-pass and the serial pass apart, and the serial pass's path
           "prepass_ms": g["prepass_ms"], "serial_ms": g["serial_ms"],
           "path": g["plan"]["path"],
           # the dependency chain alone (n = 32 samples: one CTA), and one
           # sweep at every QC'd SNP of phase 5's panel
           "chain_ms": g["chain_ms"], "all_snps_ms": g["m_all_ms"],
           "all_snps_bound_ms": g["m_all_bound"][0],
           "delta_flips": g["delta_flips"], "launches_by_path": by_path(name),
           "held_max_abs_err_by_path": held_by(name)}
          for name, line, g in (("gibbs_sweep_marker", "76", gibbs["gibbs_sweep_marker"]),
                                ("gibbs_sweep_block_mvn", "214",
                                 gibbs["gibbs_sweep_block_mvn"]))),
        {"name": "null_reml_brent", "route": "cuda", "source": src + "nullfit.cu",
         # the XLA loop of the null fit (no Pallas)
         "replaces": "janusx_tpu/core/reml.py:572", "launches": launches["null_reml_brent"],
         "max_log10_lambda_err": max(nf[T]["dx"] for T in (1, 4)),
         "max_rel_err": max(nf[T]["rel"] for T in (1, 4)), "ms": nf[1]["ms"],
         "plain_ms": nf[1]["plain_ms"], "bound_ms": nf[1]["bound"][0],
         "bound_by": nf[1]["bound"][1], "library_ms": None, "t4_ms": nf[4]["ms"],
         "t4_plain_ms": nf[4]["plain_ms"], "t4_bound_ms": nf[4]["bound"][0],
         # the Brent's dependent evaluations, one block reduction each
         "evaluations": nf["evaluations"],
         "launches_by_path": {p: c["null_reml_brent"] for p, c in paths.items()
                              if "null_reml_brent" in c}},
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
