#!/usr/bin/env python3
"""Smoke run of janusx_tpu_torch (the PyTorch + CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero; nothing is caught):
 1. require a CUDA card; print ``nvidia-smi`` name and power limit; turn
    TF32 off (the reference's f32 matmuls are full precision);
 2. build the hand-written kernels from csrc/ and print the build seconds;
 3. K1 decode+rotate on the card vs its plain PyTorch version at the main
    path's launch shape (one resident superblock: M = 299,008 SNP rows,
    n = 1410), at one 2048-row block and at a ragged shape (M = 1000,
    n = 997), rtol 1e-5 / atol 1e-4, with both times;
 4. K2 λ-lattice on the card vs its plain version (G = 256, n = 1410:
    B = 299,008 and B = 2048 with p = 1, B = 2048 with p = 3; ragged
    B = 1000, G = 200, n = 997, p = 2): the same finite/inf pattern, λ*
    within 2.02 grid spacings with > 50 % in the same argmin grid cell,
    beta/se at each λ* within rtol 2e-3 (beta's absolute floor 2e-3 se),
    with both times;
 5. the main path: a synthetic PLINK panel (1,940 samples, 1,410
    phenotyped, in sibships of 5; 600,000 SNPs, MAF ~ U[0.05, 0.5], 2 %
    missing; the trait is 20 planted QTLs of 3 % variance each + a 20 %
    polygenic background + 20 % noise) through ``jx gwas -lmm -force-model``
    (janusx_tpu_torch.cli.main); checks the TSV, the p-values, λ_null, QTL
    recovery, and that both kernels launched; prints per-stage seconds;
 6. cross-check: the first 16,384 QC'd SNPs rescanned on the CPU (plain
    versions) with the same basis: max Δ(-log10 p) <= 0.05, the same top
    5, λ_null within 2e-3;
 7. a JSON line with each kernel's numbers, then the result line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
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
HEADER = "chrom\tpos\tsnp\tallele0\tallele1\taf\tmiss\tbeta\tse\tchisq\tpwald"


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


# ------------------------------------------------------------ phases 3-4
def _basis(n: int, seed: int):
    from janusx_tpu_torch.core.spectral import eigh_grm

    rng = np.random.default_rng(seed)
    g = rng.binomial(2, rng.uniform(0.05, 0.5, 3000)[:, None], size=(3000, n))
    gc = g - g.mean(axis=1, keepdims=True)
    # a trait with a polygenic component on the basis' own SNPs (h2 ~ 0.3),
    # so the REML profile has an interior optimum, as real traits do
    y = 3.0 + gc.T @ rng.normal(0.0, 0.02, 3000) + rng.normal(size=n)
    return eigh_grm(gc.T @ gc / 3000.0, diag_ridge=1e-6), y, rng


def _packed_block(M: int, n: int, seed: int, dev):
    """(packed (M, ceil(n/4)) u8, mean (M,) f32), drawn on the device:
    dosages of SNPs with MAF ~ U[0.05, 0.5] and 2 % missing; lanes k >= n
    hold the pad code 3. A main-path block is ~420 M draws."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    p = 0.05 + 0.45 * torch.rand((M, 1), generator=g, device=dev)
    nb = -(-n // 4)
    u = lambda: torch.rand((M, 4 * nb), generator=g, device=dev)
    codes = (u() < p).to(torch.uint8) + (u() < p).to(torch.uint8)
    codes[(u() < 0.02) | (torch.arange(4 * nb, device=dev) >= n)] = 3
    q = codes.view(M, nb, 4)
    packed = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)
    return packed.contiguous(), (2.0 * p[:, 0]).float()


def check_k1(dev, M: int, n: int, U_np, seed: int, timed: bool):
    import torch

    from janusx_tpu_torch.ops import kernels

    pk, mn = _packed_block(M, n, seed, dev)
    U = torch.as_tensor(np.ascontiguousarray(U_np), dtype=torch.float32, device=dev)
    got = kernels.decode_rotate(pk, mn, U)
    want = kernels.decode_rotate_plain(pk, mn, U)
    torch.cuda.synchronize()
    err = (got - want).abs()
    ok = bool((err <= 1e-4 + 1e-5 * want.abs()).all())
    max_err = float(err.max())
    require(ok, f"K1 M={M} n={n}: outside rtol 1e-5 / atol 1e-4 (max |err| {max_err:.3g})")
    ms = plain = None
    if timed:
        ms = cuda_ms(lambda: kernels.decode_rotate(pk, mn, U))
        plain = cuda_ms(lambda: kernels.decode_rotate_plain(pk, mn, U))
    say(f"phase 3 K1 decode_rotate M={M} n={n}: ok, max|err|={max_err:.3g}"
        + (f", kernel {ms:.4f} ms, plain {plain:.4f} ms" if timed else ""))
    return max_err, ms, plain


def check_k2(dev, basis, y, rng, B: int, G: int, p: int, seed: int, timed: bool):
    import torch

    from janusx_tpu_torch import config
    from janusx_tpu_torch.core.reml import (argmin_parabolic, final_stats_f32,
                                            grid_shared, make_grid, make_rotated)
    from janusx_tpu_torch.models.lmm import _lattice_operands
    from janusx_tpu_torch.ops import kernels

    n = basis.n
    cov = rng.normal(size=(n, p - 1)) if p > 1 else None
    rot = make_rotated(basis, y, cov, device=dev)
    sh = grid_shared(rot, make_grid(G, dev))
    W, YX, SH = _lattice_operands(sh, rot)
    pk, mn = _packed_block(B, n, seed, dev)
    Gr = kernels.decode_rotate_plain(pk, mn, torch.as_tensor(
        np.ascontiguousarray(basis.U), dtype=torch.float32, device=dev))
    args = (Gr, W, YX, SH, p, config.GRAM_RIDGE, float(n))
    got = kernels.grid_neg_reml_lattice(*args)
    want = kernels.grid_neg_reml_lattice_plain(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    require(torch.equal(torch.isfinite(got), fin), f"K2 p={p}: finite/inf pattern differs")
    max_err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    lg_k = argmin_parabolic(got, sh.grid_lg)
    lg_p = argmin_parabolic(want, sh.grid_lg)
    h = float(sh.grid_lg[1] - sh.grid_lg[0])
    dlg = (lg_k - lg_p).abs()
    # "identical" = the same argmin grid cell; the parabolic refinement
    # then still moves with the last f32 bits of the three cells it reads
    same = float((torch.argmin(got, -1) == torch.argmin(want, -1)).double().mean())
    rel = float(((got[fin] - want[fin]).abs() / want[fin].abs()).max()) if bool(fin.any()) else 0.0
    detail = (f"max|err| {max_err:.3g} (rel {rel:.3g}), λ* max move "
              f"{float(dlg.max()) / h:.3g} spacings, same argmin cell {same:.1%}, "
              f"λ* equal to 1e-6 {float((dlg < 1e-6).double().mean()):.1%}")
    require(bool((dlg <= 2.02 * h).all()), f"K2 p={p}: λ* moved > 2.02 spacings; {detail}")
    require(same > 0.5, f"K2 p={p}: too few identical argmin cells; {detail}")
    b_k, se_k, _ = final_stats_f32(rot, Gr, lg_k, False)
    b_p, se_p, _ = final_stats_f32(rot, Gr, lg_p, False)
    # rtol 2e-3 (tests/test_pallas.py:102-110); a beta that is ~0 against
    # its own standard error gets the absolute floor 2e-3 * se (z within 2e-3)
    for a, b, nm, floor in ((b_k, b_p, "beta", 2e-3 * se_p), (se_k, se_p, "se", 1e-6)):
        ok = torch.isfinite(b)
        require(torch.equal(torch.isfinite(a), ok), f"K2 p={p}: {nm} NaN lanes differ")
        bad = (a - b).abs() > floor + 2e-3 * b.abs()
        i = int(torch.argmax(((a - b).abs() / b.abs()).nan_to_num(0.0)))
        require(not bool(bad[ok].any()),
                f"K2 p={p}: {nm} at λ* outside rtol 2e-3 in {int(bad[ok].sum())} lanes; "
                f"worst lane {i}: {float(a[i]):.6g} vs {float(b[i]):.6g}, λ* "
                f"{float(lg_k[i]):.6f} vs {float(lg_p[i]):.6f}; {detail}")
    ms = plain = None
    if timed:
        ms = cuda_ms(lambda: kernels.grid_neg_reml_lattice(*args))
        plain = cuda_ms(lambda: kernels.grid_neg_reml_lattice_plain(*args))
    say(f"phase 4 K2 grid_neg_reml_lattice B={B} G={G} n={n} p={p}: ok, "
        f"{detail}"
        + (f", kernel {ms:.4f} ms, plain {plain:.4f} ms" if timed else ""))
    return max_err, ms, plain


# ------------------------------------------------------------ phase 5
def write_panel(d: str, m: int, seed: int = 20261016):
    """Synthetic PLINK panel + phenotype file, generated in 50k-SNP chunks.

    Samples come in sibships (FAMILY children of two unrelated parents,
    one recombination per SEGMENT SNPs), so the GRM carries relatedness as
    in a real panel and the null REML has an interior optimum. Returns
    (prefix, pheno_path, qtl_ids, expected_kept): expected_kept counts the
    SNPs that pass the default QC (MAF >= 0.02, missing <= 0.05) on the
    phenotyped samples, computed here directly from the genotypes."""
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
    return prefix, pheno, {f"snp{i}" for i in qtl}, kept


def read_tsv(path: str):
    with open(path) as fh:
        header = fh.readline().rstrip("\n")
        rows = [ln.rstrip("\n").split("\t") for ln in fh]
    return header, rows


def run_main_path(d: str, m: int):
    """Panel -> CLI -> checks. Returns (prefix, pheno, rows, summary,
    launches)."""
    from janusx_tpu_torch.cli.main import main as cli_main
    from janusx_tpu_torch.ops import kernels

    t0 = time.monotonic()
    prefix, pheno, qtl_ids, kept = write_panel(d, m)
    say(f"phase 5 panel: {N_SAMPLES} samples ({N_PHENO} phenotyped) x {m} SNPs "
        f"written in {time.monotonic() - t0:.2f} s; {kept} SNPs pass QC")
    out = os.path.join(d, "out")
    argv = ["gwas", "-bfile", prefix, "-p", pheno, "-lmm", "-force-model",
            "-n", "0", "-o", out]
    kernels.reset_launches()
    buf = io.StringIO()
    t1 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    wall = time.monotonic() - t1
    launches = {"decode_rotate": kernels.decode_rotate.launches,
                "grid_neg_reml_lattice": kernels.grid_neg_reml_lattice.launches}
    printed = buf.getvalue().strip()
    say(f"phase 5 cli: rc={rc} wall={wall:.2f} s :: {printed}")
    require(rc == 0, f"gwas CLI returned {rc}")
    require("lambda_null=" in printed, "λ_null was not printed")
    require(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    header, rows = read_tsv(os.path.join(out, "jx.test0.LMM.assoc.tsv"))
    require(header == HEADER, f"TSV header {header!r}")
    require(len(rows) == kept, f"TSV has {len(rows)} rows, {kept} SNPs pass QC")
    pw = np.array([float(r[10]) for r in rows])
    require(bool(np.all(np.isfinite(pw) & (pw > 0) & (pw <= 1))), "non-finite p-values")
    sig = sum(1 for r in rows if r[2] in qtl_ids and float(r[10]) < 5e-8)
    require(sig >= N_QTL // 2, f"only {sig}/{N_QTL} planted QTLs reach p < 5e-8")
    with open(os.path.join(out, "jx.gwas.summary.json")) as fh:
        summary = json.load(fh)
    st = dict(summary["stages"], **summary["runs"][0]["stages"])
    scan = st["scan"]
    say("phase 5 stages (s): " + ", ".join(f"{k}={v:.3f}" for k, v in st.items())
        + f"; scan {len(rows) / scan:.0f} SNPs/s; {sig}/{N_QTL} QTLs at p < 5e-8; "
        f"launches {launches}")
    return prefix, pheno, rows, summary, launches


def cross_check(prefix: str, pheno: str, rows, summary) -> None:
    """The first CROSS_SNPS QC'd SNPs rescanned with the plain versions on
    the CPU, from the same cached GRM and the same eigendecomposition."""
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
    K = load_or_build_grm(prefix, raw.prepare(qc), qc.maf, qc.geno)
    pg = raw.prepare(qc, sample_idx=keep)
    basis = eigh_grm(K[np.ix_(keep, keep)], diag_ridge=1e-6)
    k = min(CROSS_SNPS, pg.m)
    res, null = lmm_scan(pg.take_snps(np.arange(k)), basis, y_all[keep, 0],
                         device="cpu")
    card = rows[:k]
    require([r[2] for r in card] == list(res.sites.snp), "cross-check SNP rows differ")
    lp_card = -np.log10(np.array([float(r[10]) for r in card]))
    lp_cpu = -np.log10(res.pwald)
    dmax = float(np.max(np.abs(lp_card - lp_cpu)))
    require(dmax <= 0.05, f"cross-check max Δ(-log10 p) {dmax:.4g} > 0.05")
    top_card = set(np.argsort(-lp_card, kind="stable")[:5])
    top_cpu = set(np.argsort(-lp_cpu, kind="stable")[:5])
    require(top_card == top_cpu, "cross-check top-5 SNPs differ")
    lam_card = summary["runs"][0]["lambda_null"]
    rel = abs(null.lbd - lam_card) / lam_card
    require(rel <= 2e-3, f"cross-check λ_null {null.lbd:.6g} vs {lam_card:.6g}")
    say(f"phase 6 cross-check {k} SNPs on cpu: max Δ(-log10 p)={dmax:.3g}, top-5 equal, "
        f"λ_null card={lam_card:.6g} cpu={null.lbd:.6g} (rel {rel:.2g}); "
        f"{time.monotonic() - t0:.2f} s")


def check_kernels(dev) -> dict:
    """Phases 2-4: build, then each kernel against its plain version."""
    from janusx_tpu_torch import config
    from janusx_tpu_torch.models.lmm import lattice_superblock
    from janusx_tpu_torch.ops import kernels

    so, build_s = kernels.build()
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"phase 2 build: {build_s:.2f} s -> {os.path.relpath(so, ROOT)}; "
        + " | ".join(ptxas))

    # the main path launches each kernel once per resident superblock of
    # SNPs; the 2048-row block is the reference's per-block launch shape
    rows = lattice_superblock(N_PHENO, GRID, config.DEFAULT_SNP_BLOCK)
    basis, y, rng = _basis(N_PHENO, seed=1)
    k1 = [check_k1(dev, rows, N_PHENO, basis.U, seed=11, timed=True),
          check_k1(dev, 2048, N_PHENO, basis.U, seed=12, timed=True),
          check_k1(dev, 1000, 997, rng.normal(size=(997, 997)), seed=13, timed=False)]
    k2 = [check_k2(dev, basis, y, rng, rows, GRID, 1, seed=21, timed=True),
          check_k2(dev, basis, y, rng, 2048, GRID, 1, seed=22, timed=True),
          check_k2(dev, basis, y, rng, 2048, GRID, 3, seed=23, timed=False)]
    basis_r, y_r, rng_r = _basis(997, seed=2)
    k2.append(check_k2(dev, basis_r, y_r, rng_r, 1000, 200, 2, seed=24, timed=False))
    return dict(k1_err=max(r[0] for r in k1), k1_ms=k1[0][1], k1_plain=k1[0][2],
                k2_err=max(r[0] for r in k2), k2_ms=k2[0][1], k2_plain=k2[0][2])


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    say(smi)
    config.set_full_f32_matmul()  # TF32 off: full-f32 matmuls, as the reference
    say(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"cuda {torch.version.cuda}; TF32 off")

    k = check_kernels(dev)

    with tempfile.TemporaryDirectory(prefix="jx_smoke_") as d:
        prefix, pheno, rows, summary, launches = run_main_path(d, M_SNPS)
        cross_check(prefix, pheno, rows, summary)

    src = "janusx_tpu_torch/csrc/"
    ref = "janusx_tpu/ops/pallas_kernels.py:"
    say(json.dumps({"kernels": [
        {"name": "decode_rotate", "route": "cuda", "source": src + "rotate.cu",
         "replaces": ref + "104", "launches": launches["decode_rotate"],
         "max_abs_err": k["k1_err"], "ms": k["k1_ms"], "plain_ms": k["k1_plain"]},
        {"name": "grid_neg_reml_lattice", "route": "cuda", "source": src + "lattice.cu",
         "replaces": ref + "232", "launches": launches["grid_neg_reml_lattice"],
         "max_abs_err": k["k2_err"], "ms": k["k2_ms"], "plain_ms": k["k2_plain"]},
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
