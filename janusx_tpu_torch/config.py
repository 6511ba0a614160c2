"""Global configuration for janusx_tpu_torch (the PyTorch/CUDA port).

Mirrors ``janusx_tpu/config.py``: the same ``JX_*`` knobs wherever their
meaning carries over, so one environment drives both packages. Knobs that
only steered XLA/Pallas (compile cache, the Pallas switches, the VMEM lane
cap, x64 mode) have no counterpart here.

Precision policy (the reference's, kept so the parity tests compare like
with like): genotype decode, the rotation kernel, the lambda lattice and
the final per-SNP grams are float32; rotated data, grid-shared pieces, the
null REML fit and the final Schur epilogue are float64. Every tensor the
port creates names its dtype. Both kernels run on the tensor cores and
keep float32 accuracy by default from exact bf16 pieces
(``JX_TPU_ROTATE_PREC=highest``, ``JX_TPU_GRID_MXU_PREC=highest``); each
also has the reference's reduced mode.

One default deviates from the reference: ``JX_TPU_GRID_MXU_PREC`` is
``default`` (one bf16 pass) in janusx_tpu/config.py and ``highest`` here.
The lattice only ranks λ cells (beta and se are evaluated afresh at λ* in
f32 grams and an f64 epilogue), so the one-pass mode is the reference's
choice on the TPU; the port keeps f32 grams by default because every parity
bound and smoke check of the port was set on the f32 lattice, and one pass
saves at most a few milliseconds per superblock on an H100.

Device selection: ``JX_TPU_PLATFORM=cpu`` pins the CPU (the tests and the
plain-PyTorch path); anything else, or unset, means ``cuda``, and asking
for ``cuda`` without a card raises — nothing silently runs on the CPU.
"""

from __future__ import annotations

import os

# Default SNP-block size for streamed device kernels.
DEFAULT_SNP_BLOCK: int = int(os.environ.get("JX_TPU_SNP_BLOCK", "2048"))

# Default sample-axis padding multiple (packed-byte lane alignment).
SAMPLE_ALIGN: int = 128

# QC defaults — reference: python/janusx/assoc/config.py:55-57.
DEFAULT_MAF: float = 0.02
DEFAULT_GENO: float = 0.05  # max missing rate
DEFAULT_HET: float = 1.0  # disabled by default

# λ search space, log10 scale — reference: python/janusx/pyBLUP/assoc.py:1808.
LOG10_LAMBDA_LOW: float = -5.0
LOG10_LAMBDA_HIGH: float = 5.0

# Null-fit Brent defaults — reference: src/stats/reml.rs:650.
NULL_BRENT_MAX_ITER: int = 100
NULL_BRENT_TOL: float = 1e-6

# Ridge added to X'V^-1 X diagonal — reference: src/stats/reml.rs:316.
GRAM_RIDGE: float = 1e-6

# Cache directory override (reference: JANUSX_CACHE_DIR, gfreader.py:348).
CACHE_DIR_ENV: str = "JANUSX_CACHE_DIR"


def cache_dir_override() -> str | None:
    return os.environ.get(CACHE_DIR_ENV) or None


# Expert env-knob registry: name -> (type, default, help); None = "auto".
KNOBS: dict = {
    "JX_TPU_PLATFORM": (str, None, "device: cpu pins the CPU (plain PyTorch); anything else or unset means cuda (raises without a card)"),
    "JX_TPU_DEVICES": (int, None, "cap the number of devices used on the 'snp' mesh axis"),
    "JX_TPU_SNP_BLOCK": (int, 2048, "SNP rows per device block in streamed kernels"),
    "JX_TPU_SCAN_METHOD": (str, "grid", "LMM per-SNP lambda search: grid | brent"),
    "JX_TPU_SCAN_BRENT_TOL": (float, 1e-2, "per-SNP Brent tolerance (reference lmm.rs:334)"),
    "JX_TPU_SCAN_BRENT_MAX_ITER": (int, 50, "per-SNP Brent iteration cap"),
    "JX_TPU_GRID_POINTS": (int, 256, "shared log10-lambda grid size for the grid scan"),
    "JX_TPU_NULL_BRENT_TOL": (float, 1e-6, "null-REML Brent tolerance (reference reml.rs:650)"),
    "JX_TPU_NULL_BRENT_MAX_ITER": (int, 100, "null-REML Brent iteration cap"),
    "JX_TPU_LAMBDA_LOW": (float, -5.0, "log10 lambda search lower bound"),
    "JX_TPU_LAMBDA_HIGH": (float, 5.0, "log10 lambda search upper bound"),
    "JX_TPU_EIGH_BACKEND": (str, "host", "GRM eigendecomposition backend: host (LAPACK) | device (torch.linalg.eigh)"),
    "JX_TPU_GRM_FLUSH": (int, 16, "SNP blocks accumulated in f32 before each f64 flush in the GRM build"),
    "JX_TPU_GRID_MXU_PREC": (str, "highest", "lambda-lattice gram precision: highest (f32-accurate: exact bf16 pieces on the tensor cores, 6 passes) | default (the reference's default: products and weights rounded to bf16, 1 pass; selection-grade)"),
    "JX_TPU_ROTATE_PREC": (str, "highest", "decode+rotate precision: highest (f32-accurate: exact bf16 pieces on the tensor cores, 6 passes) | high (the reference's bf16x3, 3 passes; up to ~3e-5 matrix-relative from highest on an eigenbasis)"),
    "JX_TPU_GBLUP_MAX_N": (int, 15_000, "BLUP auto-dispatch: max train n for the GBLUP kernel route"),
    "JX_TPU_GS_EIGH32": (bool, False, "GS fold eighs in f32 (ssyevd, ~2x faster CV; lambda precision ~1e-5 in log10)"),
    "JX_TPU_RRBLUP_EXACT_MAX_M": (int, 15_000, "BLUP auto-dispatch: max markers for exact rrBLUP (else PCG)"),
    "JX_TPU_HE_PROBES": (int, 16, "Hutchinson probes in the streamed HE variance-component pre-fit"),
    "JX_TPU_HASH_DIM": (int, 2048, "signed-hash sketch buckets (-hash default dim)"),
    "JX_TPU_HASH_SEED": (int, 520, "signed-hash seed (reference default 520)"),
    "JX_TPU_CG_TOL": (float, 1e-8, "Jacobi-PCG convergence tolerance"),
    "JX_TPU_CG_MAX_ITER": (int, 1000, "Jacobi-PCG iteration cap"),
    "JX_TPU_SPARSE_CUTOFF": (float, 0.05, "sparse-GRM off-diagonal threshold (-splmm default)"),
    "JX_TPU_SPARSE_MAX_DENSE_COMP": (int, 4096, "largest kinship component eigendecomposed densely; bigger (percolated) ones take per-lambda sparse-LU factors"),
    "JX_TPU_ML_SITE_BUDGET": (int, 2000, "site subsample budget for the approximate-ML tree"),
    "JX_TPU_LOWMEM": (bool, False, "force the disk-backed windowed genotype path regardless of size"),
    "JX_TPU_LOWMEM_BYTES": (int, None, "packed-size threshold (bytes) above which inputs stream from disk"),
    "JX_TPU_HISTORY_DB": (str, "~/.janusx_tpu/history.db", "SQLite run-history location (0 disables)"),
    "JX_TPU_CACHE_BESIDE_SOURCE": (bool, False, "place ~name genotype caches next to the source (reference layout)"),
    "JANUSX_CACHE_DIR": (str, None, "cache directory override (reference-compatible name)"),
    "JX_TPU_PROGRESS": (bool, True, "stage progress lines in workflow logs (0 silences)"),
}


def knob(name: str):
    """Current value of an expert knob: env override if set, else default."""
    typ, default, _help = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    if typ is bool:
        return raw.strip().lower() not in ("0", "false", "off", "no")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    return raw


def choice_knob(name: str, allowed: tuple) -> str:
    """knob() for enumerated string knobs: unknown values raise."""
    v = str(knob(name)).lower()
    if v not in allowed:
        raise ValueError(
            f"{name}={v!r}: expected one of {', '.join(allowed)}")
    return v


def knob_table() -> list:
    """(name, current, default, overridden, help) rows for `jx env`."""
    return [(name, knob(name), default, os.environ.get(name) is not None, help_)
            for name, (_typ, default, help_) in KNOBS.items()]


def resolve_device(device=None):
    """The torch device a public function runs on.

    An explicit ``device`` wins; otherwise ``JX_TPU_PLATFORM`` decides
    (``cpu`` -> CPU, anything else -> ``cuda``). A CUDA device without a
    card raises instead of falling back to the CPU."""
    import torch

    if device is None:
        plat = (knob("JX_TPU_PLATFORM") or "cuda").strip().lower()
        device = "cpu" if plat == "cpu" else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "janusx_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False (set JX_TPU_PLATFORM=cpu "
            "to run the plain-PyTorch path on the CPU)")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def set_full_f32_matmul() -> None:
    """Full-f32 matmuls (no TF32): the reference runs the GRM CᵀC and the
    scan grams at Precision.HIGHEST (janusx_tpu/models/grm.py:94,
    core/reml.py:357,403-404); TF32 keeps ~3 decimal digits."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


NULL_BRENT_MAX_ITER = knob("JX_TPU_NULL_BRENT_MAX_ITER")
SCAN_BRENT_MAX_ITER = knob("JX_TPU_SCAN_BRENT_MAX_ITER")
SCAN_BRENT_TOL = knob("JX_TPU_SCAN_BRENT_TOL")
NULL_BRENT_TOL = knob("JX_TPU_NULL_BRENT_TOL")
LOG10_LAMBDA_LOW = knob("JX_TPU_LAMBDA_LOW")
LOG10_LAMBDA_HIGH = knob("JX_TPU_LAMBDA_HIGH")
