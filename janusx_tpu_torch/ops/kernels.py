"""Hand-written Hopper kernels of the LMM scan, their wrappers and their
plain-PyTorch versions.

Two kernels carry the ``jx gwas -lmm`` scan (the JAX package's only two
``pl.pallas_call``s, janusx_tpu/ops/pallas_kernels.py):

- K1 ``decode_rotate``: R = decode_centered(packed, mean) @ U
  (csrc/rotate.cu; replaces ``decode_rotate_planar``);
- K2 ``grid_neg_reml_lattice``: the (SNP x lambda) profiled -REML lattice
  (csrc/lattice.cu; replaces ``grid_neg_reml_lattice``).

Both are CUDA C++ for ``sm_90a``, compiled with ``nvcc`` on first use into
``build/janusx_tpu_torch/`` (keyed on a hash of the sources and flags) and
bound with ``ctypes``. A wrapper takes its plain-PyTorch version only for
tensors on the CPU; for a CUDA tensor it launches the kernel or raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.ops.decode import decode_centered

_PKG_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PKG_DIR / "csrc"
_BUILD_DIR = _PKG_DIR.parent / "build" / "janusx_tpu_torch"
_SOURCES = ("rotate.cu", "lattice.cu")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# ----------------------------------------------------------------- build
def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of janusx_tpu_torch are built on first use")


def library_path() -> Path:
    """Where the kernels' shared library for the current sources lives."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    return _BUILD_DIR / f"libjx_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless a library for these sources exists.
    Returns (path, seconds spent compiling). The compiler's resource
    report (-Xptxas -v) is kept beside the library as ``.log``."""
    so = library_path()
    if so.exists():
        return so, 0.0
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *_NVCC_FLAGS, "-o", tmp, *(str(_CSRC / s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so, time.monotonic() - t0


@functools.cache
def _lib() -> ctypes.CDLL:
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.jx_decode_rotate.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.jx_decode_rotate.restype = i
    lib.jx_grid_lattice.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, f, p]
    lib.jx_grid_lattice.restype = i
    return lib


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D {dtype}, got "
                         f"{t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.numel() and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last axis must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# ------------------------------------------------------------ K1 rotate
def decode_rotate_plain(packed: torch.Tensor, mean: torch.Tensor,
                        U: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: f32 centered decode, then ``@ U``."""
    return decode_centered(packed, mean, torch.float32)[:, : U.shape[0]] @ U


def decode_rotate(packed: torch.Tensor, mean: torch.Tensor, U: torch.Tensor,
                  prec: str = "highest") -> torch.Tensor:
    """R (M, N) f32 = decode_centered(packed (M, nb) u8, mean (M,) f32)
    @ U (K, N) f32 with K <= 4 nb: samples k >= K are ignored and U is in
    natural sample order (no plane-major permutation)."""
    if prec != "highest":
        raise NotImplementedError(
            f"decode_rotate prec={prec!r}: only 'highest' (full f32) is "
            "ported; the reduced-precision mode is a ROADMAP item (K1 prec)")
    M, nb = packed.shape
    K, N = U.shape
    if K > 4 * nb or mean.shape != (M,):
        raise ValueError(f"decode_rotate: packed {tuple(packed.shape)}, "
                         f"mean {tuple(mean.shape)}, U {tuple(U.shape)}")
    if packed.device.type == "cpu":
        return decode_rotate_plain(packed, mean, U)
    dev = packed.device
    _check(packed, "packed", torch.uint8, 2, dev)
    _check(mean, "mean", torch.float32, 1, dev)
    _check(U, "U", torch.float32, 2, dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().jx_decode_rotate(
            packed.data_ptr(), mean.data_ptr(), U.data_ptr(), out.data_ptr(),
            M, K, N, packed.stride(0), U.stride(0), out.stride(0),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "decode_rotate")
    decode_rotate.launches += 1
    return out


decode_rotate.launches = 0


# ------------------------------------------------------- K2 λ-lattice
# SH (2p²+2p+3, G) f32 row layout shared by the kernel (csrc/lattice.cu
# O_* offsets), pack_sh and unpack_sh:
#   [Ar_inv (p²), Ainv_axy (p), Axx (p²), axy (p), ayy, logdetAr, logdetV]
def sh_rows(p: int) -> int:
    return 2 * p * p + 2 * p + 3


def pack_sh(Ar_inv, Ainv_axy, Axx, axy, ayy, logdetAr, logdetV) -> torch.Tensor:
    """Per-λ shared pieces ((G,p,p), (G,p), (G,p,p), (G,p), (G,), (G,), (G,))
    -> the kernel's (2p²+2p+3, G) f32 SH operand."""
    G, p = Ainv_axy.shape
    return torch.cat([
        Ar_inv.reshape(G, p * p).T, Ainv_axy.T, Axx.reshape(G, p * p).T,
        axy.T, ayy[None], logdetAr[None], logdetV[None],
    ], dim=0).to(torch.float32).contiguous()


def unpack_sh(SH: torch.Tensor, p: int):
    """Inverse of pack_sh."""
    G = SH.shape[1]
    o = [0, p * p, p * p + p, 2 * p * p + p, 2 * p * p + 2 * p]
    return (SH[o[0]:o[1]].T.reshape(G, p, p), SH[o[1]:o[2]].T,
            SH[o[2]:o[3]].T.reshape(G, p, p), SH[o[3]:o[4]].T,
            SH[o[4]], SH[o[4] + 1], SH[o[4] + 2])


def neg_reml_closed_form(agg, agy, axg, Ar_inv, Ainv_axy, Axx, axy, ayy,
                         logdetAr, logdetV, nf: float,
                         ridge: float = config.GRAM_RIDGE) -> torch.Tensor:
    """Profiled -REML per (SNP, λ) cell from the per-SNP grams (agg, agy
    (B, G), axg (B, G, p)) and the per-λ shared f32 pieces: the Schur
    complement of the ridged covariate Gram, in f32, +inf on invalid cells
    (the lattice half of janusx_tpu/core/reml.py:grid_argmin_schur)."""
    p = axg.shape[-1]
    f32 = torch.float32
    u = torch.einsum("gpq,bgq->bgp", Ar_inv, axg)
    schur = (agg + torch.tensor(ridge, dtype=f32, device=agg.device)) \
        - torch.einsum("bgp,bgp->bg", axg, u)
    beta_g = (agy - torch.einsum("bgp,gp->bg", axg, Ainv_axy)) / schur
    beta_X = Ainv_axy[None] - beta_g[..., None] * u
    lin = torch.einsum("bgp,gp->bg", beta_X, axy) + beta_g * agy
    quad = (torch.einsum("bgp,gpq,bgq->bg", beta_X, Axx, beta_X)
            + 2.0 * beta_g * torch.einsum("bgp,bgp->bg", axg, beta_X)
            + beta_g * beta_g * agg)
    rtwr = ayy[None] - 2.0 * lin + quad
    nfp = torch.tensor(nf - (p + 1), dtype=f32, device=agg.device)
    neg = 0.5 * (nfp * torch.log(rtwr) + logdetV[None]
                 + (logdetAr[None] + torch.log(schur)))
    bad = ~torch.isfinite(neg) | (rtwr <= 0) | (schur <= 0)
    return torch.where(bad, torch.tensor(float("inf"), dtype=f32,
                                         device=neg.device), neg)


def grid_neg_reml_lattice_plain(Gr, W, YX, SH, p: int, ridge: float,
                                nf: float) -> torch.Tensor:
    """Plain version of K2: the 2+p grams as f32 matmuls against Wᵀ, then
    the closed form on the unpacked SH rows."""
    n = Gr.shape[1]
    Wt = W[:, :n].T
    agg = (Gr * Gr) @ Wt
    agy = (Gr * YX[0, :n]) @ Wt
    axg = torch.stack([(Gr * YX[1 + q, :n]) @ Wt for q in range(p)], dim=-1)
    return neg_reml_closed_form(agg, agy, axg, *unpack_sh(SH, p), nf=nf,
                                ridge=ridge)


def grid_neg_reml_lattice(Gr: torch.Tensor, W: torch.Tensor,
                          YX: torch.Tensor, SH: torch.Tensor, p: int,
                          ridge: float, nf: float) -> torch.Tensor:
    """(B, G) f32 -REML lattice (+inf on invalid cells) from rotated SNP
    rows Gr (B, n), grid weights W (G, >=n), YX (1+p, >=n) = [yr, Xr
    columns] and SH (2p²+2p+3, G); p in 1..4."""
    B, n = Gr.shape
    G = W.shape[0]
    if not 1 <= p <= 4:
        raise ValueError(f"grid_neg_reml_lattice supports p <= 4, got p={p}")
    if (W.shape[1] < n or YX.shape[0] != 1 + p or YX.shape[1] < n
            or SH.shape != (sh_rows(p), G)):
        raise ValueError(
            f"grid_neg_reml_lattice: Gr {tuple(Gr.shape)}, W {tuple(W.shape)},"
            f" YX {tuple(YX.shape)}, SH {tuple(SH.shape)}, p={p}")
    if Gr.device.type == "cpu":
        return grid_neg_reml_lattice_plain(Gr, W, YX, SH, p, ridge, nf)
    dev = Gr.device
    for t, name in ((Gr, "Gr"), (W, "W"), (YX, "YX"), (SH, "SH")):
        _check(t, name, torch.float32, 2, dev)
    if not SH.is_contiguous():
        raise ValueError("SH must be contiguous")
    out = torch.empty((B, G), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().jx_grid_lattice(
            Gr.data_ptr(), W.data_ptr(), YX.data_ptr(), SH.data_ptr(),
            out.data_ptr(), B, G, n, p, Gr.stride(0), W.stride(0),
            YX.stride(0), float(ridge), float(nf - (p + 1)),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "grid_neg_reml_lattice")
    grid_neg_reml_lattice.launches += 1
    return out


grid_neg_reml_lattice.launches = 0


def reset_launches() -> None:
    decode_rotate.launches = 0
    grid_neg_reml_lattice.launches = 0
