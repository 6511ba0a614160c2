"""Hand-written Hopper kernels, their wrappers and their plain-PyTorch
versions.

Two kernels carry the ``jx gwas -lmm`` scan (the JAX package's only two
``pl.pallas_call``s, janusx_tpu/ops/pallas_kernels.py):

- K1 ``decode_rotate``: R = decode_centered(packed, mean) @ U on the
  tensor cores, in the reference's two precision modes (csrc/rotate.cu;
  replaces ``decode_rotate_planar``);
- K2 ``grid_neg_reml_lattice``: the (trait x SNP x lambda) profiled -REML
  lattice on the tensor cores, in the reference's two precision modes
  (csrc/lattice.cu; replaces ``grid_neg_reml_lattice``, with the trait axis
  the reference loops over in Python).

Two more carry the Gibbs samplers of ``jx gs -BayesA/-BayesB/-BayesCpi``,
whose reference is an XLA loop with no Pallas (janusx_tpu/gs/bayes.py), one
sweep per iteration each (csrc/gibbs.cu: a pre-pass over every block, then
the serial pass over the blocks; one counted launch per sweep):

- G1 ``gibbs_sweep_marker``: the per-marker spike-and-slab sweep of
  BayesB and BayesCpi (``_gibbs``);
- G2 ``gibbs_sweep_block_mvn``: BayesA's joint draw of each marker block
  (``_gibbs_blocked_a``).

One carries the null REML fit of the dense LMM, whose reference is an XLA
loop with no Pallas (janusx_tpu/core/reml.py's fit_null_reml):

- N1 ``null_reml_brent``: each trait's whole lockstep Brent over log10 λ
  in one thread block, every trait of a launch at once (csrc/nullfit.cu).

One forms the LM scan's p on the card, which the JAX package forms on the
host with scipy (janusx_tpu/models/lm.py):

- T1 ``student_t_p``: the two-sided Student-t p of every SNP, a lane's
  whole continued fraction in one thread (csrc/tdist.cu).

All are CUDA C++ for ``sm_90a``, compiled with ``nvcc`` on first use into
``build/janusx_tpu_torch/`` (keyed on a hash of the sources and flags) and
bound with ``ctypes``. A wrapper takes its plain-PyTorch version only for
tensors on the CPU (for G1 and G2 the plain mirror of the kernel's
schedule); for a CUDA tensor it launches the kernel or raises. N1's plain
version is core.reml's torch Brent, which core.reml.fit_null_reml takes for
CPU states, so its wrapper takes CUDA tensors only.
Each wrapper counts its kernel launches as ``launch.<wrapper>`` in
utils.trace's table (``launch_counts``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.ops.decode import decode_centered
from janusx_tpu_torch.utils import trace

_PKG_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PKG_DIR / "csrc"
_BUILD_DIR = _PKG_DIR.parent / "build" / "janusx_tpu_torch"
_SOURCES = ("rotate.cu", "lattice.cu", "gibbs.cu", "nullfit.cu", "tdist.cu")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# ----------------------------------------------------------------- build
def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of janusx_tpu_torch are built on first use")


def library_path() -> Path:
    """Where the kernels' shared library for the current sources lives: a
    hash of the flags and of every file under csrc/ (headers included)."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for f in sorted(_CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return _BUILD_DIR / f"libjx_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless a library for these sources exists: one
    ``nvcc -c`` per source, all started together, then one link.
    Returns (path, seconds spent compiling). The compiler's resource
    report (-Xptxas -v) is kept beside the library as ``.log``."""
    so = library_path()
    if so.exists():
        return so, 0.0
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src + ".o") for src in _SOURCES]
        procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", obj, str(_CSRC / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(_SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        lib = os.path.join(tmp, "lib.so")
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run([nvcc, *_NVCC_FLAGS[:2], "-shared", "-o", lib, *objs],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
        so.with_suffix(".log").write_text("".join(logs))
        if not os.path.exists(lib):
            raise RuntimeError("nvcc failed:\n" + "".join(logs))
        os.replace(lib, so)
    return so, time.monotonic() - t0


@functools.cache
def _lib() -> ctypes.CDLL:
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    lib.jx_decode_rotate.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.jx_decode_rotate.restype = i
    lib.jx_grid_lattice.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, f, f, i, p]
    lib.jx_grid_lattice.restype = i
    lib.jx_gibbs_marker.argtypes = [p] * 15 + [i] * 5 + [p]
    lib.jx_gibbs_marker.restype = i
    lib.jx_gibbs_block_mvn.argtypes = [p] * 12 + [i] * 4 + [p]
    lib.jx_gibbs_block_mvn.restype = i
    lib.jx_gibbs_plan.argtypes = [i, i, i, p]
    lib.jx_gibbs_plan.restype = i
    lib.jx_gibbs_record_floats.argtypes = [i]
    lib.jx_gibbs_record_floats.restype = i
    lib.jx_null_reml_workspace.argtypes = [i]
    lib.jx_null_reml_workspace.restype = ctypes.c_longlong
    lib.jx_null_reml_brent.argtypes = [p] * 6 + [i] * 3 + [d] * 3 + [i] + [d] * 3 + [p]
    lib.jx_null_reml_brent.restype = i
    lib.jx_student_t_p.argtypes = [p, p, ctypes.c_longlong, d, d, p]
    lib.jx_student_t_p.restype = i
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
    """A kernel entry returns cudaGetLastError(); rotate.cu returns -1 for a
    missing tensor-map encoder and -(1000 + CUresult) for a refused map."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# ------------------------------------------------------------ K1 rotate
ROTATE_PRECS = ("highest", "high")
# U-split tile multiples: csrc/rotate.cu's BK (samples per stage) and BN
_ROT_BK = 64
_ROT_BN = 64


def split_bf16(x: torch.Tensor, pieces: int) -> list[torch.Tensor]:
    """x (f32) as ``pieces`` bf16-valued f32 tensors of the same shape, each
    the round-to-nearest bf16 of what the earlier ones left: three pieces
    sum back to x exactly (24 mantissa bits), two are the reference's
    hi/lo split (janusx_tpu/ops/pallas_kernels.py:88-91)."""
    out, r = [], x.to(torch.float32)
    for _ in range(pieces):
        p = r.to(torch.bfloat16).to(torch.float32)
        out.append(p)
        r = r - p
    return out


def split_u(U: torch.Tensor) -> torch.Tensor:
    """K1's B operand, made once per basis: U (K, N) f32 -> (3, Npad, Kpad)
    bf16, the three ``split_bf16`` pieces transposed to K-major, N and K
    zero-padded to multiples of the kernel's tiles (64 each)."""
    K, N = U.shape
    kpad = max(-(-K // _ROT_BK), 1) * _ROT_BK
    npad = max(-(-N // _ROT_BN), 1) * _ROT_BN
    out = torch.zeros((3, npad, kpad), dtype=torch.bfloat16, device=U.device)
    for i, p in enumerate(split_bf16(U, 3)):
        out[i, :N, :K] = p.T.to(torch.bfloat16)
    return out


def decode_rotate_plain(packed: torch.Tensor, mean: torch.Tensor,
                        U: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 "highest": f32 centered decode, then ``@ U``."""
    return decode_centered(packed, mean, torch.float32)[:, : U.shape[0]] @ U


def decode_rotate_high_plain(packed: torch.Tensor, mean: torch.Tensor,
                             U: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 "high", the reference's bf16x3
    (pallas_kernels.py:86-96): bf16 hi/lo of the centered value a and of
    U, and a_hi u_hi + a_hi u_lo + a_lo u_hi as f32 matmuls of bf16-valued
    tensors (every product exact)."""
    a_hi, a_lo = split_bf16(decode_centered(packed, mean, torch.float32)
                            [:, : U.shape[0]], 2)
    u_hi, u_lo = split_bf16(U, 2)
    return a_hi @ u_hi + a_hi @ u_lo + a_lo @ u_hi


def _rows16(packed: torch.Tensor) -> torch.Tensor:
    """K1 reads each row's bytes 16 at a time: packed as is when its rows
    are 16-byte multiples, contiguous and aligned, else a copy padded with
    0xFF (code 3, decodes to 0). The scan's rows are ceil(n/4) bytes and
    take the copy: on the card (~0.1 ms per superblock) it measured ~60 ms
    cheaper per 299k-SNP superblock than padding on the host before the
    upload (H100)."""
    M, nb = packed.shape
    if nb % 16 == 0 and packed.is_contiguous() and packed.data_ptr() % 16 == 0:
        return packed
    out = torch.full((M, -(-nb // 16) * 16), 0xFF, dtype=torch.uint8,
                     device=packed.device)
    out[:, :nb] = packed
    return out


def decode_rotate(packed: torch.Tensor, mean: torch.Tensor, U: torch.Tensor,
                  prec: str = "highest",
                  U_split: torch.Tensor | None = None,
                  row_align: int = 1) -> torch.Tensor:
    """R (M, N) f32 = decode_centered(packed (M, nb) u8, mean (M,) f32)
    @ U (K, N) f32 with K <= 4 nb: samples k >= K are ignored and U is in
    natural sample order (no plane-major permutation). ``prec`` is
    "highest" (f32-accurate) or "high" (the reference's bf16x3). On the
    card the kernel reads ``U_split = split_u(U)``; pass it to make the
    split once per basis instead of once per call. ``row_align`` = 4 makes
    the card's R a view of rows padded to 16 bytes, which K2 reads with
    16-byte loads."""
    if prec not in ROTATE_PRECS:
        raise ValueError(f"decode_rotate prec={prec!r}: expected one of {ROTATE_PRECS}")
    M, nb = packed.shape
    K, N = U.shape
    if K > 4 * nb or mean.shape != (M,):
        raise ValueError(f"decode_rotate: packed {tuple(packed.shape)}, "
                         f"mean {tuple(mean.shape)}, U {tuple(U.shape)}")
    if packed.device.type == "cpu":
        plain = decode_rotate_plain if prec == "highest" else decode_rotate_high_plain
        return plain(packed, mean, U)
    dev = packed.device
    _check(packed, "packed", torch.uint8, 2, dev)
    _check(mean, "mean", torch.float32, 1, dev)
    _check(U, "U", torch.float32, 2, dev)
    if U_split is None:
        U_split = split_u(U)
    _check(U_split, "U_split", torch.bfloat16, 3, dev)
    _, npad, kpad = U_split.shape
    if (U_split.shape[0] != 3 or npad < N or kpad < K or npad % _ROT_BN
            or kpad % _ROT_BK or not U_split.is_contiguous()):
        raise ValueError(f"decode_rotate: U_split {tuple(U_split.shape)} is not "
                         f"split_u of a ({K}, {N}) U")
    packed = _rows16(packed)
    out = torch.empty((M, -(-N // row_align) * row_align), dtype=torch.float32,
                      device=dev)[:, :N]
    with torch.cuda.device(dev):
        err = _lib().jx_decode_rotate(
            packed.data_ptr(), mean.data_ptr(), U_split.data_ptr(),
            out.data_ptr(), M, K, N, packed.stride(0), npad, kpad,
            out.stride(0), int(prec == "high"),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "decode_rotate")
    trace.count("launch.decode_rotate")
    return out


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


GRID_PRECS = ("highest", "default")
# W-split tile multiples: csrc/lattice.cu's BN (λ points per block) and BK
# (samples per stage)
_LAT_BN = 32
_LAT_BK = 64
# the sample order of split_w inside each 16-sample step: wgmma's A fragment
# gives thread t the columns 2t, 2t+1, 2t+8, 2t+9, which the kernel fills
# with the samples 4t..4t+3 (one 16-byte load), so column c of W's pieces
# holds sample _LAT_KPERM[c]
_LAT_KPERM = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)


def split_w(W: torch.Tensor) -> torch.Tensor:
    """K2's B operand, made once per scan: the grid weights W (G, n) f32 ->
    (3, Gpad, Kpad) bf16, the three ``split_bf16`` pieces (their sum is W
    exactly; the first is W rounded to bf16, all the "default" mode reads),
    G and n zero-padded to multiples of the kernel's tiles (32 and 64), each
    16-sample step in the order ``_LAT_KPERM``."""
    G, n = W.shape
    gpad = max(-(-G // _LAT_BN), 1) * _LAT_BN
    kpad = max(-(-n // _LAT_BK), 1) * _LAT_BK
    Wp = torch.zeros((gpad, kpad), dtype=torch.float32, device=W.device)
    Wp[:G, :n] = W
    Wp = Wp.view(gpad, kpad // 16, 16)[:, :, list(_LAT_KPERM)].reshape(gpad, kpad)
    return torch.stack([p.to(torch.bfloat16) for p in split_bf16(Wp, 3)]).contiguous()


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _lattice_one(Gr, Wt, y, X, SH, p: int, ridge: float, nf: float, rnd):
    """One trait's lattice, the reference's per-trait kernel call: the 2+p
    grams as f32 matmuls of ``rnd``(products) against Wᵀ, then the closed
    form on SH's rows."""
    agg = rnd(Gr * Gr) @ Wt
    agy = rnd(Gr * y) @ Wt
    axg = torch.stack([rnd(Gr * X[q]) @ Wt for q in range(p)], dim=-1)
    return neg_reml_closed_form(agg, agy, axg, *unpack_sh(SH, p), nf=nf,
                                ridge=ridge)


def grid_neg_reml_lattice_plain(Gr, W, YX, SH, p: int, ridge: float,
                                nf: float, prec: str = "highest") -> torch.Tensor:
    """Plain version of K2: the reference's loop over traits
    (janusx_tpu/models/lmm.py:578-591), one single-trait lattice each.
    "highest" forms the grams as f32 matmuls; "default" first rounds the
    products Gr*Gr, Gr*y_t, Gr*X_q and W to bf16, as the TPU's one-pass
    Precision.DEFAULT does (every product of two bf16 values is exact in
    f32, so both compute the kernel's function up to summation order).
    Shapes as grid_neg_reml_lattice's."""
    rnd = _bf16_round if prec == "default" else (lambda x: x)
    n = Gr.shape[1]
    Wt = rnd(W[:, :n]).T
    T = 1 if SH.dim() == 2 else SH.shape[0]
    X = YX[T:, :n]
    outs = [_lattice_one(Gr, Wt, YX[t, :n], X, SH.reshape(T, -1, SH.shape[-1])[t],
                         p, ridge, nf, rnd) for t in range(T)]
    return outs[0] if SH.dim() == 2 else torch.stack(outs)


def _lattice_yx(YX: torch.Tensor, T: int, p: int, n: int, kpad: int) -> torch.Tensor:
    """K2's YX operand: (tpad + p, kpad) f32, zero past n, the T trait rows
    padded with zero rows to whole chunks of min(T, 4) traits, then the p
    covariate rows."""
    tt = min(T, 4)
    tpad = -(-T // tt) * tt
    out = torch.zeros((tpad + p, kpad), dtype=torch.float32, device=YX.device)
    out[:T, :n] = YX[:T, :n]
    out[tpad:, :n] = YX[T:, :n]
    return out


def grid_neg_reml_lattice(Gr: torch.Tensor, W: torch.Tensor,
                          YX: torch.Tensor, SH: torch.Tensor, p: int,
                          ridge: float, nf: float, prec: str = "highest",
                          W_split: torch.Tensor | None = None) -> torch.Tensor:
    """f32 -REML lattice (+inf on invalid cells) of T traits that share the
    eigenbasis, the covariates and the λ grid, from rotated SNP rows Gr
    (B, n), grid weights W (G, >=n), YX (T + p, >=n) = [T trait rows yr_t,
    then the p Xr columns] and each trait's shared rows SH (T, 2p²+2p+3, G);
    p in 1..4. Returns (T, B, G). A single trait may pass SH as
    (2p²+2p+3, G) and YX as (1 + p, >=n), the reference's layout, and gets
    (B, G). ``prec`` is "highest" (f32-accurate grams) or "default" (the
    reference's one-pass bf16 grams). On the card the kernel reads
    ``W_split = split_w(W[:, :n])``; pass it to make the split once per
    scan instead of once per call."""
    if prec not in GRID_PRECS:
        raise ValueError(f"grid_neg_reml_lattice prec={prec!r}: expected one of "
                         f"{GRID_PRECS}")
    B, n = Gr.shape
    G = W.shape[0]
    T = 1 if SH.dim() == 2 else SH.shape[0]
    if not 1 <= p <= 4:
        raise ValueError(f"grid_neg_reml_lattice supports p <= 4, got p={p}")
    if (W.shape[1] < n or YX.shape[0] != T + p or YX.shape[1] < n
            or SH.shape[-2:] != (sh_rows(p), G) or SH.dim() not in (2, 3) or T < 1):
        raise ValueError(
            f"grid_neg_reml_lattice: Gr {tuple(Gr.shape)}, W {tuple(W.shape)},"
            f" YX {tuple(YX.shape)}, SH {tuple(SH.shape)}, p={p}")
    if Gr.device.type == "cpu":
        return grid_neg_reml_lattice_plain(Gr, W, YX, SH, p, ridge, nf, prec)
    dev = Gr.device
    for t, name in ((Gr, "Gr"), (W, "W"), (YX, "YX")):
        _check(t, name, torch.float32, 2, dev)
    _check(SH, "SH", torch.float32, SH.dim(), dev)
    if not SH.is_contiguous():
        raise ValueError("SH must be contiguous")
    if W_split is None:
        W_split = split_w(W[:, :n])
    _check(W_split, "W_split", torch.bfloat16, 3, dev)
    _, gpad, kpad = W_split.shape
    if (W_split.shape[0] != 3 or gpad != -(-G // _LAT_BN) * _LAT_BN or kpad < n
            or kpad % _LAT_BK or not W_split.is_contiguous()):
        raise ValueError(f"grid_neg_reml_lattice: W_split {tuple(W_split.shape)} "
                         f"is not split_w of a ({G}, {n}) W")
    YXp = _lattice_yx(YX, T, p, n, kpad)
    out = torch.empty((T, B, G), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().jx_grid_lattice(
            Gr.data_ptr(), W_split.data_ptr(), YXp.data_ptr(), SH.data_ptr(),
            out.data_ptr(), T, B, G, n, p, Gr.stride(0), kpad, kpad,
            float(ridge), float(nf - (p + 1)), int(prec == "default"),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "grid_neg_reml_lattice")
    trace.count("launch.grid_neg_reml_lattice")
    return out[0] if SH.dim() == 2 else out


# ------------------------------------------------- G1 / G2 Gibbs sweeps
# scal, the sweep's scalars on the device: [var_e, var_slab, pi, s0_b, vb_fill]
# (vb_fill = s0_b / (df0_b + 2), var_b's value on padding markers)
GIBBS_MARKER_METHODS = {"B": 1, "Cpi": 2}
GIBBS_CMAX = 128  # markers per block the kernels take (csrc/gibbs.cu CMAX)


def gibbs_sweep_marker_plain(Zb, Gb, x2, beta, var_b, rn, ru, rca, rci, r, scal,
                             method: str) -> torch.Tensor:
    """Plain version of G1: the reference's block scan of ``_gibbs``
    (janusx_tpu/gs/bayes.py:76-116) for BayesB / BayesCpi, marker by
    marker. Updates ``beta``, ``var_b`` (BayesB only) and ``r`` in place and
    returns δ (n_blocks, C)."""
    var_e, var_slab, pi, s0_b, vb_fill = scal.unbind()
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    delta = torch.zeros_like(beta)
    lp = torch.log(pi) - torch.log1p(-pi)
    for b in range(Zb.shape[0]):
        Z1, G1, x21, b_old = Zb[b], Gb[b], x2[b], beta[b].clone()
        vb_eff = var_b[b] if method == "B" else var_slab.expand_as(x21)
        rhs0 = Z1 @ r + x21 * b_old
        # the rhs-independent pieces of each step (bayes.py:88-90), per
        # marker, and every per-marker operand as a list of 0-d views
        Cj = x21 / var_e + 1.0 / vb_eff
        var = 1.0 / Cj
        vec = zip(*(v.unbind() for v in (rhs0, G1, Cj, var, torch.log(var), torch.log(vb_eff),
                                         torch.sqrt(var), ru[b], rn[b])))
        b_new = b_old.clone()
        for j, (rhs0_j, G1_j, Cj_j, var_j, lv_j, lb_j, sd_j, ru_j, rn_j) in enumerate(vec):
            # G1[j, j] (b_new[j] - b_old[j]) is 0 here: b_new[j] is not drawn yet
            mean = (rhs0_j - G1_j @ (b_new - b_old)) / var_e / Cj_j
            logbf = 0.5 * (mean * mean / var_j + lv_j - lb_j)
            d = ru_j < torch.sigmoid(lp + logbf)
            delta[b, j] = d
            b_new[j] = torch.where(d, mean + sd_j * rn_j, zero)
        b_new = torch.where(x21 > 0, b_new, zero)
        r.sub_((b_new - b_old) @ Z1)
        beta[b] = b_new
        if method == "B":
            vb = torch.where(delta[b] > 0, (s0_b + b_new * b_new) / rca[b], s0_b / rci[b])
            var_b[b] = torch.where(x21 > 0, vb, vb_fill)
    return delta


def gibbs_sweep_block_mvn_plain(Zb, Gb, x2, beta, var_b, z, rchi, r, scal) -> None:
    """Plain version of G2: the reference's block scan of
    ``_gibbs_blocked_a`` (janusx_tpu/gs/bayes.py:214-236), one Cholesky and
    three triangular solves per block. Updates ``beta``, ``var_b`` and ``r``
    in place."""
    var_e, _, _, s0_b, vb_fill = scal.unbind()
    C = Zb.shape[1]
    eye = torch.eye(C, dtype=torch.float32, device=r.device)
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    for b in range(Zb.shape[0]):
        Z1, G1, x21, b_old = Zb[b], Gb[b], x2[b], beta[b].clone()
        rhs = Z1 @ r + G1 @ b_old
        dinv = torch.where(x21 > 0, var_e / torch.clamp_min(var_b[b], 1e-12), 1.0)
        L = torch.linalg.cholesky(G1 + torch.diag(dinv) + 1e-4 * eye)
        mean = torch.linalg.solve_triangular(
            L.T, torch.linalg.solve_triangular(L, rhs[:, None], upper=False),
            upper=True)[:, 0]
        noise = torch.sqrt(var_e) * torch.linalg.solve_triangular(
            L.T, z[b][:, None], upper=True)[:, 0]
        b_new = torch.where(x21 > 0, mean + noise, zero)
        r.sub_((b_new - b_old) @ Z1)
        beta[b] = b_new
        var_b[b] = torch.where(x21 > 0, (s0_b + b_new * b_new) / rchi[b], vb_fill)


def gibbs_marker_prepass_plain(x2, beta, var_b, rn, ru, scal, method: str) -> dict:
    """Plain mirror of G1's pre-pass (csrc/gibbs.cu gibbs_marker_prep_kernel):
    every block's chain constants from the state carried into the sweep,
    each (n_blocks, C). With Cj = x2/σe² + 1/vb and var = 1/Cj: ``a`` =
    1/(σe² Cj), ``h`` = Cj a²/2, ``c`` = logit(π) + (log var − log vb)/2,
    ``thr`` = logit(u), ``sd_rn`` = √var · rn, so that marker j's step is
    mean = rhs·a, δ = h·rhs² + c > thr, b = δ and x2 > 0 ? mean + sd_rn : 0."""
    var_e, var_slab, pi = scal[0], scal[1], scal[2]
    vb = var_b if method == "B" else var_slab.expand_as(x2)
    cj = x2 / var_e + 1.0 / vb
    var = 1.0 / cj
    lp = torch.log(pi) - torch.log1p(-pi)
    a = 1.0 / (var_e * cj)
    return {"a": a, "h": 0.5 * cj * a * a,
            "c": lp + 0.5 * (torch.log(var) - torch.log(vb)),
            "thr": torch.log(ru) - torch.log1p(-ru), "sd_rn": torch.sqrt(var) * rn}


def gibbs_sweep_marker_hoisted_plain(Zb, Gb, x2, beta, var_b, rn, ru, rca, rci, r, scal,
                                     method: str) -> torch.Tensor:
    """Plain mirror of G1's schedule, the CPU path of ``gibbs_sweep_marker``:
    the constants of every block first (``gibbs_marker_prepass_plain``),
    then block by block the chain in the kernel's form: rhs = Z1 r + x2
    b_old; at marker j the step of ``gibbs_marker_prepass_plain``, db_j = b_j − b_old_j, and the later
    markers' right-hand sides take −G1[k, j] db_j; then r −= Z1ᵀ db. The
    same sweep as ``gibbs_sweep_marker_plain`` up to rounding. Updates
    ``beta``, ``var_b`` (BayesB only) and ``r`` in place; returns δ."""
    k = gibbs_marker_prepass_plain(x2, beta, var_b, rn, ru, scal, method)
    s0_b, vb_fill = scal[3], scal[4]
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    delta = torch.zeros_like(beta)
    for b in range(Zb.shape[0]):
        Z1, G1, x21, b_old = Zb[b], Gb[b], x2[b], beta[b].clone()
        rhs = Z1 @ r + x21 * b_old
        take = x21 > 0
        b_new, db = torch.zeros_like(b_old), torch.zeros_like(b_old)
        steps = zip(*(v.unbind() for v in (k["a"][b], k["h"][b], k["c"][b], k["thr"][b],
                                            k["sd_rn"][b], take, b_old)))
        for j, (a, h, c, thr, sd, real, bo) in enumerate(steps):
            mean = rhs[j] * a
            d = h * rhs[j] * rhs[j] + c > thr
            delta[b, j] = d
            b_new[j] = torch.where(d & real, mean + sd, zero)
            db[j] = b_new[j] - bo
            rhs[j + 1:] -= G1[j + 1:, j] * db[j]
        r.sub_(db @ Z1)
        beta[b] = b_new
        if method == "B":
            vb = torch.where(delta[b] > 0, (s0_b + b_new * b_new) / rca[b], s0_b / rci[b])
            var_b[b] = torch.where(take, vb, vb_fill)
    return delta


def gibbs_block_mvn_prepass_plain(Gb, x2, beta, var_b, z, scal):
    """Plain mirror of G2's pre-pass (csrc/gibbs.cu gibbs_mvn_prep_kernel),
    every block at once from the state carried into the sweep: Cb = G1 +
    diag(σe²/var_b) + 1e-4 I, L = chol(Cb), X = L⁻¹; returns M = Cb⁻¹ = XᵀX
    (n_blocks, C, C) and w = Xᵀ(X G1 b_old + √σe² z) (n_blocks, C), so a
    block's draw is M (Z1 r) + w: the reference's mean L⁻ᵀL⁻¹(Z1 r + G1
    b_old) plus noise √σe² L⁻ᵀ z."""
    var_e = scal[0]
    C = Gb.shape[1]
    eye = torch.eye(C, dtype=torch.float32, device=Gb.device)
    gbo = (Gb @ beta[..., None])[..., 0]
    dinv = torch.where(x2 > 0, var_e / torch.clamp_min(var_b, 1e-12), 1.0)
    L = torch.linalg.cholesky(Gb + torch.diag_embed(dinv) + 1e-4 * eye)
    X = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    Xt = X.transpose(1, 2)
    t = (X @ gbo[..., None])[..., 0] + torch.sqrt(var_e) * z
    return Xt @ X, (Xt @ t[..., None])[..., 0]


def gibbs_block_mvn_serial_plain(Zb, x2, beta, var_b, rchi, r, scal, M, w) -> None:
    """Plain mirror of G2's serial pass: per block u = Z1 r, b = M u + w (0
    where x2 = 0), r −= Z1ᵀ(b − b_old), var_b = (s0_b + b²)/χ² (its fill
    value where x2 = 0). Updates ``beta``, ``var_b`` and ``r`` in place."""
    s0_b, vb_fill = scal[3], scal[4]
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    for b in range(Zb.shape[0]):
        Z1, x21 = Zb[b], x2[b]
        b_new = torch.where(x21 > 0, M[b] @ (Z1 @ r) + w[b], zero)
        r.sub_((b_new - beta[b]) @ Z1)
        beta[b] = b_new
        var_b[b] = torch.where(x21 > 0, (s0_b + b_new * b_new) / rchi[b], vb_fill)


def gibbs_sweep_block_mvn_hoisted_plain(Zb, Gb, x2, beta, var_b, z, rchi, r, scal) -> None:
    """Plain mirror of G2's schedule, the CPU path of
    ``gibbs_sweep_block_mvn``: the pre-pass over every block, then the
    serial pass. The same sweep as ``gibbs_sweep_block_mvn_plain`` up to
    rounding."""
    M, w = gibbs_block_mvn_prepass_plain(Gb, x2, beta, var_b, z, scal)
    gibbs_block_mvn_serial_plain(Zb, x2, beta, var_b, rchi, r, scal, M, w)


# the serial pass's paths (jx_gibbs_plan)
GIBBS_PATHS = ("cluster", "grid", "chunked")
_GIBBS_ALG = {"marker": 1, "mvn": 2}


def gibbs_record_floats(kind: str) -> int:
    """Floats per block of the pre-pass's records for ``kind`` ("marker":
    G1, "mvn": G2), as the library lays them out (csrc/gibbs.cu)."""
    return _lib().jx_gibbs_record_floats(_GIBBS_ALG[kind])


def gibbs_plan(kind: str, n: int, C: int) -> dict:
    """The serial pass's plan on the current card for ``kind`` ("marker":
    G1, "mvn": G2) at n samples and C markers a block: its path
    ("cluster", "grid" or "chunked"), P CTAs of S samples (chunks of SC),
    whether the next block's rows are copied behind the current one, and
    the shared memory per CTA."""
    out = (ctypes.c_longlong * 7)()
    _raise_on(_lib().jx_gibbs_plan(_GIBBS_ALG[kind], n, C, out), "gibbs_plan")
    return {"path": GIBBS_PATHS[out[0]], "P": out[1], "S": out[2], "SC": out[3],
            "rows_prefetched": bool(out[5]), "smem_bytes": out[6]}


def gibbs_cluster_limit(kind: str, C: int = GIBBS_CMAX) -> int:
    """The largest n whose serial pass ``gibbs_plan`` puts on the cluster
    path on the current card; at one sample more it takes the grid path."""
    lo, hi = 1, 1 << 20
    if gibbs_plan(kind, lo, C)["path"] != "cluster":
        return 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if gibbs_plan(kind, mid, C)["path"] == "cluster" else (lo, mid)
    return lo


def gibbs_scratch(kind: str, nb: int, C: int, dev) -> dict:
    """The kernels' scratch: the pre-pass's records
    (``gibbs_record_floats`` a block: 39,424 bytes for G1, 67,584 for G2),
    and the grid path's
    partial Z1·r (two buffers of C floats per CTA, at most one CTA per SM)
    and barrier counter."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"rec": torch.empty(nb * gibbs_record_floats(kind), dtype=torch.float32, device=dev),
            "work": torch.empty(2 * sms * C, dtype=torch.float32, device=dev),
            "counter": torch.empty(1, dtype=torch.int32, device=dev)}


def _gibbs_check(Zb, Gb, x2, r, scal, vecs) -> tuple[int, int, int]:
    nb, C, n = Zb.shape
    if Gb.shape != (nb, C, C) or r.shape != (n,) or scal.shape != (5,) or any(
            v.shape != (nb, C) for v in (x2, *vecs)):
        raise ValueError(f"Gibbs sweep: Zb {tuple(Zb.shape)}, Gb {tuple(Gb.shape)}, "
                         f"r {tuple(r.shape)}, scal {tuple(scal.shape)}, "
                         f"per-marker {[tuple(v.shape) for v in (x2, *vecs)]}")
    if C > GIBBS_CMAX:
        raise ValueError(f"Gibbs kernels take blocks of at most {GIBBS_CMAX} markers, got {C}")
    dev = Zb.device
    for t in (Zb, Gb, x2, r, scal, *vecs):
        _check(t, "Gibbs operand", torch.float32, t.dim(), dev)
        if not t.is_contiguous():
            raise ValueError("Gibbs operands must be contiguous")
    return nb, C, n


def _gibbs_options(kind: str, nb: int, C: int, dev, phases: int, scratch) -> dict:
    if phases not in (1, 2, 3):
        raise ValueError(f"Gibbs sweep: phases={phases!r} (1|2|3)")
    if scratch is None:
        if phases != 3:
            raise ValueError("Gibbs sweep: a pre-pass or serial pass alone needs the "
                             "caller's scratch")
        scratch = gibbs_scratch(kind, nb, C, dev)
    return scratch


def gibbs_sweep_marker(Zb: torch.Tensor, Gb: torch.Tensor, x2: torch.Tensor,
                       beta: torch.Tensor, var_b: torch.Tensor, rn: torch.Tensor,
                       ru: torch.Tensor, rca: torch.Tensor, rci: torch.Tensor,
                       r: torch.Tensor, scal: torch.Tensor, method: str, *,
                       phases: int = 3, scratch=None) -> torch.Tensor:
    """One BayesB / BayesCpi Gibbs sweep over every marker block (G1): f32
    marker rows Zb (n_blocks, C, n), block Grams Gb (n_blocks, C, C), x2 =
    Σ Zb² (n_blocks, C), the sweep's draws rn, ru, rca, rci (n_blocks, C),
    the residual r (n,) and ``scal``. Updates beta, var_b (BayesB) and r in
    place; returns δ (n_blocks, C). On the card, ``phases`` 1 or 2 runs the
    pre-pass or the serial pass alone on the caller's ``scratch``
    (``gibbs_scratch``), to time them apart."""
    if method not in GIBBS_MARKER_METHODS:
        raise ValueError(f"gibbs_sweep_marker method={method!r}: expected one of "
                         f"{tuple(GIBBS_MARKER_METHODS)}")
    if Zb.device.type == "cpu":
        return gibbs_sweep_marker_hoisted_plain(Zb, Gb, x2, beta, var_b, rn, ru, rca, rci, r,
                                                scal, method)
    nb, C, n = _gibbs_check(Zb, Gb, x2, r, scal, (beta, var_b, rn, ru, rca, rci))
    dev = Zb.device
    sc = _gibbs_options("marker", nb, C, dev, phases, scratch)
    delta = torch.empty_like(beta)
    with torch.cuda.device(dev):
        err = _lib().jx_gibbs_marker(
            Zb.data_ptr(), Gb.data_ptr(), x2.data_ptr(), beta.data_ptr(), var_b.data_ptr(),
            delta.data_ptr(), rn.data_ptr(), ru.data_ptr(), rca.data_ptr(), rci.data_ptr(),
            r.data_ptr(), scal.data_ptr(), sc["rec"].data_ptr(), sc["work"].data_ptr(),
            sc["counter"].data_ptr(), nb, C, n, GIBBS_MARKER_METHODS[method], phases,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "gibbs_sweep_marker")
    trace.count("launch.gibbs_sweep_marker")
    return delta


def gibbs_sweep_block_mvn(Zb: torch.Tensor, Gb: torch.Tensor, x2: torch.Tensor,
                          beta: torch.Tensor, var_b: torch.Tensor, z: torch.Tensor,
                          rchi: torch.Tensor, r: torch.Tensor, scal: torch.Tensor, *,
                          phases: int = 3, scratch=None) -> None:
    """One blocked BayesA Gibbs sweep (G2): each block of C markers drawn
    jointly from N(Cb⁻¹ rhs, σe² Cb⁻¹), Cb = G1 + diag(σe²/var_b) + 1e-4 I,
    from the standard normals z and the χ² draws rchi (n_blocks, C); other
    operands and the keywords as gibbs_sweep_marker's. Updates beta, var_b
    and r in place."""
    if Zb.device.type == "cpu":
        return gibbs_sweep_block_mvn_hoisted_plain(Zb, Gb, x2, beta, var_b, z, rchi, r, scal)
    nb, C, n = _gibbs_check(Zb, Gb, x2, r, scal, (beta, var_b, z, rchi))
    dev = Zb.device
    sc = _gibbs_options("mvn", nb, C, dev, phases, scratch)
    with torch.cuda.device(dev):
        err = _lib().jx_gibbs_block_mvn(
            Zb.data_ptr(), Gb.data_ptr(), x2.data_ptr(), beta.data_ptr(), var_b.data_ptr(),
            z.data_ptr(), rchi.data_ptr(), r.data_ptr(), scal.data_ptr(), sc["rec"].data_ptr(),
            sc["work"].data_ptr(), sc["counter"].data_ptr(), nb, C, n, phases,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "gibbs_sweep_block_mvn")
    trace.count("launch.gibbs_sweep_block_mvn")


# ------------------------------------------------- N1 null REML Brent
def null_reml_brent(s: torch.Tensor, PXX: torch.Tensor, PXy: torch.Tensor,
                    Pyy: torch.Tensor, low: float = config.LOG10_LAMBDA_LOW,
                    high: float = config.LOG10_LAMBDA_HIGH,
                    tol: float = config.NULL_BRENT_TOL,
                    max_iter: int = config.NULL_BRENT_MAX_ITER) -> torch.Tensor:
    """The null REML fit of T traits that share the eigenvalues s (n,) and
    the covariate products PXX (n, p²), from each trait's PXy (T, n, p) and
    Pyy (T, n), all f64, contiguous and on one CUDA device
    (core.reml.RotatedData's fields): brent_minimize_batched's Brent over
    log10 λ in [low, high] on -REML, with ridge config.GRAM_RIDGE. Returns
    (T, 3) f64 on the device: log10 λ, -REML and ML at it. Its plain
    version is core.reml.fit_null_reml_plain, which core.reml.fit_null_reml
    takes for states on the CPU; this wrapper takes CUDA tensors only."""
    if s.dim() != 1 or PXy.dim() != 3:
        raise ValueError(f"null_reml_brent: s {tuple(s.shape)}, PXy {tuple(PXy.shape)}")
    T, n, p = PXy.shape
    if (T < 1 or p < 1 or n <= p or s.shape != (n,) or PXX.shape != (n, p * p)
            or Pyy.shape != (T, n)):
        raise ValueError(f"null_reml_brent: s {tuple(s.shape)}, PXX {tuple(PXX.shape)}, "
                         f"PXy {tuple(PXy.shape)}, Pyy {tuple(Pyy.shape)}")
    dev = s.device
    for t, name in ((s, "s"), (PXX, "PXX"), (PXy, "PXy"), (Pyy, "Pyy")):
        if t.dtype != torch.float64 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"null_reml_brent: {name} must be a contiguous float64 tensor "
                             f"on {dev}, got {t.dtype} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"null_reml_brent takes CUDA tensors, got {dev}; "
                         f"core.reml.fit_null_reml_plain fits states on the CPU")
    # the objectives' constants as core.reml computes them
    nf, nfp = float(n), float(n - p)
    c_reml = nfp * (math.log(nfp) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    c_ml = nf * (math.log(nf) - 1.0 - math.log(2.0 * math.pi)) / 2.0
    out = torch.empty((T, 3), dtype=torch.float64, device=dev)
    lib = _lib()
    # past the p whose work buffers fit in shared memory, a workspace per lane
    need = lib.jx_null_reml_workspace(p)
    ws = torch.empty((T, need), dtype=torch.float64, device=dev) if need else None
    with torch.cuda.device(dev):
        err = lib.jx_null_reml_brent(
            s.data_ptr(), PXX.data_ptr(), PXy.data_ptr(), Pyy.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), T, n, p, min(low, high), max(low, high),
            max(abs(tol), 1e-12), int(max_iter), float(config.GRAM_RIDGE), c_reml, c_ml,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "null_reml_brent")
    trace.count("launch.null_reml_brent")
    return out


# ------------------------------------------------- T1 Student-t p
# a continued fraction's terms checked for convergence every this many
# steps (one host sync each); it stops when every lane's factor has come
# within _CF_EPS of 1, or after _CF_MAX_STEPS
_CF_CHECK, _CF_EPS, _CF_MAX_STEPS = 8, 1e-15, 4096
_CF_TINY = 1e-300
_DBL_MIN = torch.finfo(torch.float64).tiny


def _off_zero(v: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(v) < _CF_TINY, _CF_TINY, v)


def _betacf_plain(a: float, b: float, x: torch.Tensor) -> torch.Tensor:
    """The continued fraction of the regularized incomplete beta I_x(a, b),
    by the modified Lentz method (Numerical Recipes 6.4, betacf), per lane;
    it converges fast for x < (a + 1) / (a + b + 2). The coefficients are
    host scalars, so a step is a few fused multiply-adds over the lanes. A
    lane is left as it is from the step whose factor first comes within
    _CF_EPS of 1: past it the factors only wander by the recurrence's
    rounding."""
    if x.numel() == 0:
        return x
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    one = torch.ones_like(x)
    c = one
    d = torch.reciprocal(_off_zero(torch.add(one, x, alpha=-qab / qap)))
    h = d
    done = torch.isnan(x)
    for m in range(1, _CF_MAX_STEPS + 1):
        m2 = 2.0 * m
        k = m * (b - m) / ((qam + m2) * (a + m2))
        d = torch.reciprocal(_off_zero(torch.addcmul(one, x, d, value=k)))
        c = _off_zero(torch.addcdiv(one, x, c, value=k))
        step = d * c
        k = -(a + m) * (qab + m) / ((a + m2) * (qap + m2))
        d = torch.reciprocal(_off_zero(torch.addcmul(one, x, d, value=k)))
        c = _off_zero(torch.addcdiv(one, x, c, value=k))
        last = d * c
        h = torch.where(done, h, h * step * last)
        done = done | (torch.abs(last - 1.0) <= _CF_EPS)
        if m % _CF_CHECK == 0 and bool(torch.all(done)):
            break
    return h


def student_t_p_plain(t: torch.Tensor, df: int) -> torch.Tensor:
    """Plain version of T1 (``student_t_p``): models.lm.student_t_p_two_sided
    as torch ops in f64, every lane's continued fraction a step at a time
    (csrc/tdist.cu's algorithm). 1 - x is formed from t, not from the
    rounded x, so near t = 0 this is closer to the t distribution's tail
    than the host's betainc; elsewhere the two agree to ~1e-11 relative at
    df in the thousands (the lgamma of the front factor)."""
    f64 = torch.float64
    t = t.to(f64)
    if df <= 0:
        return torch.full_like(t, float("nan"))
    a, b = df / 2.0, 0.5
    tt = t * t
    x = df / (df + tt)
    # 1 - x, without its cancellation near t = 0
    xc = torch.where(torch.isinf(tt), 1.0, tt / (df + tt))
    front = torch.exp(-_log_beta(a, b) - a * torch.log1p(tt / df) + b * torch.log(xc))
    # below the turning point I_x(a, b) by its own fraction; past it
    # 1 - I_{1-x}(b, a), whose fraction converges there
    swap = x >= (a + 1.0) / (a + b + 2.0)
    p = torch.empty_like(x)
    low = ~swap
    p[low] = front[low] * _betacf_plain(a, b, x[low]) / a
    p[swap] = 1.0 - front[swap] * _betacf_plain(b, a, xc[swap]) / b
    p = torch.where(torch.isfinite(p), p, 1.0)
    p = torch.clamp(p, _DBL_MIN, 1.0)
    p = torch.where(torch.isnan(t), t, p)
    return torch.where(torch.isinf(t), _DBL_MIN, p)


def _log_beta(a: float, b: float) -> float:
    return math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)


def student_t_p(t: torch.Tensor, df: int) -> torch.Tensor:
    """The two-sided Student-t p of t with df degrees of freedom, f64 on
    t's device (models.lm.student_t_p_two_sided's value and sanitize
    rules): T1 for a CUDA tensor, ``student_t_p_plain`` for one on the CPU.
    t is taken as f64."""
    t = t.to(torch.float64).contiguous()
    if t.device.type == "cpu" or df <= 0:
        return student_t_p_plain(t, df)
    if t.device.type != "cuda":
        raise ValueError(f"student_t_p: t is on {t.device}")
    p = torch.empty_like(t)
    with torch.cuda.device(t.device):
        err = _lib().jx_student_t_p(t.data_ptr(), p.data_ptr(), t.numel(), float(df),
                                    _log_beta(df / 2.0, 0.5),
                                    torch.cuda.current_stream(t.device).cuda_stream)
    _raise_on(err, "student_t_p")
    trace.count("launch.student_t_p")
    return p


_WRAPPERS = ("decode_rotate", "grid_neg_reml_lattice", "gibbs_sweep_marker",
             "gibbs_sweep_block_mvn", "null_reml_brent", "student_t_p")


def reset_launches() -> None:
    trace.reset("launch.")


def launch_counts() -> dict:
    """Every kernel's launch count, by wrapper name."""
    table = trace.counts()
    return {name: table.get("launch." + name, 0) for name in _WRAPPERS}
