"""Eigendecomposition of the GRM (port of janusx_tpu/core/spectral.py).

Backends:
- "host": scipy.linalg.eigh in float64 (LAPACK dsyevd) — the default,
  the reference's accuracy; U then ships to the device once per scan.
- "device": torch.linalg.eigh in float64 on the resolved device.

Rotation convention: K = U diag(S) U^T with S ascending; rotated vectors
are U^T v; rotated SNP-major genotype blocks are G @ U.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.linalg
import torch

from janusx_tpu_torch import config


@dataclass
class SpectralBasis:
    """Eigenbasis of the (ridged) GRM restricted to analysis samples."""

    S: np.ndarray  # (n,) eigenvalues, ascending
    U: np.ndarray  # (n, n) eigenvectors (columns)

    @property
    def n(self) -> int:
        return len(self.S)


def eigh_grm(
    K: np.ndarray,
    diag_ridge: float = 1e-6,
    backend: str | None = None,
    device=None,
) -> SpectralBasis:
    if backend is None:
        backend = config.knob("JX_TPU_EIGH_BACKEND")
    K = np.asarray(K, dtype=np.float64)
    if diag_ridge:
        K = K + diag_ridge * np.eye(K.shape[0])
    if backend == "device":
        dev = config.resolve_device(device)
        S, U = torch.linalg.eigh(torch.as_tensor(K, dtype=torch.float64, device=dev))
        return SpectralBasis(S.cpu().numpy(), U.cpu().numpy())
    if backend != "host":
        raise ValueError(f"JX_TPU_EIGH_BACKEND={backend!r}: expected host or device")
    S, U = scipy.linalg.eigh(
        K, driver="evd", check_finite=False, overwrite_a=bool(diag_ridge)
    )
    return SpectralBasis(S, U)
