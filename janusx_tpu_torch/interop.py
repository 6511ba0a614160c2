"""State carried across from janusx_tpu to the port.

The reference's ``RotatedData`` / ``GridShared`` / ``SpectralBasis`` are
read field by field through ``np.asarray`` (so this module never imports
JAX) and rebuilt as the port's tensors, keeping each field's dtype. The
parity tests use these to run both packages from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.core.reml import GridShared, RotatedData
from janusx_tpu_torch.core.spectral import SpectralBasis


def _fields(obj, cls, device):
    dev = config.resolve_device(device)
    return cls(*(torch.tensor(np.asarray(getattr(obj, f)), device=dev)
                 for f in cls._fields))


def rotated_from_numpy(rot, device=None) -> RotatedData:
    """janusx_tpu.core.reml.RotatedData (f64 fields) -> the port's."""
    return _fields(rot, RotatedData, device)


def grid_shared_from_numpy(sh, device=None) -> GridShared:
    """janusx_tpu.core.reml.GridShared (f64 grid, f32 pieces) -> the port's."""
    return _fields(sh, GridShared, device)


def basis_from_numpy(basis) -> SpectralBasis:
    """janusx_tpu.core.spectral.SpectralBasis -> the port's (host arrays)."""
    return SpectralBasis(S=np.asarray(basis.S, np.float64),
                         U=np.asarray(basis.U, np.float64))
