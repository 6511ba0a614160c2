"""State carried across from janusx_tpu to the port.

The reference's ``RotatedData`` / ``GridShared`` / ``SpectralBasis`` /
``NullFit`` are read field by field through ``np.asarray`` (so this module
never imports JAX) and rebuilt as the port's, keeping each field's dtype;
the multi-trait scan's stacked state (a leading trait axis on every field)
comes across as the port's per-trait lists. The fitted GS objects (``GblupModel``,
``MultiKernelModel``, ``HeFit``, ``TopModel``) come across field by field
as host arrays, in either direction. The parity tests use these to run
both packages from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.core.reml import GridShared, NullFit, RotatedData
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


def null_from_numpy(null) -> NullFit:
    """janusx_tpu.core.reml.NullFit -> the port's (Python floats)."""
    return NullFit(*(float(getattr(null, f)) for f in NullFit._fields))


def _host_copy(value):
    """A field of a fitted GS object as host data: arrays (numpy or any
    array type) as numpy arrays of their own dtype, dicts and lists item
    by item, scalars and strings as they are."""
    if isinstance(value, dict):
        return {k: _host_copy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_host_copy(v) for v in value)
    if value is None or isinstance(value, (str, bool, int, float)):
        return value
    arr = np.asarray(value)
    return arr.item() if arr.ndim == 0 and not isinstance(value, np.ndarray) else arr.copy()


def gs_fit_as(obj, cls):
    """A fitted GS dataclass of one package as ``cls`` of the other, field
    by field: janusx_tpu.gs.blup.GblupModel / MultiKernelModel,
    janusx_tpu.models.he.HeFit and janusx_tpu.gs.top.TopModel become the
    port's (janusx_tpu_torch.gs.blup, .models.he, .gs.top), and the port's
    become the reference's the same way."""
    import dataclasses

    return cls(**{f.name: _host_copy(getattr(obj, f.name)) for f in dataclasses.fields(cls)})


def unstack_from_numpy(stacked, convert, device=None) -> list:
    """A reference NamedTuple with a leading trait axis on every field (the
    stacked ``rots``/``shs`` of janusx_tpu's lmm_scan_multi) -> the port's
    per-trait list, each converted by ``convert`` (rotated_from_numpy or
    grid_shared_from_numpy)."""
    T = np.asarray(stacked[0]).shape[0]
    cls = type(stacked)
    return [convert(cls(*(np.asarray(f)[t] for f in stacked)), device) for t in range(T)]
