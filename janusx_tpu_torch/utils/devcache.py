"""Host->device transfer cache (port of janusx_tpu/utils/devcache.py).

Repeated scans over the same trait/basis (multi-model runs, CV folds)
would otherwise re-upload identical large buffers (rotation matrix,
packed genotypes) on every call. Keyed by (id(array), layout, device) with
a weakref finalizer so entries die with their host array; an id() value
can only be reused after the original array is collected, by which time
the finalizer has evicted the stale entry.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

_cache: dict = {}


def _remember(src, key, dev: torch.Tensor) -> torch.Tensor:
    try:
        weakref.finalize(src, _cache.pop, key, None)
        _cache[key] = dev
    except TypeError:
        pass  # not weakref-able; skip caching
    return dev


def to_device(arr: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """torch.as_tensor(arr, dtype, device), cached on the source array."""
    key = (id(arr), "plain", dtype, arr.shape, str(device))
    hit = _cache.get(key)
    if hit is not None:
        return hit
    dev = torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype, device=device)
    return _remember(arr, key, dev)


def device_packed_blocks(pg, shape: tuple, device: torch.device,
                         lane_align: int = 4) -> torch.Tensor:
    """Lane-pad + row-pad (0xFF = code 3, decodes to 0) + reshape + upload
    a PackedGenotypes buffer as a pre-blocked uint8 tensor of ``shape`` +
    (bytes,), cached on the identity of pg.packed."""
    from janusx_tpu_torch.ops.decode import pad_packed_cols

    src = pg.packed
    m_pad = int(np.prod(shape))
    key = (id(src), "packedb", shape, lane_align, src.shape, str(device))
    hit = _cache.get(key)
    if hit is not None:
        return hit
    padded = pad_packed_cols(src, lane_align)
    if padded.shape[0] != m_pad:
        pad = np.full((m_pad - padded.shape[0], padded.shape[1]), 0xFF, np.uint8)
        padded = np.concatenate([padded, pad])
    host = padded.reshape(shape + (padded.shape[1],))
    return _remember(src, key, torch.as_tensor(host, device=device))


def to_device_blocks(arr: np.ndarray, shape: tuple, fill, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """Pad the 1-D per-SNP array to prod(shape) with ``fill``, reshape,
    upload as ``dtype``. Cached on source identity."""
    arr = np.asarray(arr)
    m_pad = int(np.prod(shape))
    key = (id(arr), "blocks", shape, fill, dtype, arr.shape, str(device))
    hit = _cache.get(key)
    if hit is not None:
        return hit
    host = arr
    if host.shape[0] != m_pad:
        pad = np.full((m_pad - host.shape[0],) + host.shape[1:], fill, host.dtype)
        host = np.concatenate([host, pad])
    dev = torch.as_tensor(host.reshape(shape)).to(dtype).to(device)
    return _remember(arr, key, dev)
