"""Host->device transfer cache (port of janusx_tpu/utils/devcache.py).

Repeated scans over the same trait/basis (multi-model runs, CV folds)
would otherwise re-upload identical large buffers (rotation matrix,
packed genotypes) on every call. Keyed by (id(array), layout, device) with
a weakref finalizer so entries die with their host array; an id() value
can only be reused after the original array is collected, by which time
the finalizer has evicted the stale entry.

Every upload (on a miss) adds its bytes to utils.trace's ``h2d_bytes``.

With a ``mesh`` (parallel.mesh.Mesh) the SNP-axis uploads are sharded: the
padded host array is made once, split along ``shard_axis`` into one equal
slice per shard, and cached as the list of per-shard tensors under the
mesh's device tuple (as janusx_tpu keys by ``tuple(mesh.devices.flat)``).
A mesh may repeat a device, so a shard is never keyed by its device alone.
"""

from __future__ import annotations

import hashlib
import weakref

import numpy as np
import torch

from janusx_tpu_torch.utils import trace

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
    dev = trace.uploaded(torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                                         device=device))
    return _remember(arr, key, dev)


def derived(src, tag, device, make):
    """``make()`` (device tensors, or host arrays, derived from ``src``),
    cached on the identity of ``src`` under ``tag`` and ``device``."""
    key = (id(src), tag, str(device))
    hit = _cache.get(key)
    if hit is not None:
        return hit
    return _remember(src, key, make())


def digest(arr) -> bytes | None:
    """A content key of a host array (None for None): blake2b of its f64
    values and shape, a strong digest (a collision would serve stale state)."""
    if arr is None:
        return None
    a = np.ascontiguousarray(arr, np.float64)
    return hashlib.blake2b(a.tobytes() + str(a.shape).encode(), digest_size=16).digest()


def _sharded(host: np.ndarray, mesh, shard_axis: int, dtype=None) -> list:
    """``host`` split along ``shard_axis`` into mesh.size equal slices,
    shard i's slice uploaded to its device."""
    D = mesh.size
    w = host.shape[shard_axis] // D
    if w * D != host.shape[shard_axis]:
        raise ValueError(f"axis {shard_axis} of {host.shape} is not divisible by "
                         f"the mesh size {D}")
    out = []
    for i, dev in enumerate(mesh.device_list):
        part = np.ascontiguousarray(np.take(host, np.arange(i * w, (i + 1) * w),
                                            axis=shard_axis))
        t = torch.as_tensor(part)
        out.append((t if dtype is None else t.to(dtype)).to(dev))
    return trace.uploaded(out)


def _place_key(device, mesh):
    return str(device) if mesh is None else ("mesh", mesh.key)


def device_packed_blocks(pg, shape: tuple, device: torch.device | None = None,
                         lane_align: int = 4, mesh=None, shard_axis: int = 1):
    """Lane-pad + row-pad (0xFF = code 3, decodes to 0) + reshape + upload
    a PackedGenotypes buffer as a pre-blocked uint8 tensor of ``shape`` +
    (bytes,), cached on the identity of pg.packed. With ``mesh`` the
    result is one tensor per shard, ``shard_axis`` (the per-block SNP axis)
    split into equal slices."""
    from janusx_tpu_torch.ops.decode import pad_packed_cols

    src = pg.packed
    m_pad = int(np.prod(shape))
    key = (id(src), "packedb", shape, lane_align, src.shape, shard_axis,
           _place_key(device, mesh))
    hit = _cache.get(key)
    if hit is not None:
        return hit
    padded = pad_packed_cols(src, lane_align)
    if padded.shape[0] != m_pad:
        pad = np.full((m_pad - padded.shape[0], padded.shape[1]), 0xFF, np.uint8)
        padded = np.concatenate([padded, pad])
    host = padded.reshape(shape + (padded.shape[1],))
    dev = (trace.uploaded(torch.as_tensor(host, device=device)) if mesh is None
           else _sharded(host, mesh, shard_axis))
    return _remember(src, key, dev)


def to_device_blocks(arr: np.ndarray, shape: tuple, fill, dtype: torch.dtype,
                     device: torch.device | None = None, mesh=None,
                     shard_axis: int = 1):
    """Pad the 1-D per-SNP array to prod(shape) with ``fill``, reshape,
    upload as ``dtype`` (one tensor per shard with ``mesh``, as
    device_packed_blocks). Cached on source identity."""
    arr = np.asarray(arr)
    m_pad = int(np.prod(shape))
    key = (id(arr), "blocks", shape, fill, dtype, arr.shape, shard_axis,
           _place_key(device, mesh))
    hit = _cache.get(key)
    if hit is not None:
        return hit
    host = arr
    if host.shape[0] != m_pad:
        pad = np.full((m_pad - host.shape[0],) + host.shape[1:], fill, host.dtype)
        host = np.concatenate([host, pad])
    host = host.reshape(shape)
    dev = (trace.uploaded(torch.as_tensor(host).to(dtype).to(device)) if mesh is None
           else _sharded(host, mesh, shard_axis, dtype))
    return _remember(arr, key, dev)


def replica(tree, device: torch.device):
    """Every tensor leaf of ``tree`` (tensors, tuples, NamedTuples, lists,
    dicts) copied to ``device``; other leaves are shared."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replica(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replica(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: replica(v, device) for k, v in tree.items()}
    return tree


def replicate_tree(tree, mesh):
    """``tree`` on every shard of ``mesh``: one copy per distinct device,
    listed per shard (no-op without a mesh)."""
    if mesh is None:
        return tree
    copies = {d: replica(tree, d) for d in mesh.distinct}
    return [copies[d] for d in mesh.device_list]
