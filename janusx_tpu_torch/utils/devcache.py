"""Host->device transfer cache (port of janusx_tpu/utils/devcache.py).

Repeated scans over the same trait/basis (multi-model runs, CV folds)
would otherwise re-upload identical large buffers (rotation matrix,
packed genotypes) on every call. Keyed by (id(array), layout, device) with
a weakref finalizer so entries die with their host array; an id() value
can only be reused after the original array is collected, by which time
the finalizer has evicted the stale entry.

Every upload (on a miss) adds its bytes to utils.trace's ``h2d_bytes``.

A panel that a scan streams in superblocks is held whole on the device
(``resident_packed_blocks``) while it fits beside what a scan carries, and
each superblock is served as a slice of it. The least recently used panel
makes way for a new one; one that cannot fit alone is not held. Chunks
that are not held are uploaded uncached (``upload_packed_blocks``,
``upload_blocks``).

With a ``mesh`` (parallel.mesh.Mesh) the SNP-axis uploads are sharded: the
padded host array is made once, split along ``shard_axis`` into one equal
slice per shard, and cached as the list of per-shard tensors under the
mesh's device tuple (as janusx_tpu keys by ``tuple(mesh.devices.flat)``).
A mesh may repeat a device, so a shard is never keyed by its device alone.
"""

from __future__ import annotations

import hashlib
import os
import weakref
from collections import OrderedDict

import numpy as np
import torch

from janusx_tpu_torch.utils import trace

_cache: dict = {}
# the resident panels' cache keys, least recently used first -> bytes per device
_resident: OrderedDict = OrderedDict()


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


def upload_packed_blocks(pg, shape: tuple, device: torch.device | None = None,
                         lane_align: int = 4, mesh=None, shard_axis: int = 1):
    """Lane-pad + row-pad (0xFF = code 3, decodes to 0) + reshape + upload
    a PackedGenotypes buffer as a pre-blocked uint8 tensor of ``shape`` +
    (bytes,), uncached, into memory of its own (never a view of the host
    buffer). With ``mesh`` the result is one tensor per shard,
    ``shard_axis`` (the per-block SNP axis) split into equal slices."""
    from janusx_tpu_torch.ops.decode import pad_packed_cols

    padded = pad_packed_cols(pg.packed, lane_align)
    m, nb = padded.shape
    m_pad = int(np.prod(shape))
    if mesh is None:
        # the rows copied straight to their place: no padded host copy
        dev = torch.empty((m_pad, nb), dtype=torch.uint8, device=device)
        dev[m:] = 0xFF
        dev[:m].copy_(torch.as_tensor(padded))
        return trace.uploaded(dev.view(shape + (nb,)))
    if m != m_pad:
        padded = np.concatenate([padded, np.full((m_pad - m, nb), 0xFF, np.uint8)])
    return _sharded(padded.reshape(shape + (nb,)), mesh, shard_axis)


def _packed_key(pg, shape, lane_align, shard_axis, device, mesh):
    return (id(pg.packed), "packedb", shape, lane_align, pg.packed.shape, shard_axis,
            _place_key(device, mesh))


def device_packed_blocks(pg, shape: tuple, device: torch.device | None = None,
                         lane_align: int = 4, mesh=None, shard_axis: int = 1):
    """``upload_packed_blocks``, cached on the identity of pg.packed."""
    key = _packed_key(pg, shape, lane_align, shard_axis, device, mesh)
    hit = _cache.get(key)
    if hit is not None:
        return hit
    return _remember(pg.packed, key, upload_packed_blocks(pg, shape, device, lane_align,
                                                          mesh, shard_axis))


def room(device) -> int:
    """Bytes a resident panel may take on ``device``. On a card: what is
    free there, the caching allocator's idle blocks included, less a
    quarter of the card's memory, which a scan's carry (the rotated rows,
    the lattices) needs beside the panel. On the CPU: half of the host's
    free memory."""
    device = torch.device(device)
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        idle = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        return free + idle - total // 4
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 2


def resident_packed_blocks(pg, shape: tuple, device: torch.device | None = None,
                           mesh=None, shard_axis: int = 1):
    """``device_packed_blocks`` of a whole in-memory panel, held while it
    fits: on a miss the least recently used resident panels are dropped
    until ``room`` takes this one on each of its devices. None when it
    cannot fit (nothing is uploaded)."""
    key = _packed_key(pg, shape, 4, shard_axis, device, mesh)
    if key not in _cache:
        nbytes = int(np.prod(shape)) * pg.packed.shape[1]
        need = ({torch.device(device or "cpu"): nbytes} if mesh is None else
                {d: nbytes // mesh.size * mesh.device_list.count(d) for d in mesh.distinct})
        while not all(room(d) >= b for d, b in need.items()):
            if not _resident:
                return None
            _cache.pop(_resident.popitem(last=False)[0], None)
        device_packed_blocks(pg, shape, device, mesh=mesh, shard_axis=shard_axis)
        _resident[key] = need
        weakref.finalize(pg.packed, _resident.pop, key, None)
    if key in _resident:
        _resident.move_to_end(key)
    return _cache[key]


def upload_blocks(arr: np.ndarray, shape: tuple, fill, dtype: torch.dtype,
                  device: torch.device | None = None, mesh=None, shard_axis: int = 1):
    """Pad the 1-D per-SNP array to prod(shape) with ``fill``, reshape,
    upload as ``dtype`` (one tensor per shard with ``mesh``, as
    upload_packed_blocks), uncached."""
    host = np.asarray(arr)
    m_pad = int(np.prod(shape))
    if host.shape[0] != m_pad:
        pad = np.full((m_pad - host.shape[0],) + host.shape[1:], fill, host.dtype)
        host = np.concatenate([host, pad])
    host = host.reshape(shape)
    return (trace.uploaded(torch.as_tensor(host).to(dtype).to(device)) if mesh is None
            else _sharded(host, mesh, shard_axis, dtype))


def to_device_blocks(arr: np.ndarray, shape: tuple, fill, dtype: torch.dtype,
                     device: torch.device | None = None, mesh=None,
                     shard_axis: int = 1):
    """``upload_blocks``, cached on the identity of ``arr``."""
    arr = np.asarray(arr)
    key = (id(arr), "blocks", shape, fill, dtype, arr.shape, shard_axis,
           _place_key(device, mesh))
    hit = _cache.get(key)
    if hit is not None:
        return hit
    return _remember(arr, key, upload_blocks(arr, shape, fill, dtype, device, mesh,
                                             shard_axis))


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
