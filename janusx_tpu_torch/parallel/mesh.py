"""Device mesh layer (port of janusx_tpu/parallel/mesh.py).

A 1-D ``snp`` mesh over an ordered tuple of torch devices:

- GWAS scans split the SNP axis into one equal slice per shard; each
  shard scans its rows on its own device (per-SNP statistics are
  independent), and the per-SNP outputs are gathered back in SNP order;
- the GRM build splits the SNP axis the same way; each shard accumulates
  its partial CᵀC on its device and the partials are summed once;
- the eigenbasis and the rotated null-model state are replicated, one
  copy per distinct device, shared by that device's shards.

PyTorch has no sharded array: the reference's ``snp_sharding`` and
``replicated`` (``NamedSharding`` specs) have no counterpart here. A
sharded operand is a list of tensors, one per shard, and a replicated one
a list whose entries on the same device are the same tensor.

``Mesh(...)`` built directly may repeat a device, the twin of the
reference tests' forced host device count (``tests/conftest.py``): eight
``cpu`` entries shard over one CPU, two ``cuda:0`` entries over one card.
``make_mesh`` never repeats a device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

SNP_AXIS = "snp"


class Mesh:
    """An ordered tuple of devices on the ``snp`` axis. ``devices`` is a
    numpy object array (``mesh.devices.size`` is the shard count, as in
    the reference); ``device_list`` the same devices as a tuple."""

    def __init__(self, devices, axis_names: tuple = (SNP_AXIS,)):
        self.device_list = tuple(_indexed(torch.device(d)) for d in devices)
        if not self.device_list:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(self.device_list), object)
        self.devices[:] = self.device_list
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.device_list)

    @property
    def distinct(self) -> tuple:
        """The mesh's devices without repeats, in mesh order."""
        return tuple(dict.fromkeys(self.device_list))

    @property
    def key(self) -> tuple:
        """A hashable identity of the device tuple (cache keys)."""
        return tuple(str(d) for d in self.device_list)

    def resident_scale(self) -> int:
        """How many times one device's resident SNP cap the whole mesh
        holds: the shard count over the most shards any one device
        carries (k for k distinct cards, 1 when every shard shares one)."""
        per_dev = max(self.device_list.count(d) for d in self.distinct)
        return max(self.size // per_dev, 1)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.device_list]}, {self.axis_names})"


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` names the current card: give it its index, so that two
    names of one card compare equal (tensors report ``cuda:<i>``)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices() -> list:
    """The devices a mesh may use: every CUDA device, or ``[cpu]`` under
    ``JX_TPU_PLATFORM=cpu`` (the reference takes ``jax.devices()``)."""
    from janusx_tpu_torch import config

    if config.resolve_device().type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = visible_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (SNP_AXIS,))


def home_device(mesh: Mesh | None, device=None) -> torch.device:
    """The device a call keeps its shared state on: the mesh's first
    device, else ``device`` resolved (config.resolve_device)."""
    from janusx_tpu_torch import config

    return mesh.device_list[0] if mesh is not None else config.resolve_device(device)


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device while a shard issues its work
    (its launches go to that device's current stream); no-op on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def shard_snp_block(mesh: Mesh, arr) -> list:
    """One tensor per shard: contiguous, equal slices of the leading
    (SNP) axis, each on its shard's device. The leading axis must be
    divisible by the mesh size (pad first)."""
    t = torch.as_tensor(np.ascontiguousarray(arr) if isinstance(arr, np.ndarray) else arr)
    if t.shape[0] % mesh.size:
        raise ValueError(f"leading axis {t.shape[0]} is not divisible by the "
                         f"mesh size {mesh.size}")
    w = t.shape[0] // mesh.size
    return [t[i * w:(i + 1) * w].to(d) for i, d in enumerate(mesh.device_list)]


def put_replicated(mesh: Mesh, arr) -> list:
    """One copy of ``arr`` per distinct device, listed per shard (the
    shards of one device share its copy)."""
    t = torch.as_tensor(arr)
    copies = {d: t.to(d) for d in mesh.distinct}
    return [copies[d] for d in mesh.device_list]


def pad_to_multiple(arr: np.ndarray, mult: int, fill=0) -> np.ndarray:
    m = arr.shape[0]
    target = -(-m // mult) * mult
    if target == m:
        return arr
    pad = np.full((target - m,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
