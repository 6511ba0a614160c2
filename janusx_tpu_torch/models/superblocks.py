"""Superblock streaming and SNP sharding shared by the port's scans.

Every scan of janusx_tpu streams an input larger than its resident cap in
chunks of whole SNP blocks, reading chunk k+1 on the host while the device
works on chunk k (janusx_tpu/models/lmm.py:413-433, lm.py:124-135,
fvlmm.py:100-108). Here that loop is written once; each scan passes the
function that scans one resident chunk for all of its traits.

With a device mesh each resident chunk is SNP-sharded as janusx_tpu's
``shard_map`` scans shard it: the block is rounded up to a multiple of the
mesh size and every shard takes an equal slice of every block
(``shard_axis`` 1 of the (nblk, block) layout). ``scan_resident`` issues
each shard's uploads and launches on its own device, synchronizes only
after the last shard is issued (so distinct cards overlap), and gathers
the per-SNP outputs back in SNP order.

A chunk of an in-memory panel is a view of its rows (``PanelSlice``), and
``scan_resident`` serves it as a slice of the whole panel held on the
device (utils.devcache.resident_packed_blocks), uploaded once for every
scan of that panel; the launches, their operands and so the results are
those of a chunk uploaded on its own. A panel that does not fit beside a
scan's carry, and a chunk read from a lazy input, are padded and uploaded
chunk by chunk.

Spans (utils.trace): ``feed``, the wait for the next chunk on the host;
``superblock``, one resident chunk, and inside it ``upload`` (the device
cache's lookups and, on a miss, the pad and the copy), ``kernels``
(``compute``) and ``to_host`` (the copy back, which waits for the
kernels); ``results``, the concatenation of the chunks' results. Counters:
``feed.resident``, chunks served from a resident panel, and
``feed.streamed``, chunks uploaded on their own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.models.scan_common import ScanResult
from janusx_tpu_torch.parallel.mesh import on_device
from janusx_tpu_torch.utils import devcache, trace
from janusx_tpu_torch.utils.prefetch import prefetch_one_ahead

_END = object()


@dataclass
class PanelSlice(PackedGenotypes):
    """SNPs [start, start + m) of a streamed input, one superblock:
    ``panel`` is the in-memory PackedGenotypes they are rows of (the codes
    and per-SNP arrays are views of its own), None for rows read from a
    lazy input."""

    panel: PackedGenotypes | None = None
    start: int = 0


def _cut(pg, s0: int, s1: int) -> PanelSlice:
    if isinstance(pg, PackedGenotypes):
        rows = slice(s0, s1)
        return PanelSlice(packed=pg.packed[rows], n_samples=pg.n_samples,
                          sites=pg.sites.take(rows), samples=pg.samples, af=pg.af[rows],
                          miss=pg.miss[rows], mean=pg.mean[rows], panel=pg, start=s0)
    return PanelSlice(**vars(pg.take_snps(np.arange(s0, s1))), start=s0)


def stream(pg, superblock: int, block: int, scan_chunk, mesh=None) -> list[ScanResult]:
    """``scan_chunk(resident_pg) -> [ScanResult per trait]`` over ``pg``:
    in one call when ``pg`` holds at most ``superblock`` SNPs (a lazy input
    is materialized first), else over chunks of whole ``block``s whose
    per-trait results are concatenated in SNP order. ``superblock`` is a
    one-device cap: a mesh of k distinct devices holds k times as many."""
    if mesh is not None:
        superblock *= mesh.resident_scale()
    superblock = min(superblock, getattr(pg, "max_resident_snps", superblock))
    m = pg.m
    if m <= superblock:
        if not hasattr(pg, "packed"):  # lazy input small enough: materialize
            with trace.span("feed"):
                pg = pg.take_snps(np.arange(m))
        return scan_chunk(pg)
    sb = max((superblock // block) * block, block)
    spans = [(s0, min(s0 + sb, m)) for s0 in range(0, m, sb)]
    chunks = prefetch_one_ahead(spans, lambda se: _cut(pg, *se))
    parts = []
    while True:
        with trace.span("feed"):
            sub = next(chunks, _END)
        if sub is _END:
            break
        parts.append(scan_chunk(sub))
    with trace.span("results"):
        return [ScanResult.concat([p[t] for p in parts]) for t in range(len(parts[0]))]


def shard_block(block: int, mesh) -> int:
    """The SNP block of a (sharded) resident chunk: every shard needs the
    same whole blocks, so a mesh rounds it up to a multiple of its size."""
    if mesh is None:
        return block
    return -(-block // mesh.size) * mesh.size


def replicas(tree, mesh) -> list:
    """``tree`` per shard (``[tree]`` without a mesh): one copy per
    distinct device, shared by that device's shards."""
    return [tree] if mesh is None else devcache.replicate_tree(tree, mesh)


def _upload(pg, shape: tuple, dev, mesh, mean: bool) -> tuple[list, list]:
    """The chunk's (nblk, B, nb) packed rows and (nblk, B) f32 means (None
    unless ``mean``) on the device, one of each per shard: a slice of the
    resident panel for a PanelSlice of one that fits, an upload of its own
    for any other PanelSlice, the cached upload of a whole input."""
    place = {"device": dev} if mesh is None else {"mesh": mesh, "shard_axis": 1}
    B, rows, pk = shape[1], slice(None), None
    panel = getattr(pg, "panel", None)
    if panel is not None and pg.start % B == 0:
        full = (-(-panel.m // B), B)
        pk = devcache.resident_packed_blocks(panel, full, **place)
    if pk is not None:
        trace.count("feed.resident")
        rows = slice(pg.start // B, pg.start // B + shape[0])
        src, shape, blocks = panel, full, devcache.to_device_blocks
    elif isinstance(pg, PanelSlice):
        trace.count("feed.streamed")
        pk = devcache.upload_packed_blocks(pg, shape, **place)
        src, blocks = pg, devcache.upload_blocks
    else:
        pk = devcache.device_packed_blocks(pg, shape, **place)
        src, blocks = pg, devcache.to_device_blocks
    mn = blocks(src.mean, shape, 0.0, torch.float32, **place) if mean else None
    per_shard = (lambda x: [x]) if mesh is None else list
    pks = [x[rows] for x in per_shard(pk)]
    return pks, ([None] * len(pks) if mn is None else [x[rows] for x in per_shard(mn)])


@trace.spanned("superblock")
def scan_resident(pg, block: int, dev, mesh, compute, mean: bool = True) -> list:
    """One resident chunk through ``compute(i, pk, mn, device)``, which
    returns device tensors (or None) whose last axis runs over the rows of
    ``pk`` (nblk, B, nb) block by block; ``mn`` is the (nblk, B) f32
    means (None unless ``mean``). Without ``mesh``: one call on ``dev``.
    With one: shard i gets rows [i·w, (i+1)·w) of every block, w =
    block / mesh.size, on mesh.device_list[i]. Returns the outputs as host
    arrays, rows in SNP order, trimmed to pg.m."""
    m = pg.m
    block = shard_block(block, mesh)
    shape = (-(-m // block), block)
    with trace.span("upload"):
        pks, mns = _upload(pg, shape, dev, mesh, mean)
    if mesh is None:
        with trace.span("kernels"):
            outs = compute(0, pks[0], mns[0], dev)
        with trace.span("to_host"):
            return [None if x is None else x.cpu().numpy()[..., :m] for x in outs]
    outs = []
    with trace.span("kernels"):
        for i, d in enumerate(mesh.device_list):
            with on_device(d):
                outs.append(compute(i, pks[i], mns[i], d))
    with trace.span("to_host"):
        gathered = []
        for xs in zip(*outs):
            if xs[0] is None:
                gathered.append(None)
                continue
            xs = [x.cpu().numpy() for x in xs]
            lead = xs[0].shape[:-1]
            # (..., nblk, w) per shard -> (..., nblk, D, w): block by block,
            # shard by shard, which is SNP order
            full = np.stack([x.reshape(lead + (shape[0], -1)) for x in xs], axis=-2)
            gathered.append(full.reshape(lead + (-1,))[..., :m])
        return gathered
