"""Multi-process initialization and host-sharded input loading (port of
janusx_tpu/parallel/distributed.py on ``torch.distributed``).

Process coordination is a gloo process group (host tensors; the
reference also gathers host numpy arrays, ``process_allgather``). Each
process computes on its own devices; the SNP axis is split over the
processes in process-major order, weighted by each process's device
count, so each host reads only its own contiguous slice of the genotype
file (bits move over the filesystem, floats never cross hosts) and only
the (n, n) partial GRMs and the per-SNP result columns are gathered.

Typical multi-host driver:

    from janusx_tpu_torch.parallel import distributed as dist
    dist.initialize()                     # torchrun env, or explicit args
    m_pad = dist.padded_snp_total(m_total)
    lo, hi = dist.host_snp_range(m_total) # this host's PADDED slice
    block = reader.rows(lo, min(hi, m_total))  # range-limited host read
    block = pad_rows(block, hi - lo)      # rows >= m_total are padding
    g = dist.make_global_snp_array(mesh, block, m_total)
    # g.global_shape[0] == m_pad; mask or trim rows >= m_total after compute

Two processes may share one card (each opens its own context on it).
"""

from __future__ import annotations

import logging
import os
from typing import NamedTuple

import numpy as np
import torch

from janusx_tpu_torch.parallel.mesh import SNP_AXIS, Mesh, visible_devices

log = logging.getLogger("janusx_tpu_torch.distributed")

__all__ = ["SNP_AXIS", "initialize", "process_index", "process_count",
           "device_count", "global_snp_mesh", "padded_snp_total", "host_snp_range",
           "make_global_snp_array", "distributed_grm", "distributed_scan"]

# every process's local device count, gathered once by initialize()
_counts: list | None = None
# how long a collective waits for the other processes before it raises
_GROUP_TIMEOUT_S = 600


def _group_ready() -> bool:
    import torch.distributed as tdist

    return tdist.is_available() and tdist.is_initialized()


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the gloo process group: ``tcp://<coordinator>`` with explicit
    arguments, else the launcher's environment (``env://``: torchrun sets
    MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE). Without that
    environment the process runs alone, as the reference's does. Under a
    launcher that sets LOCAL_RANK each process takes that card."""
    global _counts
    if _group_ready():  # pragma: no cover
        return
    import datetime

    import torch.distributed as tdist

    try:
        kw = dict(backend="gloo", timeout=datetime.timedelta(seconds=_GROUP_TIMEOUT_S))
        if coordinator is None:
            tdist.init_process_group(init_method="env://", **kw)
        else:
            tdist.init_process_group(init_method=f"tcp://{coordinator}",
                                     world_size=num_processes, rank=process_id, **kw)
    except (ValueError, RuntimeError, KeyError) as e:
        # no coordinator env (single-host dev runs): proceed single-process
        log.info("single-process mode (%s)", e)
        return
    if "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    mine = torch.tensor([len(visible_devices())], dtype=torch.int64)
    got = [torch.zeros_like(mine) for _ in range(tdist.get_world_size())]
    tdist.all_gather(got, mine)
    _counts = [int(t) for t in got]
    log.info("distributed: process %d/%d, %d local / %d global devices",
             process_index(), process_count(), _counts[process_index()], sum(_counts))


def process_index() -> int:
    import torch.distributed as tdist

    return tdist.get_rank() if _group_ready() else 0


def process_count() -> int:
    import torch.distributed as tdist

    return tdist.get_world_size() if _group_ready() else 1


def _device_counts() -> list:
    """Each process's local device count, in process order."""
    return _counts if _group_ready() and _counts else [len(visible_devices())]


def device_count() -> int:
    """Devices over all processes."""
    return sum(_device_counts())


def _mesh_devices() -> list:
    """Global device order: process-major, so each host's shard rows are
    one contiguous block of the SNP axis. Entries are (process, local
    index) pairs: a process addresses only its own devices."""
    return [(p, i) for p, c in enumerate(_device_counts()) for i in range(c)]


def global_snp_mesh() -> Mesh:
    """This process's part of the global process-major SNP mesh: its own
    devices (a process cannot launch on another's)."""
    return Mesh(visible_devices(), (SNP_AXIS,))


def padded_snp_total(m_total: int) -> int:
    """SNP-axis length padded up to a device-count multiple (equal shards;
    rows >= m_total are padding)."""
    d = device_count()
    return -(-m_total // d) * d


def host_snp_range(m_total: int) -> tuple[int, int]:
    """This host's contiguous slice [lo, hi) of the PADDED SNP axis,
    weighted by its device count. Rows at index >= m_total (only possible
    on the last hosts) are padding the caller fills with code-3 bytes."""
    m_pad = padded_snp_total(m_total)
    devs = _mesh_devices()
    per_dev = m_pad // len(devs)
    pi = process_index()
    before = sum(1 for p, _ in devs if p < pi)
    mine = sum(1 for p, _ in devs if p == pi)
    lo = before * per_dev
    return lo, lo + mine * per_dev


class GlobalSnpArray(NamedTuple):
    """This process's rows [lo, hi) of a SNP-sharded array of
    ``global_shape``. PyTorch has no single-controller global array (the
    reference's ``make_array_from_process_local_data``): each process
    holds its slice on its own devices, one tensor per local shard."""

    shards: list
    lo: int
    hi: int
    global_shape: tuple


def make_global_snp_array(mesh: Mesh, local_block, m_total: int) -> GlobalSnpArray:
    """This host's local block (its host_snp_range(m_total) rows, padded:
    the leading dim must be exactly hi - lo) split over ``mesh`` (this
    process's devices), with the padded global shape recorded; callers
    mask or trim the tail rows >= m_total after compute."""
    from janusx_tpu_torch.parallel.mesh import shard_snp_block

    lo, hi = host_snp_range(m_total)
    if local_block.shape[0] != hi - lo:
        raise ValueError(
            f"local block rows {local_block.shape[0]} != host slice {hi - lo}"
            f" (host_snp_range({m_total}) = [{lo}, {hi}))"
        )
    global_shape = (padded_snp_total(m_total),) + tuple(local_block.shape[1:])
    return GlobalSnpArray(shard_snp_block(mesh, local_block), lo, hi, global_shape)


def _allgather(payload: np.ndarray) -> np.ndarray:
    """Every process's equal-shape f64 ``payload``, stacked in process
    order (the reference's ``process_allgather``), over gloo."""
    import torch.distributed as tdist

    mine = torch.as_tensor(np.ascontiguousarray(payload, np.float64))
    got = [torch.empty_like(mine) for _ in range(process_count())]
    tdist.all_gather(got, mine)
    return torch.stack(got).numpy()


def distributed_grm(source, method: int = 1, block: int | None = None,
                    dtype=np.float64) -> np.ndarray:
    """Multi-host dense GRM: the production entry point for the recipe
    documented above.

    ``source`` is the QC'd genotype source every host can open — a
    PackedGenotypes or a disk-backed io.windowed.WindowedPacked (then
    each host's take_snps is a range-limited host-local read). Each host
    computes the unnormalized partial GRM of its host_snp_range slice on
    its device (models.grm.grm_partial — the same decode and CᵀC as
    grm_from_packed), and the (n, n) partials + denominators sum across
    processes in ONE all-gather. Single-process runs reduce to
    grm_from_packed exactly.

    Reference analog: src/stats/grm.rs rayon partial-K merge, scaled out
    host-wise."""
    from janusx_tpu_torch import config
    from janusx_tpu_torch.models.grm import grm_partial

    if block is None:
        block = config.DEFAULT_SNP_BLOCK
    m_total = int(source.m)
    n = int(getattr(source, "n_samples", None) or source.n)
    lo, hi = host_snp_range(m_total)
    hi = min(hi, m_total)
    part, denom = np.zeros((n, n), np.float64), 0.0
    # stream the host slice in bounded windows: a disk-backed
    # WindowedPacked slice must NEVER materialize whole (grm_partial is
    # additive, so windowing preserves the result up to f32 regrouping)
    win = _host_window(source)
    for s in range(lo, hi, win):
        e = min(s + win, hi)
        sub = source.take_snps(np.arange(s, e))
        p_i, d_i = grm_partial(sub, method=method, block=block, dtype=dtype)
        part += p_i
        denom += d_i
    if process_count() == 1:
        if denom <= 0:
            raise ValueError("GRM denominator is zero (no polymorphic SNPs?)")
        return part / denom
    payload = np.concatenate([part.ravel(), [float(denom)]])
    tot = _allgather(payload).sum(axis=0)
    denom_g = float(tot[-1])
    if denom_g <= 0:
        raise ValueError("GRM denominator is zero (no polymorphic SNPs?)")
    return tot[:-1].reshape(n, n) / denom_g


_SCAN_BASE_COLS = ("af", "miss", "beta", "se", "pwald")
_SCAN_OPT_COLS = ("plrt", "lbd", "ml")
_DIST_WINDOW = 1 << 17  # host-local streaming window (SNP rows)


def _host_window(source) -> int:
    cap = getattr(source, "max_resident_snps", None)
    return max(int(min(_DIST_WINDOW, cap) if cap else _DIST_WINDOW), 1)


def distributed_scan(source, scan):
    """Multi-host per-SNP scan driver: ``scan(sub)`` runs a production
    scan (lm_scan / lmm_scan / fvlmm_scan / ...) on this host's
    host_snp_range slice of ``source`` and returns a ScanResult; the
    per-SNP numeric columns all-gather across processes and reassemble
    in SNP order (process-major host slices are contiguous by
    construction). Padding rows beyond source.m are dropped.

    The per-SNP statistics need no cross-host communication — only the
    final result columns cross hosts, as float64 rows. Requires equal
    local device counts (equal host slice widths).

        res = distributed_scan(wp, lambda sub: lm_scan(sub, y))
    """
    from janusx_tpu_torch.models.scan_common import ScanResult

    m_total = int(source.m)
    lo, hi = host_snp_range(m_total)
    hi_eff = min(hi, m_total)
    # stream the host slice in bounded windows (disk-backed sources must
    # never materialize the whole slice); per-SNP scans window cleanly
    win = _host_window(source)
    parts = []
    for s in range(lo, hi_eff, win):
        e = min(s + win, hi_eff)
        sub = source.take_snps(np.arange(s, e))
        res = scan(sub)
        if res.m != e - s:
            raise ValueError(
                f"scan returned {res.m} rows for a {e - s}-row window — "
                "distributed_scan needs a scan that keeps all input SNPs")
        parts.append(res)
    width = hi - lo
    if parts:
        col_src = parts[0]
    else:
        # pure-padding host slice: probe one SNP so this host still
        # agrees with the others on the gathered column set
        col_src = scan(source.take_snps(np.arange(0, 1)))
    have_opt = [f for f in _SCAN_OPT_COLS if getattr(col_src, f) is not None]
    names = list(_SCAN_BASE_COLS) + have_opt

    def padto(vals):
        out = np.full(width, np.nan)
        if vals:
            cat = np.concatenate([np.asarray(v, np.float64) for v in vals])
            out[: len(cat)] = cat
        return out

    cols = {f: padto([getattr(r, f) for r in parts]) for f in names}

    if process_count() > 1:
        payload = np.stack([cols[f] for f in names])  # (F, width)
        g = _allgather(payload)
        concat = np.concatenate(list(g), axis=1)[:, :m_total]
        cols = {nm: concat[i] for i, nm in enumerate(names)}
    else:
        cols = {nm: cols[nm][:m_total] for nm in names}

    sites = source.sites
    if len(sites) != m_total:
        sites = sites.take(np.arange(m_total))
    return ScanResult(
        sites=sites,
        af=cols["af"], miss=cols["miss"], beta=cols["beta"],
        se=cols["se"], pwald=cols["pwald"],
        plrt=cols.get("plrt"), lbd=cols.get("lbd"), ml=cols.get("ml"),
    )
