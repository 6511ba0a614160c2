"""Superblock streaming shared by the port's scans.

Every scan of janusx_tpu streams an input larger than its resident cap in
chunks of whole SNP blocks, reading chunk k+1 on the host while the device
works on chunk k (janusx_tpu/models/lmm.py:413-433, lm.py:124-135,
fvlmm.py:100-108). Here that loop is written once; each scan passes the
function that scans one resident chunk for all of its traits.
"""

from __future__ import annotations

import numpy as np

from janusx_tpu_torch.models.scan_common import ScanResult
from janusx_tpu_torch.utils.prefetch import prefetch_one_ahead


def stream(pg, superblock: int, block: int, scan_chunk) -> list[ScanResult]:
    """``scan_chunk(resident_pg) -> [ScanResult per trait]`` over ``pg``:
    in one call when ``pg`` holds at most ``superblock`` SNPs (a lazy input
    is materialized first), else over chunks of whole ``block``s whose
    per-trait results are concatenated in SNP order."""
    superblock = min(superblock, getattr(pg, "max_resident_snps", superblock))
    m = pg.m
    if m <= superblock:
        if not hasattr(pg, "packed"):  # lazy input small enough: materialize
            pg = pg.take_snps(np.arange(m))
        return scan_chunk(pg)
    sb = max((superblock // block) * block, block)
    spans = [(s0, min(s0 + sb, m)) for s0 in range(0, m, sb)]
    parts = [scan_chunk(sub) for sub in prefetch_one_ahead(
        spans, lambda se: pg.take_snps(np.arange(se[0], se[1])))]
    return [ScanResult.concat([p[t] for p in parts]) for t in range(len(parts[0]))]
