"""Windowed LD pruning (PLINK --indep-pairwise semantics; port of
janusx_tpu/models/ldprune.py).

Replaces the reference JanusX's SIMD LD-prune kernels (src/stats/ld.rs:
count-window pruning, MAF-priority variant). Correlations for a whole SNP
chunk come from one (C, n) x (n, C) device matmul of standardized rows
(torch, full f32); the greedy window sweep over the r² matrix runs on the
host.

Greedy rule per window: scan pairs (i < j); if r² > threshold, drop the
member with the smaller MAF (maf-priority, ties drop j).
"""

from __future__ import annotations

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.ops import decode

f32 = torch.float32


def _corr_chunk(packed: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Pearson correlations of a packed chunk's rows (mean-imputed)."""
    z = decode.decode_centered(packed, mean, f32)
    norms = torch.sqrt(torch.sum(z * z, dim=1))
    zn = z / torch.clamp(norms, min=1e-12)[:, None]
    return zn @ zn.T


def _r2_chunk_pairwise(packed: torch.Tensor) -> torch.Tensor:
    """Pairwise-complete r² matrix for one packed chunk (the reference falls
    back to r2_pairwise_complete_bitplanes whenever either SNP has missing
    calls — ld.rs:211,357; zero-filled correlations deflate r² and let
    high-LD pairs with missingness slip under the prune threshold).

    All pair statistics restricted to jointly-observed samples come from
    four (C, n) x (n, C) matmuls of dosage/indicator planes.
    """
    codes = decode.unpack_codes(packed)
    obs = (codes != 3).to(f32)  # padding cols are code 3
    x = codes.to(f32) * obs  # missing -> 0
    x2 = x * x
    N = obs @ obs.T  # pair counts
    SX = x @ obs.T  # sum x_i over joint obs
    SXY = x @ x.T
    SXX = x2 @ obs.T  # sum x_i^2 over joint obs
    cov = N * SXY - SX * SX.T
    var_i = N * SXX - SX * SX
    denom = var_i * var_i.T
    return torch.where(denom > 0, (cov * cov) / torch.clamp(denom, min=1e-30),
                       torch.zeros((), dtype=f32, device=denom.device))


def _r2_host(packed: np.ndarray, mean: np.ndarray, pairwise: bool, dev) -> np.ndarray:
    """r² of a packed chunk on the device, back as a host array."""
    pk = torch.as_tensor(np.ascontiguousarray(packed), device=dev)
    if pairwise:
        return _r2_chunk_pairwise(pk).cpu().numpy()
    r = _corr_chunk(pk, torch.as_tensor(mean.astype(np.float32), device=dev))
    return (r * r).cpu().numpy()


def r2_matrix(pg: PackedGenotypes, device=None) -> np.ndarray:
    """Full pairwise r² matrix of a (small) packed subset — the shared LD
    kernel behind region plots and -ldblock heatmaps. Pairwise-complete
    when any marker has missing calls (reference ld.rs semantics)."""
    dev = config.resolve_device(device)
    packed = decode.pad_packed_cols(pg.packed)
    return _r2_host(packed, pg.mean, bool(np.any(pg.miss > 0)), dev)


def ld_prune(
    pg: PackedGenotypes,
    window: int = 50,
    step: int = 5,
    r2_threshold: float = 0.2,
    chunk: int = 4096,
    window_bp: int | None = None,
    device=None,
) -> np.ndarray:
    """Returns indices of SNPs kept.

    `window` counts variants; `window_bp` (reference gformat kb/bp
    suffixes, gformat.py:_parse_prune_window) switches to a physical
    window — each anchor's window spans the SNPs within window_bp
    downstream of its position.
    """
    dev = config.resolve_device(device)
    m = pg.m
    if m == 0:
        return np.empty(0, np.int64)
    step = max(1, int(step))
    pos = np.asarray(pg.sites.pos, np.int64)
    if window_bp is not None:
        window_bp = max(1, int(window_bp))
    else:
        window = max(2, int(window))
    removed = np.zeros(m, dtype=bool)
    packed = decode.pad_packed_cols(pg.packed)
    maf = pg.af

    # process per chromosome (windows never span chromosomes)
    chrom = pg.sites.chrom
    boundaries = [0]
    for i in range(1, m):
        if chrom[i] != chrom[i - 1]:
            boundaries.append(i)
    boundaries.append(m)

    for c0, c1 in zip(boundaries[:-1], boundaries[1:]):
        if window_bp is not None:
            # widest physical window on this chromosome, in variants
            ends = np.searchsorted(pos[c0:c1], pos[c0:c1] + window_bp, "right")
            max_extent = int(np.max(ends - np.arange(c1 - c0))) if c1 > c0 else 1
            ov = max(2, max_extent)
        else:
            ov = window
        s = c0
        while s < c1:
            e = min(s + chunk, c1)
            # include window overlap to the right
            e_ov = min(e + ov, c1)
            r2 = _r2_host(packed[s:e_ov], pg.mean[s:e_ov],
                          bool(np.any(pg.miss[s:e_ov] > 0)), dev)
            local_removed = removed[s:e_ov].copy()
            w0 = 0
            limit = e_ov - s
            while w0 < (e - s):
                if window_bp is not None:
                    w1 = min(int(np.searchsorted(
                        pos[s:e_ov], pos[s + w0] + window_bp, "right")), limit)
                else:
                    w1 = min(w0 + window, limit)
                if w1 <= w0 + 1:
                    # no in-window neighbor: the reference keeps the anchor
                    # untested (ld.rs `if end <= li + 1 { continue; }`)
                    w0 += step
                    continue
                for i in range(w0, w1):
                    if local_removed[i]:
                        continue
                    for j in range(i + 1, w1):
                        if local_removed[j]:
                            continue
                        if r2[i, j] > r2_threshold:
                            gi, gj = s + i, s + j
                            if maf[gi] < maf[gj]:
                                local_removed[i] = True
                                break
                            local_removed[j] = True
                w0 += step
            removed[s:e_ov] |= local_removed
            s = e
    return np.nonzero(~removed)[0]


def ld_clump(
    pg: PackedGenotypes,
    chrom: np.ndarray,
    pos: np.ndarray,
    pvals: np.ndarray,
    thr: float,
    window_bp: int = 250_000,
    r2_cut: float = 0.5,
):
    """PLINK-style LD clumping of significant hits (reference postgwas
    -LDclump WINDOW R2): walk hits by ascending p; each unclaimed index
    SNP claims every unclaimed significant SNP within +-window_bp on the
    same chromosome with r^2 >= r2_cut against the INDEX genotype
    (pairwise-complete r, same missingness convention as r2_matrix).

    ``chrom``/``pos``/``pvals`` come from the assoc TSV; markers are
    matched to ``pg`` by (chrom, pos) — unmatched hits clump by position
    only (r^2 treated as 1 inside the window, flagged in the output).

    Returns a list of dicts: lead assoc-row index, chrom, pos, p,
    members (assoc-row indices incl. the lead), n_genotyped.
    """
    chrom = np.asarray(chrom).astype(str)
    pos = np.asarray(pos, np.int64)
    pvals = np.asarray(pvals, np.float64)
    sig = np.nonzero(np.isfinite(pvals) & (pvals < thr))[0]
    if sig.size == 0:
        return []
    sig = sig[np.argsort(pvals[sig], kind="stable")]

    geno_row = {}
    if pg is not None:
        # match only the significant hits against the panel (the panel is
        # biobank-sized; a per-marker Python dict would dominate wall
        # time): lexsort the panel (chrom, pos) keys once, searchsorted
        # each hit
        pchrom = pg.sites.chrom.astype(str)
        ppos = np.asarray(pg.sites.pos, np.int64)
        order = np.lexsort((ppos, pchrom))
        sc, sp = pchrom[order], ppos[order]
        hc, hp = chrom[sig], pos[sig]
        lo = np.searchsorted(sc, hc, side="left")
        hi = np.searchsorted(sc, hc, side="right")
        for i, l, h, p_want in zip(sig, lo, hi, hp):
            k = l + np.searchsorted(sp[l:h], p_want, side="left")
            if k < h and sp[k] == p_want:
                geno_row[int(i)] = int(order[k])

    claimed: set = set()
    clumps = []
    for i in sig:
        i = int(i)
        if i in claimed:
            continue
        near = sig[
            (chrom[sig] == chrom[i])
            & (np.abs(pos[sig] - pos[i]) <= window_bp)
        ]
        cand = [int(j) for j in near if int(j) not in claimed and int(j) != i]
        members = [i]
        gi = geno_row.get(i)
        if gi is not None and cand:
            cand_g = [c for c in cand if c in geno_row]
            if cand_g:
                rows = pg.take_snps(
                    np.asarray([gi] + [geno_row[c] for c in cand_g]))
                Z = rows.centered()
                Zs = Z - Z.mean(axis=1, keepdims=True)
                nrm = np.sqrt((Zs * Zs).sum(axis=1))
                nrm[nrm == 0] = 1.0
                r = (Zs[1:] @ Zs[0]) / (nrm[1:] * nrm[0])
                for c, rv in zip(cand_g, r):
                    if rv * rv >= r2_cut:
                        members.append(c)
            # hits absent from the genotype panel stay unclaimed
        elif gi is None:
            # no genotype for the index: claim the whole window by
            # position (flagged via n_genotyped=0)
            members.extend(cand)
        claimed.update(members)
        clumps.append({
            "lead": i, "chrom": chrom[i], "pos": int(pos[i]),
            "p": float(pvals[i]), "members": members,
            "n_genotyped": int(gi is not None),
        })
    return clumps
