"""KING-robust relatedness and unrelated-set pruning (port of
janusx_tpu/models/king.py).

Replaces the reference's KING module (JanusX src/math/KING.rs:
KING-robust estimates from bitplanes, related-pair graph, unrelated-set
pruning).

KING-robust estimator between samples i, j over jointly observed sites:

    φ_ij = (N_het,het − 2·N_opposing_hom) / (N_het_i + N_het_j)

Per SNP block the codes are unpacked on the device and the indicator
planes (het, hom-0, hom-2, observed) are formed as f32; every pair count
is one ``torch.matmul`` of two planes. The counts are integers below 2^24,
so with TF32 off (full-f32 products) they are exact, and φ is the same
f32 quotient as the reference's. Default relatedness threshold 0.0884
(2nd-degree cutoff).
"""

from __future__ import annotations

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.ops import decode
from janusx_tpu_torch.utils import devcache

DEGREE2_THRESHOLD = 0.0884  # kinship > 2^-3.5 -> 2nd degree or closer

f32 = torch.float32


def _planes(pkb: torch.Tensor):
    """(het, hom-0, hom-2, observed) f32 indicator planes (B, 4·nb) of one
    packed block; padding (code 3) is unobserved."""
    codes = decode.unpack_codes(pkb)
    return ((codes == 1).to(f32), (codes == 0).to(f32), (codes == 2).to(f32),
            (codes != 3).to(f32))


def _king_counts(pk: torch.Tensor):
    """(hh, opp, het_shared_i) over pre-blocked (nblk, B, nb) packed rows:
    f32 (n_pad, n_pad) each."""
    n_pad = pk.shape[-1] * 4
    hh, opp, hsi = (torch.zeros((n_pad, n_pad), dtype=f32, device=pk.device)
                    for _ in range(3))
    for b in range(pk.shape[0]):
        h, a0, a2, obs = _planes(pk[b])
        hh += h.T @ h
        o = a0.T @ a2
        opp += o + o.T
        # het count of sample i over sites observed in j
        hsi += h.T @ obs
    return hh, opp, hsi


def king_kinship(pg: PackedGenotypes, block: int = config.DEFAULT_SNP_BLOCK,
                 device=None):
    """(n, n) KING-robust kinship matrix (diagonal set to 0.5)."""
    dev = config.resolve_device(device)
    m = pg.m
    block = min(block, m)
    pk = devcache.device_packed_blocks(pg, (-(-m // block), block), dev, lane_align=4)
    hh, opp, hsi = _king_counts(pk)
    n = pg.n
    hh = hh.cpu().numpy().astype(np.float64)[:n, :n]
    opp = opp.cpu().numpy().astype(np.float64)[:n, :n]
    hsi = hsi.cpu().numpy().astype(np.float64)[:n, :n]
    denom = hsi + hsi.T
    with np.errstate(divide="ignore", invalid="ignore"):
        phi = np.where(denom > 0, (hh - 2.0 * opp) / denom, 0.0)
    np.fill_diagonal(phi, 0.5)
    return phi


def unrelated_set(
    phi: np.ndarray, threshold: float = DEGREE2_THRESHOLD
) -> np.ndarray:
    """Greedy max-independent-set pruning: repeatedly drop the sample with
    the most relatives above threshold (reference king_unrelated_set)."""
    n = phi.shape[0]
    adj = (phi > threshold).astype(np.int64)
    np.fill_diagonal(adj, 0)
    alive = np.ones(n, dtype=bool)
    deg = adj.sum(axis=1)
    while True:
        deg_alive = np.where(alive, deg, -1)
        worst = int(np.argmax(deg_alive))
        if deg_alive[worst] <= 0:
            break
        alive[worst] = False
        deg = deg - adj[:, worst]
    return np.nonzero(alive)[0]


def _king_counts_pair(pk_i: torch.Tensor, pk_j: torch.Tensor) -> torch.Tensor:
    """Pairwise KING φ between two sample tiles over pre-blocked (nblk, B,
    nb) packed rows: per SNP block, indicator products between tile-i and
    tile-j planes (the reference's KING.rs bitplane AND-popcounts); f32
    (4·nb_i, 4·nb_j)."""
    ti, tj = pk_i.shape[-1] * 4, pk_j.shape[-1] * 4
    hh, opp, hsi, hsj = (torch.zeros((ti, tj), dtype=f32, device=pk_i.device)
                         for _ in range(4))
    for b in range(pk_i.shape[0]):
        h_i, a0_i, a2_i, obs_i = _planes(pk_i[b])
        h_j, a0_j, a2_j, obs_j = _planes(pk_j[b])
        hh += h_i.T @ h_j
        opp += a0_i.T @ a2_j + a2_i.T @ a0_j
        hsi += h_i.T @ obs_j
        hsj += obs_i.T @ h_j
    denom = hsi + hsj
    return torch.where(denom > 0, (hh - 2.0 * opp) / denom,
                       torch.zeros((), dtype=f32, device=denom.device))


def _king_pair_sparse(pk_i: torch.Tensor, pk_j: torch.Tensor, threshold: float,
                      same: bool):
    """Tile-pair kinship thresholded on the device: only (row, col, phi) of
    pairs above threshold leave the card, in row-major order. On the
    diagonal tile only the strict upper triangle counts."""
    phi = _king_counts_pair(pk_i, pk_j)
    if same:
        phi = torch.triu(phi, diagonal=1)
    r, c = torch.nonzero(phi > threshold, as_tuple=True)
    return r, c, phi[r, c]


def king_related_pairs(
    pg: PackedGenotypes,
    threshold: float = DEGREE2_THRESHOLD,
    tile: int = 8192,
    block: int = config.DEFAULT_SNP_BLOCK,
    device=None,
):
    """Biobank-scale KING: sample-tile x sample-tile sweep with
    thresholded sparse output — never materializes the (n, n) kinship.
    Memory is O(tile^2) device + O(related pairs) host. Returns (i_idx,
    j_idx, phi) arrays with i < j, in the reference's order.

    Reference analog: king_unrelated_set_from_bed's streaming pair graph
    (src/math/KING.rs)."""
    from janusx_tpu_torch.io import bitcodec

    dev = config.resolve_device(device)
    n = pg.n
    m = pg.m
    block = min(block, m)
    m_pad = -(-m // block) * block
    tile = min(tile, n)
    tiles = [np.arange(s, min(s + tile, n)) for s in range(0, n, tile)]
    # per-tile packed columns, row-padded once; the LAST tile is padded to
    # the full tile width with all-missing samples (denominator 0 -> phi 0),
    # as in the reference, and pairs in the padding are dropped below
    packs = []
    nb_tile = (tile + 3) // 4
    for idx in tiles:
        sub = bitcodec.subset_columns(pg.packed, n, idx)
        if sub.shape[1] < nb_tile:
            sub = np.concatenate(
                [sub, np.full((sub.shape[0], nb_tile - sub.shape[1]), 0xFF,
                              np.uint8)], axis=1,
            )
        if m_pad != m:
            sub = np.concatenate(
                [sub, np.full((m_pad - m, sub.shape[1]), 0xFF, np.uint8)]
            )
        packs.append(torch.as_tensor(sub.reshape(m_pad // block, block, nb_tile),
                                     device=dev))
    ii, jj, vv = [], [], []
    for a in range(len(tiles)):
        for b in range(a, len(tiles)):
            r, c, vals = _king_pair_sparse(packs[a], packs[b], threshold, a == b)
            r, c, vals = r.cpu().numpy(), c.cpu().numpy(), vals.cpu().numpy()
            keep_rc = (r < len(tiles[a])) & (c < len(tiles[b]))
            r, c, vals = r[keep_rc], c[keep_rc], vals[keep_rc]
            if len(r):
                ii.append(tiles[a][r])
                jj.append(tiles[b][c])
                vv.append(np.asarray(vals, np.float64))
    if not ii:
        z = np.empty(0, np.int64)
        return z, z.copy(), np.empty(0)
    return (np.concatenate(ii), np.concatenate(jj),
            np.concatenate(vv).astype(np.float64))


def unrelated_set_from_pairs(
    i_idx: np.ndarray, j_idx: np.ndarray, n: int
) -> np.ndarray:
    """Greedy max-independent-set pruning over a sparse related-pair
    graph (same policy as ``unrelated_set``, without the dense matrix)."""
    from collections import defaultdict

    adj = defaultdict(set)
    for i, j in zip(i_idx, j_idx):
        adj[int(i)].add(int(j))
        adj[int(j)].add(int(i))
    alive = np.ones(n, dtype=bool)
    deg = {v: len(s) for v, s in adj.items()}
    import heapq

    heap = [(-d, v) for v, d in deg.items()]
    heapq.heapify(heap)
    while heap:
        negd, v = heapq.heappop(heap)
        if not alive[v] or deg.get(v, 0) != -negd:
            continue  # stale entry
        if -negd <= 0:
            break
        alive[v] = False
        for u in adj[v]:
            if alive[u] and deg.get(u, 0) > 0:
                deg[u] -= 1
                heapq.heappush(heap, (-deg[u], u))
        deg[v] = 0
    return np.nonzero(alive)[0]
