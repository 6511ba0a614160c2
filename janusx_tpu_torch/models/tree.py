"""Neighbor-joining phylogeny from genotypes (port of
janusx_tpu/models/tree.py).

Replaces the reference's tree module (JanusX src/stats/tree.rs:
NJ + approximate-ML Newick trees from genotype alignments).

Distance: allele-sharing (IBS) distance d_ij = mean(|g_i - g_j|) / 2 over
jointly observed sites. |g_i - g_j| decomposes over genotype indicator
classes, so per packed SNP block the device forms four f32 products of 0/1
indicator planes (a0ᵀa1, a1ᵀa2, a0ᵀa2, obsᵀobs) and accumulates them in
f32. Every sum is an integer below 2^24, exact in f32 with TF32 off (full
f32 products), so the distance equals the reference's to the last bit.
The O(n³) NJ agglomeration and everything after it run on the host, the
reference's code kept line for line.
"""

from __future__ import annotations

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.ops import decode
from janusx_tpu_torch.utils import devcache

f32 = torch.float32


def _ibs_accumulate(pk: torch.Tensor):
    """Over pre-blocked (nblk, B, nb) packed rows: (sum|gi-gj| (n_pad,
    n_pad), n_obs_pairs (n_pad, n_pad)), f32."""
    n_pad = pk.shape[-1] * 4
    acc_d, acc_n = (torch.zeros((n_pad, n_pad), dtype=f32, device=pk.device)
                    for _ in range(2))
    for b in range(pk.shape[0]):
        codes = decode.unpack_codes(pk[b])  # (B, n_pad)
        obs = (codes != 3).to(f32)
        a0 = (codes == 0).to(f32)
        a1 = (codes == 1).to(f32)
        a2 = (codes == 2).to(f32)
        # |gi-gj| = 1*(cross 0-1 and 1-2) + 2*(cross 0-2)
        m01 = a0.T @ a1
        m12 = a1.T @ a2
        m02 = a0.T @ a2
        acc_d += (m01 + m01.T) + (m12 + m12.T) + 2.0 * (m02 + m02.T)
        acc_n += obs.T @ obs
    return acc_d, acc_n


def ibs_distance(pg: PackedGenotypes, block: int = config.DEFAULT_SNP_BLOCK,
                 device=None):
    dev = config.resolve_device(device)
    m = pg.m
    block = min(block, m)
    pk = devcache.device_packed_blocks(pg, (-(-m // block), block), dev, lane_align=4)
    d, nn = _ibs_accumulate(pk)
    n = pg.n
    d = d.cpu().numpy().astype(np.float64)[:n, :n]
    nn = nn.cpu().numpy().astype(np.float64)[:n, :n]
    with np.errstate(divide="ignore", invalid="ignore"):
        D = np.where(nn > 0, d / nn, 0.0) / 2.0
    np.fill_diagonal(D, 0.0)
    return D


def neighbor_joining(D: np.ndarray, labels) -> str:
    """Classic NJ (Saitou & Nei) -> Newick string."""
    D = np.asarray(D, np.float64).copy()
    n = D.shape[0]
    labels = [str(l) for l in labels]
    nodes = list(range(n))
    newick = {i: labels[i] for i in range(n)}
    active = list(range(n))
    Dw = D
    while len(active) > 2:
        r = len(active)
        sub = Dw[np.ix_(active, active)]
        rowsum = sub.sum(axis=1)
        Q = (r - 2) * sub - rowsum[:, None] - rowsum[None, :]
        np.fill_diagonal(Q, np.inf)
        i_loc, j_loc = np.unravel_index(np.argmin(Q), Q.shape)
        if i_loc > j_loc:
            i_loc, j_loc = j_loc, i_loc
        i, j = active[i_loc], active[j_loc]
        dij = sub[i_loc, j_loc]
        li = 0.5 * dij + (rowsum[i_loc] - rowsum[j_loc]) / (2 * (r - 2))
        lj = dij - li
        li, lj = max(li, 0.0), max(lj, 0.0)
        # new node
        k = Dw.shape[0]
        newrow = 0.5 * (
            Dw[i, :] + Dw[j, :] - dij
        )
        Dw = np.pad(Dw, ((0, 1), (0, 1)))
        Dw[k, : k] = newrow
        Dw[: k, k] = newrow
        Dw[k, k] = 0.0
        newick[k] = f"({newick[i]}:{li:.6g},{newick[j]}:{lj:.6g})"
        active = [a for a in active if a not in (i, j)] + [k]
    i, j = active
    d = max(Dw[i, j], 0.0)
    return f"({newick[i]}:{d / 2:.6g},{newick[j]}:{d / 2:.6g});"


def rapid_neighbor_joining(D: np.ndarray, labels) -> str:
    """RapidNJ-style NJ for large n (reference `jx tree -nj approx` =
    "rapid-core lowmem", tree.rs nj_newick_lowertri_rapid_core): the
    SAME minimum-Q join criterion as classic NJ, found without scanning
    all O(r²) pairs each round. Distances are static per pair, so every
    slot keeps its candidates SORTED BY DISTANCE once; a row scan can
    stop at d ≥ best + u_i + u_max (since q = d − u_i − u_j ≥
    d − u_i − u_max), and rows whose head distance already exceeds the
    bound are skipped wholesale. Joined pairs reuse slot i in-place
    (O(n²) memory total, f32 rows) with generation counters invalidating
    stale candidate entries. O(n² log n) typical work vs the classic
    implementation's O(n³) + per-round matrix copies.

    Tie-breaking may differ from `neighbor_joining` (argmin order);
    on generic distances the topologies agree."""
    D = np.ascontiguousarray(D, np.float32).copy()
    n = D.shape[0]
    labels = [str(lb) for lb in labels]
    if n <= 3:
        return neighbor_joining(D, labels)
    # candidate state is 3 more n x n arrays (12 B/pair on top of D's 4):
    # fail fast with the bill rather than OOM-ing mid-join
    need_gb = 16.0 * n * n / 1e9
    if need_gb > 64.0:
        raise MemoryError(
            f"rapid NJ at n={n} needs ~{need_gb:.0f} GB of candidate "
            "state; subset samples or raise host memory")
    newick = {i: labels[i] for i in range(n)}
    np.fill_diagonal(D, np.inf)  # keeps self out of sorted candidates
    alive = np.ones(n, bool)
    gen = np.zeros(n, np.int32)
    S = np.where(np.isfinite(D), D, 0.0).sum(axis=1, dtype=np.float64)
    # per-slot candidate state in fixed-width rows (so whole batches of
    # rows evaluate in single vector ops): js sorted by distance + the
    # generation of each candidate at build time (stale once gen moved)
    cand_j = np.zeros((n, n), np.int32)
    cand_d = np.full((n, n), np.inf, np.float32)
    cand_g = np.full((n, n), -1, np.int32)
    cand_len = np.zeros(n, np.int64)
    pos = np.zeros(n, np.int64)

    def build_row(i, js):
        d = D[i, js]
        order = np.argsort(d, kind="stable")
        m = len(js)
        cand_j[i, :m] = js[order]
        cand_d[i, :m] = d[order]
        cand_d[i, m:] = np.inf
        cand_g[i, :m] = gen[cand_j[i, :m]]
        cand_len[i] = m
        pos[i] = 0

    # cached first-valid candidate per row: re-advanced only when the head
    # entry itself dies (points at a just-joined slot), so head upkeep is
    # O(affected rows) per round instead of O(r)
    head_d = np.full(n, np.inf)
    head_j = np.full(n, -1, np.int64)

    def advance(i):
        p, m = int(pos[i]), int(cand_len[i])
        while p < m and not (alive[cand_j[i, p]]
                             and gen[cand_j[i, p]] == cand_g[i, p]):
            p += 1
        pos[i] = p
        if p < m:
            head_d[i], head_j[i] = cand_d[i, p], cand_j[i, p]
        else:
            head_d[i], head_j[i] = np.inf, -1

    all_idx = np.arange(n)
    for i in range(n):
        build_row(i, np.delete(all_idx, i))
        advance(i)

    win = np.arange(64)  # vectorized scan window width
    r = n
    while r > 2:
        act = np.nonzero(alive)[0]
        u = np.full(n, -np.inf)
        u[act] = S[act] / (r - 2)
        umax = u[act].max()
        # head entries are valid pairs: their exact q values seed best_q,
        # so most rows fail the d−u_i−u_max ≥ best_q bound outright
        hq = head_d[act] - u[act] - np.where(head_j[act] >= 0,
                                             u[head_j[act]], -np.inf)
        t0 = int(np.argmin(hq))
        best_q = float(hq[t0])
        i0 = int(act[t0])
        best = (i0, int(head_j[i0]), float(head_d[i0]))
        rows = act[head_d[act] - u[act] - umax < best_q]
        start = pos[rows].copy()
        while rows.size:
            # evaluate a 64-wide sorted-candidate window of every
            # surviving row at once; deepen only rows whose window end
            # is still inside the pruning cutoff
            idx = np.minimum(start[:, None] + win, n - 1)
            dwin = cand_d[rows[:, None], idx]
            below = ((start[:, None] + win < cand_len[rows][:, None])
                     & (dwin - u[rows][:, None] - umax < best_q))
            jwin = cand_j[rows[:, None], idx]
            valid = (below & alive[jwin]
                     & (gen[jwin] == cand_g[rows[:, None], idx]))
            q = np.where(valid, dwin - u[rows][:, None] - u[jwin], np.inf)
            k = int(np.argmin(q))
            ri, ci = divmod(k, len(win))
            if q[ri, ci] < best_q:
                best_q = float(q[ri, ci])
                best = (int(rows[ri]), int(jwin[ri, ci]),
                        float(dwin[ri, ci]))
            more = below[:, -1]
            rows = rows[more]
            start = start[more] + len(win)
        i, j, dij = best
        li = 0.5 * dij + (S[i] - S[j]) / (2.0 * (r - 2))
        lj = dij - li
        li, lj = max(li, 0.0), max(lj, 0.0)
        newick[i] = f"({newick[i]}:{li:.6g},{newick[j]}:{lj:.6g})"
        # merge j into slot i
        alive[j] = False
        rest = act[(act != i) & (act != j)]
        newrow = 0.5 * (D[i, rest] + D[j, rest] - dij)
        S[rest] += newrow - D[i, rest] - D[j, rest]
        S[i] = newrow.sum(dtype=np.float64)
        D[i, rest] = newrow
        D[rest, i] = newrow
        gen[i] += 1
        gen[j] += 1
        build_row(i, rest)
        advance(i)
        stale = rest[(head_j[rest] == i) | (head_j[rest] == j)]
        for k in stale:
            advance(int(k))
        r -= 1
    i, j = np.nonzero(alive)[0]
    d = max(float(D[i, j]), 0.0)
    return f"({newick[i]}:{d / 2:.6g},{newick[j]}:{d / 2:.6g});"


def upgma(D: np.ndarray, labels) -> str:
    """UPGMA (average-linkage, ultrametric) -> Newick (reference
    `jx treeplot -method upgma` on GRM input). Branch lengths place
    every tip at the same root distance (heights = merge distance / 2)."""
    D = np.asarray(D, np.float64).copy()
    n = D.shape[0]
    labels = [str(lb) for lb in labels]
    np.fill_diagonal(D, np.inf)
    size = np.ones(n)
    height = np.zeros(n)
    newick = {i: labels[i] for i in range(n)}
    alive = np.ones(n, bool)
    for _ in range(n - 1):
        sub = np.where(alive[:, None] & alive[None, :], D, np.inf)
        i, j = np.unravel_index(np.argmin(sub), sub.shape)
        h = float(sub[i, j]) / 2.0
        li, lj = h - height[i], h - height[j]
        newick[i] = (f"({newick[i]}:{max(li, 0.0):.6g},"
                     f"{newick[j]}:{max(lj, 0.0):.6g})")
        # average-linkage update into slot i
        rest = alive.copy()
        rest[[i, j]] = False
        D[i, rest] = ((size[i] * D[i, rest] + size[j] * D[j, rest])
                      / (size[i] + size[j]))
        D[rest, i] = D[i, rest]
        size[i] += size[j]
        height[i] = h
        alive[j] = False
    root = int(np.nonzero(alive)[0][0])
    return newick[root] + ";"


def nj_tree(pg: PackedGenotypes, block: int = config.DEFAULT_SNP_BLOCK) -> str:
    D = ibs_distance(pg, block)
    return neighbor_joining(D, pg.samples)


# ---------------------------------------------------------------- bootstrap
# reference: script/tree.py -b/--bootstrap with --support bootstrap — site
# resampling, NJ per replicate, bipartition support on the main tree.


def weighted_pair_counts(codes: np.ndarray, w: np.ndarray, n_states: int):
    """Weighted (both-observed, mismatch, |0-2| cross) pair counts.

    codes: (m, n) small ints with -1 missing; w: (m,) site weights.
    All three are (n, n) matrices from indicator matmuls — the same
    bit-plane algebra the IBS kernel uses, here in numpy f64 (bootstrap
    panels are small-n).
    """
    codes = np.asarray(codes)
    w = np.asarray(w, np.float64)
    obs = (codes >= 0).astype(np.float64)
    wobs = obs * w[:, None]
    both = obs.T @ wobs
    same = np.zeros_like(both)
    planes = [(codes == k).astype(np.float64) for k in range(n_states)]
    for I in planes:
        same += I.T @ (I * w[:, None])
    cross02 = np.zeros_like(both)
    if n_states >= 3:
        cross02 = planes[0].T @ (planes[2] * w[:, None])
        cross02 = cross02 + cross02.T
    return both, both - same, cross02


def weighted_ibs_distance(codes: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Site-weighted genotype IBS distance: sum w|gi-gj| / (2 sum w)."""
    both, mismatch, cross02 = weighted_pair_counts(codes, w, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        D = np.where(both > 0, (mismatch + cross02) / (2.0 * both), 0.0)
    np.fill_diagonal(D, 0.0)
    return D


def weighted_jc_distance(codes: np.ndarray, w: np.ndarray,
                         n_states: int = 4) -> np.ndarray:
    """Jukes-Cantor distance from a coded alignment (A/C/G/T -> 0..3)."""
    both, mismatch, _ = weighted_pair_counts(codes, w, n_states)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(both > 0, mismatch / both, 0.0)
    a = (n_states - 1.0) / n_states
    D = -a * np.log(np.clip(1.0 - p / a, 1e-10, None))
    np.fill_diagonal(D, 0.0)
    return D


def _tree_splits(newick: str) -> set:
    """Canonical leaf bipartitions of a newick tree (internal edges only)."""
    from janusx_tpu_torch.models.mltree import parse_newick

    t = parse_newick(newick)
    all_leaves = frozenset(l for l in t.labels if l)
    below = {}
    order, stack = [], [t.root]
    while stack:
        v = stack.pop()
        order.append(v)
        stack.extend(t.children[v])
    for v in reversed(order):
        if not t.children[v]:
            below[v] = frozenset([t.labels[v]])
        else:
            acc = frozenset()
            for c in t.children[v]:
                acc |= below[c]
            below[v] = acc
    splits = set()
    for v in range(len(t.children)):
        if v == t.root or not t.children[v]:
            continue
        s = below[v]
        if len(s) < 2 or len(all_leaves - s) < 2:
            continue  # trivial split
        comp = all_leaves - s
        splits.add(s if (len(s), sorted(s)) <= (len(comp), sorted(comp)) else comp)
    return splits


def bootstrap_support(
    main_newick: str,
    codes: np.ndarray,
    labels,
    n_boot: int = 100,
    seed: int = 0,
    distance: str = "ibs",
) -> str:
    """Annotate internal nodes of the main tree with bootstrap support %.

    Sites are resampled with replacement (multinomial weights — identical
    to index resampling but keeps the matmul shapes static), one NJ tree
    per replicate, split frequencies mapped back onto the main topology.
    """
    from janusx_tpu_torch.models.mltree import parse_newick

    labels = [str(l) for l in labels]
    rng = np.random.default_rng(seed)
    m = codes.shape[0]
    dist_fn = weighted_ibs_distance if distance == "ibs" else weighted_jc_distance
    counts: dict = {}
    for _ in range(int(n_boot)):
        w = rng.multinomial(m, np.full(m, 1.0 / m)).astype(np.float64)
        D = dist_fn(codes, w)
        for s in _tree_splits(neighbor_joining(D, labels)):
            counts[s] = counts.get(s, 0) + 1
    return annotate_split_support(main_newick, counts, n_boot)


def annotate_split_support(main_newick: str, counts: dict, n_boot: int) -> str:
    """Write bipartition support percentages onto the main tree's internal
    nodes (shared by the NJ and ML bootstrap routes)."""
    from janusx_tpu_torch.models.mltree import parse_newick

    t = parse_newick(main_newick)
    all_leaves = frozenset(l for l in t.labels if l)
    below = {}
    order, stack = [], [t.root]
    while stack:
        v = stack.pop()
        order.append(v)
        stack.extend(t.children[v])
    for v in reversed(order):
        below[v] = (frozenset([t.labels[v]]) if not t.children[v]
                    else frozenset().union(*(below[c] for c in t.children[v])))

    def rec(v: int) -> str:
        if not t.children[v]:
            body = t.labels[v]
        else:
            body = "(" + ",".join(rec(c) for c in t.children[v]) + ")"
            s = below[v]
            comp = all_leaves - s
            if len(s) >= 2 and len(comp) >= 2 and v != t.root:
                canon = s if (len(s), sorted(s)) <= (len(comp), sorted(comp)) else comp
                support = 100.0 * counts.get(canon, 0) / max(1, n_boot)
                body += f"{support:.0f}"
        if v == t.root:
            return body
        return f"{body}:{t.blen[v]:.6g}"

    return rec(t.root) + ";"


def read_fasta_alignment(path: str):
    """Aligned FASTA -> (codes (m_sites, n) int8 A/C/G/T=0..3 else -1, names)."""
    import gzip

    names, seqs, cur = [], [], []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
                names.append(line[1:].split()[0])
            else:
                cur.append(line.upper())
    if cur:
        seqs.append("".join(cur))
    if not names or len(names) != len(seqs):
        raise ValueError(f"malformed FASTA: {path}")
    L = len(seqs[0])
    if any(len(s) != L for s in seqs):
        raise ValueError("FASTA sequences are not aligned (unequal lengths)")
    lut = np.full(256, -1, np.int8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    codes = np.stack([
        lut[np.frombuffer(s.encode(), np.uint8)] for s in seqs
    ]).T  # (m_sites, n)
    return codes, names


def bionj(D: np.ndarray, V: np.ndarray, labels) -> str:
    """BIONJ (Gascuel 1997): variance-weighted neighbor joining.

    Like NJ but each agglomeration picks the convex combination
    λ ∈ [0, 1] of the two merged rows that minimizes the variance of the
    reduced distance matrix: λ = 1/2 + Σ_k (v_jk − v_ik) / (2(r−2)v_ij).
    Reference: src/stats/tree.rs nj_newick_bionj_from_alignment with the
    same variance bookkeeping (reduction v_uk = λv_ik + (1−λ)v_jk −
    λ(1−λ)v_ij)."""
    D = np.asarray(D, np.float64).copy()
    V = np.asarray(V, np.float64).copy()
    n = D.shape[0]
    labels = [str(l) for l in labels]
    newick = {i: labels[i] for i in range(n)}
    active = list(range(n))
    while len(active) > 2:
        r = len(active)
        sub = D[np.ix_(active, active)]
        rowsum = sub.sum(axis=1)
        Q = (r - 2) * sub - rowsum[:, None] - rowsum[None, :]
        np.fill_diagonal(Q, np.inf)
        i_loc, j_loc = np.unravel_index(np.argmin(Q), Q.shape)
        i, j = active[i_loc], active[j_loc]
        dij = D[i, j]
        bi = 0.5 * dij + (rowsum[i_loc] - rowsum[j_loc]) / (2 * (r - 2))
        bj = dij - bi
        bi, bj = max(bi, 0.0), max(bj, 0.0)
        rest = [k for k in active if k not in (i, j)]
        vij = V[i, j]
        if vij > 1e-12 and rest:
            lam = 0.5 + float(
                np.sum(V[j, rest] - V[i, rest])) / (2.0 * (r - 2) * vij)
            lam = min(max(lam, 0.0), 1.0)
        else:
            lam = 0.5
        u = D.shape[0]
        D = np.pad(D, ((0, 1), (0, 1)))
        V = np.pad(V, ((0, 1), (0, 1)))
        for k in rest:
            D[u, k] = D[k, u] = (
                lam * (D[i, k] - bi) + (1.0 - lam) * (D[j, k] - bj)
            )
            V[u, k] = V[k, u] = (
                lam * V[i, k] + (1.0 - lam) * V[j, k]
                - lam * (1.0 - lam) * vij
            )
        newick[u] = f"({newick[i]}:{bi:.6g},{newick[j]}:{bj:.6g})"
        active = rest + [u]
    i, j = active
    return f"({newick[i]}:{max(D[i, j], 0.0) / 2:.6g},{newick[j]}:{max(D[i, j], 0.0) / 2:.6g});"


def bionj_stats(codes: np.ndarray, n_states: int, var_mode: str = "jc"):
    """Per-pair JC distance + BIONJ variance from a coded alignment.

    var modes (reference tree.rs bionj_variance_from_stats):
      binom  p(1-p)/L          (raw binomial mismatch variance)
      jc     delta-method      (binomial pushed through the JC transform)
      dist   the JC distance itself
      auto   = jc
    """
    w = np.ones(codes.shape[0])
    both, mismatch, cross02 = weighted_pair_counts(codes, w, n_states)
    if n_states == 3:  # genotype codes: |0-2| cross counts twice
        mismatch = mismatch + cross02
        denom_sites = 2.0 * both
    else:
        denom_sites = both
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(denom_sites > 0, mismatch / denom_sites, 0.0)
    p = np.clip(p, 0.0, 1.0)
    a = (n_states - 1.0) / n_states if n_states != 3 else 0.75
    d = -a * np.log(np.clip(1.0 - p / a, 1e-10, None))
    L = np.maximum(both, 1.0)
    var_p = np.maximum(p * (1.0 - p) / L, 1e-12)
    mode = var_mode if var_mode != "auto" else "jc"
    if mode == "binom":
        V = var_p
    elif mode == "dist":
        V = np.maximum(d, 1e-12)
    else:  # jc delta method
        p_clip = np.minimum(p, a - 1e-12)
        denom = np.maximum(1.0 - p_clip / a, 1e-12)
        V = np.maximum(var_p / (denom * denom), 1e-12)
    np.fill_diagonal(d, 0.0)
    np.fill_diagonal(V, 0.0)
    return d, V
