"""Approximate maximum-likelihood phylogeny (FastTree-style).

Reference: JanusX src/stats/tree.rs optimize_nni_ml_jc69 (:2820)
— NJ starting topology refined under a Jukes-Cantor-type model with
nearest-neighbor-interchange (NNI) rounds and per-edge branch-length
optimization, with a site budget for large alignments
(ml_build_site_indices :1974). The reference also shells out to vendored
FastTree; this module is the in-process equivalent.

Model: k-state JC (k=2 for biallelic genotype characters — the
Cavender-Farris-Neyman model; k=4 for nucleotide alignments):
    P_same(t) = 1/k + (1 - 1/k) e^{-mu t},  P_diff(t) = (1 - e^{-mu t})/k
with mu = k/(k-1). The per-edge likelihood is then LINEAR in
x = e^{-mu t}:  L_site(x) = x*a_site + (1-x)*b_site/k, where a/b come
from the up/down Felsenstein messages — so each branch length solves a
1-D concave problem by Newton, and NNI configurations score with four
precomputed subtree messages (no global recompute per candidate).
Site-vectorized numpy f64; per-node rescaling guards underflow.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

MIN_BLEN = 1e-7
MAX_BLEN = 5.0


@dataclass
class MlTree:
    children: list  # list[list[int]]; leaves have []
    parent: np.ndarray  # (n_nodes,), -1 for root
    blen: np.ndarray  # (n_nodes,) branch length ABOVE each node
    labels: list  # leaf labels by node id (internal nodes: "")
    root: int
    n_leaves: int
    loglik: float = float("nan")
    # per-node leaf partials + CAT rates of the last refinement, kept so
    # post-hoc passes (SH-like supports) reuse the fitted state
    partials: dict = field(default_factory=dict)
    rates: np.ndarray | None = None


def parse_newick(s: str):
    """Parse a (rooted, arbitrary-degree) newick string -> MlTree skeleton."""
    s = s.strip().rstrip(";")
    children: list = []
    parent: list = []
    blen: list = []
    labels: list = []

    def new_node():
        children.append([])
        parent.append(-1)
        blen.append(MIN_BLEN)
        labels.append("")
        return len(children) - 1

    pos = 0

    def parse() -> int:
        nonlocal pos
        node = new_node()
        if s[pos] == "(":
            pos += 1
            while True:
                c = parse()
                parent[c] = node
                children[node].append(c)
                if s[pos] == ",":
                    pos += 1
                    continue
                if s[pos] == ")":
                    pos += 1
                    break
        m = re.match(r"[^,():;]*", s[pos:])
        label = m.group(0)
        pos += len(label)
        if label:
            labels[node] = label
        if pos < len(s) and s[pos] == ":":
            m = re.match(r":([0-9eE.+-]+)", s[pos:])
            blen[node] = max(float(m.group(1)), MIN_BLEN)
            pos += len(m.group(0))
        return node

    root = parse()
    n_leaves = sum(1 for c in children if not c)
    return MlTree(
        children=children, parent=np.array(parent), blen=np.array(blen),
        labels=labels, root=root, n_leaves=n_leaves,
    )


def to_newick(t: MlTree) -> str:
    def rec(v: int) -> str:
        if not t.children[v]:
            body = t.labels[v]
        else:
            body = "(" + ",".join(rec(c) for c in t.children[v]) + ")"
        if v == t.root:
            return body
        return f"{body}:{t.blen[v]:.6g}"

    return rec(t.root) + ";"


def _postorder(t: MlTree):
    order, stack = [], [t.root]
    while stack:
        v = stack.pop()
        order.append(v)
        stack.extend(t.children[v])
    return order[::-1]


def _pmul(msg: np.ndarray, x, k: int) -> np.ndarray:
    """Message through an edge with x = e^{-mu t}:
    (P(t) @ m)_y = x*m_y + (1-x)*sum(m)/k  (k-state JC).
    ``x`` is a scalar (uniform rate) or per-site (m,) array (CAT rates:
    x_s = e^{-mu r_s t})."""
    s = msg.sum(axis=1, keepdims=True)
    if np.ndim(x):
        x = np.asarray(x)[:, None]
    return x * msg + (1.0 - x) * s / k


def _x_of(blen, k, rates=None):
    """e^{-mu t} (scalar), or per-site e^{-mu r_s t} under CAT rates."""
    mu = k / (k - 1.0)
    t = np.clip(blen, MIN_BLEN, MAX_BLEN)
    if rates is None:
        return np.exp(-mu * t)
    return np.exp(-mu * t * rates)


def _blen_of_x(x, k):
    mu = k / (k - 1.0)
    x = min(max(float(x), np.exp(-mu * MAX_BLEN)), np.exp(-mu * MIN_BLEN))
    return -np.log(x) / mu


def _down_pass(t: MlTree, leaf_part: dict, k: int, rates=None):
    """Felsenstein pruning: down[v] (n_sites, k) + PER-SITE log-scalers
    (vectors, so site weights can reweight them — bootstrap-by-weights
    composes with -ml)."""
    down, scal = {}, {}
    for v in _postorder(t):
        if not t.children[v]:
            down[v] = leaf_part[v]
            scal[v] = 0.0
            continue
        acc = None
        sc = 0.0
        for c in t.children[v]:
            m = _pmul(down[c], _x_of(t.blen[c], k, rates), k)
            acc = m if acc is None else acc * m
            sc = sc + scal[c]
        mx = np.maximum(acc.max(axis=1), 1e-300)
        down[v] = acc / mx[:, None]
        scal[v] = sc + np.log(mx)
    return down, scal


def _loglik_from_down(t: MlTree, down, scal, k: int, weights) -> float:
    """Weighted site log-likelihood: sum_s w_s * log L_s. Site weights are
    the multiplicities of a bootstrap resample (reference tree.rs weighted
    `scal` accumulation); None = all-ones."""
    site = (down[t.root] / k).sum(axis=1)
    site_log = np.log(np.maximum(site, 1e-300)) + scal[t.root]
    if weights is None:
        return float(site_log.sum())
    return float(site_log @ weights)


def _up_pass(t: MlTree, down, k: int, rates=None):
    """Outside-subtree contexts. Returns (A, atnode):
    A[v] = message at parent(v) from everything EXCEPT v's subtree,
    BEFORE crossing v's edge (pairs with down[v] in the per-edge
    closed form); atnode[v] = the same context transported across v's
    edge, i.e. the rest-of-tree message AT node v. The uniform prior
    pi = 1/k factors out and is applied in the final site sum."""
    ones = np.ones_like(down[t.root])
    A: dict = {}
    atnode = {t.root: ones}
    order = [t.root]
    while order:
        v = order.pop()
        msgs = {
            c: _pmul(down[c], _x_of(t.blen[c], k, rates), k)
            for c in t.children[v]
        }
        for c in t.children[v]:
            acc = atnode[v].copy()
            for s, m in msgs.items():
                if s != c:
                    acc = acc * m
            mx = np.maximum(acc.max(axis=1), 1e-300)
            acc = acc / mx[:, None]
            A[c] = acc
            atnode[c] = _pmul(acc, _x_of(t.blen[c], k, rates), k)
            order.append(c)
    return A, atnode


def _edge_ab(up_v: np.ndarray, down_v: np.ndarray, k: int):
    """Per-site (a, b) so that L_site(x) = x*a + (1-x)*b/k for the edge
    above v: a = sum_y up_y down_y, b = (sum up)(sum down)."""
    a = (up_v * down_v).sum(axis=1)
    b = up_v.sum(axis=1) * down_v.sum(axis=1)
    return a, b


def _optimize_x(a: np.ndarray, b: np.ndarray, k: int, x0: float,
                weights=None) -> float:
    """Newton on f(x) = sum w*log(x*a + (1-x)*b/k), concave in x in (0,1)."""
    c = b / k
    d = a - c  # f = sum w*log(c + x*d)
    w = 1.0 if weights is None else weights
    x = min(max(x0, 1e-6), 1.0 - 1e-9)
    for _ in range(30):
        denom = c + x * d
        if np.any(denom <= 0):
            x = max(x * 0.5, 1e-9)
            continue
        g = (w * d / denom).sum()
        h = -(w * (d / denom) ** 2).sum()
        if h >= 0:
            break
        step = g / h
        x_new = min(max(x - step, 1e-9), 1.0 - 1e-12)
        if abs(x_new - x) < 1e-10:
            x = x_new
            break
        x = x_new
    return x


def _optimize_t(a: np.ndarray, b: np.ndarray, k: int, rates: np.ndarray,
                t0: float, weights=None) -> float:
    """Branch length under per-site CAT rates: the edge likelihood
    L_s(t) = x_s a_s + (1-x_s) b_s/k with x_s = e^{-mu r_s t} is no
    longer linear in one unknown, so Newton runs in t-space with
    backtracking (f'' has mixed sign away from the optimum)."""
    mu = k / (k - 1.0)
    c = b / k
    d = a - c
    w = 1.0 if weights is None else weights

    def f(tt):
        L = c + np.exp(-mu * rates * tt) * d
        if np.any(L <= 0):
            return -np.inf
        return float(np.sum(w * np.log(L)))

    t = min(max(float(t0), MIN_BLEN), MAX_BLEN)
    ft = f(t)
    for _ in range(30):
        x = np.exp(-mu * rates * t)
        L = c + x * d
        if np.any(L <= 0):
            t = min(max(t * 2.0, MIN_BLEN), MAX_BLEN)
            ft = f(t)
            continue
        u = x * d / L
        g = -mu * float(np.sum(w * rates * u))
        h = (mu * mu) * float(np.sum(w * rates * rates * u * (1.0 - u)))
        step = -g / h if h > 1e-300 else (0.5 * t if g < 0 else -0.5 * t)
        # backtrack the Newton/gradient step until f does not decrease
        ok = False
        for _bt in range(12):
            tn = min(max(t + step, MIN_BLEN), MAX_BLEN)
            fn = f(tn)
            if fn >= ft - 1e-12:
                ok = True
                break
            step *= 0.5
        if not ok or abs(tn - t) < 1e-9:
            break
        t, ft = tn, fn
    return t


def optimize_branch_lengths(t: MlTree, leaf_part, k: int, rounds: int = 2,
                            weights=None, rates=None):
    """Per-edge closed-form updates from shared (stale) messages are a
    Jacobi-style simultaneous step, which can overshoot — each round
    backtracks the full update vector until the global likelihood is
    non-decreasing (guaranteed monotone)."""
    down, scal = _down_pass(t, leaf_part, k, rates)
    ll0 = _loglik_from_down(t, down, scal, k, weights)
    for _ in range(rounds):
        A, _ = _up_pass(t, down, k, rates)
        old = t.blen.copy()
        cand = t.blen.copy()
        for v in range(len(t.children)):
            if v == t.root:
                continue
            a, b = _edge_ab(A[v], down[v], k)
            if rates is None:
                x = _optimize_x(a, b, k, _x_of(t.blen[v], k), weights)
                cand[v] = _blen_of_x(x, k)
            else:
                cand[v] = _optimize_t(a, b, k, rates, t.blen[v], weights)
        step = 1.0
        ll_new = None
        for _bt in range(8):
            t.blen = old + step * (cand - old)
            down, scal = _down_pass(t, leaf_part, k, rates)
            ll = _loglik_from_down(t, down, scal, k, weights)
            if ll >= ll0 - 1e-9:
                ll_new = ll
                break
            step *= 0.5
        if ll_new is None:
            t.blen = old
            down, scal = _down_pass(t, leaf_part, k, rates)
            break
        improved = ll_new > ll0 + 1e-9
        ll0 = max(ll_new, ll0)
        if not improved:
            break
    t.loglik = ll0
    return t


def _config_site_log(G, eD, eA, eB, xc, k) -> np.ndarray:
    """Per-site log-likelihood vector of topology ((A,B)c, D)p with
    rest-of-tree context G: combine A,B at c, pass through edge c (xc),
    join D and G at p. The down-pass log-scalers are identical across
    the three NNI configurations of an edge and cancel in comparisons,
    so they are deliberately omitted."""
    mc = eA * eB
    mx = np.maximum(mc.max(axis=1), 1e-300)
    mc = mc / mx[:, None]
    mp = _pmul(mc, xc, k) * eD * G
    site = np.maximum(mp.sum(axis=1), 1e-300)
    return np.log(site) + np.log(mx)


def _score_config(G, eD, eA, eB, xc, k, weights=None):
    """Log-score of topology ((A,B)c, D)p with rest-of-tree context G:
    combine A,B at c, pass through edge c (xc), join D and G at p."""
    site_log = _config_site_log(G, eD, eA, eB, xc, k)
    if weights is None:
        return float(site_log.sum())
    return float(site_log @ weights)


def nni_round(t: MlTree, leaf_part, k: int, weights=None, rates=None) -> int:
    """One NNI step: for each internal edge (p, c) with c internal,
    children(c) = {A, B} and sibling D at p, score the three topologies
    with fixed local messages (reference collect_nni_edges/apply_nni_swap,
    tree.rs:2404,2584). Messages go stale after any swap, so only the
    single best-scoring swap is applied per step and then verified with a
    full recompute (reverted if the global likelihood drops)."""
    down, scal = _down_pass(t, leaf_part, k, rates)
    ll_before = _loglik_from_down(t, down, scal, k, weights)
    _, atnode = _up_pass(t, down, k, rates)
    best_gain, best_move = 0.0, None
    for c in range(len(t.children)):
        p = int(t.parent[c])
        if p < 0 or not t.children[c] or len(t.children[c]) != 2:
            continue
        if len(t.children[p]) != 2:
            continue
        sibs = [s for s in t.children[p] if s != c]
        if len(sibs) != 1:
            continue
        D = sibs[0]
        A, B = t.children[c]
        eA = _pmul(down[A], _x_of(t.blen[A], k, rates), k)
        eB = _pmul(down[B], _x_of(t.blen[B], k, rates), k)
        eD = _pmul(down[D], _x_of(t.blen[D], k, rates), k)
        G = atnode[p]
        xc = _x_of(t.blen[c], k, rates)
        s0 = _score_config(G, eD, eA, eB, xc, k, weights)  # current
        s1 = _score_config(G, eB, eA, eD, xc, k, weights)  # swap B <-> D
        s2 = _score_config(G, eA, eB, eD, xc, k, weights)  # swap A <-> D
        if s1 - s0 > best_gain:
            best_gain, best_move = s1 - s0, (p, c, A, D, B, "B")
        if s2 - s0 > best_gain:
            best_gain, best_move = s2 - s0, (p, c, B, D, A, "A")
    if best_move is None or best_gain < 1e-9:
        return 0
    p, c, keep, D, out, _tag = best_move
    old_cc, old_pc = list(t.children[c]), list(t.children[p])
    t.children[c] = [keep, D]
    t.children[p] = [c, out]
    t.parent[D], t.parent[out] = c, p
    down, scal = _down_pass(t, leaf_part, k, rates)
    if _loglik_from_down(t, down, scal, k, weights) <= ll_before:
        t.children[c], t.children[p] = old_cc, old_pc
        t.parent[D], t.parent[out] = p, c
        return 0
    return 1


def estimate_site_rates(t: MlTree, leaf_part, k: int, ncat: int = 8,
                        weights=None):
    """FastTree-CAT-style per-site rates: evaluate every site under a
    geometric rate ladder, assign each site its argmax category, then
    normalize to (weighted) mean rate 1 so the branch-length scale stays
    identifiable (reference vendored FastTree.c CAT approximation)."""
    ladder = np.geomspace(1.0 / 8.0, 8.0, ncat)
    n_sites = next(iter(leaf_part.values())).shape[0]
    site_ll = np.empty((ncat, n_sites))
    for i, r in enumerate(ladder):
        down, scal = _down_pass(t, leaf_part, k, np.full(n_sites, r))
        site = (down[t.root] / k).sum(axis=1)
        site_ll[i] = np.log(np.maximum(site, 1e-300)) + scal[t.root]
    rates = ladder[np.argmax(site_ll, axis=0)]
    w = np.ones(n_sites) if weights is None else np.asarray(weights, float)
    mean = float(rates @ w) / max(float(w.sum()), 1e-300)
    return rates / max(mean, 1e-300)


def spr_round(t: MlTree, leaf_part, k: int, weights=None, rates=None,
              radius: int = 5, verify_top: int = 8) -> int:
    """One subtree-prune-regraft step (FastTree-style SPR, the move set
    NNI cannot reach — reference tree.rs + vendored FastTree SPR rounds).

    Candidates: prune each subtree S (binary parent P, non-root), regraft
    onto edges within ``radius`` of the pruned position. Each candidate
    gets a CHEAP proxy score from the CURRENT tree's messages (combined
    (w + S) message against the outside context A[w]; the prune-side
    correction is ignored, so the ranking is biased near the prune
    point); the ``verify_top`` best-ranked moves are then applied and
    scored with a FULL likelihood recompute, and the single best
    verified improvement is kept (reverted otherwise) — the same
    verified-acceptance discipline as nni_round."""
    down, scal = _down_pass(t, leaf_part, k, rates)
    ll_before = _loglik_from_down(t, down, scal, k, weights)
    A, _ = _up_pass(t, down, k, rates)

    wts = None if weights is None else np.asarray(weights, float)

    def site_sum(mp, log_mx):
        site = np.maximum(mp.sum(axis=1), 1e-300)
        sl = np.log(site) + log_mx
        return float(sl.sum()) if wts is None else float(sl @ wts)

    cands = []
    n_nodes = len(t.children)
    for S in range(n_nodes):
        P = int(t.parent[S])
        if P < 0 or int(t.parent[P]) < 0 or len(t.children[P]) != 2:
            continue
        sibs = [c for c in t.children[P] if c != S]
        B = sibs[0]
        eS = _pmul(down[S], _x_of(t.blen[S], k, rates), k)
        # BFS outward from P, not entering S
        seen = {S, P}
        frontier = [(B, 1), (int(t.parent[P]), 1)]
        while frontier:
            w, dist = frontier.pop()
            if w in seen or dist > radius:
                continue
            seen.add(w)
            if w != t.root and w != B and int(t.parent[w]) != P:
                eW = _pmul(down[w], _x_of(t.blen[w], k, rates), k)
                mc = eW * eS
                mx = np.maximum(mc.max(axis=1), 1e-300)
                mp = (mc / mx[:, None]) * A[w]
                cands.append((site_sum(mp, np.log(mx)), S, w))
            nxt = list(t.children[w])
            pw = int(t.parent[w])
            if pw >= 0:
                nxt.append(pw)
            for u in nxt:
                if u not in seen:
                    frontier.append((u, dist + 1))
    if not cands:
        return 0
    cands.sort(key=lambda c: -c[0])

    def snapshot():
        return ([list(c) for c in t.children], t.parent.copy(),
                t.blen.copy())

    def restore(snap):
        t.children = [list(c) for c in snap[0]]
        t.parent = snap[1].copy()
        t.blen = snap[2].copy()

    def apply_move(S, w):
        P = int(t.parent[S])
        B = [c for c in t.children[P] if c != S][0]
        G = int(t.parent[P])
        Gp = int(t.parent[w])
        if Gp == P or w == S or w == P:
            return False
        # prune: collapse P into B under G
        t.children[G][t.children[G].index(P)] = B
        t.parent[B] = G
        t.blen[B] = min(t.blen[B] + t.blen[P], MAX_BLEN)
        # regraft: reuse P as the junction splitting w's edge
        Gp = int(t.parent[w])  # may have changed if w was B's sibling
        t.children[P] = [S, w]
        t.parent[S] = P
        t.parent[w] = P
        t.children[Gp][t.children[Gp].index(w)] = P
        t.parent[P] = Gp
        half = max(t.blen[w] / 2.0, MIN_BLEN)
        t.blen[P] = half
        t.blen[w] = half
        return True

    base = snapshot()
    best_ll, best_snap = ll_before, None
    for _score, S, w in cands[:verify_top]:
        if not apply_move(S, w):
            restore(base)
            continue
        d2, s2 = _down_pass(t, leaf_part, k, rates)
        ll = _loglik_from_down(t, d2, s2, k, weights)
        if ll > best_ll + 1e-9:
            best_ll, best_snap = ll, snapshot()
        restore(base)
    if best_snap is None:
        return 0
    restore(best_snap)
    t.loglik = best_ll
    return 1


def genotype_leaf_partials(codes: np.ndarray, site_budget: int = 2000,
                           seed: int = 0):
    """2-state (CFN) leaf partials from dosage codes (m, n): state 0 =
    ref-hom, state 1 = alt-hom, het/missing = ambiguous (ones).
    Subsamples sites to ``site_budget`` (reference site budget,
    tree.rs:1974)."""
    m, n = codes.shape
    if m > site_budget:
        rng = np.random.default_rng(seed)
        rows = np.sort(rng.choice(m, size=site_budget, replace=False))
        codes = codes[rows]
        m = site_budget
    parts = []
    ct = codes.T  # (n, m)
    for i in range(n):
        P = np.ones((m, 2))
        P[ct[i] == 0, 1] = 0.0
        P[ct[i] == 2, 0] = 0.0
        parts.append(P)
    return parts


def me_nni_start(newick: str, D: np.ndarray, labels: list,
                 max_rounds: int | None = None) -> str:
    """Minimum-evolution NNI improvement of a starting topology.

    FastTree builds its -ml start tree by minimum evolution rather than
    plain NJ (JanusX src/FastTree.c ME NNIs/SPRs before ML);
    this is the in-process equivalent: repeated NNI sweeps over the NJ
    topology, each internal edge tested with the four-point condition on
    subtree-average distances (the OLS-ME selection rule of Desper &
    Gascuel's FastNNI) until no swap improves. Branch lengths are left
    alone — the ML stage re-optimizes them anyway.

    O(n^2) per sweep via per-node distance-row sums; topology-only."""
    t = parse_newick(newick)
    n = t.n_leaves
    if max_rounds is None:
        max_rounds = 2 * n
    lab_to_row = {lab: i for i, lab in enumerate(labels)}
    leaf_row = {}
    for v in range(len(t.children)):
        if not t.children[v]:
            leaf_row[v] = lab_to_row[t.labels[v]]

    nL = D.shape[0]

    def node_state():
        """per-node: bool mask over D rows + distance-row sum + count."""
        mask = {}
        S = {}
        for v in _postorder(t):
            if not t.children[v]:
                m = np.zeros(nL, bool)
                m[leaf_row[v]] = True
                mask[v] = m
                S[v] = D[leaf_row[v]].astype(np.float64)
            else:
                m = np.zeros(nL, bool)
                s = np.zeros(nL)
                for c in t.children[v]:
                    m |= mask[c]
                    s += S[c]
                mask[v], S[v] = m, s
        return mask, S

    def avg(Sx, cx, my):
        cy = int(my.sum())
        if cx == 0 or cy == 0:
            return 0.0
        return float(Sx[my].sum()) / (cx * cy)

    for _ in range(max_rounds):
        mask, S = node_state()
        swapped = 0
        for v in range(len(t.children)):
            if len(t.children[v]) != 2 or t.parent[v] < 0:
                continue
            u = t.parent[v]
            a, b = t.children[v]
            for c in list(t.children[u]):
                if c == v:
                    continue
                ma, mb, mc = mask[a], mask[b], mask[c]
                mr = ~(ma | mb | mc)
                if not mr.any():
                    continue
                ca, cb, cc = int(ma.sum()), int(mb.sum()), int(mc.sum())
                # current (A,B | C,R) vs the two NNI alternatives
                s_ab = avg(S[a], ca, mb) + avg(S[c], cc, mr)
                s_ac = avg(S[a], ca, mc) + avg(S[b], cb, mr)
                s_bc = avg(S[b], cb, mc) + avg(S[a], ca, mr)
                best = min(s_ab, s_ac, s_bc)
                if best >= s_ab - 1e-12:
                    continue
                # swap C with B (s_ac wins) or with A (s_bc wins)
                out = b if best == s_ac else a
                t.children[v].remove(out)
                t.children[v].append(c)
                t.children[u].remove(c)
                t.children[u].append(out)
                t.parent[out], t.parent[c] = u, v
                t.blen[out], t.blen[c] = t.blen[c], t.blen[out]
                mask, S = node_state()
                swapped += 1
                break  # children lists changed: move to the next edge
        if swapped == 0:
            break
    return to_newick(t)


def gamma20_rescale(t: MlTree, leaf_part: dict, k: int, weights=None,
                    ncat: int = 20):
    """FastTree ``-gamma`` semantics: after the CAT-approximation search,
    rescale the tree and report the discrete-Gamma(20) log-likelihood
    (JanusX src/FastTree.c Gamma20LogLk / RescaleGammaLogLk).

    Site likelihoods are evaluated once on a geometric ladder of uniform
    rate multipliers (each is one Felsenstein down-pass); the Gamma
    mixture loglik for any (alpha, scale) then interpolates the ladder in
    log-rate — so the 2-D (alpha, scale) ML grid + refinement costs no
    further tree passes. Mutates ``t.blen`` by the ML scale and returns
    (gamma_loglik, alpha, scale)."""
    from scipy.special import gammainc, logsumexp
    from scipy.stats import gamma as _sgamma

    n_sites = next(iter(leaf_part.values())).shape[0]
    ladder = np.geomspace(2.0 ** -6, 2.0 ** 6, 49)
    site_ll = np.empty((len(ladder), n_sites))
    for i, e in enumerate(ladder):
        down, scal = _down_pass(t, leaf_part, k, np.full(n_sites, e))
        site = (down[t.root] / k).sum(axis=1)
        site_ll[i] = np.log(np.maximum(site, 1e-300)) + scal[t.root]
    loge = np.log(ladder)
    wv = (np.ones(n_sites) if weights is None
          else np.asarray(weights, np.float64))

    def interp(eff):
        x = np.clip(np.log(eff), loge[0], loge[-1])
        j = np.clip(np.searchsorted(loge, x) - 1, 0, len(loge) - 2)
        w = (x - loge[j]) / (loge[j + 1] - loge[j])
        return site_ll[j] * (1 - w[:, None]) + site_ll[j + 1] * w[:, None]

    def cat_means(alpha):
        """Yang-1994 mean rates of the ncat equal-probability Gamma
        categories (shape alpha, mean 1): K * (P(a+1, a b_{i+1}) -
        P(a+1, a b_i)) with b the quantile boundaries."""
        b = _sgamma.ppf(np.arange(1, ncat) / ncat, alpha, scale=1.0 / alpha)
        Pb = np.concatenate([[0.0], gammainc(alpha + 1.0, alpha * b), [1.0]])
        return np.maximum(ncat * np.diff(Pb), 1e-6)

    def ll_of(alpha, c):
        L = interp(cat_means(alpha) * c)
        return float((logsumexp(L, axis=0) - np.log(ncat)) @ wv)

    alphas = np.geomspace(0.15, 20.0, 21)
    scales = np.geomspace(0.3, 3.0, 21)
    best = (-np.inf, 1.0, 1.0)
    for a in alphas:
        for c in scales:
            ll = ll_of(a, c)
            if ll > best[0]:
                best = (ll, float(a), float(c))
    # one local refinement at half the grid spacing
    ll0, a0, c0 = best
    for a in a0 * np.array([0.85, 0.93, 1.0, 1.08, 1.18]):
        for c in c0 * np.array([0.9, 0.95, 1.0, 1.05, 1.11]):
            ll = ll_of(a, c)
            if ll > best[0]:
                best = (ll, float(a), float(c))
    gamma_ll, alpha, scale = best
    t.blen = np.clip(t.blen * scale, MIN_BLEN, MAX_BLEN)
    return gamma_ll, alpha, scale


def ml_refine_tree(
    newick: str,
    leaf_partials: list,
    leaf_names: list,
    k: int = 2,
    nni_rounds: int | None = None,
    bl_rounds: int = 2,
    weights=None,
    rate_categories: int = 1,
    spr: bool = True,
    spr_radius: int = 5,
) -> MlTree:
    """NJ topology -> approximate-ML tree: alternate verified single-swap
    NNI steps and monotone branch-length rounds until no swap improves,
    then verified SPR steps (re-entering NNI after each accepted
    regraft) — the FastTree move schedule in miniature. Default budget
    4*n_leaves NNI steps and n_leaves SPR steps.

    ``weights``: per-site multiplicities (bootstrap resamples compose
    with -ml by reweighting instead of materializing resampled
    alignments). ``rate_categories`` > 1 enables FastTree-CAT-style
    per-site rates: estimated once on the branch-optimized start tree,
    then held fixed through the search."""
    t = parse_newick(newick)
    if nni_rounds is None:
        nni_rounds = 4 * t.n_leaves
    name_to_part = dict(zip(leaf_names, leaf_partials))
    leaf_part = {}
    for v in range(len(t.children)):
        if not t.children[v]:
            if t.labels[v] not in name_to_part:
                raise ValueError(f"leaf {t.labels[v]!r} missing from alignment")
            leaf_part[v] = name_to_part[t.labels[v]]
    if weights is not None:
        weights = np.asarray(weights, np.float64).reshape(-1)
        n_sites = next(iter(leaf_part.values())).shape[0]
        if len(weights) != n_sites:
            raise ValueError(
                f"site weights length {len(weights)} != {n_sites} sites")
    t.blen = np.clip(t.blen, MIN_BLEN, MAX_BLEN)
    rates = None
    optimize_branch_lengths(t, leaf_part, k, rounds=bl_rounds,
                            weights=weights)
    if rate_categories > 1:
        rates = estimate_site_rates(t, leaf_part, k, ncat=rate_categories,
                                    weights=weights)
        optimize_branch_lengths(t, leaf_part, k, rounds=bl_rounds,
                                weights=weights, rates=rates)

    def nni_until_done(budget):
        for _ in range(budget):
            swaps = nni_round(t, leaf_part, k, weights=weights, rates=rates)
            optimize_branch_lengths(t, leaf_part, k, rounds=1,
                                    weights=weights, rates=rates)
            if swaps == 0:
                break

    nni_until_done(nni_rounds)
    if spr:
        for _ in range(max(1, t.n_leaves)):
            moved = spr_round(t, leaf_part, k, weights=weights, rates=rates,
                              radius=spr_radius)
            if moved == 0:
                break
            optimize_branch_lengths(t, leaf_part, k, rounds=1,
                                    weights=weights, rates=rates)
            nni_until_done(nni_rounds)
    t.partials = leaf_part
    t.rates = rates
    return t


def ml_bootstrap_support(
    main_newick: str,
    leaf_partials: list,
    leaf_names: list,
    k: int = 2,
    n_boot: int = 100,
    seed: int = 0,
    nni_rounds: int | None = None,
) -> str:
    """Bootstrap support for an ML tree: each replicate draws multinomial
    SITE WEIGHTS and refines under the weighted likelihood (no resampled
    alignments materialized — the weighted `scal` accumulation makes -b
    compose with -ml, reference tree.rs bootstrap-with-ml)."""
    from janusx_tpu_torch.models.tree import _tree_splits, annotate_split_support

    rng = np.random.default_rng(seed)
    m = leaf_partials[0].shape[0]
    counts: dict = {}
    for _ in range(int(n_boot)):
        w = rng.multinomial(m, np.full(m, 1.0 / m)).astype(np.float64)
        t = ml_refine_tree(main_newick, leaf_partials, leaf_names, k=k,
                           nni_rounds=nni_rounds, weights=w)
        for s in _tree_splits(to_newick(t)):
            counts[s] = counts.get(s, 0) + 1
    return annotate_split_support(main_newick, counts, n_boot)


def shlike_support(t: MlTree, leaf_part, k: int, n_res: int = 1000,
                   seed: int = 0, weights=None, rates=None) -> dict:
    """SH-like local supports (reference `jx tree -ml --support shlike`,
    shlike_support_on_cache tree.rs:4686 legacy local-bootstrap form):
    for each internal edge eligible for NNI, compute the per-site
    log-likelihoods of the current configuration and its two NNI
    alternatives, then draw ``n_res`` RELL multinomial site resamples
    (shared across edges); the support of the edge is the fraction of
    resamples in which the current configuration stays at least as good
    as both alternatives (resampled sum of s0-s1 and s0-s2 both >= 0 —
    tree.rs:4905-4913). The reference's adaptive-rep/winsorization
    variance-reduction knobs are deliberately not reproduced. Returns
    {internal node id: support in [0, 1]}."""
    down, _scal = _down_pass(t, leaf_part, k, rates)
    _, atnode = _up_pass(t, down, k, rates)
    m = down[t.root].shape[0]
    rng = np.random.default_rng(seed)
    if weights is None:
        p_site = np.full(m, 1.0 / m)
        ndraw = m
    else:
        w = np.asarray(weights, np.float64).reshape(-1)
        p_site = w / w.sum()
        ndraw = int(round(w.sum()))
    W = rng.multinomial(ndraw, p_site, size=int(n_res)).astype(np.float64)
    support: dict = {}
    for c in range(len(t.children)):
        p = int(t.parent[c])
        if p < 0 or not t.children[c] or len(t.children[c]) != 2:
            continue
        if len(t.children[p]) != 2:
            continue
        sibs = [s for s in t.children[p] if s != c]
        if len(sibs) != 1:
            continue
        D = sibs[0]
        A, B = t.children[c]
        eA = _pmul(down[A], _x_of(t.blen[A], k, rates), k)
        eB = _pmul(down[B], _x_of(t.blen[B], k, rates), k)
        eD = _pmul(down[D], _x_of(t.blen[D], k, rates), k)
        G = atnode[p]
        xc = _x_of(t.blen[c], k, rates)
        s0 = _config_site_log(G, eD, eA, eB, xc, k)
        s1 = _config_site_log(G, eB, eA, eD, xc, k)
        s2 = _config_site_log(G, eA, eB, eD, xc, k)
        cur = W @ s0
        alt = np.maximum(W @ s1, W @ s2)
        support[c] = float(np.mean(cur >= alt))
    return support


def to_newick_with_support(t: MlTree, support: dict) -> str:
    """Newick with internal-node support labels `(...)NN:blen`
    (percent, same convention as the NJ bootstrap annotator)."""
    def rec(v: int) -> str:
        if not t.children[v]:
            body = t.labels[v]
        else:
            body = "(" + ",".join(rec(c) for c in t.children[v]) + ")"
            if v in support:
                body += str(int(round(100.0 * support[v])))
        if v == t.root:
            return body
        return f"{body}:{t.blen[v]:.6g}"

    return rec(t.root) + ";"


def ml_tree(pg, site_budget: int | None = None, seed: int = 0,
            nni_rounds: int | None = None, rate_categories: int = 1,
            spr: bool = True, me_start: bool = True,
            gamma: bool = False) -> tuple[str, float]:
    """Approximate-ML tree from packed genotypes: IBS-NJ start improved
    by minimum-evolution NNIs (FastTree's start-tree recipe; disable
    with me_start=False) + CFN NNI/SPR/branch-length refinement
    (optionally with CAT per-site rates). With ``gamma``, the fitted
    tree is rescaled to the ML discrete-Gamma(20) likelihood and that
    loglik is returned (FastTree -gamma). Returns (newick, loglik)."""
    from janusx_tpu_torch import config
    from janusx_tpu_torch.models.tree import ibs_distance, neighbor_joining

    if site_budget is None:
        site_budget = config.knob("JX_TPU_ML_SITE_BUDGET")
    samples = [str(s) for s in pg.samples]
    D = ibs_distance(pg)
    nwk = neighbor_joining(D, samples)
    if me_start:
        nwk = me_nni_start(nwk, D, samples)
    parts = genotype_leaf_partials(pg.dosages(), site_budget, seed)
    t = ml_refine_tree(nwk, parts, samples, k=2,
                       nni_rounds=nni_rounds,
                       rate_categories=rate_categories, spr=spr)
    if gamma:
        gll, _alpha, _scale = gamma20_rescale(t, t.partials, k=2)
        return to_newick(t), gll
    return to_newick(t), t.loglik
