"""GARFIELD: logic-rule (epistasis) association search (port of
janusx_tpu/models/garfield.py).

Binary SNP features (hom-alt indicators) are rows of a 0/1 matrix B
(m, n). Scoring every AND/AND-NOT/XOR extension of a beam seed against
every marker reduces to two products:

    num[s, j]  = (b_s ∘ t) · b_j     -> (S, n) @ (n, m)
    cnt[s, j]  = b_s · b_j           -> (S, n) @ (n, m)

where t is the centered residual (continuous traits, point-biserial
corr^2 score) or the 0/1 phenotype (binary traits, MCC^2 score). AND-NOT
derives from the same products via complements, XOR from
inclusion-exclusion. The beam keeps the top-B rules per depth;
significance comes from a maxT permutation null.

Where the work runs. B is built on the device once per ``garfield_scan``
from the packed 2-bit codes (code 2 = hom-alt; a missing call and a
padding lane never are) and stays there as f32: ``garfield_window_scan``
builds it once for the panel and takes each window as a row gather. Per
search the device scores depth 1 in f64 (row chunks, so B is never cast
whole), takes the beam's seeds by ``torch.topk``, scores the extensions in
f32 with full-f32 products (the reference's Precision.HIGHEST) and keeps
the ``max(4, beam // len(frontier))`` best markers of each (seed, op) by
``torch.topk``; only those indices, scores and counts, and the B rows of
the rules the beam keeps, come to the host. The ML pre-selection screen
runs on the device too. The host keeps the reference's bookkeeping line
for line: the candidate filters, the ``seen`` set, the new rule vectors,
and the numpy generator of the permutations and of the screen's pairs, so
a seed permutes exactly as the reference does.

Ties: the reference orders equal scores by ``np.argsort(...)[::-1]``,
whose order for equal keys is unspecified; ``torch.topk`` has its own.
Identical indicator rows (LD) score alike, as do a rule and its
complement, so the rules kept on a tie may carry other marker names than
the reference's, with the same scores.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from janusx_tpu_torch import config
from janusx_tpu_torch.io.packed import PackedGenotypes
from janusx_tpu_torch.ops.decode import unpack_codes

_EPS = 1e-9
_OPS = ("AND", "ANDN", "XOR")
_ROWS = 65_536  # marker rows per chunk of the B build and of the f64 depth-1 pass
f32, f64 = torch.float32, torch.float64


def hom_alt_matrix(pg: PackedGenotypes, rows=None, device=None) -> torch.Tensor:
    """The (m, n) f32 hom-alt indicator matrix B = (code == 2) of ``pg``'s
    rows (all, or ``rows``) on the device, decoded from the packed codes in
    chunks of _ROWS markers. Equal to ``pg.dosages() == 2``: a missing call
    (code 3) and a padding lane are not hom-alt."""
    dev = config.resolve_device(device)
    n = pg.n_samples
    packed = pg.packed if rows is None else pg.packed[np.asarray(rows)]
    B = torch.empty((packed.shape[0], n), dtype=f32, device=dev)
    for s in range(0, packed.shape[0], _ROWS):
        pk = torch.as_tensor(np.ascontiguousarray(packed[s:s + _ROWS]), device=dev)
        B[s:s + _ROWS] = unpack_codes(pk)[:, :n] == 2
    return B


def _score(num, cnt, t2sum, n, mode):
    """corr^2 (point-biserial, ``mode="corr"``) or MCC^2 (``"mcc"``: num =
    true positives, t2sum = the case count) of rules with ``cnt`` carriers;
    the dtype follows the operands."""
    if mode == "corr":
        var = cnt * (1.0 - cnt / n)
        return (num * num) / (t2sum * torch.clamp(var, min=_EPS))
    tp = num
    fp = cnt - tp
    fn = t2sum - tp
    tn = n - cnt - fn
    s = tp * tn - fp * fn
    den = (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)
    return (s * s) / torch.clamp(den, min=_EPS)


def _marker_sums(B: torch.Tensor, t: torch.Tensor):
    """(1, m) carrier counts and (1, m) t-sums of every marker, in B's and
    t's dtype."""
    return B.sum(dim=1)[None, :], (B @ t)[None, :]


def _extension_scores(Bseed, B, t, t2sum, n_real: float, mode: str, mark=None):
    """Scores of AND / AND-NOT / XOR extensions for each (seed, marker).

    Bseed: (S, n) 0/1 seed rule vectors; B: (m, n) 0/1 marker features;
    t: (n,) centered residual (mode="corr") or 0/1 phenotype (mode="mcc"),
    all f32 on one device; ``mark`` the search's ``_marker_sums(B, t)``.
    Returns dict op -> ((S, m) score, (S, m) support)."""
    bt = Bseed * t[None, :]
    num_and = bt @ B.T  # (S, m)
    cnt_and = Bseed @ B.T  # (S, m)
    seed_cnt = torch.sum(Bseed, dim=1)[:, None]
    seed_num = torch.sum(bt, dim=1)[:, None]
    mark_cnt, mark_num = _marker_sums(B, t) if mark is None else mark
    pairs = {
        "AND": (num_and, cnt_and),
        "ANDN": (seed_num - num_and, seed_cnt - cnt_and),
        "XOR": (
            seed_num + mark_num - 2.0 * num_and,
            seed_cnt + mark_cnt - 2.0 * cnt_and,
        ),
    }
    return {op: (_score(num, cnt, t2sum, n_real, mode), cnt)
            for op, (num, cnt) in pairs.items()}


def _extension_top(Bseed, B, t, t2sum, n_real, mode, mark, min_support: int, k: int):
    """The k best markers of each (seed, op) among those whose support lies
    in [min_support, n - min_support] (the others score 0), on the device.
    Returns host arrays (S, 3, k) of scores (f32) and marker indices."""
    ext = _extension_scores(Bseed, B, t, t2sum, n_real, mode, mark)
    vals, idx = [], []
    for op in _OPS:
        scores, counts = ext[op]
        ok = (counts >= min_support) & (counts <= n_real - min_support)
        v, i = torch.topk(torch.where(ok, scores, torch.zeros_like(scores)), k, dim=1)
        vals.append(v)
        idx.append(i)
    return (torch.stack(vals, dim=1).cpu().numpy(),
            torch.stack(idx, dim=1).cpu().numpy())


def _host_rows(B: torch.Tensor, idx) -> dict:
    """{j: B[j] as a host uint8 vector} for the marker indices ``idx``,
    gathered on the device and copied in one transfer."""
    idx = sorted(set(int(j) for j in idx))
    if not idx:
        return {}
    rows = B.index_select(0, torch.as_tensor(idx, device=B.device)).to(torch.uint8)
    return dict(zip(idx, rows.cpu().numpy()))


@dataclass
class Rule:
    snps: tuple  # marker indices
    ops: tuple  # "VAR"/"NOT", then "AND"/"ANDN"/"XOR" per extension
    score: float  # corr^2 (continuous) or MCC^2 (binary) vs target
    support: int  # carriers

    def describe(self, snp_names) -> str:
        head = str(snp_names[self.snps[0]])
        parts = [f"NOT {head}" if self.ops[0] == "NOT" else head]
        for op, idx in zip(self.ops[1:], self.snps[1:]):
            shown = "AND NOT" if op == "ANDN" else op
            parts.append(f"{shown} {snp_names[idx]}")
        return " ".join(parts)


@dataclass
class GarfieldResult:
    rules: list  # Rule, sorted by score desc
    perm_max_scores: np.ndarray  # maxT null distribution
    pvalues: np.ndarray  # empirical p per rule
    mode: str = "corr"


def _residualize(y, covariates, K=None):
    y = np.asarray(y, np.float64).reshape(-1)
    n = len(y)
    X = np.ones((n, 1)) if covariates is None else np.concatenate(
        [np.ones((n, 1)), np.asarray(covariates, np.float64)], axis=1
    )
    if K is not None:
        from janusx_tpu_torch.gs.blup import fit_gblup

        mdl = fit_gblup(K, y, np.arange(n), None if covariates is None else covariates)
        u = K @ mdl.alpha
        # subtract the REML (GLS) fixed-effect fit — the one alpha was
        # computed against — not an OLS refit, which would leave
        # covariate-direction signal in the residual under structure
        r = y - X @ mdl.beta - u
    else:
        b, *_ = np.linalg.lstsq(X, y, rcond=None)
        r = y - X @ b
    return r - r.mean()


def _single_scores(B, t, t2sum, mode, n):
    """Depth-1 scores for every marker and its negation, in f64 on B's
    device: returns (2m,) scores and supports, the negations second."""
    m = B.shape[0]
    tt = torch.as_tensor(np.asarray(t, np.float64), device=B.device)
    cnt = torch.empty(m, dtype=f64, device=B.device)
    num = torch.empty(m, dtype=f64, device=B.device)
    for s in range(0, m, _ROWS):
        blk = B[s:s + _ROWS].to(f64)
        cnt[s:s + _ROWS] = blk.sum(dim=1)
        num[s:s + _ROWS] = blk @ tt
    t_sum = float(t.sum())
    # negated literal: support n - cnt, num t_sum - num
    cnts = torch.cat([cnt, n - cnt])
    nums = torch.cat([num, t_sum - num])
    return _score(nums, cnts, t2sum, float(n), mode), cnts


def _beam_search(B, t, depth, beam, snp_min_support, mode="corr"):
    """One search over the device matrix B (m, n) f32 against the host
    target t (n,)."""
    m, n = B.shape
    t = np.asarray(t, np.float64)
    t2sum = float(t @ t) if mode == "corr" else float(t.sum())
    tj = torch.as_tensor(t, dtype=f32, device=B.device)

    s1, cnts1 = _single_scores(B, t, t2sum, mode, n)
    valid = (cnts1 >= snp_min_support) & (cnts1 <= n - snp_min_support)
    s1 = torch.where(valid, s1, torch.zeros_like(s1))
    top1, order = torch.topk(s1, min(beam, 2 * m))
    order, top1, cnt1 = (a.cpu().numpy() for a in (order, top1, cnts1[order]))
    rules: list[Rule] = []
    for i, sc, c in zip(order, top1, cnt1):
        neg = i >= m
        j = int(i % m)
        rules.append(Rule((j,), ("NOT" if neg else "VAR",), float(sc), int(c)))
    Bh = _host_rows(B, [ru.snps[0] for ru in rules])
    frontier = [
        (ru, (1 - Bh[ru.snps[0]] if ru.ops[0] == "NOT" else Bh[ru.snps[0]]))
        for ru in rules
    ]
    all_rules = list(rules)
    mark = _marker_sums(B, tj) if depth > 1 else None
    for _d in range(1, depth):
        seeds = np.stack([v for _, v in frontier]).astype(np.float32)
        top_s, top_j = _extension_top(
            torch.as_tensor(seeds, device=B.device), B, tj, t2sum, float(n), mode,
            mark, snp_min_support, min(max(4, beam // len(frontier)), m))
        cand = []
        for si, (ru, vec) in enumerate(frontier):
            for o, op in enumerate(_OPS):
                scr, top = top_s[si, o], top_j[si, o]
                for kk, j in enumerate(top):
                    if int(j) in ru.snps or scr[kk] <= ru.score + 1e-9:
                        continue
                    cand.append((float(scr[kk]), si, int(j), op))
        cand.sort(reverse=True)
        Bh = _host_rows(B, [j for _, _, j, _ in cand])
        next_frontier = []
        seen = set()
        for score, si, j, op in cand:
            ru, vec = frontier[si]
            key = (tuple(sorted(ru.snps + (j,))), op, ru.ops[0])
            if key in seen:
                continue
            seen.add(key)
            if op == "AND":
                newvec = vec & Bh[j]
            elif op == "ANDN":
                newvec = vec & (1 - Bh[j])
            else:
                newvec = vec ^ Bh[j]
            newvec = newvec.astype(np.uint8)
            new_rule = Rule(
                ru.snps + (j,), ru.ops + (op,), score, int(newvec.sum())
            )
            next_frontier.append((new_rule, newvec))
            if len(next_frontier) >= beam:
                break
        if not next_frontier:
            break
        frontier = next_frontier
        all_rules.extend(ru for ru, _ in frontier)
    all_rules.sort(key=lambda ru: ru.score, reverse=True)
    return all_rules


def preselect_features(
    B: torch.Tensor, t: np.ndarray, mode: str, top_k: int,
    pair_sample: int = 2000, seed: int = 0,
) -> np.ndarray:
    """ML feature pre-selection (reference src/ml/engine.rs:14-27):
    univariate scores plus a sampled pairwise-AND interaction screen —
    keeps markers that score well alone OR inside a sampled AND pair. The
    pairs are drawn on the host by the reference's generator; the scores,
    the per-marker maxima and the top-k run on B's device."""
    m, n = B.shape
    if m <= top_k:
        return np.arange(m)
    t = np.asarray(t, np.float64)
    t2sum = float(t @ t) if mode == "corr" else float(t.sum())
    s1, _ = _single_scores(B, t, t2sum, mode, n)
    uni = torch.maximum(s1[:m], s1[m:])  # best of literal / negated literal
    rng = np.random.default_rng(seed)
    n_pairs = min(pair_sample, m * (m - 1) // 2)
    ii = rng.integers(0, m, size=n_pairs)
    jj = rng.integers(0, m, size=n_pairs)
    pair_best = torch.zeros(m, dtype=f64, device=B.device)
    if n_pairs:
        it = torch.as_tensor(ii, device=B.device)
        jt = torch.as_tensor(jj, device=B.device)
        tt = torch.as_tensor(t, device=B.device)
        Bi = B.index_select(0, it).to(f64)
        Bjp = B.index_select(0, jt).to(f64)
        num_and = ((Bi * tt[None, :]) * Bjp).sum(dim=1)
        cnt_and = (Bi * Bjp).sum(dim=1)
        seed_cnt, seed_num = Bi.sum(dim=1), Bi @ tt
        mark_cnt, mark_num = Bjp.sum(dim=1), Bjp @ tt
        pairs = {
            "AND": (num_and, cnt_and),
            "ANDN": (seed_num - num_and, seed_cnt - cnt_and),
            "XOR": (seed_num + mark_num - 2.0 * num_and,
                    seed_cnt + mark_cnt - 2.0 * cnt_and),
        }
        for op in _OPS:
            num_o, cnt_o = pairs[op]
            d = _score(num_o, cnt_o, t2sum, float(n), mode)
            pair_best.scatter_reduce_(0, it, d, "amax")
            pair_best.scatter_reduce_(0, jt, d, "amax")
    combined = torch.maximum(uni, 0.5 * pair_best)
    return np.sort(torch.topk(combined, top_k).indices.cpu().numpy())


def garfield_scan(
    pg: PackedGenotypes,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    K: np.ndarray | None = None,
    depth: int = 2,
    beam: int = 64,
    n_perm: int = 100,
    top_rules: int = 50,
    min_support: int = 5,
    seed: int = 0,
    trait_type: str = "auto",
    preselect: int = 0,
    snp_subset: np.ndarray | None = None,
    device=None,
) -> GarfieldResult:
    """Search AND/AND-NOT/XOR rules over hom-alt indicators.

    Continuous traits score by residualized point-biserial corr^2
    (optionally GRM-residualized via K); binary 0/1 traits score by MCC^2
    on the raw phenotype (reference beam_search_and_binary_mcc).
    ``preselect`` > 0 screens markers with the ML feature scorer first;
    ``snp_subset`` restricts the search to those marker rows (window
    scans). B is built once, on ``device``."""
    B = hom_alt_matrix(pg, snp_subset, device=device)
    return garfield_scan_features(
        B, y, covariates=covariates, K=K, depth=depth, beam=beam,
        n_perm=n_perm, top_rules=top_rules, min_support=min_support,
        seed=seed, trait_type=trait_type, preselect=preselect,
        snp_subset=snp_subset,
    )


def garfield_scan_features(
    B,
    y: np.ndarray,
    covariates: np.ndarray | None = None,
    K: np.ndarray | None = None,
    depth: int = 2,
    beam: int = 64,
    n_perm: int = 100,
    top_rules: int = 50,
    min_support: int = 5,
    seed: int = 0,
    trait_type: str = "auto",
    preselect: int = 0,
    snp_subset: np.ndarray | None = None,
) -> GarfieldResult:
    """Rule search over an explicit (m, n) 0/1 feature matrix ``B`` —
    e.g. BIN01 k-mer presence/absence rows (reference
    garfield_scan_windows_bin_py, src/lib.rs:751-767). A tensor ``B``
    stays on its device; a host array goes to ``config.resolve_device()``."""
    config.set_full_f32_matmul()
    if isinstance(B, torch.Tensor):
        B = B.to(f32)
    else:
        B = torch.as_tensor(np.asarray(B, np.uint8), device=config.resolve_device()).to(f32)
    y = np.asarray(y, np.float64).reshape(-1)
    uniq = np.unique(y[np.isfinite(y)])
    binary = trait_type == "binary" or (
        trait_type == "auto" and len(uniq) <= 2 and set(uniq) <= {0.0, 1.0}
    )
    if binary:
        mode = "mcc"
        t = y.astype(np.float64)
    else:
        mode = "corr"
        t = _residualize(y, covariates, K)

    B_full = B
    if preselect and preselect < B.shape[0]:
        kept = preselect_features(B, t, mode, preselect, seed=seed)
        B = B.index_select(0, torch.as_tensor(kept, device=B.device))
    else:
        kept = None

    rules = _beam_search(B, t, depth, beam, min_support, mode)[:top_rules]

    # permutation null: max score under shuffled target (maxT)
    rng = np.random.default_rng(seed)
    null_max = np.empty(n_perm)
    for p_i in range(n_perm):
        tp = rng.permutation(t)
        # the null search repeats the whole observed pipeline, the ML
        # preselection included, with the same beam: a weaker null search
        # finds lower maxima and makes the maxT p-values anti-conservative
        if kept is not None:
            kept_p = preselect_features(B_full, tp, mode, preselect, seed=seed)
            B_p = B_full.index_select(0, torch.as_tensor(kept_p, device=B.device))
        else:
            B_p = B
        null_rules = _beam_search(B_p, tp, depth, beam, min_support, mode)
        null_max[p_i] = null_rules[0].score if null_rules else 0.0
    scores = np.array([ru.score for ru in rules])
    pvals = np.array(
        [(1 + np.sum(null_max >= s)) / (n_perm + 1) for s in scores]
    )
    if kept is not None:  # map pre-selection indices back to marker rows
        rules = [
            Rule(tuple(int(kept[s]) for s in ru.snps), ru.ops, ru.score, ru.support)
            for ru in rules
        ]
    if snp_subset is not None:
        sub = np.asarray(snp_subset)
        rules = [
            Rule(tuple(int(sub[s]) for s in ru.snps), ru.ops, ru.score, ru.support)
            for ru in rules
        ]
    return GarfieldResult(
        rules=rules, perm_max_scores=null_max, pvalues=pvals, mode=mode
    )


def garfield_window_scan(
    pg: PackedGenotypes,
    y: np.ndarray,
    window_kb: float = 500.0,
    step_kb: float | None = None,
    top_per_window: int = 3,
    device=None,
    **kw,
) -> list[tuple[str, int, int, GarfieldResult]]:
    """Window-restricted rule scans (reference garfield_scan_windows_bin):
    the rule search runs independently inside each genomic window, so
    rules stay local (cis-epistasis). B is built once for the panel on
    ``device``; each window searches its rows of it.

    Returns [(chrom, start_bp, end_bp, GarfieldResult), ...]."""
    B = hom_alt_matrix(pg, device=device)
    win = int(window_kb * 1000)
    step = int((step_kb or window_kb) * 1000)
    out = []
    chroms = pg.sites.chrom
    pos = pg.sites.pos
    for c in dict.fromkeys(chroms):
        on_c = np.nonzero(chroms == c)[0]
        if len(on_c) == 0:
            continue
        lo, hi = int(pos[on_c].min()), int(pos[on_c].max())
        for start in range(lo, hi + 1, step):
            end = start + win
            rows = on_c[(pos[on_c] >= start) & (pos[on_c] < end)]
            if len(rows) < 2:
                continue
            res = garfield_scan_features(
                B.index_select(0, torch.as_tensor(rows, device=B.device)), y,
                snp_subset=rows, **kw)
            res.rules = res.rules[:top_per_window]
            res.pvalues = res.pvalues[:top_per_window]
            out.append((str(c), start, end, res))
    return out


def parse_pm_spec(spec) -> tuple[str, float]:
    """Parse the reference `-pm/--permutation` threshold spec
    (script/garfield.py:2010-2051 _parse_rule_null_penalty_spec):
    None/'gev'/'gumbel'/'auto' -> GEV at q=0.99; 'gNN[.N]' -> GEV at
    NN/100; 'qNN[.N]' -> empirical quantile; a float in (0,1) ->
    empirical quantile. Returns (method, quantile)."""
    if spec is None:
        return "gev", 0.99
    text = str(spec).strip().lower()
    if text in ("gev", "gumbel", "auto"):
        return "gev", 0.99
    if text and text[0] in ("g", "q"):
        try:
            q = float(text[1:]) / 100.0
        except ValueError:
            raise ValueError(
                f"-pm: bad spec {spec!r} (want gev, g99, g99.9, q99, or a "
                f"float in (0,1))")
        method = "gev" if text[0] == "g" else "quantile"
    else:
        try:
            q = float(text)
        except ValueError:
            raise ValueError(
                f"-pm: bad spec {spec!r} (want gev, g99, g99.9, q99, or a "
                f"float in (0,1))")
        method = "quantile"
    if not (0.0 < q < 1.0):
        raise ValueError(f"-pm: quantile must be in (0,1), got {q}")
    return method, q


def rule_null_threshold(perm_max_scores: np.ndarray, method: str = "gev",
                        quantile: float = 0.99) -> float:
    """Permutation-null score threshold for rule significance.

    'gev': Gumbel (GEV type-I) method-of-moments fit to the permutation
    max scores — scale = std*sqrt(6)/pi, loc = mean - gamma*scale,
    threshold = loc - scale*ln(-ln(q)) (reference
    src/garfield/permutation.rs:468 gumbel_penalty_from_maxima).
    'quantile': nearest-rank empirical quantile of the max scores."""
    s = np.asarray(perm_max_scores, np.float64)
    s = s[np.isfinite(s)]
    if s.size == 0:
        return float("inf")
    if method == "quantile":
        k = min(max(int(np.ceil(quantile * s.size)), 1), s.size)
        return float(np.sort(s)[k - 1])
    mean = float(s.mean())
    std = float(s.std(ddof=1)) if s.size > 1 else 0.0
    if not std > 0:
        return mean
    euler_gamma = 0.5772156649015329
    scale = std * np.sqrt(6.0) / np.pi
    loc = mean - euler_gamma * scale
    log_term = -np.log(quantile)
    if not (np.isfinite(log_term) and log_term > 0):
        return loc
    thr = loc - scale * np.log(log_term)
    return float(thr) if np.isfinite(thr) else loc


def bh_fdr(pvalues: np.ndarray, n_tests: int | None = None) -> np.ndarray:
    """Benjamini-Hochberg adjusted p-values; ``n_tests`` overrides the
    test count (the reference `-m/--meff` effective-test correction,
    script/garfield.py:2674)."""
    p = np.asarray(pvalues, np.float64)
    m = int(n_tests) if n_tests else p.size
    order = np.argsort(p)
    adj = np.empty_like(p)
    running = 1.0
    for rank_from_end, i in enumerate(order[::-1]):
        rank = p.size - rank_from_end
        running = min(running, p[i] * m / rank)
        adj[i] = min(running, 1.0)
    return adj


def write_garfield_tsv(path: str, res: GarfieldResult, sites,
                       score_threshold: float | None = None,
                       meff: int | None = None) -> None:
    """``score_threshold`` (from -pm) adds a `sig` column; ``meff`` adds a
    `pfdr` column (BH over pperm with meff as the test count)."""
    extra = ""
    if score_threshold is not None:
        extra += "\tsig"
    pfdr = None
    if meff is not None:
        pfdr = bh_fdr(np.asarray(res.pvalues), n_tests=meff)
        extra += "\tpfdr"
    with open(path, "wt") as fh:
        fh.write("rule\tdepth\tsupport\tscore\tpperm" + extra + "\n")
        for k, (ru, p) in enumerate(zip(res.rules, res.pvalues)):
            row = (f"{ru.describe(sites.snp)}\t{len(ru.snps)}\t{ru.support}"
                   f"\t{ru.score:.6g}\t{p:.4g}")
            if score_threshold is not None:
                row += f"\t{int(ru.score >= score_threshold)}"
            if pfdr is not None:
                row += f"\t{pfdr[k]:.4g}"
            fh.write(row + "\n")
