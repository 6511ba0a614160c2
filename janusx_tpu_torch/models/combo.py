"""User-specified SNP-combination joint FvLMM tests (port of
janusx_tpu/models/combo.py).

Reference: `jx fvlmm2 -i pairs.txt` (python/janusx/script/fvlmm2.py:
interaction-expression parsing :212-283, literal/combo construction
:306-388, joint fixed-λ GLS src/stats/fvlmm2.rs:39-290). Model per
expression: y = covariates + SNP1 + SNP2 + combo + Zu + e, evaluated at
the trait's null λ; beta/se and a two-sided normal p per genotype term.

Expressions (one per line): ``tok1 OP tok2`` with OP in {&, |, *, ^};
tokens are SNP names (or chrom:pos) with optional `!` negation. Logic
ops act on dual-dosage hardcalls in {0, 1, 2} (GARFIELD convention,
negation = 2 − hit); `*` multiplies raw dosages and rejects negation —
all exactly as the reference (the parse, literal, xor and BH code here is
the reference's, line for line).

On the device: the rotation of the [g1, g2, combo] rows by the eigenbasis
and the batched joint GLS, both in f64. Only the genotype rows the
expressions name are decoded, never the whole (m, n) panel.

One deliberate divergence of the reference, kept: the reference joint
kernel (fvlmm2.rs:39-100) receives the genotype columns UNROTATED while y
and the covariates arrive in the eigenbasis — it takes no rotation operand
at all — so its GLS mixes bases. Here the combo/literal columns are
rotated through the same U as y/X before the weighted solve, which is
the mathematically consistent fixed-λ GLS (the two agree as λ→∞ or
K→I).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np
import torch

from janusx_tpu_torch import config

f64 = torch.float64

_EXPR_RE = re.compile(r"^\s*([^\s&|*^]+)\s*([&|*^])\s*([^\s&|*^]+)\s*$")


@dataclass(frozen=True)
class ComboSpec:
    expr: str
    snp1: str
    op: str
    snp2: str
    row1: int
    row2: int
    neg1: bool
    neg2: bool


def _split_literal(token: str) -> tuple:
    text = str(token).strip()
    negated = False
    while text.startswith("!"):
        negated = not negated
        text = text[1:].strip()
    if not text:
        raise ValueError("literal token has no SNP name after '!'")
    return text, negated


def build_name_map(sites) -> dict:
    """SNP-name (and chrom:pos) -> row indices of the FILTERED panel."""
    name_map: dict = {}
    chrom = np.asarray(sites.chrom).astype(str)
    pos = np.asarray(sites.pos)
    snp = np.asarray(sites.snp).astype(str)
    for j in range(len(snp)):
        for key in (snp[j], f"{chrom[j]}:{int(pos[j])}"):
            name_map.setdefault(key, []).append(j)
    return name_map


def parse_interaction_file(path: str, name_map: dict) -> tuple:
    """-> (specs, skipped rows [{line, expr, reason}]) — mirrors the
    reference line grammar incl. the negated-`*` rejection."""
    specs: list = []
    skipped: list = []
    with open(path, encoding="utf-8", errors="replace") as fh:
        for line_no, raw in enumerate(fh, start=1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            token = line.split()[0]
            m = _EXPR_RE.match(token)
            if m is None:
                skipped.append({"line": line_no, "expr": token,
                                "reason": "invalid_expression"})
                continue
            try:
                snp1, neg1 = _split_literal(m.group(1))
                snp2, neg2 = _split_literal(m.group(3))
            except ValueError as ex:
                skipped.append({"line": line_no, "expr": token,
                                "reason": str(ex)})
                continue
            op = m.group(2)
            expr = (("!" if neg1 else "") + snp1 + op
                    + ("!" if neg2 else "") + snp2)
            if op == "*" and (neg1 or neg2):
                skipped.append({
                    "line": line_no, "expr": expr,
                    "reason":
                        "negated_literals_not_supported_for_multiplicative"
                        "_interaction"})
                continue
            rows = []
            bad = None
            for tok in (snp1, snp2):
                hits = name_map.get(tok, [])
                if len(hits) == 1:
                    rows.append(int(hits[0]))
                else:
                    bad = (f"SNP token '{tok}' "
                           + ("is ambiguous" if hits else "was not found"))
                    break
            if bad:
                skipped.append({"line": line_no, "expr": expr, "reason": bad})
                continue
            specs.append(ComboSpec(expr=expr, snp1=snp1, op=op, snp2=snp2,
                                   row1=rows[0], row2=rows[1],
                                   neg1=neg1, neg2=neg2))
    return specs, skipped


def literalize(g: np.ndarray, neg) -> np.ndarray:
    """Dual-dosage hardcalls in {0,1,2}; negation flips to 2−hit
    (reference _literalize_chunk)."""
    hit = np.rint(np.clip(np.asarray(g, np.float64), 0.0, 2.0))
    neg = np.asarray(neg, bool).reshape(-1, 1)
    return np.where(neg, 2.0 - hit, hit)


def xor_dual(l1: np.ndarray, l2: np.ndarray) -> np.ndarray:
    """Reference _xor_dual_chunk truth table on {0,1,2} hardcalls."""
    a = np.rint(np.clip(np.asarray(l1, np.float64), 0.0, 2.0))
    b = np.rint(np.clip(np.asarray(l2, np.float64), 0.0, 2.0))
    same = a == b
    has_het = (a == 1.0) | (b == 1.0)
    return np.where(same, np.where(a == 1.0, 1.0, 0.0),
                    np.where(has_het, 1.0, 2.0))


def make_combos(g1: np.ndarray, g2: np.ndarray, specs) -> np.ndarray:
    """(B, n) combo genotypes from raw mean-imputed dosage rows."""
    neg1 = [s.neg1 for s in specs]
    neg2 = [s.neg2 for s in specs]
    lit1 = literalize(g1, neg1)
    lit2 = literalize(g2, neg2)
    out = np.empty_like(np.asarray(g1, np.float64))
    for i, s in enumerate(specs):
        if s.op == "*":
            out[i] = g1[i] * g2[i]
        elif s.op == "&":
            out[i] = np.minimum(lit1[i], lit2[i])
        elif s.op == "|":
            out[i] = np.maximum(lit1[i], lit2[i])
        else:  # ^
            out[i] = xor_dual(lit1[i], lit2[i])
    return out, lit1, lit2


def _joint_chunk(G3r: torch.Tensor, Xr: torch.Tensor, yr: torch.Tensor,
                 w: torch.Tensor, n: int, p: int) -> torch.Tensor:
    """Batched fixed-λ joint GLS (reference fvlmm2.rs joint solve) in f64
    on the inputs' device: G3r (B, 3, n) rotated [g1, g2, combo]; A = DᵀWD
    (+1e-6 ridge), σ² = residual quadform / (n − p − 3), per-term z →
    two-sided normal p. Returns (B, 9) = [beta, se, p] × [g1, g2, combo]."""
    G3r, Xr, yr, w = (a.to(f64) for a in (G3r, Xr, yr, w))
    dim = p + 3
    Xw = Xr * w[:, None]
    A_xx = Xr.T @ Xw                          # (p, p)
    b_x = Xw.T @ yr                           # (p,)
    yy = torch.sum(w * yr * yr)
    Gw = G3r * w[None, None, :]               # (B, 3, n)
    A_xg = torch.einsum("np,bgn->bpg", Xw, G3r)  # (B, p, 3)
    A_gg = torch.einsum("bgn,bhn->bgh", Gw, G3r)
    b_g = torch.einsum("bgn,n->bg", Gw, yr)
    B = G3r.shape[0]
    A = torch.zeros((B, dim, dim), dtype=f64, device=G3r.device)
    A[:, :p, :p] = A_xx[None]
    A[:, :p, p:] = A_xg
    A[:, p:, :p] = A_xg.transpose(1, 2)
    A[:, p:, p:] = A_gg
    b = torch.cat([b_x.expand(B, p), b_g], dim=1)
    Ar = A + 1e-6 * torch.eye(dim, dtype=f64, device=G3r.device)[None]
    beta = torch.linalg.solve(Ar, b[..., None])[..., 0]
    # exact residual quadform (reference recomputes Σ w (y − Dβ)²):
    # yᵀWy − 2βᵀb + βᵀAβ with the UNridged A
    quad = torch.einsum("bi,bij,bj->b", beta, A, beta)
    rtvr = yy - 2.0 * torch.einsum("bi,bi->b", beta, b) + quad
    sigma2 = rtvr / float(n - dim)
    Ainv = torch.linalg.inv(Ar)
    var = sigma2[:, None] * torch.diagonal(Ainv, dim1=1, dim2=2)[:, p:]
    se = torch.sqrt(torch.clamp(var, min=0.0))
    bg = beta[:, p:]
    z = bg.abs() / torch.clamp(se, min=1e-300)
    # two-sided normal p: 2·sf(z) = erfc(z/√2)
    pz = torch.clamp(torch.special.erfc(z / math.sqrt(2.0)), 1e-308, 1.0)
    bad = (~torch.isfinite(se) | (se <= 0) | (sigma2 <= 0)[:, None]
           | ~torch.isfinite(bg))
    nan = torch.full((), float("nan"), dtype=f64, device=G3r.device)
    out = torch.stack([torch.where(bad, nan, bg), torch.where(bad, nan, se),
                       torch.where(bad, nan, pz)], dim=-1)  # (B, 3, 3)
    return out.reshape(B, 9)


def _named_rows(pg, rows) -> np.ndarray:
    """Mean-imputed f64 dosages (len(rows), n) of the named SNP rows alone
    (pg.dosages' −1-missing decode of just these rows, then the
    reference's per-row mean imputation)."""
    from janusx_tpu_torch.io import bitcodec

    codes = bitcodec.unpack_codes(pg.packed[np.asarray(rows, np.int64)], pg.n_samples)
    g = codes.astype(np.float64)
    g[codes == bitcodec.CODE_MISSING] = -1.0
    miss = g < 0  # mean-impute missing, as the reference decode
    if miss.any():
        cnt = np.maximum((~miss).sum(axis=1), 1)
        mu = np.where(miss, 0, g).sum(axis=1) / cnt
        g[miss] = np.broadcast_to(mu[:, None], g.shape)[miss]
    return g


def bh_adjust(p: np.ndarray, n_tests: int | None = None) -> np.ndarray:
    """BH q-values; n_tests optionally raises the denominator
    (reference _bh_adjust / --n-tests)."""
    p = np.asarray(p, np.float64)
    ok = np.isfinite(p)
    m = max(int(ok.sum()), 1)
    if n_tests is not None:
        m = max(m, int(n_tests))
    out = np.full(len(p), np.nan)
    pv = p[ok]
    order = np.argsort(pv)
    ranked = pv[order] * m / (np.arange(len(pv)) + 1)
    qv = np.minimum.accumulate(ranked[::-1])[::-1]
    out[np.nonzero(ok)[0][order]] = np.clip(qv, 0.0, 1.0)
    return out


def fvlmm_joint_combo_scan(
    pg, basis, y: np.ndarray, covariates, specs,
    batch_size: int = 4096,
    device=None,
):
    """Run every combo spec through the joint fixed-λ FvLMM.

    Returns a list of per-spec dicts with the reference compact-TSV
    fields (chrom/pos of SNP1, combo_id, combo_af, joint beta/se/p for
    the combo and joint p's for both literals)."""
    from janusx_tpu_torch.core.reml import fit_null_reml, make_rotated
    from janusx_tpu_torch.models.lm import design_matrix

    dev = config.resolve_device(device)
    y = np.asarray(y, np.float64).reshape(-1)
    X = design_matrix(len(y), covariates)
    rot = make_rotated(basis, y, X, device=dev)
    null = fit_null_reml(rot)
    w = 1.0 / (np.asarray(basis.S, np.float64) + null.lbd)
    n, p = len(y), X.shape[1]
    if n <= p + 4:
        raise ValueError(f"too few samples for the joint test: n={n}, p={p}")
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=f64, device=dev)
    U = t(basis.U)
    Xr, yr, w_d = t(basis.U.T @ X), t(basis.U.T @ y), t(w)
    chrom = np.asarray(pg.sites.chrom).astype(str)
    pos = np.asarray(pg.sites.pos)

    results: list = []
    for start in range(0, len(specs), max(1, batch_size)):
        batch = specs[start:start + max(1, batch_size)]
        g1 = _named_rows(pg, [s.row1 for s in batch])
        g2 = _named_rows(pg, [s.row2 for s in batch])
        combo, _l1, _l2 = make_combos(g1, g2, batch)
        combo_af = (combo > 0).mean(axis=1)
        stackg = np.stack([g1, g2, combo], axis=1)  # (B, 3, n)
        G3r = t(stackg) @ U
        out = _joint_chunk(G3r, Xr, yr, w_d, n, p).cpu().numpy()
        for i, s in enumerate(batch):
            results.append({
                "chrom": chrom[s.row1], "pos": int(pos[s.row1]),
                "combo_id": s.expr, "combo_af": float(combo_af[i]),
                "unit_name": "",
                "beta_combo_joint": float(out[i, 6]),
                "se_combo_joint": float(out[i, 7]),
                "p_combo_joint": float(out[i, 8]),
                "p_lit1_joint": float(out[i, 2]),
                "p_lit2_joint": float(out[i, 5]),
            })
    return results, null
