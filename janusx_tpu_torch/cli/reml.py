"""`jx reml` — multi-trait REML / BLUE / BLUP from a phenotype table.

Reference: python/janusx/script/reml.py (multi-VC REML over a
repeated-measures observation table). Capability parity:

  jx reml -p pheno.tsv -n Yield -c year,loc -o outdir
  jx reml -p pheno.tsv -n Yield -c PCA1,PCA2 -rc block -k data.cGRM.npy
  jx reml -p pheno.tsv -n Yield -gxe loc -gxc temperature -spk data.jxgrm

The first table column is the sample/line ID. Fixed (-c), random (-rc),
GxE (-gxe) and GxC (-gxc) terms come from table columns; `A:B` builds an
interaction (cat×cat combines levels, num×num multiplies, mixed types
create per-level slopes — reference reml.py:_compile_effect_matrix).
Column types follow the reference's low-cardinality rule
(reml.py:_infer_column_type_details): integer-valued columns with ≤10
distinct values covering ≤5% of rows are categorical.

Outputs (reference names): {prefix}.blue.txt, {prefix}.blup.txt,
{prefix}.gblup.txt (with -k/-spk), {prefix}.reml.summary.tsv, plus the
per-term variance table {prefix}.vc.tsv.

Line-nested designs (line + GxE + GxC only) use the batched block
solver in models/lme.py; designs with non-nested -rc terms fall back to
the reduced-space AI-REML in models/vcomp.py.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

from janusx_tpu_torch.cli import common

log = logging.getLogger("janusx_tpu.reml")


def build_parser(prog="jx reml") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Multi-VC REML / BLUE / BLUP")
    p.add_argument("-p", "--pheno", type=str, required=True,
                   help="phenotype table (.tsv/.csv/whitespace); first col = sample/line ID")
    p.add_argument("-n", "--ncol", action="append", default=None, metavar="COL",
                   help="phenotype column(s): name or zero-based index excluding the "
                        "ID column; comma lists / ranges (2-5) accepted; default: all "
                        "usable numeric columns")
    p.add_argument("-c", "--cov", action="append", default=[], metavar="TERM",
                   help="fixed-effect term(s); A:B = interaction")
    p.add_argument("-rc", "--rcov", "--random-cov", action="append", default=[],
                   metavar="TERM", dest="rcov", help="random nuisance term(s)")
    p.add_argument("-gxe", "--gxe", action="append", default=[], metavar="TERM",
                   help="random Line×environment term(s) (categorical)")
    p.add_argument("-gxc", "--gxc", action="append", default=[], metavar="COL",
                   help="random Line×continuous slope column(s)")
    g = p.add_mutually_exclusive_group()
    g.add_argument("-k", "--grm", type=str, default=None, metavar="FILE",
                   help="dense GRM .npy (+ .id sidecar): corrected narrow-sense h2 + GBLUP")
    g.add_argument("-spk", "--grm-sparse", type=str, default=None, metavar="FILE",
                   help="sparse GRM .jxgrm (+ .id sidecar): narrow-sense h2 + GBLUP")
    p.add_argument("--spk-mode", dest="spk_mode", choices=("raw", "fastgwa"),
                   default="raw",
                   help="sparse REML objective for -spk/-k: raw = profile "
                        "REML over (va, vline); fastgwa = fixed-Vp "
                        "1-D search matched to GCTA fastGWA-REML "
                        "(reference --spk-mode)")
    p.add_argument("-maxiter", "--maxiter", "--max-iter", type=int, default=100,
                   dest="maxiter")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("-dev", "--dev", action="store_true",
                   help=argparse.SUPPRESS)  # reference dev-help flag
    common.add_out_args(p, default_prefix="reml")
    return p


# ---------------------------------------------------------------- table


def _load_table(path: str):
    import pandas as pd

    first = open(path).readline()
    sep = "\t" if "\t" in first else ("," if path.endswith(".csv") else r"\s+")
    return pd.read_csv(path, sep=sep, dtype={0: str})


def infer_column_type(series) -> str:
    """Reference low-cardinality rule (reml.py:2491-2536)."""
    import pandas as pd

    non_missing = series.dropna()
    valid = int(non_missing.shape[0])
    if valid == 0:
        return "categorical"
    numeric = pd.to_numeric(non_missing, errors="coerce")
    finite = numeric.notna() & np.isfinite(numeric)
    if int(finite.sum()) != valid:
        return "categorical"
    values = np.asarray(numeric, np.float64)
    uniq = int(pd.Series(values).nunique(dropna=True))
    limit = max(1, int(np.floor(valid * 0.05)))
    if bool(np.all(values == np.floor(values))) and uniq <= 10 and uniq <= limit:
        return "categorical"
    return "continuous"


def _resolve_col(tok: str, df, id_col: str) -> str:
    cols = [c for c in df.columns if c != id_col]
    if tok in df.columns:
        return tok
    if tok.lstrip("-").isdigit():
        i = int(tok)
        if 0 <= i < len(cols):
            return cols[i]
    raise SystemExit(f"column {tok!r} not found (have: {cols})")


def _split_tokens(values) -> list:
    out = []
    for raw in values or []:
        for t in str(raw).split(","):
            t = t.strip()
            if t:
                out.append(t)
    return out


def _parse_trait_cols(ncol, df, id_col: str, used: set) -> list:
    cols = [c for c in df.columns if c != id_col]
    if not ncol:
        return [c for c in cols
                if c not in used and infer_column_type(df[c]) == "continuous"]
    out = []
    for tok in _split_tokens(ncol):
        if "-" in tok and all(x.isdigit() for x in tok.split("-", 1)):
            a, b = (int(x) for x in tok.split("-", 1))
            if a > b:
                raise SystemExit(
                    f"-n range {tok!r} is inverted (use {b}-{a})"
                )
            if b >= len(cols):
                raise SystemExit(
                    f"-n range {tok!r} exceeds the {len(cols)} phenotype "
                    f"columns (0-based, excluding the ID column)"
                )
            for i in range(a, b + 1):
                out.append(cols[i])
        else:
            out.append(_resolve_col(tok, df, id_col))
    return out


# ---------------------------------------------------------------- effects


def _factor_codes(series):
    import pandas as pd

    ss = series.astype("string").fillna("NA").astype(str)
    codes, levels = pd.factorize(ss, sort=True)
    return np.asarray(codes, np.int64), [str(x) for x in levels]


def _onehot(series, prefix: str, drop_first: bool):
    codes, levels = _factor_codes(series)
    n = codes.shape[0]
    if drop_first:
        keep = levels[1:]
        Z = np.zeros((n, max(0, len(levels) - 1)))
        m = codes > 0
        Z[np.nonzero(m)[0], codes[m] - 1] = 1.0
    else:
        keep = levels
        Z = np.zeros((n, len(levels)))
        Z[np.arange(n), codes] = 1.0
    return Z, [f"{prefix}-{l}" for l in keep]


def _parse_effect_specs(values, kind: str, df, id_col: str) -> list:
    """-> list of (label, sources tuple, types tuple). Validates like the reference."""
    specs = []
    for tok in _split_tokens(values):
        if tok.count(":") > 1:
            raise SystemExit(f"invalid {kind} interaction {tok!r}: expected A:B")
        srcs = tuple(_resolve_col(t.strip(), df, id_col) for t in tok.split(":"))
        types = tuple(infer_column_type(df[c]) for c in srcs)
        label = ":".join(srcs)
        if kind == "gxe" and any(t != "categorical" for t in types):
            raise SystemExit(f"-gxe term {tok!r} must be categorical (got {types})")
        if kind == "gxc" and (len(srcs) != 1 or types[0] != "continuous"):
            raise SystemExit(f"-gxc term {tok!r} requires one continuous column")
        specs.append((label, srcs, types))
    return specs


def _combine_key(df, cols):
    import pandas as pd

    key = df[cols[0]].astype("string").fillna("NA").astype(str)
    for c in cols[1:]:
        key = key + "@@" + df[c].astype("string").fillna("NA").astype(str)
    return key


def _compile_fixed(df, spec):
    """One fixed effect spec -> (matrix, names)."""
    import pandas as pd

    label, srcs, types = spec
    if len(srcs) == 1:
        c = srcs[0]
        if types[0] == "continuous":
            v = pd.to_numeric(df[c], errors="coerce").to_numpy(np.float64)
            return v[:, None], [label]
        return _onehot(df[c], label, drop_first=True)
    a, b = srcs
    if types == ("categorical", "categorical"):
        return _onehot(_combine_key(df, [a, b]), label, drop_first=True)
    if types == ("continuous", "continuous"):
        v = (pd.to_numeric(df[a], errors="coerce").to_numpy(np.float64)
             * pd.to_numeric(df[b], errors="coerce").to_numpy(np.float64))
        return v[:, None], [label]
    cat, cont = (a, b) if types[0] == "categorical" else (b, a)
    Z, names = _onehot(df[cat], f"{cat}:{cont}", drop_first=False)
    v = pd.to_numeric(df[cont], errors="coerce").to_numpy(np.float64)
    return Z * v[:, None], [f"{n}:slope" for n in names]


def _drop_degenerate(M, names):
    keep = np.ptp(M, axis=0) > 1e-12
    return M[:, keep], [n for n, k in zip(names, keep) if k]


# ---------------------------------------------------------------- kinship


def _load_kinship(dense_path, sparse_path):
    """-> (K dense f64, ids list) or (None, None)."""
    path = dense_path or sparse_path
    if path is None:
        return None, None
    if sparse_path is not None:
        from janusx_tpu_torch.io.jxgrm import read_jxgrm

        # keep the thresholded kinship SPARSE end-to-end: the narrow-sense
        # joint fit factors V by sparse LU (models/lme.fit_joint_kernel),
        # so biobank-scale line counts never materialize the n² matrix
        K = read_jxgrm(sparse_path).tocsr()
        # `jx grm -sparse` writes {x}.spgrm.id; older callers may have {x}.id
        candidates = [sparse_path + ".id",
                      os.path.splitext(sparse_path)[0] + ".id"]
    else:
        K = np.load(dense_path)
        candidates = [os.path.splitext(dense_path)[0] + ".id"]
    id_path = next((c for c in candidates if os.path.exists(c)), None)
    if id_path is None:
        raise SystemExit(f"missing GRM id sidecar: {candidates[0]}")
    with open(id_path) as fh:
        ids = [l.split()[0] for l in fh if l.strip()]
    if len(ids) != K.shape[0]:
        raise SystemExit(f"GRM ids ({len(ids)}) != GRM dim ({K.shape[0]})")
    import scipy.sparse as _sp

    return (K if _sp.issparse(K) else np.asarray(K, np.float64)), ids


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    from janusx_tpu_torch.models.lme import (
        NestedTerm, blue_line_nested, fit_joint_kernel, fit_line_nested,
        harmonic_mean,
    )

    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "reml")
    import pandas as pd

    df_all = _load_table(args.pheno)
    id_col = df_all.columns[0]

    fixed_specs = _parse_effect_specs(args.cov, "fixed", df_all, id_col)
    random_specs = _parse_effect_specs(args.rcov, "random", df_all, id_col)
    gxe_specs = _parse_effect_specs(args.gxe, "gxe", df_all, id_col)
    gxc_specs = _parse_effect_specs(args.gxc, "gxc", df_all, id_col)
    used = {c for spec in fixed_specs + random_specs + gxe_specs + gxc_specs
            for c in spec[1]}
    traits = _parse_trait_cols(args.ncol, df_all, id_col, used)
    if not traits:
        raise SystemExit("no usable numeric phenotype columns found")

    K_full, kin_ids = _load_kinship(args.grm, args.grm_sparse)
    kin_pos = {s: i for i, s in enumerate(kin_ids)} if kin_ids else {}

    all_lines = list(dict.fromkeys(df_all[id_col].astype(str)))
    n_lines_total, n_obs_total = len(all_lines), len(df_all)
    blue_out = pd.DataFrame({id_col: all_lines})
    blup_out = pd.DataFrame({id_col: all_lines})
    gblup_out = pd.DataFrame({id_col: all_lines}) if K_full is not None else None
    env_label = ",".join(s[0] for s in fixed_specs) or "None"
    rand_label = ",".join(
        [s[0] for s in random_specs]
        + [f"{id_col}x{s[0]}" for s in gxe_specs]
        + [f"{id_col}x{s[0]}:slope" for s in gxc_specs]
    ) or "None"
    summary_rows = []
    vc_rows = []

    for trait in traits:
        t0 = time.time()
        try:
            row = _run_trait(
                df_all, id_col, trait, fixed_specs, random_specs, gxe_specs,
                gxc_specs, K_full, kin_pos, args, blue_out, blup_out,
                gblup_out, vc_rows,
                NestedTerm=NestedTerm, fit_line_nested=fit_line_nested,
                blue_line_nested=blue_line_nested,
                fit_joint_kernel=fit_joint_kernel, harmonic_mean=harmonic_mean,
            )
        except Exception as exc:  # keep going across traits like the reference
            log.exception("trait %s: REML failed: %s", trait, exc)
            blue_out[trait] = np.nan
            blup_out[trait] = np.nan
            if gblup_out is not None:
                gblup_out[trait] = np.nan
            row = {"trait": trait, "status": f"failed:{type(exc).__name__}"}
        row.setdefault("total_obs", n_obs_total)
        row.setdefault("total_lines", n_lines_total)
        row.setdefault("env_fixed_label", env_label)
        row.setdefault("random_label", rand_label)
        row["elapsed_sec"] = round(time.time() - t0, 3)
        summary_rows.append(row)
        log.info("trait %s: H2=%.4g h2_narrow=%.4g status=%s",
                 trait, row.get("hsqr", float("nan")),
                 row.get("h2_narrow", float("nan")), row.get("status"))

    cols = ["trait", "used_obs", "used_lines", "total_obs", "total_lines",
            "env_fixed_label", "random_label", "hsqr", "h2_narrow", "vg",
            "vge", "ve", "lambda", "h_env", "h_plot", "narrow_method",
            "elapsed_sec", "status"]
    summary = pd.DataFrame(summary_rows)
    for c in cols:
        if c not in summary.columns:
            summary[c] = np.nan
    blue_out.to_csv(f"{prefix}.blue.txt", sep="\t", index=False)
    blup_out.to_csv(f"{prefix}.blup.txt", sep="\t", index=False)
    if gblup_out is not None:
        gblup_out.to_csv(f"{prefix}.gblup.txt", sep="\t", index=False)
    summary[cols].to_csv(f"{prefix}.reml.summary.tsv", sep="\t", index=False)
    with open(f"{prefix}.vc.tsv", "wt") as fh:
        fh.write("trait\tterm\tsigma2\tproportion\n")
        for tr, nm, s2, pr in vc_rows:
            fh.write(f"{tr}\t{nm}\t{s2:.6g}\t{pr:.6g}\n")
    for tr_row in summary_rows:
        print(f"{tr_row['trait']}\tH2={tr_row.get('hsqr', float('nan')):.4g}\t"
              f"h2={tr_row.get('h2_narrow', float('nan')):.4g}\t"
              f"status={tr_row.get('status')}")
    print(f"{prefix}.reml.summary.tsv")
    return 0


def _run_trait(df_all, id_col, trait, fixed_specs, random_specs, gxe_specs,
               gxc_specs, K_full, kin_pos, args, blue_out, blup_out,
               gblup_out, vc_rows, *, NestedTerm, fit_line_nested,
               blue_line_nested, fit_joint_kernel, harmonic_mean):
    import pandas as pd

    y_raw = pd.to_numeric(df_all[trait], errors="coerce").to_numpy(np.float64)
    keep = np.isfinite(y_raw)
    # fixed/random source columns must be present too
    for spec in fixed_specs + random_specs + gxe_specs + gxc_specs:
        for c in spec[1]:
            if infer_column_type(df_all[c]) == "continuous":
                keep &= np.isfinite(
                    pd.to_numeric(df_all[c], errors="coerce").to_numpy(np.float64))
            else:
                keep &= df_all[c].notna().to_numpy()
    df = df_all.loc[keep].reset_index(drop=True)
    y = y_raw[keep]
    N = len(df)
    if N < 3:
        raise ValueError(f"too few usable observations ({N})")
    line_codes, line_levels = _factor_codes(df[id_col])
    L = len(line_levels)

    # ---- fixed design
    X_parts, fixed_names = [np.ones((N, 1))], ["intercept"]
    for spec in fixed_specs:
        M, names = _drop_degenerate(*_compile_fixed(df, spec))
        X_parts.append(M)
        fixed_names += names
    X = np.concatenate(X_parts, axis=1)

    # ---- random terms (line + rc + gxe + gxc), line-nested where possible
    terms = [NestedTerm(name=str(id_col), lev=line_codes, val=np.ones(N),
                        n_levels=L, level_names=line_levels, kind="line")]
    nested_ok = True
    for label, srcs, types in random_specs:
        if len(srcs) == 1 and types[0] == "continuous":
            nested_ok = False  # random regression: general path
            continue
        codes, levels = _factor_codes(_combine_key(df, list(srcs)))
        # a plain random factor is line-nested iff each level maps to one line
        owner = np.full(len(levels), -1, np.int64)
        ok = True
        for lc, cc in zip(line_codes, codes):
            if owner[cc] < 0:
                owner[cc] = lc
            elif owner[cc] != lc:
                ok = False
                break
        if not ok:
            nested_ok = False
        terms.append(NestedTerm(name=label, lev=codes, val=np.ones(N),
                                n_levels=len(levels), level_names=levels,
                                kind="random"))
    gxe_meta = []
    for label, srcs, types in gxe_specs:
        env = _combine_key(df, list(srcs))
        codes, levels = _factor_codes(
            df[id_col].astype("string").astype(str) + "@@" + env)
        env_per_line = (
            pd.DataFrame({"l": df[id_col].astype(str), "e": env})
            .drop_duplicates().groupby("l").size().to_numpy(np.float64))
        h_env = max(1.0, harmonic_mean(env_per_line))
        name = f"{id_col}x{label}"
        terms.append(NestedTerm(name=name, lev=codes, val=np.ones(N),
                                n_levels=len(levels), level_names=levels,
                                h_env=h_env, kind="gxe"))
        gxe_meta.append((name, h_env))
    for label, srcs, types in gxc_specs:
        v = pd.to_numeric(df[srcs[0]], errors="coerce").to_numpy(np.float64)
        # centered, unscaled — reference _compile_line_slope_matrix
        # (reml.py:2744-2767); centering decorrelates the slope from the
        # line intercept term, which absorbs the mean response
        terms.append(NestedTerm(name=f"{id_col}x{label}:slope", lev=line_codes,
                                val=v - float(np.mean(v)), n_levels=L,
                                level_names=line_levels, kind="gxc"))

    # ---- broad fit
    single_obs = L == N
    if nested_ok:
        fit = fit_line_nested(y, X, line_codes, terms, max_iter=args.maxiter,
                              tol=args.tol)
        sigma2, blups = fit.sigma2, fit.blups
        loglik_ok = fit.converged
    else:
        from janusx_tpu_torch.models.vcomp import RandomTerm, ai_reml

        vterms = []
        for t in terms:
            Z = np.zeros((N, t.n_levels))
            Z[np.arange(N), t.lev] = t.val
            vterms.append(RandomTerm(name=t.name, Z=Z,
                                     levels=np.asarray(t.level_names)))
        for label, srcs, types in random_specs:
            if len(srcs) == 1 and types[0] == "continuous":
                v = pd.to_numeric(df[srcs[0]], errors="coerce").to_numpy(np.float64)
                vterms.append(RandomTerm(name=label, Z=v[:, None],
                                         levels=np.asarray([label])))
        res = ai_reml(y, X, vterms, max_iter=args.maxiter, tol=args.tol)
        sigma2 = dict(res.sigma2)
        blups = res.blups
        loglik_ok = res.converged

    vg = float(sigma2.get(str(id_col), np.nan))
    ve = float(sigma2["residual"])
    total = sum(v for k, v in sigma2.items())
    for nm, s2 in sigma2.items():
        vc_rows.append((trait, nm, float(s2), float(s2 / total) if total > 0 else np.nan))

    # ---- broad-sense H² (reference formula: vg / (vg + Σvge/h_env + ve/h_plot))
    obs_per_line = np.bincount(line_codes, minlength=L).astype(np.float64)
    h_plot = max(1.0, harmonic_mean(obs_per_line))
    env_cols = [c for spec in fixed_specs for c in spec[1]
                if infer_column_type(df_all[c]) == "categorical"]
    if env_cols:
        env_key = _combine_key(df, env_cols)
        h_env = max(1.0, harmonic_mean(
            pd.DataFrame({"l": df[id_col].astype(str), "e": env_key})
            .drop_duplicates().groupby("l").size().to_numpy(np.float64)))
    else:
        h_env = 1.0
    vge_raw = sum(float(sigma2.get(nm, 0.0)) for nm, _ in gxe_meta)
    gxe_adj = sum(float(sigma2.get(nm, 0.0)) / he for nm, he in gxe_meta)
    if gxe_meta and gxe_adj > 0 and vge_raw > 0:
        # reference: effective h_env of the fitted GxE terms replaces the
        # fixed-design environment count in the summary (reml.py:3406-3414)
        h_env = float(vge_raw / gxe_adj)
    status = "ok" if loglik_ok else "warning_not_converged"
    if single_obs and len(terms) == 1:
        hsqr = np.nan
        status = "warning_single_obs_nonidentifiable_h2"
        log.warning("trait %s: one observation per line and no replication; "
                    "broad-sense H2 non-identifiable", trait)
    else:
        denom = vg + gxe_adj + ve / h_plot
        hsqr = float(vg / denom) if denom > 0 else np.nan
    lbd = float(ve / vg) if vg > 0 else np.nan

    # ---- line BLUPs -> blup.txt
    lv, u = blups[str(id_col)]
    blup_map = {str(l): float(x) for l, x in zip(lv, u)}
    blup_out[trait] = blup_out[id_col].astype(str).map(blup_map).to_numpy(np.float64)

    # ---- stage-1 BLUE (line fixed, GLS under nuisance variances) -> blue.txt
    if single_obs and len(terms) == 1:
        blue, blue_se = y.copy(), np.zeros(N)
        order = line_codes  # identity: one obs per line
        blue_by_line = np.empty(L)
        blue_by_line[order] = blue
        se_by_line = np.zeros(L)
    else:
        nuis = [t for t in terms if t.kind != "line"]
        if nested_ok:
            sig_n = [sigma2.get(t.name, 0.0) for t in nuis]
            blue_by_line, se_by_line, _ = blue_line_nested(
                y, X[:, 1:], line_codes, nuis, sig_n, ve)
        else:
            # general path: dense GLS with line fixed (guarded by table size)
            if N > 20000:
                raise ValueError("non-line-nested design too large for dense BLUE")
            V = ve * np.eye(N)
            for t in nuis:
                Z = np.zeros((N, t.n_levels))
                Z[np.arange(N), t.lev] = t.val
                V += sigma2.get(t.name, 0.0) * (Z @ Z.T)
            Zl = np.zeros((N, L))
            Zl[np.arange(N), line_codes] = 1.0
            Xf = np.concatenate([Zl, X[:, 1:]], axis=1)
            Vi = np.linalg.inv(V)
            A = Xf.T @ Vi @ Xf
            A.flat[:: A.shape[0] + 1] += 1e-10
            Ainv = np.linalg.inv(A)
            bhat = Ainv @ (Xf.T @ (Vi @ y))
            blue_by_line = bhat[:L]
            se_by_line = np.sqrt(np.clip(np.diag(Ainv)[:L], 0, None))
    blue_map = {str(l): float(b) for l, b in zip(line_levels, blue_by_line)}
    blue_out[trait] = blue_out[id_col].astype(str).map(blue_map).to_numpy(np.float64)

    row = dict(trait=trait, used_obs=N, used_lines=L, hsqr=hsqr, vg=vg,
               vge=vge_raw, ve=ve, h_env=h_env, h_plot=h_plot,
               **{"lambda": lbd}, h2_narrow=np.nan, narrow_method="none",
               status=status)

    # ---- narrow-sense joint kernel fit -> gblup.txt
    if K_full is not None:
        kept = [i for i, l in enumerate(line_levels) if str(l) in kin_pos]
        if len(kept) >= 2:
            sel = np.array([kin_pos[str(line_levels[i])] for i in kept])
            import scipy.sparse as _sp

            Ksub = (K_full[sel][:, sel] if _sp.issparse(K_full)
                    else K_full[np.ix_(sel, sel)])
            noise = se_by_line[kept] ** 2
            jf = fit_joint_kernel(blue_by_line[kept], Ksub, noise,
                                  max_iter=args.maxiter,
                                  mode=args.spk_mode)
            row["h2_narrow"] = jf.h2
            row["narrow_method"] = ("joint_dense" if args.grm else "joint_sparse")
            gmap = {str(line_levels[i]): float(g)
                    for i, g in zip(kept, jf.add_blup)}
            gblup_out[trait] = (gblup_out[id_col].astype(str).map(gmap)
                                .to_numpy(np.float64))
            if np.isfinite(hsqr) and np.isfinite(jf.h2) and jf.h2 > hsqr * 1.02:
                log.warning("trait %s: narrow h2 (%.4g) exceeds broad H2 (%.4g); "
                            "estimators are on different effective scales",
                            trait, jf.h2, hsqr)
        else:
            log.warning("trait %s: too few lines overlap the kinship ids; "
                        "narrow-sense h2 skipped", trait)
            gblup_out[trait] = np.nan
    return row
