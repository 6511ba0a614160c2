"""`jx postbsa` — BSA post-analysis: thresholds + genome plots.

Reference: JanusX python/janusx/script/postbsa.py (window G/G'
recompute, CI-percentile thresholds, per-chromosome genome panels).

Two input modes:

- `jx bsa` TSV mode (default): per-SNP table (chrom pos snp_index1
  snp_index2 delta_snp_index G Gprime). Produces
  {prefix}.postbsa.tsv — the table extended with simulated null Δ-SNP
  confidence bounds (Takagi et al.: binomial resampling of both bulk
  depths at p=0.5, per depth pair), G' p-values from a lognormal null
  fitted on the Hampel-trimmed G' distribution (QTLseqr semantics) and
  BH-FDR q-values — plus {prefix}.bsa.png panels.
- bulk-prefix mode (-b1/-b2, the reference `jx postbsa` drop-in
  surface, postbsa.py:1623-1764): a caller table (or glob of
  per-chromosome tables) with CHROM/POS and {bulk}.DP/.AD[/.GQ]
  columns. Runs the reference DP/GQ/total-DP/depth-difference/
  allele-frequency filter chain, per-SNP SNP-index/Δ/ED/G, stepped
  sliding-window smoothing (window/step, ED^power, tricube G'),
  CI-percentile thresholds (repeatable -ci; region filtering at the
  max level), and writes {prefix}.raw.tsv, {prefix}.smooth.tsv,
  {prefix}.thr.tsv plus snp-index and stats figures.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from janusx_tpu_torch.cli import common

log = logging.getLogger("janusx_tpu.postbsa")


def build_parser(prog="jx postbsa") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="BSA thresholds + plots")
    p.add_argument("-i", "-file", "--file", "--input", dest="input",
                   type=str, required=True,
                   nargs="+",
                   help="jx bsa output TSV, or (with -b1/-b2) caller "
                        "table(s)/glob with {bulk}.DP/.AD[/.GQ] columns")
    p.add_argument("-b1", "--bulk1", type=str, default=None,
                   help="bulk-1 column prefix (enables reference prefix mode)")
    p.add_argument("-b2", "--bulk2", type=str, default=None,
                   help="bulk-2 column prefix")
    p.add_argument("-d", "--depths", type=str, default=None,
                   help="original depth TSV (chrom pos alt1 ref1 alt2 ref2) "
                        "for exact per-SNP CI simulation; omit to use the "
                        "median depth")
    p.add_argument("-win", "-window", "--window", dest="window",
                   type=float, default=1_000_000,
                   help="window for the smoothed tracks: bp when >= 1000, "
                        "else Mb (the reference -window unit, e.g. "
                        "`--window 1 --step 0.25` = 1 Mb / 250 kb)")
    p.add_argument("-step", "--step", type=float, default=None,
                   help="window-center step (same bp/Mb rule; prefix mode; "
                        "default win/2)")
    p.add_argument("-ed", "--ed-power", dest="ed_power", type=int, default=4,
                   help="ED exponent for thresholding/smoothing (default 4)")
    p.add_argument("-ci", "--ci", type=float, action="append", default=None,
                   help="CI percentile; repeatable in prefix mode "
                        "(-ci 95 -ci 99; region filter uses the max). "
                        "Default 95")
    p.add_argument("-sims", "--sims", type=int, default=10_000,
                   help="null simulation replicates per depth pair")
    p.add_argument("-fdr", "--fdr", type=float, default=0.05,
                   help="G' BH-FDR significance level")
    p.add_argument("-no-plot", "--no-plot", action="store_true")
    p.add_argument("-fmt", "--fmt", dest="format", type=str, default="png",
                   choices=("png", "pdf", "svg", "tif"),
                   help="figure output format (reference -fmt)")
    p.add_argument("-ratio", "--ratio", type=str, default=None,
                   help="subplot width/height ratio, e.g. 3, 3:1, 16/5 "
                        "(reference -ratio)")
    p.add_argument("-palette", "--palette", type=str, default=None,
                   help="chromosome color palette: cmap name or "
                        "';'-separated colors (reference -palette)")
    from janusx_tpu_torch.cli.bsa import add_filter_args

    add_filter_args(p)
    common.add_out_args(p, default_prefix="postbsa")
    return p


def simulate_delta_ci(
    d1: np.ndarray, d2: np.ndarray, q: float, sims: int, seed: int = 0,
    max_bins: int = 256,
) -> np.ndarray:
    """Per-SNP |Δ-SNP| null quantile via binomial resampling at p=0.5.

    Depth pairs are binned (both depths clipped at the max_bins-th
    percentile grid) so the simulation runs once per distinct pair —
    the reference simulates per depth pair too (postbsa.py CI tables)."""
    rng = np.random.default_rng(seed)
    d1 = np.clip(d1.astype(np.int64), 1, None)
    d2 = np.clip(d2.astype(np.int64), 1, None)
    pairs, inv = np.unique(np.stack([d1, d2], 1), axis=0, return_inverse=True)
    if len(pairs) > max_bins:
        # quantize both depth axes to ~sqrt(max_bins) levels
        lev = int(np.sqrt(max_bins))
        qs = np.linspace(0, 100, lev)
        g1 = np.unique(np.percentile(d1, qs).astype(np.int64))
        g2 = np.unique(np.percentile(d2, qs).astype(np.int64))
        q1 = g1[np.clip(np.searchsorted(g1, d1), 0, len(g1) - 1)]
        q2 = g2[np.clip(np.searchsorted(g2, d2), 0, len(g2) - 1)]
        pairs, inv = np.unique(np.stack([q1, q2], 1), axis=0, return_inverse=True)
    thr = np.empty(len(pairs))
    for i, (a, b) in enumerate(pairs):
        x1 = rng.binomial(a, 0.5, size=sims) / a
        x2 = rng.binomial(b, 0.5, size=sims) / b
        thr[i] = np.percentile(np.abs(x1 - x2), q)
    return thr[inv]


def gprime_pvalues(gp: np.ndarray) -> np.ndarray:
    """Lognormal null p-values for G' (QTLseqr / Magwene et al.):
    estimate null mean/var from the Hampel-trimmed (outlier-removed)
    log G' distribution, then p = 1 - lognorm.cdf."""
    from scipy import stats as sp

    gp = np.asarray(gp, float)
    ok = np.isfinite(gp) & (gp > 0)
    lg = np.log(gp[ok])
    med = np.median(lg)
    mad = np.median(np.abs(lg - med)) * 1.4826
    keep = np.abs(lg - med) <= 5.2 * mad  # Hampel rule
    mu, sd = float(np.mean(lg[keep])), float(np.std(lg[keep]))
    p = np.ones_like(gp)
    p[ok] = sp.norm.sf(np.log(gp[ok]), loc=mu, scale=max(sd, 1e-12))
    return p


def bh_fdr(p: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg q-values."""
    p = np.asarray(p, float)
    m = len(p)
    order = np.argsort(p)
    ranked = p[order] * m / (np.arange(m) + 1)
    qv = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(m)
    out[order] = np.clip(qv, 0, 1)
    return out


def window_mean(pos: np.ndarray, val: np.ndarray, window: int) -> np.ndarray:
    """Centered sliding-window mean over a sorted position axis."""
    half = window // 2
    lo = np.searchsorted(pos, pos - half, side="left")
    hi = np.searchsorted(pos, pos + half, side="right")
    c = np.concatenate([[0.0], np.cumsum(np.nan_to_num(val))])
    k = np.concatenate([[0], np.cumsum(np.isfinite(val).astype(np.int64))])
    cnt = np.maximum(k[hi] - k[lo], 1)
    return (c[hi] - c[lo]) / cnt


def _parse_ratio(spec):
    if spec is None:
        return None
    s = str(spec).replace(":", "/")
    if "/" in s:
        a, b = s.split("/", 1)
        return float(a) / float(b)
    return float(spec)


def plot_bsa(df, prefix: str, ci_pct: float, fdr: float,
             fmt: str = "png", ratio=None, palette=None) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from janusx_tpu_torch.plots.structure import resolve_palette

    chroms = list(dict.fromkeys(df["chrom"]))
    ccol = resolve_palette(palette, len(chroms)) if palette else None
    r = _parse_ratio(ratio)
    width = max(8, 2.2 * len(chroms))
    fig, axes = plt.subplots(
        2, len(chroms), figsize=(width, width / r if r else 5.2),
        sharey="row", squeeze=False, gridspec_kw={"wspace": 0.06},
    )
    sig_any = df["gprime_q"] <= fdr
    for j, ch in enumerate(chroms):
        sub = df[df["chrom"] == ch]
        mb = sub["pos"] / 1e6
        ax = axes[0][j]
        ax.scatter(mb, sub["delta_snp_index"], s=2,
                   c=[ccol[j]] if ccol else "#b8c4d0", rasterized=True)
        ax.plot(mb, sub["delta_smoothed"], c="#1f4e79", lw=1.2)
        ax.plot(mb, sub["delta_ci_hi"], c="#c0504d", lw=0.8, ls="--")
        ax.plot(mb, -sub["delta_ci_hi"], c="#c0504d", lw=0.8, ls="--")
        ax.set_ylim(-1.05, 1.05)
        ax.set_title(str(ch), fontsize=9)
        if j == 0:
            ax.set_ylabel("Δ(SNP-index)")
        ax2 = axes[1][j]
        lp = -np.log10(np.clip(sub["gprime_p"], 1e-300, 1.0))
        ax2.scatter(mb, lp, s=2, c="#9caf88", rasterized=True)
        sig = sub["gprime_q"] <= fdr
        if sig.any():
            ax2.scatter(mb[sig], lp[sig], s=4, c="#c0504d", rasterized=True)
        if sig_any.any():
            thr_p = df.loc[sig_any, "gprime_p"].max()
            ax2.axhline(-np.log10(max(thr_p, 1e-300)), c="#c0504d", lw=0.8, ls=":")
        ax2.set_xlabel("Mb")
        if j == 0:
            ax2.set_ylabel("-log10 p(G')")
    fig.suptitle(f"BSA: Δ-SNP index ({ci_pct:g}% CI) and G' significance", y=0.995)
    path = f"{prefix}.bsa.{fmt}"
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def _fmt_pct(p: float) -> str:
    return f"{p:g}"


def run_prefix_mode(args, prefix: str, ci_levels: list) -> int:
    """Reference `jx postbsa -file ... -b1 ... -b2 ...` pipeline
    (postbsa.py:1767-1990): filter chain -> per-SNP stats -> stepped
    windows -> percentile thresholds -> region table + figures."""
    import glob as globmod

    import pandas as pd

    from janusx_tpu_torch.cli.bsa import load_bulk_prefixed
    from janusx_tpu_torch.models.bsa import bsa_analysis, bsa_windows

    paths: list = []
    for pat in args.input:
        hits = sorted(globmod.glob(pat))
        paths.extend(hits if hits else [pat])
    frames = [pd.read_csv(f, sep="\t") for f in paths]
    df = frames[0] if len(frames) == 1 else pd.concat(frames, ignore_index=True)
    log.info("loaded %d loci from %d file(s)", len(df), len(paths))

    chrom, pos, a1, r1, a2, r2 = load_bulk_prefixed(
        df, args.bulk1, args.bulk2, args)
    res = bsa_analysis(chrom, pos, a1, r1, a2, r2,
                       window_bp=args.window, min_depth=0, gprime=False)
    win = bsa_windows(res, window_bp=args.window, step_bp=args.step,
                      ed_power=args.ed_power)

    b1n, b2n = f"{args.bulk1}.SNPindex", f"{args.bulk2}.SNPindex"
    dname = f"Delta.SNPindex({args.bulk2}-{args.bulk1})"
    raw = pd.DataFrame({
        "chr": res.chrom, "pos": res.pos, b1n: res.snp_index1,
        b2n: res.snp_index2, dname: res.delta, "ED": res.ed, "G": res.g_stat,
    })
    raw_path = prefix + ".raw.tsv"
    raw.to_csv(raw_path, sep="\t", index=False, float_format="%.6g")
    print(raw_path)

    smooth = pd.DataFrame({
        "chr": win.chrom, "pos": win.center.astype(np.int64),
        "n_snps": win.n_snps, b1n: win.index1, b2n: win.index2,
        dname: win.delta, "ED_power": win.ed_power, "Gprime": win.g_prime,
    })
    smooth_path = prefix + ".smooth.tsv"
    smooth.to_csv(smooth_path, sep="\t", index=False, float_format="%.6g")
    print(smooth_path)

    # percentile thresholds: raw ED^power / raw delta, smoothed Gprime
    # (reference postbsa.py:1431-1451)
    edp_raw = np.power(np.asarray(res.ed, float), args.ed_power)
    delta_raw = np.asarray(res.delta, float)
    gp_sm = np.asarray(win.g_prime, float)
    gp_fin = gp_sm[np.isfinite(gp_sm)]
    max_ci = max(ci_levels)
    thr = {}
    for ci in ci_levels:
        thr[ci] = (
            float(np.nanpercentile(edp_raw, ci)),
            float(np.nanpercentile(delta_raw, 100.0 - ci)),
            float(np.nanpercentile(delta_raw, ci)),
            float(np.nanpercentile(gp_fin, ci)) if gp_fin.size else float("nan"),
        )
        log.info("Threshold of ED^%d (P%s): %.4f", args.ed_power,
                 _fmt_pct(ci), thr[ci][0])
        log.info("Threshold of Delta-SNPindex (P%s,P%s): %.4f, %.4f",
                 _fmt_pct(100.0 - ci), _fmt_pct(ci), thr[ci][1], thr[ci][2])
        log.info("Threshold of Gprime (P%s): %.4f", _fmt_pct(ci), thr[ci][3])

    ed_cut, d_lo, d_hi, _ = thr[max_ci]
    half = args.window // 2
    sm_ed = np.asarray(win.ed_power, float)
    sm_d = np.asarray(win.delta, float)
    mask = (np.isfinite(sm_ed) & np.isfinite(sm_d)
            & ((sm_ed >= ed_cut) | (sm_d >= d_hi) | (sm_d <= d_lo)))
    if mask.any():
        centers = win.center[mask].astype(np.int64)
        thr_df = pd.DataFrame({
            "Chr": win.chrom[mask], "start": centers - half,
            "end": centers + half,
            f"ED{args.ed_power}": np.round(sm_ed[mask], 4),
            "deltaSNPindex": np.round(sm_d[mask], 4),
            "direction": np.where(sm_d[mask] >= d_hi, "upper", "lower"),
        })
        thr_path = prefix + ".thr.tsv"
        thr_df.to_csv(thr_path, sep="\t", index=False)
        print(thr_path)
        log.info("threshold regions at P%s: %d windows", _fmt_pct(max_ci),
                 int(mask.sum()))
    else:
        log.info("no windows exceed the P%s thresholds", _fmt_pct(max_ci))

    if not args.no_plot:
        print(plot_prefix_mode(raw, smooth, b1n, b2n, dname, thr[max_ci],
                               args.ed_power, prefix, fmt=args.format,
                               ratio=args.ratio, palette=args.palette))
    return 0


def plot_prefix_mode(raw, smooth, b1n, b2n, dname, cuts, ed_power,
                     prefix: str, fmt: str = "png", ratio=None,
                     palette=None) -> str:
    """Per-chromosome snp-index (2 rows) + stats (3 rows) panel figures
    (reference fig_snp/fig_stats, postbsa.py:1515-1620)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from janusx_tpu_torch.plots.structure import resolve_palette

    ed_cut, d_lo, d_hi, gp_cut = cuts
    chroms = list(dict.fromkeys(raw["chr"]))
    ncol = max(1, len(chroms))
    ccol = resolve_palette(palette, ncol) if palette else None
    r = _parse_ratio(ratio)

    def _panels(nrows):
        width = max(8, 2.2 * ncol)
        return plt.subplots(
            nrows, ncol,
            figsize=(width, width / r if r else 1.9 * nrows + 1.2),
            sharey="row", squeeze=False, gridspec_kw={"wspace": 0.06},
        )

    fig1, ax1 = _panels(2)
    fig2, ax2 = _panels(3)
    for j, ch in enumerate(chroms):
        rsub = raw[raw["chr"] == ch]
        ssub = smooth[smooth["chr"].astype(str) == str(ch)]
        mb, smb = rsub["pos"] / 1e6, ssub["pos"] / 1e6
        for k, col in enumerate((b1n, b2n)):
            ax = ax1[k][j]
            ax.scatter(mb, rsub[col], s=2,
                       c=[ccol[j]] if ccol else "#b8c4d0", rasterized=True)
            ax.plot(smb, ssub[col], c="#1f4e79", lw=1.2)
            ax.set_ylim(-0.05, 1.05)
            if j == 0:
                ax.set_ylabel(col, fontsize=8)
        ax1[0][j].set_title(str(ch), fontsize=9)
        ax1[1][j].set_xlabel("Mb")

        ax = ax2[0][j]
        ax.scatter(mb, rsub[dname], s=2,
                   c=[ccol[j]] if ccol else "#b8c4d0", rasterized=True)
        ax.plot(smb, ssub[dname], c="#1f4e79", lw=1.2)
        for y in (d_lo, d_hi):
            ax.axhline(y, c="#c0504d", lw=0.8, ls="--")
        ax.set_ylim(-1.05, 1.05)
        ax.set_title(str(ch), fontsize=9)
        if j == 0:
            ax.set_ylabel("Δ(SNP-index)")
        ax = ax2[1][j]
        ax.plot(smb, ssub["ED_power"], c="#9caf88", lw=1.2)
        ax.axhline(ed_cut, c="#c0504d", lw=0.8, ls="--")
        if j == 0:
            ax.set_ylabel(f"ED^{ed_power}")
        ax = ax2[2][j]
        ax.plot(smb, ssub["Gprime"], c="#8064a2", lw=1.2)
        if np.isfinite(gp_cut):
            ax.axhline(gp_cut, c="#c0504d", lw=0.8, ls="--")
        ax.set_xlabel("Mb")
        if j == 0:
            ax.set_ylabel("G'")
    p1, p2 = f"{prefix}.snpindex.{fmt}", f"{prefix}.stats.{fmt}"
    fig1.savefig(p1, dpi=150, bbox_inches="tight")
    fig2.savefig(p2, dpi=150, bbox_inches="tight")
    plt.close(fig1)
    plt.close(fig2)
    return p2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)
    common.setup_logging(args.verbose, prefix, "postbsa")
    # window/step unit rule: values < 1000 are Mb (the reference unit,
    # script/postbsa.py DEFAULT_WINDOW_MB), larger values are bp
    args.window = int(args.window * 1e6) if args.window < 1000 else int(args.window)
    if args.step is not None:
        args.step = int(args.step * 1e6) if args.step < 1000 else int(args.step)
    if (args.bulk1 is None) != (args.bulk2 is None):
        raise SystemExit("-b1 and -b2 must be given together")
    ci_levels = sorted({float(c) for c in (args.ci or [95.0])})
    if any(not 0.0 < c < 100.0 for c in ci_levels):
        raise SystemExit("-ci percentiles must be in (0, 100)")
    if args.bulk1:
        return run_prefix_mode(args, prefix, ci_levels)
    if len(args.input) != 1:
        raise SystemExit("multiple -i inputs need -b1/-b2 (prefix mode)")

    import pandas as pd

    df = pd.read_csv(args.input[0], sep="\t")
    need = {"chrom", "pos", "delta_snp_index", "Gprime"}
    missing = need - set(df.columns)
    if missing:
        raise SystemExit(f"missing columns in {args.input}: {sorted(missing)}")
    df = df.sort_values(["chrom", "pos"], kind="stable").reset_index(drop=True)

    if args.depths:
        dd = pd.read_csv(args.depths, sep="\t")
        dd = dd.sort_values(["chrom", "pos"], kind="stable").reset_index(drop=True)
        key = ["chrom", "pos"]
        # duplicated positions (e.g. multiallelic rows) would inflate the
        # left-merge beyond len(df): keep the first depth row per site
        dd = dd.drop_duplicates(subset=key, keep="first")
        merged = df[key].merge(dd, on=key, how="left")
        d1 = (merged["alt1"] + merged["ref1"]).to_numpy(float)
        d2 = (merged["alt2"] + merged["ref2"]).to_numpy(float)
        d1 = np.where(np.isfinite(d1), d1, np.nanmedian(d1))
        d2 = np.where(np.isfinite(d2), d2, np.nanmedian(d2))
    else:
        # no depth file: flat CI from a nominal depth (the bsa TSV has no
        # depths; warn so users know the band is approximate)
        log.warning("no -d depth table: using a flat 40x CI band")
        d1 = np.full(len(df), 40.0)
        d2 = np.full(len(df), 40.0)
    ci_pct = max(ci_levels)
    df["delta_ci_hi"] = simulate_delta_ci(d1, d2, ci_pct, args.sims)

    parts = []
    for ch, sub in df.groupby("chrom", sort=False):
        sm = window_mean(
            sub["pos"].to_numpy(np.int64),
            sub["delta_snp_index"].to_numpy(float), args.window,
        )
        parts.append(pd.Series(sm, index=sub.index))
    df["delta_smoothed"] = pd.concat(parts).sort_index()

    df["gprime_p"] = gprime_pvalues(df["Gprime"].to_numpy())
    df["gprime_q"] = bh_fdr(df["gprime_p"].to_numpy())
    df["sig_delta"] = np.abs(df["delta_smoothed"]) > df["delta_ci_hi"]
    df["sig_gprime"] = df["gprime_q"] <= args.fdr

    out = prefix + ".postbsa.tsv"
    df.to_csv(out, sep="\t", index=False, float_format="%.6g")
    print(out)
    n_sig = int(df["sig_gprime"].sum())
    log.info("G' significant SNPs at FDR %.2g: %d", args.fdr, n_sig)
    if not args.no_plot:
        print(plot_bsa(df, prefix, ci_pct, args.fdr, fmt=args.format,
                       ratio=args.ratio, palette=args.palette))
    return 0
