"""GS diagnostics plots (reference: bioplotkit/gsplot.py)."""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def pred_vs_obs_plot(y_true, y_pred, out_path: str, title: str | None = None,
                     dpi: int = 150) -> None:
    yt = np.asarray(y_true, float)
    yp = np.asarray(y_pred, float)
    ok = np.isfinite(yt) & np.isfinite(yp)
    yt, yp = yt[ok], yp[ok]
    fig, ax = plt.subplots(figsize=(4.2, 4.2))
    ax.scatter(yt, yp, s=10, alpha=0.6, c="#4C72B0", lw=0)
    if len(yt) > 1:
        lo = min(yt.min(), yp.min())
        hi = max(yt.max(), yp.max())
        ax.plot([lo, hi], [lo, hi], color="red", lw=0.8, ls="--")
        r = np.corrcoef(yt, yp)[0, 1]
        ttl = f"{title or ''}  r={r:.3f}".strip()
        ax.set_title(ttl)
    ax.set_xlabel("Observed")
    ax.set_ylabel("Predicted")
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)


def cv_fold_bars(fold_metrics: list, out_path: str, metric: str = "pearson",
                 dpi: int = 150) -> None:
    vals = [fm.get(metric, np.nan) for fm in fold_metrics]
    fig, ax = plt.subplots(figsize=(4.5, 3))
    ax.bar(range(len(vals)), vals, color="#4C72B0")
    ax.axhline(np.nanmean(vals), color="red", ls="--", lw=0.8)
    ax.set_xlabel("Fold")
    ax.set_ylabel(metric)
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)


def accuracy_violin(trait_methods: dict, out_path: str, metric: str = "pearson",
                    dpi: int = 150) -> None:
    """Fold-accuracy distributions per trait x method (reference
    gsplot.plot_accuracy_split_violin, simplified single-axis form).

    trait_methods: {trait: {method: [fold metric values]}}.
    """
    labels, data = [], []
    for trait, methods in trait_methods.items():
        for method, vals in methods.items():
            vals = [v for v in vals if np.isfinite(v)]
            if vals:
                labels.append(f"{trait}\n{method}" if len(trait_methods) > 1
                              else method)
                data.append(vals)
    if not data:
        return
    fig, ax = plt.subplots(figsize=(max(4.0, 1.1 * len(data)), 3.4))
    parts = ax.violinplot(data, showmeans=True, showextrema=False)
    for pc in parts["bodies"]:
        pc.set_facecolor("#4C72B0")
        pc.set_alpha(0.5)
    for i, vals in enumerate(data):
        ax.scatter(np.full(len(vals), i + 1) + np.linspace(-0.06, 0.06, len(vals)),
                   vals, s=12, color="#2d3a52", zorder=3)
    ax.set_xticks(range(1, len(labels) + 1))
    ax.set_xticklabels(labels, fontsize=8)
    ax.set_ylabel(f"CV {metric}")
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)


def accuracy_runtime_scatter(points: list, out_path: str, dpi: int = 150) -> None:
    """CV accuracy vs CV wall time per method (reference
    gsplot.plot_accuracy_runtime_scatter).

    points: list of (label, cv_seconds, pearson).
    """
    pts = [(l, s, r) for l, s, r in points
           if np.isfinite(s) and np.isfinite(r)]
    if not pts:
        return
    fig, ax = plt.subplots(figsize=(4.6, 3.4))
    xs = [p[1] for p in pts]
    ys = [p[2] for p in pts]
    ax.scatter(xs, ys, s=28, c="#4C72B0", zorder=3)
    for label, x, y in pts:
        ax.annotate(label, (x, y), textcoords="offset points", xytext=(4, 4),
                    fontsize=7)
    ax.set_xlabel("CV wall time (s)")
    ax.set_ylabel("CV pearson")
    if max(xs) / max(min(xs), 1e-9) > 30:
        ax.set_xscale("log")
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)


def signed_effect_manhattan(chrom, pos, effect, out_path: str,
                            title: str | None = None, dpi: int = 150) -> None:
    """Signed marker-effect Manhattan (reference gsplot.plot_signed_effect):
    per-chromosome alternating colors, y = signed effect size."""
    chrom = np.asarray(chrom, dtype=object)
    pos = np.asarray(pos, np.int64)
    eff = np.asarray(effect, np.float64)
    ok = np.isfinite(eff)
    chrom, pos, eff = chrom[ok], pos[ok], eff[ok]
    # genome-wide x offsets in input order of chromosomes
    chroms = list(dict.fromkeys(chrom.tolist()))
    colors = ("#4C72B0", "#DD8452")
    fig, ax = plt.subplots(figsize=(7.5, 3))
    offset = 0
    ticks, tick_labels = [], []
    for ci, c in enumerate(chroms):
        m = chrom == c
        x = offset + (pos[m] - pos[m].min())
        ax.vlines(x, 0, eff[m], color=colors[ci % 2], lw=0.7)
        ticks.append(offset + (pos[m].max() - pos[m].min()) / 2)
        tick_labels.append(str(c))
        offset += pos[m].max() - pos[m].min() + max(1, int(0.02 * (pos.max() - pos.min() + 1)))
    ax.axhline(0.0, color="black", lw=0.6)
    ax.set_xticks(ticks)
    ax.set_xticklabels(tick_labels, fontsize=8)
    ax.set_xlabel("Chromosome")
    ax.set_ylabel("Effect")
    if title:
        ax.set_title(title)
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
