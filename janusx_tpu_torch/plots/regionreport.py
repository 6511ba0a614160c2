"""LocusZoom-style regional association reports.

Reference: the postgwas region-report machinery
(JanusX python/janusx/script/postgwas.py — regional panels with
annotation and LD context around top loci).

One figure per locus:
  panel 1 — regional -log10(p) scatter, points colored by LD r^2 to the
            lead SNP (grey when no genotype is available), lead SNP as a
            purple diamond, significance line;
  panel 2 — stacked gene models from GFF3 (plots.geneplot track);
  panel 3 — rotated LD r^2 triangle under the region (optional).
"""

from __future__ import annotations

import numpy as np

_LD_BINS = [
    (0.8, "#d73027"), (0.6, "#fc8d59"), (0.4, "#fee090"),
    (0.2, "#91bfdb"), (-0.01, "#4575b4"),
]


def pick_loci(
    chrom: np.ndarray, pos: np.ndarray, p: np.ndarray,
    n_loci: int = 3, window: int = 250_000, max_p: float = 1e-4,
) -> list[tuple[str, int]]:
    """Greedy top-K independent loci: best SNP, mask +-window, repeat."""
    chrom = np.asarray(chrom).astype(str)
    pos = np.asarray(pos)
    p = np.asarray(p, float)
    # underflowed p == 0.0 are the STRONGEST hits, not invalid — clamp to
    # the smallest positive double so they can lead a locus
    p = np.where(np.isfinite(p) & (p <= 0.0), 5e-324, p)
    ok = np.isfinite(p)
    loci = []
    masked = ~ok
    for _ in range(n_loci):
        if masked.all():
            break
        i = int(np.argmin(np.where(masked, np.inf, p)))
        if not np.isfinite(p[i]) or p[i] > max_p:
            break
        loci.append((chrom[i], int(pos[i])))
        masked |= (chrom == chrom[i]) & (np.abs(pos - pos[i]) <= window)
    return loci


def _ld_to_lead(sub_pg, lead_idx: int):
    """(r² to lead, full r² matrix) for the region markers (device corr)."""
    from janusx_tpu_torch.models.ldprune import r2_matrix

    r2 = r2_matrix(sub_pg)
    return r2[lead_idx].clip(0, 1), r2


def region_report(
    df,  # assoc DataFrame (chrom pos [snp] + pcol)
    chrom: str,
    center: int,
    out_path: str,
    pcol: str = "pwald",
    window: int = 250_000,
    gff_path: str | None = None,
    pg=None,  # PackedGenotypes for LD coloring + triangle
    sig_line: float | None = None,
    ld_triangle: bool = True,
    max_ld_markers: int = 300,
) -> dict:
    """Render one locus report. Returns {'n_genes', 'lead', 'n_snps'}."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lo, hi = center - window, center + window
    sub = df[(df["chrom"].astype(str) == str(chrom))
             & (df["pos"] >= lo) & (df["pos"] <= hi)]
    pos = sub["pos"].to_numpy()
    nlp = -np.log10(np.clip(sub[pcol].to_numpy(float), 1e-300, 1.0))
    lead_i = int(np.argmax(nlp)) if len(nlp) else 0
    lead_pos = int(pos[lead_i]) if len(pos) else center
    lead_name = (
        str(sub.iloc[lead_i]["snp"]) if "snp" in sub.columns and len(sub)
        else f"{chrom}:{lead_pos}"
    )

    # LD to lead (optional)
    r2_lead = None
    r2_mat = None
    sel_pos = None
    if pg is not None and len(pos):
        mask = ((pg.sites.chrom.astype(str) == str(chrom))
                & (pg.sites.pos >= lo) & (pg.sites.pos <= hi))
        sel = np.nonzero(mask)[0]
        if len(sel) > max_ld_markers:
            keep = np.linspace(0, len(sel) - 1, max_ld_markers).astype(int)
            # always keep the lead marker in the subsample
            lead_in_sel = np.nonzero(pg.sites.pos[sel] == lead_pos)[0]
            if len(lead_in_sel):
                keep = np.union1d(keep, lead_in_sel[:1])
            sel = sel[keep]
        if len(sel) >= 2:
            sub_pg = pg.take_snps(sel)
            sel_pos = sub_pg.sites.pos
            li = int(np.argmin(np.abs(sel_pos - lead_pos)))
            r2_lead_sel, r2_mat = _ld_to_lead(sub_pg, li)
            # map assoc positions onto the NEAREST genotype marker (the raw
            # insertion index always snapped to the right neighbor)
            j = np.clip(np.searchsorted(sel_pos, pos), 1, len(sel_pos) - 1)
            pick_left = np.abs(pos - sel_pos[j - 1]) <= np.abs(sel_pos[j] - pos)
            idx = np.where(pick_left, j - 1, j)
            r2_lead = r2_lead_sel[idx]

    models, rows, n_rows = [], [], 1
    if gff_path:
        from janusx_tpu_torch.plots.geneplot import _assign_rows, read_gene_models

        models = read_gene_models(gff_path, str(chrom), lo, hi)
        rows, n_rows = _assign_rows(models)

    n_panels = 2 + (1 if (ld_triangle and r2_mat is not None) else 0)
    heights = [3.0, 0.35 * max(n_rows, 1) + 0.4] + (
        [1.8] if n_panels == 3 else []
    )
    fig, axes = plt.subplots(
        n_panels, 1, figsize=(9, sum(heights) + 1.2), sharex=False,
        gridspec_kw={"height_ratios": heights, "hspace": 0.25},
    )
    axes = np.atleast_1d(axes)

    ax = axes[0]
    if r2_lead is not None:
        colors = np.empty(len(pos), object)
        for i, v in enumerate(r2_lead):
            for thr, c in _LD_BINS:
                if v >= thr:
                    colors[i] = c
                    break
        ax.scatter(pos / 1e6, nlp, s=16, c=list(colors), edgecolors="none",
                   zorder=2)
        for thr, c in _LD_BINS:
            ax.scatter([], [], c=c, s=16,
                       label=f"r² ≥ {max(thr, 0):.1f}")
        ax.legend(fontsize=6, loc="upper right", title="LD to lead",
                  title_fontsize=6)
    else:
        ax.scatter(pos / 1e6, nlp, s=14, c="#7a8aa0", edgecolors="none",
                   zorder=2)
    if len(nlp):
        ax.scatter([lead_pos / 1e6], [nlp[lead_i]], marker="D", s=48,
                   c="#7b2d8b", zorder=3, label=None)
        ax.annotate(lead_name, (lead_pos / 1e6, nlp[lead_i]),
                    textcoords="offset points", xytext=(4, 4), fontsize=7)
    if sig_line is not None:
        ax.axhline(sig_line, color="red", linestyle="--", linewidth=0.8)
    ax.set_ylabel(r"$-\log_{10}(p)$")
    ax.set_xlim(lo / 1e6, hi / 1e6)
    ax.set_title(f"{chrom}:{lo:,}-{hi:,} — lead {lead_name}")

    ax_g = axes[1]
    if models:
        from janusx_tpu_torch.plots.geneplot import draw_gene_track

        draw_gene_track(ax_g, models, rows, n_rows)
    else:
        ax_g.text(0.5, 0.5, "no gene models", transform=ax_g.transAxes,
                  ha="center", fontsize=8, color="#999999")
        ax_g.set_yticks([])
    ax_g.set_xlim(lo / 1e6, hi / 1e6)
    ax_g.set_xlabel(f"chr{chrom} position (Mb)")

    if n_panels == 3:
        ax_l = axes[2]
        # rotated LD triangle: cell (i, j) plotted at midpoint, depth |i-j|
        q = len(sel_pos)
        xs, ys, cs = [], [], []
        for i in range(q):
            for j in range(i + 1, q):
                xs.append((sel_pos[i] + sel_pos[j]) / 2e6)
                ys.append(-(sel_pos[j] - sel_pos[i]) / 1e6 / 2)
                cs.append(r2_mat[i, j])
        ax_l.scatter(xs, ys, c=cs, cmap="Reds", s=4, marker="D",
                     vmin=0, vmax=1, edgecolors="none")
        ax_l.set_xlim(lo / 1e6, hi / 1e6)
        ax_l.set_yticks([])
        ax_l.set_ylabel("LD", fontsize=8)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return {"n_genes": len(models), "lead": lead_name, "n_snps": len(pos)}
