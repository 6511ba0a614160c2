"""Regional gene-model track plot (optionally under an association panel).

Reference: JanusX python/janusx/bioplotkit/geneplot.py — gene
structures (exon boxes, intron lines, strand arrows) drawn from GFF3 for
a genomic window, stacked beneath the regional -log10(p) scatter in
postgwas region reports.
"""

from __future__ import annotations

import gzip

import numpy as np


def read_gene_models(gff_path: str, chrom: str, start: int, end: int):
    """Gene models overlapping [start, end]: list of dicts with
    name/start/end/strand/exons (exons from exon/CDS features grouped by
    Parent; genes without exon rows get one full-length exon)."""
    chrom = str(chrom)
    opener = gzip.open if str(gff_path).endswith(".gz") else open
    genes: dict = {}
    exons: dict = {}
    with opener(gff_path, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 9 or f[0] != chrom:
                continue
            s, e = int(f[3]), int(f[4])
            if e < start or s > end:
                continue
            attrs = dict(
                kv.split("=", 1) for kv in f[8].split(";") if "=" in kv
            )
            if f[2] == "gene":
                gid = attrs.get("ID") or f"{f[0]}:{s}-{e}"
                name = attrs.get("Name") or attrs.get("gene_name") or gid
                genes[gid] = {"name": name, "start": s, "end": e,
                              "strand": f[6], "exons": []}
            elif f[2] in ("exon", "CDS"):
                parent = attrs.get("Parent", "")
                for pid in parent.split(","):
                    exons.setdefault(pid, []).append((s, e))
    # attach exons through mRNA parents when possible: try direct match,
    # else any exon set whose span falls inside the gene
    for gid, g in genes.items():
        direct = exons.get(gid, [])
        if not direct:
            for pid, ex in exons.items():
                lo = min(s for s, _ in ex)
                hi = max(e for _, e in ex)
                if g["start"] <= lo and hi <= g["end"]:
                    direct = direct + ex
        g["exons"] = sorted(set(direct)) or [(g["start"], g["end"])]
    return sorted(genes.values(), key=lambda g: g["start"])


def _assign_rows(models):
    """Greedy interval-graph coloring so overlapping genes stack."""
    rows: list = []
    out = []
    for g in models:
        for ri, occupied_end in enumerate(rows):
            if g["start"] > occupied_end + 1:
                rows[ri] = g["end"]
                out.append(ri)
                break
        else:
            rows.append(g["end"])
            out.append(len(rows) - 1)
    return out, len(rows)


def gene_model_plot(
    gff_path: str,
    chrom: str,
    start: int,
    end: int,
    out_path: str,
    assoc=None,  # optional (pos, neglogp) arrays for the upper panel
    sig_line: float | None = None,
    title: str | None = None,
):
    """Draw gene models for the window; with ``assoc``, add a regional
    association scatter above the track. Returns the model count."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    models = read_gene_models(gff_path, chrom, start, end)
    rows, n_rows = _assign_rows(models)
    if assoc is not None:
        fig, (ax_a, ax) = plt.subplots(
            2, 1, figsize=(9, 3.2 + 0.4 * max(n_rows, 1)), sharex=True,
            gridspec_kw={"height_ratios": [3, max(n_rows, 1)]},
        )
        pos, nlp = assoc
        ax_a.scatter(np.asarray(pos) / 1e6, nlp, s=12, alpha=0.75,
                     edgecolors="none")
        if sig_line is not None:
            ax_a.axhline(sig_line, color="red", linestyle="--", linewidth=0.8)
        ax_a.set_ylabel(r"$-\log_{10}(p)$")
        if title:
            ax_a.set_title(title)
    else:
        fig, ax = plt.subplots(figsize=(9, 1.2 + 0.4 * max(n_rows, 1)))
        if title:
            ax.set_title(title)
    draw_gene_track(ax, models, rows, n_rows)
    ax.set_xlim(start / 1e6, end / 1e6)
    ax.set_xlabel(f"chr{chrom} position (Mb)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return len(models)


def draw_gene_track(ax, models, rows, n_rows: int) -> None:
    """Draw stacked gene models (exon boxes, intron lines, strand arrows)
    onto an existing axes — shared by gene_model_plot and the postgwas
    region reports (plots.regionreport)."""
    from matplotlib.patches import Rectangle

    for g, row in zip(models, rows):
        y = -row
        ax.plot([g["start"] / 1e6, g["end"] / 1e6], [y, y],
                color="#555555", linewidth=1.0, zorder=1)
        for s, e in g["exons"]:
            ax.add_patch(Rectangle(
                (s / 1e6, y - 0.18), (e - s) / 1e6, 0.36,
                facecolor="#2b6cb0", edgecolor="none", zorder=2,
            ))
        marker = ">" if g["strand"] == "+" else "<"
        ax.plot([(g["start"] if g["strand"] == "+" else g["end"]) / 1e6],
                [y], marker=marker, color="#2b6cb0", markersize=4, zorder=3)
        ax.text((g["start"] + g["end"]) / 2e6, y + 0.28, g["name"],
                ha="center", fontsize=7)
    ax.set_ylim(-(max(n_rows, 1) - 0.3), 0.8)
    ax.set_yticks([])
