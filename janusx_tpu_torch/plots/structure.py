"""Population-structure plots (reference: bioplotkit/pcshow.py,
popstructure.py, LDBlock.py)."""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

_PAL = [
    "#4C72B0", "#DD8452", "#55A868", "#C44E52", "#8172B3",
    "#937860", "#DA8BC3", "#8C8C8C", "#CCB974", "#64B5CD",
]


def resolve_palette(palette, n: int) -> list:
    """cmap name (tab10) or ','/';'-separated color list -> n colors
    (reference pca.py -palette semantics)."""
    if palette is None:
        return [_PAL[i % len(_PAL)] for i in range(n)]
    import re

    import matplotlib as mpl

    toks = [t for t in re.split(r"[,;]", str(palette)) if t.strip()]
    if len(toks) > 1:
        return [toks[i % len(toks)].strip() for i in range(n)]
    try:
        cmap = mpl.colormaps[str(palette)]
    except KeyError:
        return [_PAL[i % len(_PAL)] for i in range(n)]
    if getattr(cmap, "N", 256) <= 32:
        return [cmap(i % cmap.N) for i in range(n)]
    return [cmap(i / max(1, n - 1)) for i in range(n)]


def pc_scatter(vecs: np.ndarray, out_path: str, groups=None, labels=None,
               pcs=(0, 1), dpi: int = 150, palette=None) -> None:
    """PC scatter plot; optional group coloring + per-point labels."""
    fig, ax = plt.subplots(figsize=(4.6, 4.2))
    i, j = pcs
    if groups is None:
        ax.scatter(vecs[:, i], vecs[:, j], s=10, c=_PAL[0], alpha=0.7, lw=0)
    else:
        groups = np.asarray(groups)
        uniq = list(dict.fromkeys(groups))
        colors = resolve_palette(palette, len(uniq))
        for gi, g in enumerate(uniq):
            sel = groups == g
            ax.scatter(
                vecs[sel, i], vecs[sel, j], s=10, alpha=0.7, lw=0,
                c=[colors[gi]], label=str(g),
            )
        ax.legend(frameon=False, fontsize=8)
    if labels is not None:
        for k, lab in enumerate(labels):
            if lab:
                ax.annotate(str(lab), (vecs[k, i], vecs[k, j]), fontsize=6,
                            textcoords="offset points", xytext=(2, 2))
    ax.set_xlabel(f"PC{i + 1}")
    ax.set_ylabel(f"PC{j + 1}")
    ax.spines[["top", "right"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)


def pc_scatter3d_gif(vecs: np.ndarray, out_path: str, groups=None,
                     palette=None, n_frames: int = 24, dpi: int = 90) -> None:
    """Rotating PC1-PC3 3D scatter GIF (reference pca.py -plot3D)."""
    from matplotlib.animation import FuncAnimation, PillowWriter

    fig = plt.figure(figsize=(4.6, 4.2))
    ax = fig.add_subplot(projection="3d")
    if groups is None:
        ax.scatter(vecs[:, 0], vecs[:, 1], vecs[:, 2], s=8, c=_PAL[0], alpha=0.7)
    else:
        groups = np.asarray(groups)
        uniq = list(dict.fromkeys(groups))
        colors = resolve_palette(palette, len(uniq))
        for gi, g in enumerate(uniq):
            sel = groups == g
            ax.scatter(vecs[sel, 0], vecs[sel, 1], vecs[sel, 2], s=8,
                       alpha=0.7, c=[colors[gi]], label=str(g))
        ax.legend(frameon=False, fontsize=7)
    ax.set_xlabel("PC1")
    ax.set_ylabel("PC2")
    ax.set_zlabel("PC3")

    def turn(frame):
        ax.view_init(elev=20, azim=frame * (360.0 / n_frames))
        return ()

    anim = FuncAnimation(fig, turn, frames=n_frames)
    anim.save(out_path, writer=PillowWriter(fps=8), dpi=dpi)
    plt.close(fig)


def admixture_bars(Q: np.ndarray, out_path: str, sample_labels=None,
                   sort_by_component: bool = True, dpi: int = 150) -> None:
    """Stacked ancestry-fraction bars (one bar per sample)."""
    Q = np.asarray(Q, float)
    n, K = Q.shape
    order = np.arange(n)
    if sort_by_component:
        major = np.argmax(Q.mean(axis=0))
        order = np.argsort(-Q[:, major], kind="stable")
    fig, ax = plt.subplots(figsize=(max(6, n * 0.02), 2.6))
    bottom = np.zeros(n)
    x = np.arange(n)
    for k in range(K):
        vals = Q[order, k]
        ax.bar(x, vals, bottom=bottom, width=1.0, color=_PAL[k % len(_PAL)],
               lw=0)
        bottom += vals
    ax.set_xlim(-0.5, n - 0.5)
    ax.set_ylim(0, 1)
    ax.set_ylabel("Ancestry")
    ax.set_xticks([])
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)


def ld_heatmap(r2: np.ndarray, out_path: str, positions=None, title=None,
               dpi: int = 150, cmap=None, ratio: float | None = None) -> None:
    """LD r² heatmap for a marker window. ``cmap``: matplotlib name or a
    ';'-separated color ramp (reference -ldblock-palette)."""
    if cmap and (";" in str(cmap) or "," in str(cmap)):
        import re

        from matplotlib.colors import LinearSegmentedColormap

        cols = [t for t in re.split(r"[;,]", str(cmap)) if t.strip()]
        cmap = LinearSegmentedColormap.from_list("ldpal", cols)
    fig, ax = plt.subplots(
        figsize=(4.6 * (ratio or 1.0), 4.2) if ratio else (4.6, 4.2))
    im = ax.imshow(r2, cmap=cmap or "Reds", vmin=0, vmax=1,
                   interpolation="nearest")
    fig.colorbar(im, ax=ax, shrink=0.8, label=r"$r^2$")
    if title:
        ax.set_title(title)
    ax.set_xlabel("Marker")
    ax.set_ylabel("Marker")
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
