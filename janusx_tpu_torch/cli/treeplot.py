"""`jx treeplot` — render phylogenetic trees from Newick or a GRM.

Reference: script/treeplot.py (toytree-based; here matplotlib):
-nwk newick or -k GRM input (NJ built from 1 - K/diag similarity),
layouts r/l/u/d (directional rectangular), c (circular), w (unrooted
radial), -root re-rooting, -showlabels / -regexlabels label control.
"""

from __future__ import annotations

import argparse
import math
import re as _re

from janusx_tpu_torch.cli import common


def parse_newick(text: str):
    """Minimal Newick parser -> nested (children, length, name) tuples.

    NJ trees nest one paren level per join (depth O(n)), so the default
    1000-frame recursion limit dies around ~1k tips — raise it to cover
    this tree before the recursive walk."""
    import sys

    need = text.count("(") * 4 + 10_000
    if sys.getrecursionlimit() < need:
        sys.setrecursionlimit(need)
    text = text.strip().rstrip(";")
    pos = [0]

    def parse_node():
        children = []
        name = ""
        length = 0.0
        if text[pos[0]] == "(":
            pos[0] += 1
            while True:
                children.append(parse_node())
                if text[pos[0]] == ",":
                    pos[0] += 1
                    continue
                if text[pos[0]] == ")":
                    pos[0] += 1
                    break
        start = pos[0]
        while pos[0] < len(text) and text[pos[0]] not in ",():":
            pos[0] += 1
        name = text[start : pos[0]]
        if pos[0] < len(text) and text[pos[0]] == ":":
            pos[0] += 1
            start = pos[0]
            while pos[0] < len(text) and text[pos[0]] not in ",()":
                pos[0] += 1
            length = float(text[start : pos[0]])
        return [children, length, name]

    return parse_node()


def count_leaves(nd):
    return 1 if not nd[0] else sum(count_leaves(c) for c in nd[0])


def reroot(tree, target: str):
    """Re-root at the edge above the named tip (simple tip-outgroup root)."""
    # find path from root to the tip
    path = []

    def find(nd):
        path.append(nd)
        if not nd[0] and nd[2] == target:
            return True
        for c in nd[0]:
            if find(c):
                return True
        path.pop()
        return False

    if not find(tree) or len(path) < 2:
        return tree  # tip absent or already at root: keep as-is
    # split the tip's edge: the tip stays a LEAF child of the new root,
    # and the inverted ancestor chain becomes the sibling subtree
    tip = path[-1]
    half = tip[1] / 2.0
    tip[1] = half
    chain = list(reversed(path[:-1]))  # [parent_of_tip, ..., old root]
    chain[0][0] = [c for c in chain[0][0] if c is not tip]
    prev_len = half
    for i, nd in enumerate(chain):
        nd_old_len = nd[1]
        nd[1] = prev_len
        prev_len = nd_old_len
        if i + 1 < len(chain):
            parent = chain[i + 1]
            parent[0] = [c for c in parent[0] if c is not nd]
            nd[0].append(parent)
    return [[tip, chain[0]], 0.0, ""]


def _leaf_label(name, show, pattern):
    if not show or not name:
        return ""
    if pattern and not _re.search(pattern, name):
        return ""
    return name


def draw_rect(node, ax, x0, ycounter, show, pattern, flip=False):
    children, length, name = node
    x1 = x0 + length
    if not children:
        y = ycounter[0]
        ycounter[0] += 1
        ax.plot([x0, x1], [y, y], color="#333", lw=0.9)
        lab = _leaf_label(name, show, pattern)
        if lab:
            ax.text(x1, y, " " + lab, va="center", fontsize=6,
                    ha="right" if flip else "left")
        return y
    ys = [draw_rect(c, ax, x1, ycounter, show, pattern, flip) for c in children]
    y = sum(ys) / len(ys)
    ax.plot([x0, x1], [y, y], color="#333", lw=0.9)
    ax.plot([x1, x1], [min(ys), max(ys)], color="#333", lw=0.9)
    return y


def draw_circular(node, ax, show, pattern):
    """Circular (fan) layout: radial edges for every branch (leaves
    included), arcs connecting children."""
    n = count_leaves(node)
    counter = [0]

    def rec(nd, r0):
        children, length, name = nd
        r1 = r0 + length
        if not children:
            theta = 2 * math.pi * counter[0] / n
            counter[0] += 1
            ax.plot([theta, theta], [r0, r1], color="#333", lw=0.8)
            lab = _leaf_label(name, show, pattern)
            if lab:
                deg = math.degrees(theta)
                flip = 90 < deg % 360 < 270
                ax.text(theta, r1 * 1.03, lab, fontsize=5,
                        rotation=deg + 180 if flip else deg,
                        rotation_mode="anchor",
                        ha="right" if flip else "left", va="center")
            return theta
        thetas = [rec(c, r1) for c in children]
        th = sum(thetas) / len(thetas)
        tmin, tmax = min(thetas), max(thetas)
        arc_t = [tmin + (tmax - tmin) * k / 24 for k in range(25)]
        ax.plot(arc_t, [r1] * len(arc_t), color="#333", lw=0.8)
        ax.plot([th, th], [r0, r1], color="#333", lw=0.8)
        return th

    rec(node, 0.0)


def draw_unrooted(node, ax, show, pattern):
    """Equal-angle unrooted layout in cartesian coordinates: each subtree
    gets an angular wedge proportional to its leaf count."""

    def rec(nd, x0, y0, wedge_lo, wedge_hi):
        children, length, name = nd
        ang = (wedge_lo + wedge_hi) / 2.0
        x1 = x0 + length * math.cos(ang)
        y1 = y0 + length * math.sin(ang)
        ax.plot([x0, x1], [y0, y1], color="#333", lw=0.9)
        if not children:
            lab = _leaf_label(name, show, pattern)
            if lab:
                deg = math.degrees(ang)
                flip = 90 < deg % 360 < 270
                ax.text(x1, y1, " " + lab if not flip else lab + " ",
                        fontsize=5, rotation=deg + 180 if flip else deg,
                        rotation_mode="anchor",
                        ha="right" if flip else "left", va="center")
            return
        total = sum(count_leaves(c) for c in children)
        lo = wedge_lo
        for c in children:
            frac = count_leaves(c) / total
            hi = lo + (wedge_hi - wedge_lo) * frac
            rec(c, x1, y1, lo, hi)
            lo = hi

    children = node[0] or [node]
    total = sum(count_leaves(c) for c in children)
    lo = 0.0
    for c in children:
        hi = lo + 2 * math.pi * count_leaves(c) / total
        rec(c, 0.0, 0.0, lo, hi)
        lo = hi
    ax.set_aspect("equal")


def draw_rect_vertical(node, ax, xcounter, show, pattern, down=False):
    """Directional u/d layouts: distance on the y axis, tips along x."""
    children, length, name = node

    def rec(nd, y0):
        ch, ln, nm = nd
        y1 = y0 + ln
        if not ch:
            x = xcounter[0]
            xcounter[0] += 1
            ax.plot([x, x], [y0, y1], color="#333", lw=0.9)
            lab = _leaf_label(nm, show, pattern)
            if lab:
                ax.text(x, y1, " " + lab, va="bottom", ha="center",
                        fontsize=6, rotation=90)
            return x
        xs = [rec(c, y1) for c in ch]
        x = sum(xs) / len(xs)
        ax.plot([x, x], [y0, y1], color="#333", lw=0.9)
        ax.plot([min(xs), max(xs)], [y1, y1], color="#333", lw=0.9)
        return x

    rec(node, 0.0)
    if down:
        ax.invert_yaxis()


def build_parser(prog="jx treeplot") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description="Plot a phylogenetic tree")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("-i", "-nwk", "--newick", dest="input", type=str,
                   help=".nwk/.newick file")
    g.add_argument("-k", "--grm", type=str, help="GRM matrix (.npy/.txt): "
                   "NJ tree from 1 - K/mean(diag) distances")
    p.add_argument("-kid", "--grm-id", type=str, default=None,
                   help="GRM sample id file (default: <grm>.id)")
    p.add_argument("-layout", "--layout", choices=("r", "l", "u", "d", "c", "w"),
                   default="c", help="r/l/u/d directional, c circular, "
                                     "w unrooted radial (default c)")
    p.add_argument("-root", "--root", type=str, default=None,
                   help="re-root at this tip label (or 0-based tip index)")
    p.add_argument("-showlabels", "--showlabels", action="store_true",
                   help="show tip labels")
    p.add_argument("-regexlabels", "--regexlabels", type=str, default=None,
                   help="only show labels matching this regex")
    p.add_argument("-fmt", "--fmt", dest="format", type=str, default="png",
                   choices=("png", "pdf", "svg", "tif"),
                   help="figure output format (reference -fmt)")
    p.add_argument("-fontsize", "--fontsize", type=float, default=None,
                   help="tip-label font size")
    p.add_argument("--edge-width", dest="edge_width", type=float,
                   default=None, help="branch line width")
    p.add_argument("--node-size", dest="node_size", type=float, default=4.0,
                   help="tip-marker size when -meta assigns node colors")
    p.add_argument("--height", type=float, default=None,
                   help="figure height in inches")
    p.add_argument("-ratio", "--ratio", type=float, default=None,
                   help="figure width/height ratio")
    p.add_argument("--scale-bar", dest="scale_bar", action="store_true",
                   help="draw a branch-length scale bar (circular/unrooted "
                        "layouts; rect layouts already carry a distance "
                        "axis)")
    p.add_argument("--shrink", type=float, default=None,
                   help="extra margin fraction for long tip labels")
    p.add_argument("--hover", action="store_true",
                   help="accepted for reference compatibility (output here "
                        "is static matplotlib; no tooltip layer)")
    p.add_argument("-method", "--method", choices=("nj", "upgma"),
                   default="nj",
                   help="tree inference from GRM input (reference -method)")
    p.add_argument("--nj-backend", dest="nj_backend",
                   choices=("auto", "rust", "toytree"), default="auto",
                   help="reference backend selector, mapped here: "
                        "auto/rust -> RapidNJ pruned search at n>=1500, "
                        "toytree -> classic exact NJ")
    p.add_argument("-meta", "--meta", type=str, default=None,
                   help="sample meta table (csv/tsv: sample,label,"
                        "show_label,group,label_color,node_color,"
                        "node_size columns; any subset) for tip "
                        "coloring/relabeling (reference -meta)")
    common.add_out_args(p, default_prefix="tree")
    return p


def _apply_meta_colors(ax, meta) -> None:
    """Recolor/relabel already-drawn tip texts from the -meta table
    (columns: sample [,label, show_label, group, label_color])."""
    import matplotlib as mpl

    groups = None
    if "group" in meta.columns and "label_color" not in meta.columns:
        uniq = list(dict.fromkeys(meta["group"].astype(str)))
        cyc = mpl.rcParams["axes.prop_cycle"].by_key().get("color", ["k"])
        groups = {g: cyc[i % len(cyc)] for i, g in enumerate(uniq)}
    for txt in ax.texts:
        name = txt.get_text().strip()
        if name not in meta.index:
            continue
        row = meta.loc[name]
        if "show_label" in meta.columns and not bool(row["show_label"]):
            txt.set_visible(False)
            continue
        if "label" in meta.columns and str(row.get("label", "")) not in (
                "", "nan"):
            txt.set_text(" " + str(row["label"]))
        color = None
        if "label_color" in meta.columns:
            color = str(row["label_color"])
        elif groups is not None:
            color = groups.get(str(row.get("group")))
        if color and color != "nan":
            txt.set_color(color)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prefix = common.out_prefix(args)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    if args.grm:
        from janusx_tpu_torch.models.tree import neighbor_joining

        K = (np.load(args.grm) if args.grm.endswith(".npy")
             else np.loadtxt(args.grm))
        idp = args.grm_id or (args.grm.rsplit(".", 1)[0] + ".id")
        import os

        if os.path.exists(idp):
            with open(idp) as fh:
                labels = [l.split()[0] for l in fh if l.strip()]
            if len(labels) != K.shape[0]:
                raise SystemExit(
                    f"id sidecar {idp} has {len(labels)} ids but the GRM is "
                    f"{K.shape[0]}x{K.shape[1]} — stale sidecar would "
                    f"mislabel every tip"
                )
        else:
            labels = [f"s{i}" for i in range(K.shape[0])]
        D = 1.0 - K / max(float(np.mean(np.diag(K))), 1e-12)
        np.fill_diagonal(D, 0.0)
        D = np.clip((D + D.T) / 2, 0.0, None)
        if args.method == "upgma":
            from janusx_tpu_torch.models.tree import upgma

            tree = parse_newick(upgma(D, labels))
        elif (args.nj_backend in ("auto", "rust")
              and (K.shape[0] >= 1500 or args.nj_backend == "rust")):
            from janusx_tpu_torch.models.tree import rapid_neighbor_joining

            tree = parse_newick(rapid_neighbor_joining(D, labels))
        else:
            tree = parse_newick(neighbor_joining(D, labels))
    else:
        tree = parse_newick(open(args.input).read())

    if args.root is not None:
        target = args.root
        if target.isdigit():
            leaves = []

            def collect(nd):
                if not nd[0]:
                    leaves.append(nd[2])
                for c in nd[0]:
                    collect(c)

            collect(tree)
            idx = int(target)
            if 0 <= idx < len(leaves):
                target = leaves[idx]
        tree = reroot(tree, target)

    n = count_leaves(tree)
    show = args.showlabels
    if args.fontsize:
        plt.rcParams["font.size"] = float(args.fontsize)
    if args.edge_width:
        plt.rcParams["lines.linewidth"] = float(args.edge_width)
    meta = None
    if args.meta:
        import pandas as pd

        sep = "," if args.meta.endswith(".csv") else "\t"
        mdf = pd.read_csv(args.meta, sep=sep)
        if "sample" not in mdf.columns:
            raise SystemExit("-meta needs a 'sample' column")
        meta = mdf.set_index(mdf["sample"].astype(str))
    def _size(w, h):
        if args.height:
            h = float(args.height)
            w = h * (args.ratio or (w / h if h else 1.0))
        elif args.ratio:
            w = h * float(args.ratio)
        return (w, h)

    if args.layout == "c":
        fig = plt.figure(figsize=_size(7, 7))
        ax = fig.add_subplot(projection="polar")
        draw_circular(tree, ax, show, args.regexlabels)
        ax.set_xticks([])
        ax.set_yticks([])
        ax.spines["polar"].set_visible(False)
    elif args.layout == "w":
        fig, ax = plt.subplots(figsize=_size(7, 7))
        draw_unrooted(tree, ax, show, args.regexlabels)
        ax.set_xticks([])
        ax.set_yticks([])
        ax.axis("off")
    elif args.layout in ("u", "d"):
        fig, ax = plt.subplots(figsize=_size(max(2, n * 0.14), 6))
        draw_rect_vertical(tree, ax, [0], show, args.regexlabels,
                           down=args.layout == "d")
        ax.set_xticks([])
        ax.spines[["top", "right", "bottom"]].set_visible(False)
        ax.set_ylabel("distance")
    else:
        fig, ax = plt.subplots(figsize=_size(6, max(2, n * 0.14)))
        draw_rect(tree, ax, 0.0, [0], show, args.regexlabels,
                  flip=args.layout == "l")
        if args.layout == "l":
            ax.invert_xaxis()
        ax.set_yticks([])
        ax.spines[["top", "right", "left"]].set_visible(False)
        ax.set_xlabel("distance")
    if args.shrink:
        for side in ("x", "y"):
            getattr(ax, f"set_{side}margin")(float(args.shrink))
    if args.scale_bar and args.layout in ("c", "w"):
        from matplotlib.lines import Line2D

        span = 0.1 * max(
            (abs(x) for x in ax.get_xlim() + ax.get_ylim()), default=1.0)
        ax.add_line(Line2D([0.05, 0.2], [0.02, 0.02],
                           transform=ax.transAxes, color="black", lw=1.2))
        ax.text(0.125, 0.035, f"{span:.3g}", transform=ax.transAxes,
                ha="center", fontsize=7)
    if meta is not None:
        _apply_meta_colors(ax, meta)
    fig.tight_layout()
    out = f"{prefix}.tree.{args.format}"
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(out)
    return 0
