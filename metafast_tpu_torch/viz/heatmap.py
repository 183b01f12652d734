"""UPGMA clustering + heatmap/dendrogram rendering.

Parity: src/algo/FullHeatMap.java — O(n^3) greedy average-linkage
clustering (clusterObjects :221-296, distanceBetweenGroups :297-308) with
leaf order from the in-order traversal (renumber :323-333); rendering is
re-done with matplotlib (PNG + SVG) instead of AWT/Batik.
"""

from __future__ import annotations

import numpy as np


class _Node:
    __slots__ = ("no", "left", "right", "distance", "leafs")

    def __init__(self, no=-1, left=None, right=None, distance=0.0):
        self.no = no
        self.left = left
        self.right = right
        self.distance = distance
        self.leafs = 1 if no >= 0 else left.leafs + right.leafs


def upgma_tree(dist: np.ndarray) -> _Node:
    """Greedy average-linkage agglomeration, ties broken like the
    reference (first (i, j) in row-major scan order)."""
    n = len(dist)
    nodes: list[_Node | None] = [_Node(no=i) for i in range(n)]
    d = np.asarray(dist, dtype=np.float64).copy()
    groups = [[i] for i in range(n)]
    count = n
    root = nodes[0] if n else None
    while count > 1:
        best = (np.inf, -1, -1)
        for i in range(n):
            if nodes[i] is None:
                continue
            for j in range(i + 1, n):
                if nodes[j] is not None and d[i, j] < best[0]:
                    best = (d[i, j], i, j)
        mind, i, j = best
        root = _Node(left=nodes[i], right=nodes[j], distance=mind)
        nodes[i], nodes[j] = root, None
        groups[i] = groups[i] + groups[j]
        groups[j] = []
        g1 = groups[i]
        for ii in range(n):
            d[ii, j] = d[j, ii] = -1
            if ii != i and nodes[ii] is not None:
                g2 = groups[ii]
                v = float(np.mean(dist[np.ix_(g1, g2)]))
                d[ii, i] = d[i, ii] = v
        count -= 1
    return root


def _leaves(node: _Node, out: list[int]) -> None:
    if node is None:
        return
    if node.no >= 0:
        out.append(node.no)
        return
    _leaves(node.left, out)
    _leaves(node.right, out)


def upgma_order(dist: np.ndarray) -> list[int]:
    """Permutation of sample indices in dendrogram leaf order."""
    if len(dist) == 0:
        return []
    if len(dist) == 1:
        return [0]
    out: list[int] = []
    _leaves(upgma_tree(dist), out)
    return out


def _dendrogram_segments(node: _Node, y_of: dict[int, float], x_scale: float):
    """Line segments ((x0, y0), (x1, y1)) of the left-side dendrogram;
    x = 0 at leaves, growing with merge distance."""
    segs = []

    def rec(nd):
        if nd.no >= 0:
            return 0.0, y_of[nd.no]
        xl, yl = rec(nd.left)
        xr, yr = rec(nd.right)
        x = nd.distance * x_scale
        segs.append(((xl, yl), (x, yl)))
        segs.append(((xr, yr), (x, yr)))
        segs.append(((x, yl), (x, yr)))
        return x, (yl + yr) / 2.0

    rec(node)
    return segs


def render_heatmap(dist: np.ndarray, names: list[str], png_path: str,
                   svg_path: str | None = None, renumber: bool = True,
                   invert_colors: bool = False,
                   colors: list[str] | None = None,
                   fmt: str = "%.4f") -> list[int]:
    """Write heatmap + dendrogram PNG (and SVG); returns the permutation."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(names)
    perm = upgma_order(dist) if (renumber and n > 1) else list(range(n))
    d = np.asarray(dist, dtype=np.float64)[np.ix_(perm, perm)]

    fig_w = max(6.0, 2.5 + 0.6 * n)
    fig_h = max(4.5, 1.5 + 0.6 * n)
    fig, (ax_d, ax_h) = plt.subplots(
        1, 2, figsize=(fig_w, fig_h),
        gridspec_kw={"width_ratios": [1, 3], "wspace": 0.02})

    cmap = "viridis_r" if invert_colors else "viridis"
    im = ax_h.imshow(d, cmap=cmap, vmin=0.0,
                     vmax=max(1e-12, float(d.max())), aspect="auto")
    ax_h.set_xticks(range(n))
    ax_h.set_yticks(range(n))
    labels = [names[p] for p in perm]
    ax_h.set_xticklabels(labels, rotation=90, fontsize=8)
    ax_h.set_yticklabels([])
    ax_h.yaxis.set_ticks_position("right")
    for i in range(n):
        for j in range(n):
            val = fmt % d[i, j]
            ax_h.text(j, i, val, ha="center", va="center", fontsize=7,
                      color="white" if d[i, j] > d.max() * 0.5 else "black")
    fig.colorbar(im, ax=ax_h, fraction=0.04, pad=0.12)

    ax_d.set_axis_off()
    if n > 1:
        tree = upgma_tree(np.asarray(dist, dtype=np.float64))
        pos_in_perm = {s: i for i, s in enumerate(perm)}
        y_of = {s: pos_in_perm[s] for s in range(n)}
        segs = _dendrogram_segments(tree, y_of, 1.0)
        for (x0, y0), (x1, y1) in segs:
            ax_d.plot([-x0, -x1], [y0, y1], color="black", lw=1.0)
        ax_d.set_ylim(ax_h.get_ylim())
        tick_colors = colors or ["#000000"] * n
        for i, s in enumerate(perm):
            ax_d.text(0.0, i, " " + names[s], fontsize=8, va="center",
                      ha="left", color=tick_colors[s])

    fig.savefig(png_path, dpi=120, bbox_inches="tight")
    if svg_path:
        fig.savefig(svg_path, bbox_inches="tight")
    plt.close(fig)
    return perm
