from .heatmap import upgma_order, render_heatmap  # noqa: F401
