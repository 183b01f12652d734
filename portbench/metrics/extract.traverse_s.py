"""extract.traverse_s: mean seconds a job spends traversing the graph from
the pivots and collecting the components (the program's `pivot.traverse`
span, graph/pivot), inside its component-extractor step."""

from portbench.harness.named_spans import named_span_mean


def read(rec):
    return named_span_mean(rec, "pivot.traverse", "component-extractor")
