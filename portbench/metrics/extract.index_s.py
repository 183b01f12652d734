"""extract.index_s: mean seconds a job spends building the pivot graph's
neighbour index (the program's `pivot.index` span, graph/pivot), inside
its component-extractor step."""

from portbench.harness.named_spans import named_span_mean


def read(rec):
    return named_span_mean(rec, "pivot.index", "component-extractor")
