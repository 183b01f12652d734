"""features.select_s: mean seconds a job spends loading the selected k-mers
and restricting each component to them (the program's `features.select`
span), inside its features-calculator step."""

from portbench.harness.named_spans import named_span_mean


def read(rec):
    return named_span_mean(rec, "features.select", "features-calculator")
