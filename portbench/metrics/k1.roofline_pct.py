"""k1.roofline_pct: the extraction kernel K1 (csrc/stream_extract.cu)
against its memory bound, in percent: the least time its launches could
take (the bytes each must move, from its shapes, over 3.35 TB/s) over
their device time in the profiler's trace.  Nothing when the trace holds
no K1 launch, or not one for each launch the harness recorded."""

from portbench.harness import roofline


def read(rec):
    t = rec.trace
    if t is None or t.k1_launches == 0 or t.k1_launches != len(rec.k1_words):
        return None
    need = sum(roofline.bound_s(roofline.k1_bytes(n, layout))
               for n, layout in rec.k1_words)
    return 100.0 * need / t.k1_device_s
