"""prep_us.spmv: host microseconds inside the program's `tsp.prep` spans
(x cast, checked and padded, the device plan, y zeroed) in the traced
window, per SpMV call."""
from benchmark import spans


def read(rec):
    return spans.span_us(rec, "tsp.prep")
