"""finish_us.spmv: host microseconds inside the program's `tsp.finish`
spans (the residual and y's cast) in the traced window, per SpMV
call."""
from benchmark import spans


def read(rec):
    return spans.span_us(rec, "tsp.finish")
