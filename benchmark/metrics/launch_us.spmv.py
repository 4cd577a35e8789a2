"""launch_us.spmv: host microseconds inside the program's
`tsp.launch.<class>` spans (each class's wrapper checks, the library
load and the launch) in the traced window, per SpMV call."""
from benchmark import spans


def read(rec):
    return spans.span_us(rec, "tsp.launch.")
