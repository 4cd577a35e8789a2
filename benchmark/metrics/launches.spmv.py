"""launches.spmv: host runtime calls that put work on the card (kernel
launches, asynchronous copies and fills) begun inside the program's
`tsp.forward` spans of the traced window, per SpMV call."""
from benchmark import spans


def read(rec):
    return spans.count_in_calls(rec, spans.LAUNCHES)
