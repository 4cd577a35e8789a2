"""call_waits.spmv: host runtime calls that can wait for the card
(synchronizations, synchronous copies, device allocation and release)
begun inside the program's `tsp.forward` spans of the traced window,
per SpMV call."""
from benchmark import spans


def read(rec):
    return spans.count_in_calls(rec, spans.WAITS)
