"""spmm_ms: the window's host-clock time, ending in a synchronize, over
the matmat(X) iterations it completed (cells with k > 1)."""
from benchmark import readers


def read(rec):
    return readers.per_call_ms(rec, matmat=True)
