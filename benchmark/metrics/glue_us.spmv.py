"""glue_us.spmv: host microseconds inside each SpMV call of the
untraced window (the operator's glue and its launches), per call, from
the host clock read before and after each call."""
from benchmark import readers


def read(rec):
    return readers.glue_us(rec, matmat=False)
