"""device_idle.spmm: the share of the traced window in which no device
operation ran, in %."""
from benchmark import readers


def read(rec):
    return readers.idle_pct(rec, matmat=True)
