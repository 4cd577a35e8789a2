"""spmv_roofline: floor.py's least time of one SpMV call over the device
time of the operations launched inside the call's span (the class
kernels, fills and casts; not the benchmark's update and check), in %."""
from benchmark import readers


def read(rec):
    return readers.roofline_pct(rec, matmat=False)
