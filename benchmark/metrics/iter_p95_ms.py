"""iter_p95_ms: the 95th percentile, over every iteration of the
window, of one iteration's time (call, update, check), from the host
clock read at each iteration's start. Only loops that read the check to
the host every iteration have it: each iteration then ends when the
card has finished its work."""
import numpy as np


def read(rec):
    if rec.iter_ms is None or not len(rec.iter_ms):
        return None
    return float(np.percentile(rec.iter_ms, 95))
