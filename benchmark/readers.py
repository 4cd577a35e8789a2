"""Arithmetic that the metric readers (metrics/<name>.py) share. Each
returns None where the run has nothing to read: a cell of the other
kind (k = 1 against k > 1), or a run without a trace."""
from __future__ import annotations

from typing import Optional


def _fits(rec, matmat: bool) -> bool:
    return (rec.k > 1) == matmat and rec.iters > 0


def per_call_ms(rec, matmat: bool) -> Optional[float]:
    """The window's host-clock time over the calls it completed."""
    return rec.window_s * 1e3 / rec.iters if _fits(rec, matmat) else None


def _traced(rec, matmat: bool):
    tl = rec.timeline
    if not _fits(rec, matmat) or tl is None or not len(tl.calls):
        return None
    return tl


def glue_us(rec, matmat: bool) -> Optional[float]:
    """Host time inside the calls of the untraced window, per call."""
    return rec.glue_s * 1e6 / rec.iters if _fits(rec, matmat) else None


def roofline_pct(rec, matmat: bool) -> Optional[float]:
    """floor.py's least time of a call over the device time of the
    operations the call spans launched, per call, in %."""
    tl = _traced(rec, matmat)
    if tl is None or tl.call_device_s() <= 0:
        return None
    return 100 * rec.floor_ms / 1e3 / (tl.call_device_s() / len(tl.calls))


def idle_pct(rec, matmat: bool) -> Optional[float]:
    """The share of the window in which no device operation ran, in %."""
    tl = _traced(rec, matmat)
    if tl is None:
        return None
    busy = tl.busy()[1]
    return None if busy <= 0 else 100 * (1 - busy / tl.window_s())
