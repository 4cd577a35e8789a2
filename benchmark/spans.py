"""What the program's own spans and counters say in a run: the readers
of the operator-glue metrics (the `tsp.*` spans of
tilespmv_tpu_torch/spans.py in a traced run's timeline) and of the
planner's phases (the program's `plan_phases()` table).

Each returns None where there is nothing to read: a cell of the other
kind (k > 1), a run without a trace, a program without the spans (no
`tsp.forward` span in the window) or without the table (no
tilespmv_tpu_torch.spans module). Only the plan readers import the
program, and only when called.
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np

FORWARD = "tsp.forward"
# host runtime calls that can wait for the card: synchronizations, the
# synchronous copies, and allocation and release of device memory
WAITS = re.compile(
    r"^(cudaStreamSynchronize|cudaDeviceSynchronize|cudaEventSynchronize"
    r"|cudaMemcpy|cudaMalloc|cudaFree|cuStreamSynchronize|cuCtxSynchronize"
    r"|cuEventSynchronize|cuMemcpy(HtoD|DtoH|DtoD)?|cuMemAlloc|cuMemFree)"
    r"(_v\d+)?(_pt(sz|ds))?$")
# host runtime calls that put work on the card
LAUNCHES = re.compile(
    r"^(cudaLaunchKernel(ExC)?|cuLaunchKernel(Ex)?|cudaMemcpyAsync"
    r"|cudaMemsetAsync)(_v\d+)?(_pt(sz|ds))?$")


def _mask(tl, match) -> np.ndarray:
    """Host events of the window whose name `match` accepts."""
    hit = {n: bool(match(n)) for n in set(tl.host_name)}
    w0, w1 = tl.window
    start = tl.host[:, 0]
    named = np.fromiter((hit[n] for n in tl.host_name), bool,
                        len(tl.host_name))
    return named & (start >= w0) & (start <= w1)


def _merged(iv: np.ndarray) -> np.ndarray:
    """The union of intervals (k, 2), as sorted disjoint intervals."""
    out = []
    for a, b in iv[np.argsort(iv[:, 0], kind="stable")].tolist():
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def _traced(rec):
    """The run's timeline where its SpMV calls carry the program's
    spans, else None."""
    tl = rec.timeline
    if rec.k != 1 or rec.iters <= 0 or tl is None or not len(tl.calls):
        return None
    if not _mask(tl, FORWARD.__eq__).any():
        return None
    return tl


def span_us(rec, prefix: str) -> Optional[float]:
    """Host microseconds covered by the window's spans named `prefix`
    (or starting with it, for a prefix ending in "."), per call."""
    tl = _traced(rec)
    if tl is None:
        return None
    match = (prefix.__eq__ if not prefix.endswith(".")
             else lambda n: n.startswith(prefix))
    iv = _merged(tl.host[_mask(tl, match)])
    return float((iv[:, 1] - iv[:, 0]).sum()) / 1e3 / len(tl.calls)


def count_in_calls(rec, names: re.Pattern) -> Optional[float]:
    """The window's host events named as `names` that begin inside a
    `tsp.forward` span, per call."""
    tl = _traced(rec)
    if tl is None:
        return None
    fwd = _merged(tl.host[_mask(tl, FORWARD.__eq__)])
    t = tl.host[_mask(tl, names.match), 0]
    j = np.searchsorted(fwd[:, 0], t, side="right") - 1
    inside = (j >= 0) & (t <= fwd[np.maximum(j, 0), 1])
    return int(inside.sum()) / len(tl.calls)


def plan_phase(name: str) -> Optional[float]:
    """Seconds of the planner's phase `name` in the program's table (the
    process built one operator), or None without one."""
    try:
        from tilespmv_tpu_torch import spans
    except ImportError:
        return None
    return spans.plan_phases().get(name)
