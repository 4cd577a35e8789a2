"""Program spans and the planner's phase times.

`span(name)` marks a piece of a call (`tsp.forward`, `tsp.prep`,
`tsp.launch.<class>`, ...) as a profiler span, so it lands in the
profiler's trace on the same clock as the card's activity
(`utils.profiling.trace_context` writes it out). While no profiler
records, it returns one shared no-op context: entering a
`record_function` costs microseconds even then, and a call passes
about ten spans. While one records, the span is torch's C++
`_RecordFunctionFast` (a CPU op in the trace), where this torch has it,
else a `record_function`: under the profiler a `record_function` took
8-9 us on an H100 machine's host CPU, and the spans' own cost then fell
between them, outside any span and in the card's idle time.

`phase(name)` times a piece of the operator's set-up (`plan.convert`,
`plan.classes`, `plan.stream`, `plan.census`, `plan.upload`) on the
host clock, always, into a table that `plan_phases()` reads and
`reset_plan_phases()` clears, and marks it as a span as well. A phase
entered inside another counts its seconds once, as its own: the outer
phase keeps only the time outside it. So the phases sum to the time
spent inside any of them, and they add up across operators (column
parts, `.T`) until the table is cleared.

`plan_census()` is the shape of the plan of the operator built last,
by class kind: its chunks, nonzeros, value slots and the bytes its
kernels stream, from the plan's summary (`record_plan`).

Imports nothing of the package, which every layer of it imports.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# the operator's set-up, in the order it runs: tile_create, the plan's
# classes (the lane plan's routing and packing, or the xla plan), the
# stream classes' geometry and packing, the plan's summary (its classes'
# nonzeros counted), the buffers' upload
PLAN_PHASES = ("plan.convert", "plan.classes", "plan.stream", "plan.census",
               "plan.upload")
_PLAN = dict.fromkeys(PLAN_PHASES, 0.0)
# one entry per open phase: the seconds of the phases nested in it
_OPEN: list = []


class _Off:
    """What span() gives while no profiler records: a context whose
    __enter__ and __exit__ are one C function that takes any arguments
    and returns "" (false, so an exception passes through). Python
    methods there took about twice as long on an H100 machine's host."""
    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()
_RECORD = getattr(torch._C._profiler, "_RecordFunctionFast",
                  torch.profiler.record_function)


def span(name: str):
    """A span named `name` while a profiler records, else a shared no-op
    context (a flag read)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _RECORD(name)


@contextlib.contextmanager
def phase(name: str):
    """Adds the block's host seconds, less those of the phases nested in
    it, to `name` in the table; also a span of that name."""
    _OPEN.append(0.0)
    t = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        dt = time.perf_counter() - t
        _PLAN[name] = _PLAN.get(name, 0.0) + dt - _OPEN.pop()
        if _OPEN:
            _OPEN[-1] += dt


def plan_phases() -> dict:
    """{phase: seconds} since the last reset, every PLAN_PHASES entry
    included (0.0 where it did not run)."""
    return dict(_PLAN)


def reset_plan_phases() -> None:
    _PLAN.clear()
    _PLAN.update(dict.fromkeys(PLAN_PHASES, 0.0))


_STATE_BUILDS = 0


def state_built() -> None:
    """Counts one call state built."""
    global _STATE_BUILDS
    _STATE_BUILDS += 1


def state_builds() -> int:
    """Call states built since the process started or the last reset."""
    return _STATE_BUILDS


def reset_state_builds() -> None:
    global _STATE_BUILDS
    _STATE_BUILDS = 0


# the plan summary of the operator built last (record_plan), or None
_PLAN_SUMMARY = None


def record_plan(summary: dict) -> None:
    """Keeps `summary` (a plan's `summary()`, or a column-partitioned
    operator's, whose classes are its parts') as the summary of the
    operator built last."""
    global _PLAN_SUMMARY
    _PLAN_SUMMARY = summary


def plan_census():
    """The plan of the operator built last, by class kind, or None before
    the first and for an xla plan (whose engines hold no such counts):
    for each kind (`dense`, `band`, `w{W}`, `stream`, `stream2`,
    `residual`), "chunks" (chunks of a dense, band or W-class, slabs of
    a stream class, entries of the residual), "nnz" (values that are not
    zero), "slots" (value slots, padding included) and "bytes" (what
    its kernels stream a call), summed over the classes of that kind,
    over a column-partitioned operator's parts too. Read from the
    summary the plan gave when it was built; nothing is counted here."""
    s = _PLAN_SUMMARY
    if s is None or "classes" not in s:
        return None
    out = {}
    for c in s["classes"]:
        o = out.setdefault(c["kind"], dict(chunks=0, nnz=0, slots=0,
                                           bytes=0))
        o["chunks"] += c.get("chunks", c.get("slabs", 0))
        for key in ("nnz", "slots", "bytes"):
            o[key] += c[key]
    r = s["residual_nnz"]
    out["residual"] = dict(chunks=r, nnz=r, slots=r,
                           bytes=s["residual_bytes"])
    return out
