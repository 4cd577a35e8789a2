"""One run of one cell: set-up, the measured window, the check.

Set-up makes the cell's matrix on the device from the seed
(generators/<name>.py), hands one host copy of it to the program
(`TileSpMV(csr, dtype=...)` converts, plans and uploads it) and warms
the loop. The window then drives the traffic's loop (traffic/<name>.json)
for the given seconds. Each iteration computes y = op(x) (op.matmat(X)
for k > 1), steps x <- x0 + c*y with c = 0.85 / ||A||_inf (PageRank's
damped step), reads ||x_new - x||_1 to the host every `check_every`
iterations, as a solver's stopping test does, and restarts from the
next seeded x0 every `solve_len` iterations. A seeded reservoir keeps
`samples` of the window's calls, (x, y) pairs drawn uniformly; once the
window has closed and the program's operator is freed, reference.py
computes each y again and `check` holds the largest gap to its limit.
The host's clock stamps each iteration's start and each call's return:
every loop that has iteration times reads its check to the host every
iteration, so the card is idle at each start. A traced run first runs
an untraced window (the glue's host time), then a shorter one under
torch.profiler. Every metric is read from the run's Record by
metrics/<name>.py.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import random
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import floor, reference
from .timeline import CALL, WINDOW, Timeline

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}
# top-level modules that no run may have loaded by its end
FORBIDDEN = ("jax", "jaxlib", "flax", "tilespmv_tpu")
DAMPING = 0.85
# seeded x0 vectors a loop restarts from, in turn
X0_POOL = 8
# iterations a traced run makes under the profiler before its window
TRACE_WARM = 3
# the longest windows of a traced run, untraced then traced (its trace is
# read in memory)
TRACE_SECONDS = 10.0


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def plugin(kind: str, name: str):
    """The module <kind>/<name>.py of the benchmark (a generator or a
    metric's reader), loaded from its file."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(workload: str, man: dict) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the cell named `workload`."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in man["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def cell_metrics(man: dict, workload: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") that the cell
    reports: an end-to-end metric wherever its `workloads` name the cell
    or it has none; a per-layer one where its `workloads` name the cell
    or, without them, wherever the end-to-end metric it moves is."""
    def e2e(m):
        return workload in m.get("workloads", [workload])
    if kind == "end_to_end":
        return [m for m in man["end_to_end"] if e2e(m)]
    moves = {m["name"]: e2e(m) for m in man["end_to_end"]}
    return [m for m in man["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else moves[m["moves"]])]


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN,
    compared whole (tilespmv_tpu_torch is not tilespmv_tpu)."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def derive_seed(*parts: int) -> int:
    """A 64-bit seed from the run's seed and a purpose."""
    ss = np.random.SeedSequence([p % 2 ** 64 for p in parts])
    return int(ss.generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class Record:
    """What a run measured; metrics/<name>.py read it."""
    k: int
    setup_s: float
    plan_s: float
    iters: int                # calls in the untraced window
    window_s: float           # host clock: first call to the closing sync
    glue_s: float             # host clock: the window's time inside calls
    iter_ms: Optional[np.ndarray]   # each iteration's time, or None
    floor_ms: float           # floor.py's least time of one call
    timeline: Optional[Timeline]    # traced runs


@dataclasses.dataclass
class Loop:
    """One traffic mix's loop over the operator."""
    call: Callable
    x0s: list
    c: float
    check_every: int
    solve_len: int
    size: int                 # the reservoir's samples
    samples: list = dataclasses.field(default_factory=list)
    rng: random.Random = dataclasses.field(default_factory=random.Random)
    count: int = 0            # calls offered to the reservoir
    nonfinite: int = 0        # checks whose norm was not finite

    def reset(self, seed: int) -> None:
        self.samples = [None] * self.size
        self.rng = random.Random(seed)
        self.count = self.nonfinite = 0

    def offer(self) -> Optional[int]:
        """The reservoir slot the next call goes to, or None (algorithm R:
        every call since the reset is kept with the same chance)."""
        i = self.count
        self.count += 1
        if i < self.size:
            return i
        j = int(self.rng.random() * (i + 1))
        return j if j < self.size else None


class Bench:
    """A configuration's matrix, made from the seed, and the program's
    operator over it, in the configuration's dtype or `dtype` (the
    control's lower precision)."""

    def __init__(self, config: dict, seed: int, device="cuda",
                 dtype: Optional[str] = None):
        from tilespmv_tpu_torch import CSRMatrix, TileSpMV
        self.device = torch.device(device)
        self.dtype = DTYPES[config["dtype"]]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive_seed(seed, 0))
        m, n, indptr, indices, data = plugin(
            "generators", config["generator"]).generate(
                config, gen, self.device, self.dtype)
        rows = torch.repeat_interleave(
            torch.arange(m, device=self.device), indptr.diff())
        norm = float(torch.zeros(m, dtype=torch.float64, device=self.device)
                     .index_add_(0, rows, data.abs().double()).max())
        self.c = DAMPING / norm if norm > 0 else 0.0
        # the reference's arrays; the program gets copies of its own
        self.indptr = indptr.cpu().numpy()
        self.indices = indices.cpu().numpy()
        self.data = data.cpu().numpy()
        self.shape = (m, n)
        del rows, indptr, indices, data
        self.sync()
        if self.device.type == "cuda":
            # generation's temporaries are the benchmark's, not the
            # program's: the peak is the program's from here on
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        csr = CSRMatrix(self.shape, self.indptr.copy(), self.indices.copy(),
                        self.data.copy())
        t = time.perf_counter()
        self.op = TileSpMV(csr, device=self.device,
                           dtype=DTYPES[dtype or config["dtype"]])
        self.sync()
        self.plan_s = time.perf_counter() - t

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def loop(self, traffic: dict, seed: int) -> Loop:
        """The traffic's loop, its x0 pool drawn from the seed."""
        k = traffic["k"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive_seed(seed, 1, k))
        shape = (self.shape[1],) if k == 1 else (self.shape[1], k)
        x0s = [(torch.rand(shape, generator=gen, device=self.device,
                           dtype=torch.float64) * 2 - 1).to(self.dtype)
               for _ in range(X0_POOL)]
        lp = Loop(self.op if k == 1 else self.op.matmat, x0s, self.c,
                  traffic["check_every"], traffic["solve_len"],
                  traffic["samples"])
        lp.reset(derive_seed(seed, 2, k))
        return lp

    def iterate(self, lp: Loop, seconds: float = math.inf,
                iters: Optional[int] = None, marks: Optional[list] = None,
                spans: bool = False) -> tuple[int, float, float]:
        """Runs lp's iterations, from x0s[0], until `seconds` have passed
        on the host clock or `iters` are done (at least one), and
        synchronizes; returns (iterations, seconds, seconds inside the
        calls). `marks` gets the host clock at each iteration's start and
        at the end of the last."""
        call, c, every, solve_len = lp.call, lp.c, lp.check_every, lp.solve_len
        x0s, offer, samples = lp.x0s, lp.offer, lp.samples
        clock = time.perf_counter
        solve = i = 0
        glue = 0.0
        x0 = x = x0s[0]
        t0 = clock()
        stop = t0 + seconds
        while True:
            t = clock()
            if marks is not None:
                marks.append(t)
            if spans:
                with torch.profiler.record_function(CALL):
                    y = call(x)
            else:
                y = call(x)
            glue += clock() - t
            slot = offer()
            if slot is not None:
                samples[slot] = (x, y.clone())
            x_new = torch.add(x0, y, alpha=c)
            i += 1
            if i % every == 0:
                change = torch.linalg.vector_norm(x_new - x, 1).item()
                if not math.isfinite(change):
                    lp.nonfinite += 1
            x = x_new
            if i % solve_len == 0:
                solve += 1
                x0 = x = x0s[solve % len(x0s)]
            if i == iters or clock() >= stop:
                break
        if marks is not None:
            marks.append(clock())
        self.sync()
        return i, clock() - t0, glue

    def warm(self, lp: Loop) -> None:
        """Runs every path of the loop: calls, checks, restarts, the
        reservoir's copies."""
        n = max(2 * lp.solve_len, 2 * lp.check_every) + lp.size
        for _ in range(2):
            self.iterate(lp, iters=n)

    def free(self) -> None:
        """Drops the program's operator and its cached memory."""
        self.op = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def gaps(self, samples: list) -> list:
        """reference.gap of each (x, y) sample against the reference."""
        out = []
        for x, y in samples:
            want, scale = reference.product(self.indptr, self.indices,
                                            self.data, x)
            out.append(reference.gap(y, want, scale))
        return out


def run_cell(man: dict, cell: dict, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device="cuda",
             t0: Optional[float] = None,
             dtype: Optional[str] = None) -> tuple[dict, list]:
    """One run of `cell`: (the result line's object, the lines that
    name each number compared beside its limit). `t0`: the host clock at
    the process's start (set-up is timed from it). `dtype`: the
    program's dtype in place of the configuration's (the control)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = Bench(config, seed, device, dtype)
    lp = bench.loop(traffic, seed)
    bench.warm(lp)
    lp.reset(derive_seed(seed, 2, traffic["k"]))
    # iteration times where each iteration ends in a read to the host
    marks = [] if lp.check_every == 1 else None
    setup_s = time.perf_counter() - t0
    iters, window_s, glue_s = bench.iterate(
        lp, min(seconds, TRACE_SECONDS) if trace else seconds, marks=marks)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if bench.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        bench.iterate(lp, iters=TRACE_WARM)
        with torch.profiler.record_function(WINDOW):
            bench.iterate(lp, min(seconds, TRACE_SECONDS), spans=True)
        prof.stop()
    cuda = bench.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(bench.device) if cuda else 0
    iter_ms = None if marks is None else np.diff(marks) * 1e3
    samples = [(x.double().cpu().numpy(), y.double().cpu().numpy())
               for x, y in (s for s in lp.samples if s is not None)]
    nonfinite, attempted = lp.nonfinite, lp.count
    lp = marks = None
    bench.free()
    timeline = Timeline.from_profile(prof) if trace else None
    prof = None

    t = time.perf_counter()
    gaps = bench.gaps(samples)
    limit = config["limits"]["y_err"]
    y_err = max(gaps) if gaps else math.inf
    failed = sum(1 for g in gaps if not g <= limit)
    correct = bool(gaps) and failed == 0 and nonfinite == 0
    ref_s = time.perf_counter() - t

    k = traffic["k"]
    rec = Record(k=k, setup_s=setup_s, plan_s=bench.plan_s, iters=iters,
                 window_s=window_s, glue_s=glue_s, iter_ms=iter_ms,
                 floor_ms=floor.floor_ms(bench.nnz, *bench.shape, k,
                                         config["dtype"])["ms"],
                 timeline=timeline)
    metrics = {}
    for m in cell_metrics(man, cell["name"],
                          "per_layer" if trace else "end_to_end"):
        value = plugin("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(bench.device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted,
              "failed": failed + nonfinite, "metrics": metrics,
              "device": dev}
    if timeline is not None:
        dev["busy_s"] = timeline.busy()[1]
        dev["window_s"] = timeline.window_s()
        result["breakdown"] = {"device_ops": timeline.top_device_ops(),
                               "idle_gaps": timeline.idle_gaps()}
    result["check"] = {"y_err": {"value": y_err, "limit": limit},
                       "nonfinite": {"value": nonfinite, "limit": 0}}
    lines = [f"reference: {len(samples)} calls compared in {ref_s:.3f} s",
             f"check y_err {y_err!r} limit {limit!r}",
             f"check nonfinite {nonfinite} limit 0"]
    return result, lines
