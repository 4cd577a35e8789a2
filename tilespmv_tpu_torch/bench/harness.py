"""Benchmark harness.

Port of tilespmv_tpu/bench/harness.py. Measures steady-state SpMV time
the way the reference does, warmup iterations followed by timed ones
(reference tilespmv_cuda.h:1058-1139, WARMUP_NUM=200 / BENCH_REPEAT=1000).
On the card a repetition is the replay of one CUDA graph holding
`iters_per_rep` calls of `op(x)`, timed by CUDA events: the device's
time with no host dispatch between calls, the counterpart of the
reference's on-device `lax.fori_loop` (whose result-dependent
perturbation of x, there to keep XLA from hoisting the call, a graph
does not need). Beside it, `eager_ms` is the time of the same calls
issued one by one from the host, what a Python solver loop pays.

Reported metrics (reference parity + roofline): ms per SpMV, GFLOPS =
2*nnz/t (tilespmv_cuda.h:1138), Gnnz/s, GB/s over the bytes the plan's
classes must move (utils/profiling.py::class_bound: each class's
nonzeros as CSR, a band class without a column per entry, the residual
as CSR, with x and y; not the plan's own byte count, which includes
arrays no card kernel reads), and the share of the card's HBM peak
that is.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from ..ops.spmv import TileSpMV
from ..utils import profiling
from . import roofline


@dataclasses.dataclass
class BenchResult:
    name: str
    m: int
    n: int
    nnz: int
    ms: float
    gflops: float
    gnnz_per_s: float
    gbytes_per_s: float
    roofline_frac: float
    chip: str
    backend: str
    iters: int
    # measurement quality: False when the rep spread exceeded max_spread
    # or the implied GFLOPS exceeds the card's physical compute peak.
    # Unreliable rows must NOT enter results.csv.
    reliable: bool = True
    spread: float = 0.0   # (p84 - p16) / median of the timed reps
    # ms per call issued from the host one by one (CUDA events on the
    # card); on the CPU the same loop as `ms`
    eager_ms: float = math.nan

    def csv_row(self) -> str:
        """Reference results.csv schema: filename,m,n,nnz,ms,gflops
        (tilespmv_cuda.h:1145-1146)."""
        return (f"{self.name},{self.m},{self.n},{self.nnz},"
                f"{self.ms:.6f},{self.gflops:.4f}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _event_ms(fn) -> float:
    """CUDA-event time of fn() on the current stream, in ms."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _reps_cuda(op: TileSpMV, x: torch.Tensor, warmup: int, reps: int,
               iters: int) -> tuple:
    """(graph ms per call for each rep, eager ms per call for each
    rep) on the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            op(x)

    def eager():
        for _ in range(iters):
            op(x)
    for _ in range(warmup):
        graph.replay()
        eager()
    torch.cuda.synchronize()
    g = [_event_ms(graph.replay) / iters for _ in range(reps)]
    e = [_event_ms(eager) / iters for _ in range(reps)]
    return g, e


def benchmark_op(op: TileSpMV, x: Optional[np.ndarray] = None,
                 name: str = "matrix", warmup: int = 2,
                 timed_reps: int = 5, iters_per_rep: int = 100,
                 max_spread: float = 0.30) -> BenchResult:
    """Benchmark one operator on its device (see the module doc; on the
    CPU every rep is a `time.perf_counter` loop of `iters_per_rep`
    calls). `x` defaults to main.cu's (i % 10) / 4 (main.cu:93-97)."""
    m, n = op.shape
    if x is None:
        x = (np.arange(n) % 10) / 4.0
    xt = torch.as_tensor(x, dtype=op.dtype, device=op.device)
    if op.device.type == "cuda":
        times, eager = _reps_cuda(op, xt, warmup, timed_reps, iters_per_rep)
        chip = roofline.detect_chip()
    else:
        def loop() -> float:
            t0 = time.perf_counter()
            for _ in range(iters_per_rep):
                op(xt)
            return (time.perf_counter() - t0) * 1e3 / iters_per_rep
        for _ in range(warmup):
            loop()
        times = [loop() for _ in range(timed_reps)]
        eager = times
        chip = "cpu"
    ms = float(np.median(times))
    p16, p84 = np.percentile(times, [16, 84])
    spread = float((p84 - p16) / ms) if ms > 0 else math.inf
    dt = max(ms, 1e-9) / 1e3
    plan = op.device_plan()
    classes = [c for c in (plan.dense, plan.band, *plan.sparses,
                           plan.stream, plan.stream2) if c is not None]
    if plan.residual.val.shape[0]:
        classes.append(plan.residual)
    nbytes = profiling.class_bound(classes)["bytes"]
    gflops = op.flops() / dt / 1e9
    vbytes = torch.finfo(op.dtype).bits // 8
    reliable = (ms > 0 and spread <= max_spread
                and not gflops > roofline.peak_compute_gflops(chip, vbytes))
    gbps = nbytes / dt / 1e9
    return BenchResult(
        name=name, m=m, n=n, nnz=op.nnz, ms=ms, gflops=gflops,
        gnnz_per_s=op.nnz / dt / 1e9, gbytes_per_s=gbps,
        roofline_frac=gbps / roofline.peak_bandwidth_gbps(chip),
        chip=chip, backend=op.device.type,
        iters=timed_reps * iters_per_rep, reliable=reliable, spread=spread,
        eager_ms=float(np.median(eager)))


def append_results_csv(path: str, result: BenchResult) -> None:
    """Append-only CSV in the reference's schema
    (tilespmv_cuda.h:1141-1147). Refuses unreliable rows: a record the
    harness knows is at the noise floor must never enter the results
    file."""
    if not result.reliable:
        raise ValueError(
            f"refusing to record unreliable measurement for {result.name} "
            f"(spread={result.spread:.2f}); escalate iterations or mark "
            "the row unmeasurable")
    with open(path, "a") as f:
        f.write(result.csv_row() + "\n")
