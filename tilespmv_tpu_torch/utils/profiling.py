"""Per-class cost profiling and tracing hooks.

Port of tilespmv_tpu/utils/profiling.py, the counterpart of the
reference's per-format cost instrumentation (`DEBUG_FORMATCOST` /
`formatprofile`, reference main.cu:12 and tilespmv_cuda.h:102-110,
525-533): `profile_engines` times each execution-plan class on its own,
so the cost of every class is visible, and `trace_context` records a
`torch.profiler` trace for deep dives. `csr_bound`, `band_bound` and
`class_bound` give the least time the card could take for a class's
work, the yardstick its kernel's time is read against; `graph_ms` and
`ab_arms` time kernels and the probe scripts' arms on the card in CUDA
graphs (`capture_graph`); `step_time` and `launch_time` time the
microbenchmarks' steps, and `shared_floor_ns` gives a step's
shared-memory floor from its `bank_wavefronts`.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import subprocess
import time

import numpy as np
import torch

from ..bench import roofline
from ..ops.cuda import kernels, reference
from ..ops.cuda.lane_plan import (BandChunks, acc_dtype, kernel_bytes,
                                  value_dtype)


def _timed(fn, *args, reps: int = 3, k1: int = 25, k2: int = 425) -> float:
    """Difference-method timing of fn(*args), in seconds: the time of k2
    calls minus the time of k1 calls, over k2 - k1, the median over
    `reps` (after one run of each loop as warm-up), never below 1e-9 s.

    When any argument is a tensor on a CUDA device, each loop is timed by
    a pair of `torch.cuda.Event`s recorded on the current stream around
    it (the second one synchronized); otherwise by `time.perf_counter`.
    The fixed cost of a loop (the first launch's latency, the final
    synchronization) cancels in the difference. A call that spends longer
    on the host than on the device is timed at the host's launch rate.
    The JAX version perturbs x by a result-dependent epsilon inside a
    `fori_loop` because XLA could hoist a loop-invariant call out of the
    loop; eager PyTorch runs every call it is given, so the loops here
    are plain Python loops."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)

    def loop(k: int) -> float:
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(k):
                fn(*args)
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        t0 = time.perf_counter()
        for _ in range(k):
            fn(*args)
        return time.perf_counter() - t0

    loop(k1)
    loop(k2)
    ts = []
    for _ in range(reps):
        ta = loop(k1)
        tb = loop(k2)
        ts.append((tb - ta) / (k2 - k1))
    return max(float(np.median(ts)), 1e-9)


def _launch_s(launch, n: int) -> float:
    """CUDA-event time of one launch(n), in seconds."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    launch(n)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def step_time(launch, n1: int, n2: int, reps: int = 5) -> float:
    """Difference-method time of one step of a kernel on the card, in
    seconds: `launch(n)` enqueues one launch of n steps; the CUDA-event
    time of launch(n2) minus that of launch(n1), over n2 - n1, the median
    over `reps` (after one warm-up launch of each size). With n1 and n2
    whole multiples of the units a launch runs at once (the
    microbenchmarks' persistent grid), the result is the chip's time per
    step with every SM running steps together; the launch's fixed cost
    and whatever a unit does once a launch (the microbenchmarks' input
    load) cancel."""
    _launch_s(launch, n1)
    _launch_s(launch, n2)
    ts = []
    for _ in range(reps):
        ta = _launch_s(launch, n1)
        tb = _launch_s(launch, n2)
        ts.append((tb - ta) / (n2 - n1))
    return float(np.median(ts))


def launch_time(launch, n: int, reps: int = 5) -> float:
    """Median CUDA-event time of one launch(n), in seconds, after one
    warm-up launch."""
    _launch_s(launch, n)
    return float(np.median([_launch_s(launch, n) for _ in range(reps)]))


def bank_wavefronts(words) -> np.ndarray:
    """Shared-memory wavefronts of warp loads: `words` (..., 32) holds the
    32-bit word each lane of a warp reads (a byte's word for a byte load).
    A load takes as many wavefronts as the most distinct words that fall
    in one of the 32 banks (lanes reading one word share it); returns one
    count per warp, shape words.shape[:-1]."""
    w = np.sort(np.asarray(words, dtype=np.int64), axis=-1)
    lead = w.shape[:-1]
    w = w.reshape(-1, 32)
    new = np.ones(w.shape, dtype=np.int64)
    new[:, 1:] = w[:, 1:] != w[:, :-1]
    slot = np.arange(len(w))[:, None] * 32 + w % 32
    per_bank = np.bincount(slot.ravel(), weights=new.ravel(),
                           minlength=32 * len(w)).reshape(-1, 32)
    return per_bank.max(axis=1).astype(np.int64).reshape(lead)


def sm_clock_hz() -> float:
    """Card 0's highest SM clock, in Hz (`nvidia-smi
    --query-gpu=clocks.max.sm`)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def shared_floor_ns(wavefronts: int, device) -> float:
    """Least time of `wavefronts` shared-memory wavefronts spread over
    every SM of `device`, one wavefront an SM a cycle at the highest SM
    clock, in ns."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return wavefronts / (sms * sm_clock_hz()) * 1e9


# H100 SXM peaks at its 700 W limit (bench/roofline.py's table): HBM3
# bytes/s, and FLOP/s by value size (BF16 on the tensor cores; FP32 and
# FP64 outside them)
HBM_BYTES_PER_S = roofline.HBM_GBPS["h100_sxm"] * 1e9
PEAK_FLOPS = {vb: g * 1e9
              for vb, g in roofline.PEAK_GFLOPS["h100_sxm"].items()}


def csr_bound(nnz: int, rows: int, cols: int, vbytes: int,
              k: int = 1, xbytes: int = 0) -> dict:
    """Least time of Y = A @ X over k right-hand sides for A in CSR with
    `nnz` entries over `rows` distinct rows and `cols` distinct columns,
    values of `vbytes` bytes, X and Y of `xbytes` (0: vbytes), which also
    picks the peak FLOP/s: each byte read or written once, bytes =
    nnz*(vbytes + 4) + 4*(rows + 1) + xbytes*(cols + rows)*k (values and
    int32 columns, row pointer, x and y), flops = 2*nnz*k; roofline's
    dict."""
    xbytes = xbytes or vbytes
    return roofline(
        nnz * (vbytes + 4) + 4 * (rows + 1) + xbytes * (cols + rows) * k,
        2 * nnz * k, xbytes)


def roofline(nbytes: float, flops: float, vbytes: int) -> dict:
    """{"bytes", "flops", "bound_ms", "bound_by"}: the larger of nbytes
    over HBM_BYTES_PER_S and flops over PEAK_FLOPS[vbytes], in ms, and
    which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[vbytes] * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def band_bound(nnz: int, rows: int, cols: int, vbytes: int,
               index_bytes: int, k: int = 1, xbytes: int = 0) -> dict:
    """Least time of Y = A @ X over k right-hand sides for a banded A:
    its columns follow from each tile row's first block column, so no
    index per entry is read. bytes = nnz*vbytes + index_bytes (the
    block columns and panel ids) + xbytes*(cols + rows)*k (xbytes as in
    csr_bound), flops = 2*nnz*k; roofline's dict."""
    xbytes = xbytes or vbytes
    return roofline(nnz * vbytes + index_bytes + xbytes * (cols + rows) * k,
                    2 * nnz * k, xbytes)


def class_bound(classes, k: int = 1) -> dict:
    """The bound summed over plan classes of one value dtype
    (reference.class_coo's nonzeros; each class its own launch): a band
    class by band_bound over its bloc, pb and cw, every other class by
    csr_bound as its own CSR: values at the bytes of the class's value
    dtype (2 for bf16), x, y and the FLOP/s peak at those of its compute
    dtype (lane_plan.acc_dtype: float32 for bf16, which is what the
    kernels read, write and multiply in)."""
    parts, xbytes = [], 4
    for cls in classes:
        row, col, val = reference.class_coo(cls)
        vdt = value_dtype(cls.val)
        xbytes = acc_dtype(vdt).itemsize
        shape = (val.size, np.unique(row).size, np.unique(col).size,
                 vdt.itemsize)
        if isinstance(cls, BandChunks):
            index = _nbytes(*(torch.as_tensor(a)
                              for a in (cls.bloc, cls.pb, cls.cw)))
            parts.append(band_bound(*shape, index, k, xbytes))
        else:
            parts.append(csr_bound(*shape, k, xbytes))
    return roofline(sum(p["bytes"] for p in parts),
                    sum(p["flops"] for p in parts), xbytes)


def capture_graph(fn, iters: int) -> torch.cuda.CUDAGraph:
    """One CUDA graph of `iters` calls of fn(), captured after a warm-up
    call on a side stream (which capture needs before fn's first call in
    a graph)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return graph


def graph_ms(fn, reps: int = 5, iters: int = 20) -> float:
    """Device time of one fn() on the card, in ms: `iters` calls
    captured in one CUDA graph (capture_graph), the median over `reps`
    of the CUDA-event time of a replay, over `iters`. It leaves out the
    host's time per call (checks, launch calls), which sets the pace of
    a loop of kernels shorter than it."""
    graph = capture_graph(fn, iters)
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / iters)
    return float(np.median(ts))


def ab_arms(make_run, arms, want: torch.Tensor, tol: float,
            timed_only=(), rounds: int = 2, name: str = "kernel") -> dict:
    """{arm: {"ms", "min_ms", "max_ms", "err"}}: an A/B of kernel arms on
    the card. `make_run(arm, y)` returns a callable that launches `arm`
    once, adding into y (shaped as `want`). Each arm not in `timed_only`
    first runs once into a zeroed y and is held to the plain version's
    `want` within tol * max(1, max|want|) (raises past it; "err" None for
    the timed-only arms, whose y is wrong). Then every arm is timed by
    graph_ms into one shared y, the arms in turns, forward then
    backward, `rounds` times: median, least and most ms."""
    bound = tol * max(1.0, float(want.abs().max()))
    out = {}
    for arm in arms:
        y = torch.zeros_like(want)
        make_run(arm, y)()
        torch.cuda.synchronize()
        err = None
        if arm not in timed_only:
            err = float((y - want).abs().max())
            if not err <= bound:
                raise AssertionError(f"{name} arm {arm}: max |kernel - "
                                     f"plain| {err:.3e} > {bound:.3e}")
        out[arm] = {"err": err}
    y = torch.zeros_like(want)
    runs = {arm: make_run(arm, y) for arm in arms}
    times = {arm: [] for arm in arms}
    for _ in range(rounds):
        for arm in (*arms, *arms[::-1]):
            times[arm].append(graph_ms(runs[arm]))
    for arm, ts in times.items():
        out[arm].update(ms=float(np.median(ts)), min_ms=min(ts),
                        max_ms=max(ts))
    return out


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def op_classes(op) -> list:
    """The classes of the lane plan of `op`, or of each of its column
    parts (`op.parts`), and each plan's residual where it holds entries:
    the work class_bound counts."""
    out = []
    for part in (op.parts if op.parts is not None else [op]):
        plan = part.device_plan()
        out += [c for _, _, c in reference.class_order(plan)]
        if plan.residual.val.shape[0]:
            out.append(plan.residual)
    return out


def _class_fields(kind: str, c) -> tuple:
    """(bytes, counts) that profile_engines gives a class of `kind`: its
    value and index arrays (the reference's count) and its shape."""
    if kind == "band":
        return _nbytes(c.val, c.bloc), dict(chunks=int(c.val.shape[0]),
                                            c_cols=c.c_cols)
    if kind == "stream":
        return (_nbytes(c.val, c.vidx, c.planes),
                dict(slabs=int(c.nslabs), rounds=c.rounds,
                     s_batch=c.s_batch))
    return _nbytes(c.val, c.meta), dict(chunks=int(c.val.shape[0]),
                                        t_lanes=c.t_lanes)


def profile_engines(op, x=None) -> dict[str, dict]:
    """Per-class timing breakdown of a TileSpMV operator (f32, f64 or
    bf16).

    Returns {class: {"us", "bytes", "gbps", ...}} with a key for each
    class of the plan in the main path's order (reference.class_order:
    its span's suffix, "dense", "band", "sparse_w{W}", "stream",
    "stream2"), then "residual" where the plan has one, and the class's
    counts (dense and W-classes `chunks`, `t_lanes`; band `chunks`,
    `c_cols`; stream classes `slabs`, `rounds`, `s_batch`). `bytes`
    counts the class's value and index arrays (the reference's count);
    `gbps` is bytes / time. Each class runs through its wrapper in
    ops/cuda/kernels.py into its own zeroed y: on a CUDA operator that
    launches the kernel (CUDA-event timing, which times the host where
    a class takes less time than its wrapper), on a CPU operator it
    runs the plain version (host clock). A CUDA operator's classes also
    give `device_us`, the device time of one call by CUDA-graph replay
    (`graph_ms`), and `kernel_bytes`, the arrays its kernel reads
    (lane_plan.kernel_bytes): `bytes`, except that the stream kernels
    read `erow` and not the round planes. The residual is timed with
    reference.residual_add, the main path's `index_add_`. `x` defaults to
    bench.py's (i % 10) / 4. An operator on the xla backend, which has
    no such classes, raises ValueError (as the reference's does). A
    column-partitioned operator gives each part's classes under
    "part{i}_<class>", each part on its columns of x.
    """
    if op.backend != "pallas":
        raise ValueError("profile_engines requires the pallas backend")
    if op.parts is not None:
        x = (np.arange(op.shape[1]) % 10) / 4.0 if x is None else x
        return {f"part{i}_{k}": v
                for i, (c0, part) in enumerate(zip(op._col_starts, op.parts))
                for k, v in profile_engines(
                    part, x[c0: c0 + part.shape[1]]).items()}
    plan = op.device_plan()
    if x is None:
        x = (np.arange(plan.n) % 10) / 4.0
    xt = torch.as_tensor(x, dtype=plan.dtype, device=op.device)
    xp = reference.pad_x(plan, xt)

    def timed(fn, cls, b: int, xs=xp, **counts) -> dict:
        y = reference.zero_y(plan, xt)
        dt = _timed(fn, cls, xs, y)
        out = {"us": dt * 1e6, "bytes": b, "gbps": b / dt / 1e9, **counts}
        if xt.is_cuda:
            out["device_us"] = graph_ms(lambda: fn(cls, xs, y)) * 1e3
            out["kernel_bytes"] = kernel_bytes(
                plan.residual if cls is None else cls)
        return out

    out = {}
    for name, kind, c in reference.class_order(plan):
        b, counts = _class_fields(kind, c)
        # the class's SpMV wrapper, kernels.<kind>_spmv
        out[name.removeprefix("tsp.launch.")] = timed(
            getattr(kernels, kind + "_spmv"), c, b, **counts)
    r = plan.residual
    if r.val.shape[0]:
        out["residual"] = timed(
            lambda _, xu, y: reference.residual_add(plan, xu, y), None,
            _nbytes(r.val, r.row, r.col), xs=xt)
    return out


@contextlib.contextmanager
def trace_context(logdir: str):
    """`torch.profiler` trace of the block (host activity, and the card's
    when one is present), written into `logdir` as a Chrome trace
    (`trace.<pid>.<ns>.json`) when the block ends; yields the profiler
    (e.g. for `key_averages()`). The counterpart of the reference's
    `jax.profiler.start_trace` / `stop_trace` (there: the deep-dive
    analog of the reference's gettimeofday spans, main.cu:62-65)."""
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # one cycle: acc_events only keeps torch from warning that it clears
    # events between cycles
    prof = torch.profiler.profile(activities=acts, acc_events=True)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            str(path / f"trace.{os.getpid()}.{time.time_ns()}.json"))


def card_line() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them for card 0."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]
