#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tilespmv_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build — the CUDA class kernels (nvcc, sm_90a) and the native host
   library (g++) from the checkout's sources;
2. plan — convert and plan the flagship trio (banded_large,
   powerlaw_large, mixed_large at full size, from their seeds) through
   `TileSpMV(csr, device="cuda")`;
3. main path — one `op(x)` per matrix with the kernel launch counters
   reset just before; every kernel must have launched, and the full y
   must pass the f64 CSR golden gates (1% + 1e-4 per row, and
   rtol 2e-4 / atol 1e-4); then each matrix's op(x) alone, for the
   launches per call;
4. kernels — each class kernel against its plain PyTorch version on the
   card, on the flagship plan that uses it (the stream kernel on
   powerlaw_large's two classes and mixed_large's one, each class also
   timed alone) and a seeded uniform(-1, 1) x (bench.py's dyadic x
   makes every f32 sum exact): one launch per class, max |kernel -
   plain| <= 1e-5 * max(1, max|plain|) (the bound allows for atomics
   adding in any order), and the time of each: its device time
   (`utils.profiling.graph_ms`: 20 calls in one CUDA graph) and, as in
   earlier runs, the median CUDA-event time of a loop of calls, which
   holds the wrappers' host time too; the stream kernel also at 1, 2, 4
   and S slabs per block (blocks per class printed). Beside each time,
   the yardstick: the bound (utils.profiling.class_bound: the classes'
   nonzeros as CSR, a band class's as values, block columns, x and y
   with no column per entry; bytes over 3.35 TB/s or flops over the
   peak, whichever is larger) with the share of it the kernel reaches,
   and the library call: one cuSPARSE product per class
   (`torch.sparse_csr_tensor` of its nonzeros, reference.class_coo;
   `torch.mv`, or `@` for SpMM), held to the plain version within the
   kernel's bound and timed the same way. The dense kernel's row also
   prints its launch (kernels.dense_launch: blocks, threads, active
   tiles / lane slots, the bytes it reads and those bytes at 3.35 TB/s,
   the layout floor, all counted from the plan, so printed and kept out
   of the JSON line) and the A/B of its arms (scripts/dense_probes:
   dense.cu against copies of it built without the list of active lane
   groups or without the column mask), each arm held to the plain
   version, the arms' times in the JSON line as "ab";
5. end to end — median ms and GFLOPS (2*nnz/t) per matrix for the
   kernel path and for the plain path;
6. .mtx — tests/fixtures/bcsstk_style_sym.mtx through load_mtx and
   TileSpMV against the golden;
7. SpMM — `op.matmat(X)` at k = 8 per matrix (column r of X is
   ((i + r) % 10) / 4, dyadic) with the launch counters reset just
   before: every fused SpMM kernel must have launched, and every column
   must pass the golden gates; alone, each matrix's matmat must launch
   the SpMM stream kernel once per stream class over all k columns and
   the SpMV stream kernel never (launches per matmat printed); then
   mixed_large at k = 5 (odd k through the same kernels) and
   banded_large at k = 17 (one SpMV per column), gated the same way;
   each SpMM kernel against its plain version at k = 8 with a seeded
   uniform(-1, 1) X (one launch per class over all k columns), with the
   phase-4 bound and times at k = 8, band_spmm's and dense_spmm's rows
   also with their launch and layout floor (kernels.band_launch,
   dense_launch at k = 8: printed, kept out of the JSON line); and end
   to end per matrix at k = 8:
   matmat ms against 8 SpMV calls and the plain matmat, GFLOPS =
   2*nnz*k/t;
8. f64 — the trio planned through `TileSpMV(csr, device="cuda",
   dtype=torch.float64)` (the reference's f64 routing, native-FP64
   values), classes printed; one `op(x)` per matrix with bench.py's x as
   float64 and the launch counters reset just before: band_f64,
   dense_f64 and stream_f64 must have launched; every y gated against
   the float64 CSR golden at max |y - golden| / (1 + |A|·|x|) <= 1e-12,
   with that x and with a seeded uniform(-1, 1) x, and so are the .mtx
   fixture and `matmat` at k = 3 on mixed_large (one f64 SpMV per
   column); each f64 kernel against its plain version on every class of
   its kind (band_f64 on banded_large, dense_f64 on mixed_large,
   stream_f64 on powerlaw_large and mixed_large's split pair) within
   1e-12 * max(1, max|plain|), with median times and, as in phase 4,
   the bound, the library call and dense_f64's launch and A/B; end to
   end per matrix f64 ms and GFLOPS for the kernel and plain paths and
   the ratio to phase 5's f32 ms;
9. measurement — with the launch counters reset just before: the two
   microbenchmarks (tilespmv_tpu_torch/scripts/microbench_{gather,
   scatter}.py's `timeit`: every R and every arm, ns per step over 4 and
   64 whole waves) and `utils.profiling.profile_engines` on the trio in
   f32 and f64; microbench_gather, microbench_scatter and every SpMV
   class kernel must have launched, and every class of each plan must
   be profiled with us > 0; each class's bytes printed against the
   card's L2 size, the sum of the class times beside phase 5's and
   phase 8's end-to-end ms; `utils.profiling.trace_context` around
   TRACE_CALLS op(x) per matrix and dtype must trace device time, whose
   share of the end-to-end ms (the device's busy share) is printed with
   the largest device items; then each microbenchmark kernel against
   its plain version on the card for every R and arm (one launch of one
   wave of steps, the phase-4 bound), with the kernel's time per step
   (the scripts' number), the plain version's time for one step, and
   the time of a launch of one step, and the bound per step (the
   variant's operations over the FP32 peak, its inputs once over the
   launch); no one PyTorch call computes a step, so these rows have no
   library call.
10. entry points — the command-line tool `tilespmv_tpu_torch.cli.main`
   as a user runs it, the launch counters reset before each call, each
   call fatal unless it exits 0: mixed_large with --profile,
   --save-plan, --save-tiles and a results CSV (errcount = 0 and PASS
   printed; dense, sparse and stream launched; the CSV then holds one
   row of the reference schema name,m,n,nnz,ms,gflops); --load-plan of
   that plan file (PASS), and `TileSpMV.from_plan(load_lane_plan(...))`
   on the card within KERNEL_TOL of phase 3's mixed_large y; banded_large
   with --dtype f64 (band_f64 launched, a second CSV row); `op.T(y)`
   and `op.rmatvec(y)` on tall_rect (131072 x 4096) against the float64
   A^T y with phase 3's gates, and `op.T.T is op`; the examples on the
   card (tilespmv_tpu_torch/examples: CG error < 1e-4, PageRank error
   < 1e-6, tests/test_examples.py's bounds). Each CLI line is printed,
   and the phase's seconds.

Prints the card's name and power limit (nvidia-smi), then one JSON line
of per-kernel results (launches on the main path and per call, error,
ms, plain_ms, bound_ms and bound_by, library_ms, share of bound), then
the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA device or the repo.
"""
import dataclasses
import json
import pathlib
import statistics
import sys
import time

import numpy as np

FLAGSHIP = ("banded_large", "powerlaw_large", "mixed_large")
# kernel vs plain version on the card: the order of float32 atomic adds
KERNEL_TOL = 1e-5
# end to end vs the float64 CSR golden (tests/test_pallas.py's bound)
GOLD_RTOL, GOLD_ATOL = 2e-4, 1e-4
# f64: kernel vs plain version (float64 atomics in any order), and
# max |y - golden| / (1 + |A|·|x|) against the float64 golden
KERNEL_TOL_F64 = 1e-12
GOLD_TOL_F64 = 1e-12
_SRC = "tilespmv_tpu_torch/ops/cuda/csrc/"
_TPU = "tilespmv_tpu/ops/pallas/kernels.py:"
# name: (source, TPU kernel it replaces, matrix whose plan runs it)
KERNELS = {
    "band": (_SRC + "band.cu", _TPU + "772", "banded_large"),
    "stream": (_SRC + "stream.cu", _TPU + "1853",
               ("powerlaw_large", "mixed_large")),
    "dense": (_SRC + "dense.cu", _TPU + "679", "mixed_large"),
    "sparse": (_SRC + "sparse.cu", _TPU + "724", "mixed_large"),
}
SPMM_KERNELS = {
    "band_spmm": (_SRC + "band_spmm.cu", _TPU + "860", "banded_large"),
    "dense_spmm": (_SRC + "dense_spmm.cu", _TPU + "1015", "mixed_large"),
    "sparse_spmm": (_SRC + "sparse_spmm.cu", _TPU + "1042", "mixed_large"),
    "stream2": (_SRC + "stream2.cu", _TPU + "1555", "powerlaw_large"),
}
# the f64 kernels: (source, TPU kernel arm, matrices whose plans run it)
F64_KERNELS = {
    "band_f64": (_SRC + "band.cu", _TPU + "545", ("banded_large",)),
    "dense_f64": (_SRC + "dense.cu", _TPU + "378", ("mixed_large",)),
    "stream_f64": (_SRC + "stream.cu", _TPU + "1926",
                   ("powerlaw_large", "mixed_large")),
}
# the microbenchmark kernels: (source, TPU kernel it replaces)
MB_KERNELS = {
    "microbench_gather": (_SRC + "microbench_gather.cu",
                          "scripts/microbench_gather.py:45"),
    "microbench_scatter": (_SRC + "microbench_scatter.cu",
                           "scripts/microbench_scatter.py:98"),
}
# float operations per step of each microbenchmark variant, as its plain
# version counts them: one add per gathered value (gather); a subtract
# and an add per round and target of each slab (rounds); per slab the
# differences (not offs_nodep) and the picks' adds, then the sum over
# the 8 picks (offs arms)
MB_OPS = {("microbench_gather", r): 512 * 128 for r in (8, 16, 32, 64)}
MB_OPS.update({("microbench_scatter", "rounds"): 8 * 13 * 1024 * 2,
               ("microbench_scatter", "offs"): (13 + 13 * 8 + 8) * 1024,
               ("microbench_scatter", "offs_nodep"): (13 * 8 + 8) * 1024,
               ("microbench_scatter", "offs_noroll"): (13 + 13 * 8 + 8)
               * 1024})
# right-hand sides of the SpMM phase's plan-level runs and comparisons
K_MM = 8
# op(x) calls per matrix and dtype in phase 9's trace
TRACE_CALLS = 20
MTX = "tests/fixtures/bcsstk_style_sym.mtx"


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_x(n: int) -> np.ndarray:
    """bench.py's x: ((i % 10) / 4) as float32."""
    return ((np.arange(n) % 10) / 4.0).astype(np.float32)


def bench_xs(n: int, k: int) -> np.ndarray:
    """(n, k) float32, column r = ((i + r) % 10) / 4: dyadic like bench_x,
    so every f32 sum is exact."""
    i = np.arange(n)[:, None] + np.arange(k)[None, :]
    return ((i % 10) / 4.0).astype(np.float32)


def golden(csr, x: np.ndarray) -> np.ndarray:
    """Float64 CSR y = A @ x."""
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    return np.bincount(rows, weights=csr.data * x[csr.indices].astype(
        np.float64), minlength=csr.m)


def gate(name: str, y: np.ndarray, ref: np.ndarray) -> None:
    """bench.py's full-vector 1% + 1e-4 gate and the rtol/atol bound."""
    if y.shape != ref.shape or not np.isfinite(y).all():
        raise AssertionError(f"{name}: y has shape {y.shape} or "
                             "non-finite values")
    err = np.abs(y.astype(np.float64) - ref)
    bad = err > 0.01 * np.abs(ref) + 1e-4
    if bad.any():
        i = int(np.argmax(err))
        raise AssertionError(f"{name}: 1% gate failed on {int(bad.sum())} "
                             f"rows; worst row {i}: {y[i]} vs {ref[i]}")
    tight = err > GOLD_ATOL + GOLD_RTOL * np.abs(ref)
    if tight.any():
        raise AssertionError(f"{name}: rtol {GOLD_RTOL} / atol {GOLD_ATOL} "
                             f"bound failed on {int(tight.sum())} rows")


def cuda_ms(fn, reps: int = 5, iters: int = 10) -> float:
    """Median over `reps` of the mean CUDA-event time of `iters` calls,
    after warm-up."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def class_lists(plan) -> dict:
    """The plan's classes per kernel name (SpMV and SpMM kernels)."""
    cl = {"band": [plan.band] if plan.band is not None else [],
          "dense": [plan.dense] if plan.dense is not None else [],
          "sparse": list(plan.sparses),
          "stream": [s for s in (plan.stream, plan.stream2)
                     if s is not None]}
    cl.update({"band_spmm": cl["band"], "dense_spmm": cl["dense"],
               "sparse_spmm": cl["sparse"], "stream2": cl["stream"],
               "band_f64": cl["band"], "dense_f64": cl["dense"],
               "stream_f64": cl["stream"]})
    return cl


def gate_mm(name: str, csr, y: np.ndarray, x: np.ndarray) -> None:
    """gate() on every column of Y = A @ X."""
    if y.shape != (csr.m, x.shape[1]):
        raise AssertionError(f"{name}: Y has shape {y.shape}")
    for r in range(x.shape[1]):
        gate(f"{name} column {r}", y[:, r], golden(csr, x[:, r]))


# plan fields a kernel does not read: the stream kernels read erow and
# not the round planes; the dense kernels not cfirst
_UNREAD = {"stream": ("planes", "cfirst"), "stream_f64": ("planes", "cfirst"),
           "stream2": ("planes", "cfirst"), "dense": ("cfirst",),
           "dense_f64": ("cfirst",), "dense_spmm": ("cfirst",)}
# the stream kernel's slabs per block tried in phases 4 and 8 (S: all of
# a step's slabs, the wrapper clamping the group to S)
STREAM_GROUPS = {"1": 1, "2": 2, "4": 4, "S": 1 << 30}


def class_bytes(cls, kname: str) -> int:
    """Bytes of the plan tensors the kernel `kname` reads of a class."""
    return sum(t.numel() * t.element_size()
               for f in dataclasses.fields(cls)
               if f.name not in _UNREAD.get(kname, ())
               and hasattr(t := getattr(cls, f.name), "element_size"))


def per_call_launches(calls: dict) -> dict:
    """{matrix: launch counts of one call}, each call run alone with the
    counters reset just before."""
    import torch
    from tilespmv_tpu_torch.ops.cuda import kernels
    out = {}
    for name, fn in calls.items():
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        out[name] = kernels.launch_counts()
    return out


def compare_kernels(dev, card, table, wrap, plain, ops, csrs, launches,
                    per_call, k=None, tol=KERNEL_TOL) -> list:
    """Each kernel of `table` against its plain version on the card, on
    all the classes of its kind in the plan of each of its matrices, with
    a seeded uniform(-1, 1) x in the plan's dtype: one launch per class,
    the `tol` bound, median times, the bound and the library call (see
    compare_on). `k` None: SpMV (flat x and y); else SpMM with x
    (rows, k) and y (ylen, k). Returns
    the kernels' JSON entries (errors the largest, numbers those of the
    first matrix, then by matrix), `launches` being the main path's
    counts and `per_call` per_call_launches' of the main path's call."""
    results = []
    for kname, (src, replaces, mnames) in table.items():
        mnames = (mnames,) if isinstance(mnames, str) else mnames
        runs = [compare_on(dev, card, kname, wrap, plain, ops[m], csrs[m],
                           m, k, tol) for m in mnames]
        r0 = runs[0]
        results.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=launches[kname],
            launches_per_call={m: per_call[m][kname] for m in mnames},
            max_abs_err=max(r["err"] for r in runs), ms=r0["ms"],
            call_ms=r0["call_ms"],
            plain_ms=r0["plain_ms"], bound_ms=r0["bound_ms"],
            bound_by=r0["bound_by"], library_ms=r0["library_ms"],
            library="torch.sparse_csr_tensor (cuSPARSE) " + (
                "mv" if k is None else "mm"),
            share_of_bound=r0["bound_ms"] / r0["ms"],
            kernel_over_library=r0["ms"] / r0["library_ms"]))
        for f in ("ms_by_group", "by_class", "ab"):
            if f in r0:
                results[-1][f] = r0[f]
        if len(runs) > 1:
            results[-1]["by_matrix"] = {
                m: {f: r[f] for f in ("ms", "call_ms", "plain_ms",
                                      "bound_ms", "library_ms", "by_class")
                    if f in r}
                for m, r in zip(mnames, runs)}
    return results


def library_mats(classes, xp, ylen: int) -> list:
    """One torch sparse CSR matrix per class on xp's device: the class's
    nonzeros (reference.class_coo), int32 indices, shape (ylen, rows of
    xp). The yardstick's input only: the port never calls it."""
    import torch
    from tilespmv_tpu_torch.ops.cuda import reference
    mats = []
    for c in classes:
        row, col, val = reference.class_coo(c)
        order = np.lexsort((col, row))
        crow = np.zeros(ylen + 1, np.int64)
        np.cumsum(np.bincount(row, minlength=ylen), out=crow[1:])
        mats.append(torch.sparse_csr_tensor(
            torch.from_numpy(crow.astype(np.int32)).to(xp.device),
            torch.from_numpy(col[order].astype(np.int32)).to(xp.device),
            torch.from_numpy(val[order]).to(xp.device),
            size=(ylen, xp.shape[0])))
    return mats


def compare_on(dev, card, kname, wrap, plain, op, csr, mname, k,
               tol) -> dict:
    """compare_kernels on one matrix: {"err", "ms", "plain_ms",
    "bound_ms", "bound_by", "library_ms"} (and the stream kernel's
    "ms_by_group"). The bound is utils.profiling.class_bound over the
    classes' nonzeros at k; the library call is
    one cuSPARSE SpMV (`torch.mv`) or SpMM (`@`) per class on
    library_mats, checked against the plain version within `tol` and
    timed the same way as the kernel."""
    import torch
    from tilespmv_tpu_torch.ops.cuda import kernels, reference
    from tilespmv_tpu_torch.utils import profiling
    plan = op.device_plan()
    classes = class_lists(plan)[kname]
    if not classes:
        raise AssertionError(f"{mname}'s plan has no {kname} class")
    rhs = () if k is None else (k,)
    xr = np.random.default_rng(0).uniform(-1, 1, (csr.n,) + rhs)
    xp = reference.pad_x(plan, torch.from_numpy(xr).to(dev))
    ylen = max(plan.y_padded_len, plan.n_stream_windows * 1024)
    yk = torch.zeros((ylen,) + rhs, dtype=xp.dtype, device=dev)
    yp = torch.zeros((ylen,) + rhs, dtype=xp.dtype, device=dev)

    def run(fn, y, **kw):
        for c in classes:
            fn(c, xp, y, **kw)
    before = kernels.launch_counts()[kname]
    run(wrap[kname], yk)
    run(plain[kname], yp)
    torch.cuda.synchronize()
    delta = kernels.launch_counts()[kname] - before
    if delta != len(classes):
        raise AssertionError(f"{kname}: {delta} launches for "
                             f"{len(classes)} classes")
    err = float((yk - yp).abs().max())
    bound = tol * max(1.0, float(yp.abs().max()))
    rel = float(((yk - yp).abs() / yp.abs().clamp(min=1e-30)).max())
    if not err <= bound:
        raise AssertionError(f"{kname}: max |kernel - plain| {err:.3e}"
                             f" > {bound:.3e}")
    out = {"err": err}
    # the library call on the same inputs, before the timing loops below
    # add into yk and yp again
    mats = library_mats(classes, xp, ylen)

    def lib():
        return sum(torch.mv(a, xp) if k is None else a @ xp for a in mats)
    lerr = float((lib() - yp).abs().max())
    if not lerr <= bound:
        raise AssertionError(f"{kname}: max |library - plain| {lerr:.3e}"
                             f" > {bound:.3e}")
    if kname in ("stream", "stream_f64"):
        out["ms_by_group"] = {}
        for g, group in STREAM_GROUPS.items():
            yg = torch.zeros_like(yk)
            run(wrap[kname], yg, group=group)
            torch.cuda.synchronize()
            gerr = float((yg - yp).abs().max())
            if not gerr <= bound:
                raise AssertionError(f"{kname} group {g}: max |kernel - "
                                     f"plain| {gerr:.3e} > {bound:.3e}")
            ms_g = out["ms_by_group"][g] = profiling.graph_ms(
                lambda: run(wrap[kname], yg, group=group))
            log(f"kernel {kname} on {mname}, group {g}: blocks "
                f"{[kernels.stream_blocks(c, group) for c in classes]} "
                f"(S {[c.s_batch for c in classes]}), max abs err "
                f"{gerr:.3e}, {ms_g:.4f} ms [{card}]")
    ms = out["ms"] = profiling.graph_ms(lambda: run(wrap[kname], yk))
    call_ms = out["call_ms"] = cuda_ms(lambda: run(wrap[kname], yk),
                                       iters=20)
    plain_ms = out["plain_ms"] = cuda_ms(lambda: run(plain[kname], yp),
                                         iters=3)
    # the yardstick: the bound, and the library call's time
    bnd = profiling.class_bound(classes, k=1 if k is None else k)
    out.update(bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])
    try:
        lib_ms = profiling.graph_ms(lib)
    except RuntimeError as e:     # cuSPARSE refused the graph capture
        log(f"library {kname}: no graph capture ({e}); timed by events")
        lib_ms = cuda_ms(lib, iters=20)
    out["library_ms"] = lib_ms
    if kname in ("stream", "stream_f64"):
        out["by_class"] = [stream_class_line(
            card, kname, mname, i, c, mats[i], xp, yk, wrap[kname])
            for i, c in enumerate(classes)]
    if kname in ("dense", "dense_f64"):
        out["ab"] = dense_lines(
            card, kname, mname, classes[0], xp, ylen, ms, bnd, lib_ms)
    if kname in ("band_spmm", "dense_spmm"):
        spmm_launch_line(card, kname, mname, classes[0], k, ms, bnd, lib_ms)
    mb = sum(class_bytes(c, kname) for c in classes) / 1e6
    log(f"kernel {kname} on {mname} ({len(classes)} class(es), "
        f"{mb:.1f} MB of plan read, launches +{delta}"
        f"{'' if k is None else f', k {k}'}): max abs err {err:.3e} "
        f"(bound {bound:.3e}), max rel err {rel:.3e}, {ms:.4f} ms "
        f"({mb / ms:.0f} GB/s; {call_ms:.4f} ms a call with the wrapper's "
        f"host time) vs plain {plain_ms:.4f} ms; bound "
        f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
        f"({bnd['bytes'] / 1e6:.2f} MB, {bnd['flops'] / 1e6:.2f} MFLOP), "
        f"share of bound {bnd['bound_ms'] / ms:.3f}; library "
        f"{lib_ms:.4f} ms (max abs err {lerr:.3e}), kernel / library "
        f"{ms / lib_ms:.2f} [{card}]")
    return out


def stream_class_line(card, kname, mname, i, cls, mat, xp, y, wrap) -> dict:
    """One stream class alone: the kernel's device time, its bound and
    the library call's time (as compare_on), printed; returns them."""
    import torch
    from tilespmv_tpu_torch.utils import profiling
    ms = profiling.graph_ms(lambda: wrap(cls, xp, y))
    bnd = profiling.class_bound([cls])
    lib_ms = profiling.graph_ms(lambda: torch.mv(mat, xp))
    log(f"kernel {kname} on {mname} class {i} ({cls.nslabs} slabs, S "
        f"{cls.s_batch}): {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms by "
        f"{bnd['bound_by']}, share of bound {bnd['bound_ms'] / ms:.3f}; "
        f"library {lib_ms:.4f} ms, kernel / library {ms / lib_ms:.2f} "
        f"[{card}]")
    return dict(ms=ms, bound_ms=bnd["bound_ms"], library_ms=lib_ms)


def dense_lines(card, kname, mname, d, xp, ylen, ms, bnd, lib_ms) -> dict:
    """The dense kernel's launch on class `d` (kernels.dense_launch:
    blocks, threads, active tiles of the lane slots, the bytes it reads
    and their time at 3.35 TB/s, the layout floor, all counted from the
    plan) beside its time, bound and cuSPARSE time, and the A/B of its
    arms (scripts/dense_probes.run_arms: the group list against every
    lane group, the column mask against every column), printed; returns
    the arms' measured results."""
    from tilespmv_tpu_torch.ops.cuda import kernels
    from tilespmv_tpu_torch.scripts import dense_probes
    from tilespmv_tpu_torch.utils.profiling import HBM_BYTES_PER_S
    ln = kernels.dense_launch(d)
    floor_ms = ln["bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"kernel {kname} on {mname} launch: {ln['blocks']} blocks, "
        f"{ln['threads']} threads, active tiles {ln['active']} / lane "
        f"slots {ln['slots']} ({ln['active'] / ln['slots']:.3f}); reads "
        f"{ln['bytes'] / 1e6:.3f} MB (values {ln['val_bytes'] / 1e6:.3f} "
        f"MB in 32-B sectors), layout floor {floor_ms:.4f} ms; kernel "
        f"{ms:.4f} ms ({floor_ms / ms:.3f} of the floor), bound "
        f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}, share "
        f"{bnd['bound_ms'] / ms:.3f}, cuSPARSE {lib_ms:.4f} ms, kernel / "
        f"library {ms / lib_ms:.2f} [{card}]")
    every = kernels.dense_launch(d, table=False)
    ab = dense_probes.run_arms(d, xp, ylen)
    main = ab[dense_probes.ARMS[0]]["ms"]
    for arm, r in ab.items():
        blocks = (every if arm.startswith("all") else ln)["blocks"]
        log(f"A/B {kname} on {mname} arm {arm} ({blocks} blocks): median "
            f"{r['ms']:.4f} ms (min {r['min_ms']:.4f}, max "
            f"{r['max_ms']:.4f}), {r['ms'] / main:.3f}x groups+mask, max "
            f"abs err {r['err']:.3e} [{card}]")
    return ab


def spmm_launch_line(card, kname, mname, cls, k, ms, bnd, lib_ms) -> None:
    """The launch of band_spmm.cu or dense_spmm.cu on class `cls` at k,
    counted from the plan (kernels.band_launch / dense_launch: blocks,
    dense's active tiles of the lane slots, the bytes of its layout and
    their time at 3.35 TB/s, the layout floor), beside its time, bound
    and cuSPARSE time, printed."""
    from tilespmv_tpu_torch.ops.cuda import kernels
    from tilespmv_tpu_torch.utils.profiling import HBM_BYTES_PER_S
    if kname == "dense_spmm":
        ln = kernels.dense_launch(cls, k=k)
        grid = (f"{ln['blocks']} blocks, active tiles {ln['active']} / "
                f"lane slots {ln['slots']} "
                f"({ln['active'] / ln['slots']:.3f})")
    else:
        ln = kernels.band_launch(cls, k=k)
        grid = f"{ln['blocks']} blocks"
    floor_ms = ln["bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"kernel {kname} on {mname} launch (k {k}): {grid}; reads "
        f"{ln['bytes'] / 1e6:.3f} MB (values {ln['val_bytes'] / 1e6:.3f} "
        f"MB), layout floor {floor_ms:.4f} ms; kernel {ms:.4f} ms "
        f"({floor_ms / ms:.3f} of the floor), bound {bnd['bound_ms']:.4f} "
        f"ms by {bnd['bound_by']}, share {bnd['bound_ms'] / ms:.3f}, "
        f"cuSPARSE {lib_ms:.4f} ms, kernel / library {ms / lib_ms:.2f} "
        f"[{card}]")


def spmm_phase(dev, card, ops, csrs) -> list:
    """Phase 7 (see the module doc); returns the SpMM kernels' results."""
    import torch
    from tilespmv_tpu_torch.ops.cuda import kernels, reference
    # plan level: k = 8 on the trio, counters reset just before
    xs = {n: bench_xs(csrs[n].n, K_MM) for n in FLAGSHIP}
    xd = {n: torch.from_numpy(xs[n]).to(dev) for n in FLAGSHIP}
    kernels.reset_launch_counts()
    ys = {n: ops[n].matmat(xd[n]) for n in FLAGSHIP}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"spmm main path (k {K_MM}) launches: {launches}")
    per_call = per_call_launches({n: (lambda n=n: ops[n].matmat(xd[n]))
                                  for n in FLAGSHIP})
    log(f"launches per matmat (k {K_MM}): {json.dumps(per_call)}")
    for name in SPMM_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "SpMM path")
    # the stream classes: one launch of the SpMM kernel each, all columns
    for n in FLAGSHIP:
        want = len(class_lists(ops[n].device_plan())["stream2"])
        got = (per_call[n]["stream2"], per_call[n]["stream"])
        if got != (want, 0):
            raise AssertionError(f"matmat {n}: stream2 / stream launches "
                                 f"{got}, expected ({want}, 0)")
        log(f"launches per matmat {n} (k {K_MM}): stream2 {got[0]} (one "
            f"per stream class), stream {got[1]}")
    for n in FLAGSHIP:
        gate_mm(f"matmat {n}", csrs[n], ys[n].cpu().numpy(), xs[n])
        log(f"gate matmat {n} (k {K_MM}): ok")

    # odd k (through the same SpMM kernels) and k > 16 (one SpMV per
    # column)
    for n, k, expect in (("mixed_large", 5, ("stream2", "sparse_spmm")),
                         ("banded_large", 17, ("band",))):
        x = bench_xs(csrs[n].n, k)
        kernels.reset_launch_counts()
        y = ops[n].matmat(torch.from_numpy(x).to(dev))
        torch.cuda.synchronize()
        cnt = kernels.launch_counts()
        if not all(cnt[e] for e in expect) or (
                k > 16 and any(cnt[s] for s in SPMM_KERNELS)) or (
                k <= 16 and cnt["stream"]):
            raise AssertionError(f"matmat {n} k {k}: launches {cnt}")
        gate_mm(f"matmat {n} k {k}", csrs[n], y.cpu().numpy(), x)
        log(f"gate matmat {n} (k {k}): ok, launches {cnt}")

    # each SpMM kernel against its plain version
    wrap = {"band_spmm": kernels.band_spmm, "dense_spmm": kernels.dense_spmm,
            "sparse_spmm": kernels.sparse_spmm,
            "stream2": kernels.stream_spmm}
    plain = {"band_spmm": reference.band_spmm_reference,
             "dense_spmm": reference.dense_spmm_reference,
             "sparse_spmm": reference.sparse_rows_reference,
             "stream2": reference.stream_rows_reference}
    results = compare_kernels(dev, card, SPMM_KERNELS, wrap, plain, ops,
                              csrs, launches, per_call, k=K_MM)

    # end to end at k = 8
    for n in FLAGSHIP:
        op, x = ops[n], xd[n]
        plan = op.device_plan()
        cols = [x[:, r].contiguous() for r in range(K_MM)]
        ms = cuda_ms(lambda: op.matmat(x))
        spmv_ms = cuda_ms(lambda: [op(c) for c in cols])
        plain_ms = cuda_ms(lambda: reference.spmm_reference(plan, x),
                           iters=3)
        flops = 2.0 * op.nnz * K_MM
        log(f"e2e matmat {n} (k {K_MM}): kernels {ms:.4f} ms "
            f"{flops / ms / 1e6:.2f} GFLOPS, {K_MM} x SpMV {spmv_ms:.4f} ms "
            f"{flops / spmv_ms / 1e6:.2f} GFLOPS, plain {plain_ms:.4f} ms "
            f"{flops / plain_ms / 1e6:.2f} GFLOPS [{card}]")
    return results


def gate64(name: str, csr, y: np.ndarray, x: np.ndarray) -> float:
    """max |y - golden| / (1 + |A|·|x|) <= GOLD_TOL_F64 over the full y,
    golden and |A|·|x| in float64; returns the measure."""
    if y.shape != (csr.m,) or y.dtype != np.float64 \
            or not np.isfinite(y).all():
        raise AssertionError(f"{name}: y has shape {y.shape}, dtype "
                             f"{y.dtype} or non-finite values")
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    mag = np.bincount(rows, weights=np.abs(csr.data * x[csr.indices]),
                      minlength=csr.m)
    err = float(np.max(np.abs(y - golden(csr, x)) / (1.0 + mag)))
    if not err <= GOLD_TOL_F64:
        raise AssertionError(f"{name}: max |y - golden| / (1 + |A||x|) "
                             f"{err:.3e} > {GOLD_TOL_F64}")
    return err


def f64_phase(dev, card, csrs, f32_ms) -> tuple:
    """Phase 8 (see the module doc); returns the f64 kernels' results,
    the f64 operators and their end-to-end ms."""
    import torch
    from tilespmv_tpu_torch import TileSpMV, load_mtx
    from tilespmv_tpu_torch.ops.cuda import kernels, reference
    ops = {}
    for name in FLAGSHIP:
        t0 = time.perf_counter()
        ops[name] = TileSpMV(csrs[name], device=dev, dtype=torch.float64)
        torch.cuda.synchronize()
        log(f"plan f64 {name}: convert+plan+upload "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{ops[name].summary['plan_mbytes']} MB, "
            f"{json.dumps(ops[name].summary['classes'])}")

    # main path, bench.py's x as float64, counters reset just before
    xs = {n: bench_x(csrs[n].n).astype(np.float64) for n in FLAGSHIP}
    xd = {n: torch.from_numpy(xs[n]).to(dev) for n in FLAGSHIP}
    kernels.reset_launch_counts()
    ys = {n: ops[n](xd[n]) for n in FLAGSHIP}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"f64 main path launches: {launches}")
    per_call = per_call_launches({n: (lambda n=n: ops[n](xd[n]))
                                  for n in FLAGSHIP})
    log(f"launches per f64 op(x): {json.dumps(per_call)}")
    for name in F64_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "f64 path")
    for n in FLAGSHIP:
        err = gate64(f"f64 {n}", csrs[n], ys[n].cpu().numpy(), xs[n])
        xu = np.random.default_rng(1).uniform(-1, 1, csrs[n].n)
        erru = gate64(f"f64 {n} uniform x", csrs[n],
                      ops[n](xu).cpu().numpy(), xu)
        log(f"gate f64 {n}: ok, max |y - golden| / (1 + |A||x|) {err:.3e}"
            f" (bench x), {erru:.3e} (uniform x)")

    csr = load_mtx(str(pathlib.Path(__file__).resolve().parent / MTX))
    x = bench_x(csr.n).astype(np.float64)
    err = gate64(f"f64 {MTX}", csr, TileSpMV(
        csr, device=dev, dtype=torch.float64)(x).cpu().numpy(), x)
    log(f"gate f64 {MTX}: ok, {err:.3e}")

    n = "mixed_large"
    x = bench_xs(csrs[n].n, 3).astype(np.float64)
    kernels.reset_launch_counts()
    y = ops[n].matmat(torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    cnt = kernels.launch_counts()
    if y.shape != (csrs[n].m, 3) or not cnt["dense_f64"] or any(
            cnt[s] for s in SPMM_KERNELS):
        raise AssertionError(f"f64 matmat {n}: Y {tuple(y.shape)}, "
                             f"launches {cnt}")
    y = y.cpu().numpy()
    errs = [gate64(f"f64 matmat {n} column {r}", csrs[n], y[:, r].copy(),
                   x[:, r].copy()) for r in range(3)]
    log(f"gate f64 matmat {n} (k 3): ok, {max(errs):.3e}, launches {cnt}")

    # each f64 kernel against its plain version
    wrap = {"band_f64": kernels.band_spmv, "dense_f64": kernels.dense_spmv,
            "stream_f64": kernels.stream_spmv}
    plain = {"band_f64": reference.band_reference,
             "dense_f64": reference.dense_reference,
             "stream_f64": reference.stream_rows_reference}
    results = compare_kernels(dev, card, F64_KERNELS, wrap, plain, ops,
                              csrs, launches, per_call, tol=KERNEL_TOL_F64)

    # end to end
    f64_ms = {}
    for n in FLAGSHIP:
        op, x = ops[n], xd[n]
        plan = op.device_plan()
        ms = f64_ms[n] = cuda_ms(lambda: op(x))
        plain_ms = cuda_ms(lambda: reference.spmv_reference(plan, x),
                           iters=3)
        flops = 2.0 * op.nnz
        log(f"e2e f64 {n}: kernels {ms:.4f} ms {flops / ms / 1e6:.2f} "
            f"GFLOPS, plain {plain_ms:.4f} ms {flops / plain_ms / 1e6:.2f} "
            f"GFLOPS, f64 / f32 ms {ms / f32_ms[n]:.2f}, plan "
            f"{op.summary['plan_mbytes']} MB [{card}]")
    return results, ops, f64_ms


def profile_keys(plan) -> list:
    """The profile_engines keys the plan's classes must give, in order."""
    return (["dense"] * (plan.dense is not None)
            + ["band"] * (plan.band is not None)
            + [f"sparse_w{s.width}" for s in plan.sparses]
            + [k for k, st in (("stream", plan.stream),
                               ("stream2", plan.stream2)) if st is not None]
            + ["residual"] * bool(plan.residual.val.shape[0]))


def traced_device_us(profiling, op, calls: int) -> tuple:
    """`profiling.trace_context` around `calls` op(x) with bench.py's x on
    the card, the trace written into a temporary directory under the
    checkout's git-ignored build/: the device time traced in us (kernels,
    fills, copies) and the three largest device items, (name, us)."""
    import tempfile
    import torch
    x = torch.as_tensor(bench_x(op.shape[1]), dtype=op.dtype,
                        device=op.device)
    op(x)
    torch.cuda.synchronize()
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        with profiling.trace_context(d) as prof:
            for _ in range(calls):
                op(x)
        if not list(pathlib.Path(d).glob("*.json")):
            raise AssertionError("trace_context wrote no trace")
    per = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # "void (anonymous namespace)::k<float>(int, ...)" -> "k"
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].split("<")[0]
            name = name.split("::")[-1].strip()
            per[name] = per.get(name, 0.0) + e.self_device_time_total
    return sum(per.values()), sorted(per.items(), key=lambda kv: -kv[1])[:3]


def measurement_phase(dev, card, ops, e2e_ms) -> list:
    """Phase 9 (see the module doc). `ops` and `e2e_ms` are keyed by
    (matrix, "f32" or "f64"); returns the microbenchmark kernels'
    results."""
    import torch
    from tilespmv_tpu_torch.ops.cuda import kernels, reference
    from tilespmv_tpu_torch.scripts import (microbench_gather,
                                            microbench_scatter)
    from tilespmv_tpu_torch.utils import profiling
    g_in = microbench_gather.inputs(device=dev)
    s_in = {arm: microbench_scatter.inputs(arm, device=dev)
            for arm in reference.MB_SCATTER_ARMS}

    # the measurement path, counters reset just before
    log(f"microbenchmarks [{card}]")
    kernels.reset_launch_counts()
    timings = {"microbench_gather": {
        r: microbench_gather.timeit(r, *g_in)
        for r in reference.MB_GATHER_R}}
    timings["microbench_scatter"] = {
        arm: microbench_scatter.timeit(arm, *s_in[arm])
        for arm in reference.MB_SCATTER_ARMS}
    profiles = {key: profiling.profile_engines(op)
                for key, op in ops.items()}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"measurement path launches: {launches}")
    for name in (*MB_KERNELS, *KERNELS, *F64_KERNELS):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "measurement path")

    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    for (n, dt), prof in profiles.items():
        want = profile_keys(ops[n, dt].device_plan())
        if list(prof) != want or not all(v["us"] > 0
                                         for v in prof.values()):
            raise AssertionError(f"profile {n} {dt}: classes "
                                 f"{list(prof)}, expected {want}: {prof}")
        for k, v in prof.items():
            counts = {f: c for f, c in v.items()
                      if f not in ("us", "bytes", "gbps")}
            log(f"profile {n} {dt} {k}: {v['us']:.2f} us, "
                f"{v['bytes'] / 1e6:.2f} MB "
                f"({'within' if v['bytes'] <= l2 else 'over'} the "
                f"{l2 / 1e6:.1f} MB L2), {v['gbps']:.1f} GB/s, "
                f"{json.dumps(counts)} [{card}]")
        total = sum(v["us"] for v in prof.values()) / 1e3
        log(f"profile {n} {dt}: sum of classes {total:.4f} ms, end to end "
            f"{e2e_ms[n, dt]:.4f} ms (phase {5 if dt == 'f32' else 8}) "
            f"[{card}]")

    # device busy share of the main path under trace_context
    for (n, dt), op in ops.items():
        dev_us, top = traced_device_us(profiling, op, TRACE_CALLS)
        if not dev_us > 0:
            raise AssertionError(f"trace {n} {dt}: no device time traced")
        ms = dev_us / TRACE_CALLS / 1e3
        log(f"trace {n} {dt}: device {ms:.4f} ms per call over "
            f"{TRACE_CALLS} calls, busy {ms / e2e_ms[n, dt]:.2f} of the "
            f"end to end ms; " + ", ".join(
                f"{k} {v / TRACE_CALLS / 1e3:.4f}" for k, v in top)
            + f" [{card}]")

    # each microbenchmark kernel against its plain version
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    runs = {
        "microbench_gather": {
            r: (lambda n, r=r: kernels.microbench_gather(*g_in, r, n),
                lambda r=r: reference.microbench_gather_reference(*g_in, r))
            for r in reference.MB_GATHER_R},
        "microbench_scatter": {
            arm: (lambda n, a=arm: kernels.microbench_scatter(a, *s_in[a],
                                                              n),
                  lambda a=arm: reference.microbench_scatter_reference(
                      a, *s_in[a]))
            for arm in reference.MB_SCATTER_ARMS},
    }
    inputs = {"microbench_gather": {r: g_in for r in runs[
        "microbench_gather"]}, "microbench_scatter": s_in}
    results = []
    for name, (src, replaces) in MB_KERNELS.items():
        errs, ms, plain_ms, one_ms, bnd = {}, {}, {}, {}, {}
        for v, (run, plain) in runs[name].items():
            wave = sms * kernels.microbench_blocks_per_sm(name, v)
            # per step: the inputs and the (8, 128) result once over the
            # timed launch of 64 waves, and the variant's operations
            nbytes = 8 * 128 * 4 + sum(t.numel() * t.element_size()
                                       for t in inputs[name][v])
            bnd[v] = profiling.roofline(nbytes / (64 * wave),
                                        MB_OPS[name, v], 4)
            before = kernels.launch_counts()[name]
            out = run(wave)
            want = plain()
            torch.cuda.synchronize()
            if kernels.launch_counts()[name] != before + 1:
                raise AssertionError(f"{name} {v}: no launch counted")
            err = errs[v] = float((out - want).abs().max())
            bound = KERNEL_TOL * max(1.0, float(want.abs().max()))
            if not err <= bound:
                raise AssertionError(f"{name} {v}: max |kernel - plain| "
                                     f"{err:.3e} > {bound:.3e}")
            ms[v] = timings[name][v] / 1e6
            plain_ms[v] = cuda_ms(plain, iters=20)
            one_ms[v] = cuda_ms(lambda: run(1), iters=20)
            log(f"kernel {name} {v}: max abs err {err:.3e} (bound "
                f"{bound:.3e}, {wave} steps); per step: kernel "
                f"{ms[v] * 1e6:.3f} ns (whole chip, above) vs plain "
                f"{plain_ms[v] * 1e6:.1f} ns, bound "
                f"{bnd[v]['bound_ms'] * 1e6:.3f} ns by "
                f"{bnd[v]['bound_by']} (share "
                f"{bnd[v]['bound_ms'] / ms[v]:.3f}); a launch of one step "
                f"{one_ms[v]:.4f} ms [{card}]")
        first = next(iter(ms))
        results.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            launches_per_call={"timeit": launches[name] // len(ms)},
            max_abs_err=max(errs.values()),
            ms=ms[first], plain_ms=plain_ms[first],
            bound_ms=bnd[first]["bound_ms"],
            bound_by=bnd[first]["bound_by"], library_ms=None,
            library="none: no one PyTorch call gathers and sums as the "
                    "step does",
            share_of_bound=bnd[first]["bound_ms"] / ms[first],
            ms_by_variant={str(v): t for v, t in ms.items()},
            plain_ms_by_variant={str(v): t for v, t in plain_ms.items()},
            bound_ms_by_variant={str(v): b["bound_ms"]
                                 for v, b in bnd.items()},
            one_step_launch_ms={str(v): t for v, t in one_ms.items()}))
    return results


def run_cli(card, args: list, launched=()) -> str:
    """`cli.main(args)` with the launch counters reset just before; its
    output, each line printed. Fails unless it exits 0 and every kernel
    of `launched` launched."""
    import contextlib
    import io
    import torch
    from tilespmv_tpu_torch import cli
    from tilespmv_tpu_torch.ops.cuda import kernels
    kernels.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    torch.cuda.synchronize()
    out, cnt = buf.getvalue(), kernels.launch_counts()
    for line in out.splitlines():
        log(f"cli: {line}" + (f" [{card}]" if "ms" in line else ""))
    log(f"cli {' '.join(args)}: exit {rc} in {time.perf_counter() - t0:.1f}"
        f" s, launches {json.dumps({k: v for k, v in cnt.items() if v})}")
    if rc != 0:
        raise AssertionError(f"cli {args}: exit {rc}")
    missing = [k for k in launched if not cnt[k]]
    if missing:
        raise AssertionError(f"cli {args}: {missing} never launched")
    return out


def entry_points_phase(dev, card, y_mixed, repo) -> None:
    """Phase 10 (see the module doc); `y_mixed` is phase 3's y of
    mixed_large."""
    import tempfile
    from tilespmv_tpu_torch import TileSpMV
    from tilespmv_tpu_torch.core.serialize import load_lane_plan
    from tilespmv_tpu_torch.examples import cg, pagerank
    from tilespmv_tpu_torch.io import generate
    from tilespmv_tpu_torch.utils.host import csr_transpose
    t_phase = time.perf_counter()
    build = repo / "build"
    build.mkdir(exist_ok=True)
    iters = ["--iters", "20", "--reps", "3"]
    with tempfile.TemporaryDirectory(dir=build) as d:
        plan, tiles, csv = (str(pathlib.Path(d) / f) for f in (
            "plan.npz", "tiles.npz", "results.csv"))
        out = run_cli(card, ["mixed_large", "--profile", "--save-plan", plan,
                             "--save-tiles", tiles, "--csv", csv] + iters,
                      ("dense", "sparse", "stream"))
        if "errcount = 0" not in out or "PASS!" not in out:
            raise AssertionError("cli mixed_large: no errcount = 0 / PASS!")
        rows = pathlib.Path(csv).read_text().splitlines()
        if len(rows) != 1 or rows[0].split(",")[:4] != [
                "mixed_large", "65536", "65536", "1113972"] \
                or len(rows[0].split(",")) != 6:
            raise AssertionError(f"cli results CSV: {rows}")
        out = run_cli(card, ["--load-plan", plan, "mixed_large", "--csv",
                             ""] + iters, ("dense", "sparse", "stream"))
        if "PASS!" not in out:
            raise AssertionError("cli --load-plan mixed_large: no PASS!")
        op = TileSpMV.from_plan(load_lane_plan(plan), device=dev)
        y = op(bench_x(op.shape[1]))
        err = float((y - y_mixed).abs().max())
        bound = KERNEL_TOL * max(1.0, float(y_mixed.abs().max()))
        if not err <= bound:
            raise AssertionError(f"from_plan mixed_large: max |y - phase 3 "
                                 f"y| {err:.3e} > {bound:.3e}")
        log(f"from_plan(load_lane_plan) mixed_large: max |y - phase 3 y| "
            f"{err:.3e} (bound {bound:.3e})")
        run_cli(card, ["banded_large", "--dtype", "f64", "--csv", csv]
                + iters, ("band_f64",))
        rows = pathlib.Path(csv).read_text().splitlines()
        if len(rows) != 2 or not rows[1].startswith("banded_large,"):
            raise AssertionError(f"cli results CSV: {rows}")

    csr = generate.get_matrix("tall_rect")
    op = TileSpMV(csr, device=dev)
    y = bench_x(csr.m)
    want = golden(csr_transpose(csr), y)
    gate("tall_rect .T", op.T(y).cpu().numpy(), want)
    gate("tall_rect rmatvec", op.rmatvec(y).cpu().numpy(), want)
    if op.T.T is not op:
        raise AssertionError("tall_rect: op.T.T is not op")
    log(f"tall_rect ({csr.m} x {csr.n}) .T and rmatvec: ok, A^T "
        f"{op.T.shape}, {json.dumps(op.T.summary['classes'])}")

    err = cg.main(device=dev)
    if not err < 1e-4:
        raise AssertionError(f"CG example: error {err:.3e}")
    err = pagerank.main(device=dev)
    if not err < 1e-6:
        raise AssertionError(f"PageRank example: error {err:.3e}")
    log(f"phase 10 (entry points): {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    try:
        from tilespmv_tpu_torch import TileSpMV, load_mtx
    except ImportError as e:
        print(f"chip_smoke: tilespmv_tpu_torch not importable ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2
    from tilespmv_tpu_torch.core import native
    from tilespmv_tpu_torch.io import generate
    from tilespmv_tpu_torch.ops.cuda import build, kernels, reference
    from tilespmv_tpu_torch.utils.profiling import card_line

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    build.load()
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("native host library (g++) did not build")
    t_gxx = time.perf_counter() - t0
    log(f"build: nvcc {t_nvcc:.1f} s, g++ {t_gxx:.1f} s")

    # 2. plan
    ops, csrs = {}, {}
    for name in FLAGSHIP:
        t0 = time.perf_counter()
        csrs[name] = generate.get_matrix(name)
        t1 = time.perf_counter()
        ops[name] = TileSpMV(csrs[name], device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        log(f"plan {name}: nnz {csrs[name].nnz}, generate {t1 - t0:.1f} s, "
            f"convert+plan+upload {t2 - t1:.1f} s, "
            f"{json.dumps(ops[name].summary['classes'])}")

    # 3. main path, launch counters reset just before
    xs = {n: torch.from_numpy(bench_x(csrs[n].n)).to(dev) for n in FLAGSHIP}
    kernels.reset_launch_counts()
    ys = {n: ops[n](xs[n]) for n in FLAGSHIP}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"main path launches: {launches}")
    for name in KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    per_call = per_call_launches({n: (lambda n=n: ops[n](xs[n]))
                                  for n in FLAGSHIP})
    log(f"launches per op(x): {json.dumps(per_call)}")
    refs = {n: golden(csrs[n], bench_x(csrs[n].n)) for n in FLAGSHIP}
    for n in FLAGSHIP:
        y = ys[n].cpu().numpy()
        gate(n, y, refs[n])
        log(f"gate {n}: ok, max |y - golden| "
            f"{float(np.abs(y - refs[n]).max()):.3e}")

    # 4. each kernel against its plain version, on the card
    wrap = {"band": kernels.band_spmv, "dense": kernels.dense_spmv,
            "sparse": kernels.sparse_spmv, "stream": kernels.stream_spmv}
    plain = {"band": reference.band_reference,
             "dense": reference.dense_reference,
             "sparse": reference.sparse_rows_reference,
             "stream": reference.stream_rows_reference}
    results = compare_kernels(dev, card, KERNELS, wrap, plain, ops, csrs,
                              launches, per_call)

    # 5. end to end
    f32_ms = {}
    for n in FLAGSHIP:
        op, x = ops[n], xs[n]
        plan = op.device_plan()
        ms = cuda_ms(lambda: op(x))
        plain_ms = cuda_ms(lambda: reference.spmv_reference(plan, x),
                           iters=3)
        flops = 2.0 * op.nnz
        f32_ms[n] = ms
        log(f"e2e {n}: kernels {ms:.4f} ms {flops / ms / 1e6:.2f} GFLOPS, "
            f"plain {plain_ms:.4f} ms {flops / plain_ms / 1e6:.2f} GFLOPS "
            f"[{card}]")

    # 6. the .mtx entry point
    csr = load_mtx(str(repo / MTX))
    x = bench_x(csr.n)
    y = TileSpMV(csr, device=dev)(x).cpu().numpy()
    gate(MTX, y, golden(csr, x))
    log(f"mtx {MTX}: {csr.m}x{csr.n} nnz {csr.nnz} ok")

    results += spmm_phase(dev, card, ops, csrs)
    res64, ops64, f64_ms = f64_phase(dev, card, csrs, f32_ms)
    results += res64
    results += measurement_phase(
        dev, card, {**{(n, "f32"): ops[n] for n in FLAGSHIP},
                    **{(n, "f64"): ops64[n] for n in FLAGSHIP}},
        {**{(n, "f32"): f32_ms[n] for n in FLAGSHIP},
         **{(n, "f64"): f64_ms[n] for n in FLAGSHIP}})

    entry_points_phase(dev, card, ys["mixed_large"], repo)

    log(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
