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
   scatter}.py's `timeit`: every R and every arm, ns per step over
   launches of 4 and 64 steps a unit of the persistent grid,
   `kernels.microbench_grid`) and `utils.profiling.profile_engines` on
   the trio in f32 and f64; microbench_gather, microbench_scatter and
   every SpMV class kernel must have launched, and every class of each
   plan must be profiled with us > 0; each class's bytes printed
   against the card's L2 size, the sum of the class times beside phase
   5's and phase 8's end-to-end ms; `utils.profiling.trace_context`
   around TRACE_CALLS op(x) per matrix and dtype must trace device time,
   whose share of the end-to-end ms (the device's busy share) is
   printed with the largest device items; then each microbenchmark
   kernel against its plain version on the card for every R and arm,
   one launch each of 1, G - 1, G + 1 and MB_CHECK_STEPS steps (G: the
   grid's units; the phase-4 bound), with the kernel's time per step
   (the scripts' number), the plain version's time for one step, the
   time of a launch of one step, the bound per step (the variant's
   operations over the FP32 peak, its inputs once over the timed
   launch), the shared-memory floor per step (the scripts'
   `wavefronts` over every SM at the highest SM clock) and the time of
   a launch of 2n steps over that of n = MB_RATIO_STEPS * G, which must
   exceed 1.5 (each step's work stays in its step); no one
   PyTorch call computes a step, so these rows have no library call.
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
   and the phase's seconds;
11. bf16 — the trio planned through `TileSpMV(csr, device="cuda",
   dtype=torch.bfloat16)` (the f32 plan with bf16 values), plan MB and
   classes printed; with the launch counters reset just before, one
   `op(x)` per matrix with bench.py's x and one `op.matmat(X)` at k = 8
   (bench_xs): every bf16 kernel (band_bf16, dense_bf16, sparse_bf16,
   stream_bf16 and the four SpMM ones) must have launched, and y and
   every column of Y must pass max |y - golden| <= 2^-8 |golden| + 1e-6
   element by element against the float64 golden (the values and x are
   quarters, so every f32 sum is exact and only y's one rounding to bf16
   remains); then each bf16 kernel against its plain version on its f32
   y (KERNEL_TOL, x rounded to bf16) as in phases 4 and 7, with its
   time, launches per call, the bound (2-byte values, f32 x and y), the
   plain version's time, the f32 kernel's time from phase 4 or 7 beside
   it, and two cuSPARSE calls: the library time, f32 on the
   bf16-rounded nonzeros (the function the kernels compute, held to the
   plain version), and a bf16 `torch.sparse_csr_tensor` product beside
   it (its error printed, not gated: cuSPARSE sums bf16 at lower
   precision than the kernels; where torch raises, its error is
   printed); end to end per matrix, bf16 ms per
   SpMV (cuda_ms, as phase 5 times it, x held in bf16) between two
   timings of the f32 operator (x in f32), the device ms per bf16 call
   under `trace_context` and its busy share, and matmat at k = 8 against
   8 SpMV calls; and the CLI with `--dtype bf16` on banded_large (PASS,
   band_bf16 launched).
12. xla engines and forced lane plans — (a) the trio through
   `TileSpMV(csr, device="cuda", backend="xla")` at tile size 16 and
   through `TileConfig(tile_size=8)`, which picks the xla engines
   itself (backend, plan MB and the seconds of conversion and planning
   printed); with the launch counters reset just before, one `op(x)` per
   matrix and tile size must launch no class kernel and pass phase 3's
   gates; f64 on mixed_large at tile size 8 passes phase 8's 1e-12 gate
   (bench and uniform x), bf16 on banded_large max |y - golden| <=
   2^-6 |A|·|x| + 1e-3 element by element (the rows over
   tests/test_plan_spmv.py's 1% + 1e-3 printed: the reference's own
   bf16 y misses that gate at this size, ROADMAP.md C), matmat at
   k = 8 on mixed_large phase 7's gates; per matrix the xla path's ms
   (CUDA-graph replay) and eager_ms (bench/harness.py::benchmark_op)
   beside the lane plan's and one cuSPARSE `torch.mv` on the whole
   matrix; the CLI with `--tile-size 8` on mixed_large and `--backend
   xla` on banded_large (PASS). (b) the trio planned with the reference
   distributed layer's options (force_t=128, use_stream = COO entries >=
   STREAM_MIN_ENTRIES, stream_s_batch=8, stream_span_rows=64) in f32,
   and mixed_large in f64 and bf16, plus use_stream=False on
   powerlaw_large and use_stream=True on mixed_large and banded_large
   (which has no COO entry: an all-inert stream class), each through
   `TileSpMV.from_plan(plan, device="cuda")`: with the counters reset
   just before, op(x) and matmat at k = 8 must launch every class kernel
   the plan holds and pass the golden gates of their dtype; then each
   class kernel against its plain version on the card within KERNEL_TOL
   (f64: KERNEL_TOL_F64), its classes' forced layout and its time
   printed beside its phase 4, 7, 8 or 11 time on the automatic plan.
   The phase's seconds are printed.
13. multi-device — the trio at full size on `make_mesh(4,
   devices=["cuda:0"] * 4)`, four virtual shards of the card
   (tilespmv_tpu_torch/parallel): (a) `DistributedSpMV` in f32 with
   x_mode allgather, replicated, halo and auto, and on mixed_large in
   f64 (allgather, halo) and bf16 (allgather); (b) `DistributedSpMV2D`
   on `make_mesh2d(2, 2, ...)`, the trio in f32 and mixed_large in f64.
   Each operator is built (its seconds of conversion, planning and
   upload, the global use_stream, each shard's plan MB and classes, the
   halo's max_pk and traffic_ratio and the x bytes exchanged per call
   printed); with the launch counters reset just before its first
   op(x), every class kernel its shard plans hold must launch, and y
   must pass phase 3's gates (f32), phase 8's 1e-12 (f64) or phase 11's
   2^-8 (bf16), and lie within KERNEL_TOL (f64: KERNEL_TOL_F64) times
   max(1, max|y|) of the single-device operator's y (phases 3, 8); its
   graph ms and eager ms per call (bench/scaling.py::time_op) beside
   the single-device operator's, and their ratio. (c) On mixed_large
   with `TileConfig(tile_size=8)` the xla engines per shard: no class
   kernel may launch, phase 3's gates hold. (d) `scaling_sweep` on
   mixed_large and powerlaw_large at 1, 2 and 4 virtual shards. (e)
   `cli.main(["--scaling", "mixed_large"])` exits 0, and
   `examples.distributed_run.main(quick=True)` passes. Virtual shards
   run one after another on the card: the times measure what
   partitioning costs, not scaling. The phase's seconds are printed.
14. multi-process and routing — (a) `parallel.launch.spawn` starts
   worker processes (this script with --phase14-worker) that join one
   process group by `initialize_multihost` (a file:// rendezvous) and
   build phase 13's 4-position layout over it: on one card 2 processes
   x 2 virtual shards of cuda:0 over gloo (nccl refuses two ranks on
   one card; gloo takes the CUDA tensors and copies them through host
   memory itself), one process per card over nccl where
   two cards are visible; then a world of 1 over nccl (4 shards of the
   card), which runs nccl's all-gather, all-to-all and all-reduce.
   Operators: `DistributedSpMV` in f32 (allgather on mixed_large and
   powerlaw_large, halo and auto on banded_large), mixed_large in f64
   and bf16 (allgather), `DistributedSpMV2D` on mixed_large at (2, 2)
   (rows are processes: psum within each) and, with two processes, at
   (1, 4) (psum across them by all_reduce); the nccl world of 1 runs
   mixed_large allgather, banded_large halo and mixed_large (2, 2).
   Each worker resets the launch counters just before its first op(x);
   every class kernel its shard plans hold must launch, y must pass
   phase 3's gates (f32), phase 8's 1e-12 (f64) or phase 11's 2^-8
   (bf16), and lie within KERNEL_TOL (f64: KERNEL_TOL_F64; bf16: one
   bf16 rounding, 2^-8 |y|, more) times max(1, max|y|) of phase 13's
   one-process y on the same layout ((1, 4): phase 3's y). Printed per
   operator: the backend, world size and positions, each process's
   build seconds and plan MB, its launches per kernel, the errors, and
   the slowest process's eager ms per call (bench/scaling.py::time_op)
   beside phase 13's one-process eager ms. On one card over gloo this
   measures host copies and process overhead, not scaling. A worker
   that fails, or outlives its time limit, fails the run. (b)
   mixed_large planned under ROUTE_MODE "model" and under each
   ROUTE_FORCE_THETA 0..len(W_CHOICES): each plan's class kernels must
   launch and y pass phase 3's gates; its classes and graph ms are
   printed beside the fixed arm's. The phase's seconds are printed.
15. planner arms — the reference planner's layouts that the port loads
   but does not build, each from a file the reference wrote
   (tests/fixtures/arm_plans, listed in its manifest.json; written by
   tests/make_arm_plans.py on the CPU) through `load_lane_plan` and
   `TileSpMV.from_plan(plan, device="cuda")`. (a) The stream y-scatter
   encodings offs and roll: power_law(2048, 2048, 10, seed=6) in f32,
   bf16 (`as_bf16` of the f32 plan) and f64 (the reference's df64
   file); every stream class's erow must equal the port's own (rounds)
   plan's. (b) The prefix route of the dense and W-classes: mixed_medium
   (dense, W24) and block_random(2048, 2048, 0.05, 0.33, seed=5) (dense,
   W96) in f32 and bf16. For each plan, with the launch counters reset
   just before, one op(x) and (f32, bf16) one matmat at k = 8: the
   kernels of the arm (stream and stream2; dense, sparse, dense_spmm and
   sparse_spmm; in the plan's dtype) must launch, and y and Y pass phase
   3's gates (f32), phase 8's 1e-12 (f64) or phase 11's 2^-8 (bf16);
   each of those kernels against its plain version on every class of its
   kind, with a seeded uniform(-1, 1) x, within KERNEL_TOL (f64:
   KERNEL_TOL_F64) of max(1, max|plain|); its graph ms beside the port's
   own plan's (in turns: own, arm, arm, own), and the plan MB of both.
   (c) `rectangular(262144, 4194304, 8)` as one plan and with
   max_cols_per_plan = 2^21 and 2^20 (2 and 4 column parts): y passes
   phase 3's gates, with its graph ms, eager ms (CUDA events over a loop
   of calls), plan MB and build seconds. The phase's seconds are
   printed.

Prints the card's name and power limit (nvidia-smi), then one JSON line
of per-kernel results (launches on the main path and per call, error,
ms, plain_ms, bound_ms and bound_by, library_ms, share of bound; a
"forced" list per kernel: plan, error, ms and the automatic plan's ms;
an "arms" dict per kernel that phase 15 ran: per arm, matrix and dtype,
error, ms and the default plan's ms; "distributed_launches": the SpMV kernels' launches over phase 13's
main-path calls; "multiprocess_launches": over phase 14's, summed over
its workers) with an "xla" entry per matrix (ms and eager_ms at
tile sizes 16 and 8, the lane plan's, cuSPARSE's, conversion and
planning seconds) and a "distributed" entry per matrix (per operator:
ms, eager ms, the single-device operator's, error, traffic_ratio,
exchanged bytes; the sweep's points), a "multiprocess" list (phase 14
(a), per operator and world), a "routing" entry (phase 14 (b)) and an
"arms" entry (phase 15: per arm, matrix and dtype, plan MB and the op(x)
and matmat graph ms beside the default plan's; the column parts' rows),
then the last line
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
# bf16 y against the float64 golden: rtol (y's one rounding) and atol
BF16_GOLD_RTOL, BF16_GOLD_ATOL = 2.0 ** -8, 1e-6
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
# the bf16 kernels: (source, TPU kernel it replaces with bf16 values and
# f32 sums, matrices whose plans run it), SpMV then SpMM at K_MM
BF16_KERNELS = {
    "band_bf16": (_SRC + "band.cu", _TPU + "772", ("banded_large",)),
    "dense_bf16": (_SRC + "dense.cu", _TPU + "679", ("mixed_large",)),
    "sparse_bf16": (_SRC + "sparse.cu", _TPU + "724", ("mixed_large",)),
    "stream_bf16": (_SRC + "stream.cu", _TPU + "1853",
                    ("powerlaw_large", "mixed_large")),
}
BF16_SPMM_KERNELS = {
    "band_spmm_bf16": (_SRC + "band_spmm.cu", _TPU + "860",
                       ("banded_large",)),
    "dense_spmm_bf16": (_SRC + "dense_spmm.cu", _TPU + "1015",
                        ("mixed_large",)),
    "sparse_spmm_bf16": (_SRC + "sparse_spmm.cu", _TPU + "1042",
                         ("mixed_large",)),
    "stream2_bf16": (_SRC + "stream2.cu", _TPU + "1555",
                     ("powerlaw_large",)),
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
# the largest step count at which phase 9 holds each microbenchmark
# kernel to its plain version
MB_CHECK_STEPS = 300
# steps a unit of its persistent grid runs in phase 9's launch of n steps
# that a launch of 2n is held against
MB_RATIO_STEPS = 1024
# right-hand sides of the SpMM phase's plan-level runs and comparisons
K_MM = 8
# op(x) calls per matrix and dtype in phase 9's trace
TRACE_CALLS = 20
# phase 12's tile size below 16, where TileSpMV picks the xla engines
XLA_TILE = 8
# the xla path's bf16 y against the float64 golden: its engines sum in
# bf16 as the reference's do, a few roundings of 2^-8 a row, so
# |y - golden| <= 2^-6 |A|·|x| + 1e-3 (tests/test_torch_bf16_slice.py's
# bound; the reference test's 1% gate fails for the reference's own y at
# this size, ROADMAP.md C)
XLA_BF16_RTOL, XLA_BF16_ATOL = 2.0 ** -6, 1e-3
MTX = "tests/fixtures/bcsstk_style_sym.mtx"
# phase 13's mesh: this many virtual shards of the one card
VIRTUAL_SHARDS = 4
# phase 14's worlds: (matrix, x mode or 2-D grid, dtype) per operator
MP_SPECS = [("mixed_large", "allgather", "f32"),
            ("powerlaw_large", "allgather", "f32"),
            ("banded_large", "halo", "f32"), ("banded_large", "auto", "f32"),
            ("mixed_large", "allgather", "f64"),
            ("mixed_large", "allgather", "bf16"),
            ("mixed_large", "2d", "f32"), ("mixed_large", "2d_1x4", "f32")]
NCCL1_SPECS = [("mixed_large", "allgather", "f32"),
               ("banded_large", "halo", "f32"), ("mixed_large", "2d", "f32")]
# seconds a phase-14 world may take, build included
MP_TIMEOUT = 300
# phase 15: the reference's plan files of the planner arms, and the
# kernels that run each arm's layout (SpMV, then SpMM at K_MM)
ARM_PLANS = pathlib.Path("tests") / "fixtures" / "arm_plans"
ARM_KERNELS = {"offs": ("stream", "stream2"), "roll": ("stream", "stream2"),
               "prefix": ("dense", "sparse", "dense_spmm", "sparse_spmm")}
# phase 15 (c): the wide matrix and its column-partition limits
COL_PARTS_MATRIX = (262144, 4194304, 8)
COL_PARTS_LIMITS = (None, 1 << 21, 1 << 20)


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
    cl.update({k + "_bf16": cl[k] for k in (
        "band", "dense", "sparse", "stream", "band_spmm", "dense_spmm",
        "sparse_spmm", "stream2")})
    return cl


def gate_mm(name: str, csr, y: np.ndarray, x: np.ndarray) -> None:
    """gate() on every column of Y = A @ X."""
    if y.shape != (csr.m, x.shape[1]):
        raise AssertionError(f"{name}: Y has shape {y.shape}")
    for r in range(x.shape[1]):
        gate(f"{name} column {r}", y[:, r], golden(csr, x[:, r]))


# plan fields a kernel does not read: the stream kernels read erow and
# not the round planes; the dense kernels not cfirst
_UNREAD = {**{k: ("planes", "cfirst") for k in (
    "stream", "stream_f64", "stream2", "stream_bf16", "stream2_bf16")},
    **{k: ("cfirst",) for k in (
        "dense", "dense_f64", "dense_spmm", "dense_bf16", "dense_spmm_bf16")}}
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
                "mv" if k is None else "mm") + (
                ", f32 on the bf16 values" if kname.endswith("_bf16")
                else ""),
            share_of_bound=r0["bound_ms"] / r0["ms"],
            kernel_over_library=r0["ms"] / r0["library_ms"]))
        for f in ("ms_by_group", "by_class", "ab", "library_bf16_ms",
                  "library_bf16_err", "library_bf16_error"):
            if f in r0:
                results[-1][f] = r0[f]
        if len(runs) > 1:
            results[-1]["by_matrix"] = {
                m: {f: r[f] for f in ("ms", "call_ms", "plain_ms",
                                      "bound_ms", "library_ms",
                                      "library_bf16_ms", "by_class")
                    if f in r}
                for m, r in zip(mnames, runs)}
    return results


def library_mats(classes, xp, ylen: int, dtype) -> list:
    """One torch sparse CSR matrix per class on xp's device: the class's
    nonzeros (reference.class_coo) as `dtype`, int32 indices, shape
    (ylen, rows of xp). The yardstick's input only: the port never calls
    it."""
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
            torch.from_numpy(val[order]).to(xp.device, dtype),
            size=(ylen, xp.shape[0])))
    return mats


def library_ms(kname: str, lib) -> float:
    """The library call's device time: graph_ms, or CUDA events where
    cuSPARSE refuses the graph capture."""
    from tilespmv_tpu_torch.utils import profiling
    try:
        return profiling.graph_ms(lib)
    except RuntimeError as e:
        log(f"library {kname}: no graph capture ({e}); timed by events")
        return cuda_ms(lib, iters=20)


def compare_on(dev, card, kname, wrap, plain, op, csr, mname, k,
               tol) -> dict:
    """compare_kernels on one matrix: {"err", "ms", "plain_ms",
    "bound_ms", "bound_by", "library_ms"} (and the stream kernel's
    "ms_by_group"). x is rounded to the plan's value dtype (bf16 for a
    bf16 plan, as the operator rounds it) and padded in its compute
    dtype. The bound is utils.profiling.class_bound over the classes'
    nonzeros at k; the library call is one cuSPARSE SpMV (`torch.mv`) or
    SpMM (`@`) per class on library_mats in the plan's compute dtype
    (for a bf16 plan: float32 on the bf16-rounded values, the function
    the kernels compute), checked against the plain version within
    `tol`, and timed the same way as the kernel. A bf16 plan also runs
    the same product on bf16 values and x (y in bf16, a coarser
    function): its time in "library_bf16_ms" and its max error against
    the plain version in "library_bf16_err", not gated; where torch
    raises on it, "library_bf16_error" holds the error."""
    import torch
    from tilespmv_tpu_torch.ops.cuda import kernels, reference
    from tilespmv_tpu_torch.utils import profiling
    plan = op.device_plan()
    classes = class_lists(plan)[kname]
    if not classes:
        raise AssertionError(f"{mname}'s plan has no {kname} class")
    rhs = () if k is None else (k,)
    xr = np.random.default_rng(0).uniform(-1, 1, (csr.n,) + rhs)
    xp = reference.pad_x(plan, torch.from_numpy(xr).to(dev, plan.dtype))
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
    def product(mats, xl):
        return lambda: sum(torch.mv(a, xl) if k is None else a @ xl
                           for a in mats)
    mats = library_mats(classes, xp, ylen, xp.dtype)
    lib = product(mats, xp)
    lerr = float((lib() - yp).abs().max())
    if not lerr <= bound:
        raise AssertionError(f"{kname}: max |library - plain| {lerr:.3e}"
                             f" > {bound:.3e}")
    lib16 = None
    if plan.dtype == torch.bfloat16:
        try:
            lib16 = product(library_mats(classes, xp, ylen, plan.dtype),
                            xp.to(plan.dtype))
            out["library_bf16_err"] = float((lib16() - yp).abs().max())
        except (RuntimeError, NotImplementedError) as e:
            lib16 = None
            out["library_bf16_error"] = (f"{type(e).__name__}: "
                                         f"{e}").splitlines()[0]
            log(f"library {kname}: torch refuses the bf16 product "
                f"({out['library_bf16_error']})")
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
    lib_ms = out["library_ms"] = library_ms(kname, lib)
    if lib16 is not None:
        out["library_bf16_ms"] = library_ms(kname, lib16)
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
    lib_txt = (f"library {lib_ms:.4f} ms (max abs err {lerr:.3e}), kernel /"
               f" library {ms / lib_ms:.2f}")
    if "library_bf16_ms" in out:
        lib_txt += (f"; bf16 library {out['library_bf16_ms']:.4f} ms (max "
                    f"abs err {out['library_bf16_err']:.3e})")
    elif "library_bf16_error" in out:
        lib_txt += f"; bf16 library: {out['library_bf16_error']}"
    log(f"kernel {kname} on {mname} ({len(classes)} class(es), "
        f"{mb:.1f} MB of plan read, launches +{delta}"
        f"{'' if k is None else f', k {k}'}): max abs err {err:.3e} "
        f"(bound {bound:.3e}), max rel err {rel:.3e}, {ms:.4f} ms "
        f"({mb / ms:.0f} GB/s; {call_ms:.4f} ms a call with the wrapper's "
        f"host time) vs plain {plain_ms:.4f} ms; bound "
        f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
        f"({bnd['bytes'] / 1e6:.2f} MB, {bnd['flops'] / 1e6:.2f} MFLOP), "
        f"share of bound {bnd['bound_ms'] / ms:.3f}; {lib_txt} [{card}]")
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

    # each microbenchmark kernel against its plain version, at step counts
    # that leave most units idle (1), some with a step more (G - 1, G + 1)
    # and every unit busy (MB_CHECK_STEPS)
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
        errs, ms, plain_ms, one_ms, bnd, floor_ms, ratio = (
            {}, {}, {}, {}, {}, {}, {})
        for v, (run, plain) in runs[name].items():
            script = (microbench_gather if name == "microbench_gather"
                      else microbench_scatter)
            units, cluster = kernels.microbench_grid(name, v)
            n_timed = script.WAVES[1] * units
            # per step: the inputs and the (8, 128) result once over the
            # timed launch, and the variant's operations
            nbytes = 8 * 128 * 4 + sum(t.numel() * t.element_size()
                                       for t in inputs[name][v])
            bnd[v] = profiling.roofline(nbytes / n_timed, MB_OPS[name, v], 4)
            floor_ms[v] = profiling.shared_floor_ns(
                script.wavefronts(v, inputs[name][v][1]), dev) / 1e6
            want = plain()
            bound = KERNEL_TOL * max(1.0, float(want.abs().max()))
            for n in (1, units - 1, units + 1, MB_CHECK_STEPS):
                if n < 1:
                    continue
                before = kernels.launch_counts()[name]
                out = run(n)
                torch.cuda.synchronize()
                if kernels.launch_counts()[name] != before + 1:
                    raise AssertionError(f"{name} {v}: no launch counted")
                err = float((out - want).abs().max())
                if not err <= bound:
                    raise AssertionError(
                        f"{name} {v}, {n} steps: max |kernel - plain| "
                        f"{err:.3e} > {bound:.3e}")
                errs[v] = max(errs.get(v, 0.0), err)
            ms[v] = timings[name][v] / 1e6
            plain_ms[v] = cuda_ms(plain, iters=20)
            one_ms[v] = cuda_ms(lambda: run(1), iters=20)
            # a step's work stays in the step: twice the steps, twice the
            # time (the launch's fixed cost and input load, tens of us,
            # are small beside MB_RATIO_STEPS steps a unit)
            n_ratio = MB_RATIO_STEPS * units
            ratio[v] = (profiling.launch_time(run, 2 * n_ratio)
                        / profiling.launch_time(run, n_ratio))
            log(f"kernel {name} {v}: max abs err {errs[v]:.3e} (bound "
                f"{bound:.3e}; 1, G - 1, G + 1, {MB_CHECK_STEPS} steps; "
                f"G = {units} units of {cluster}); per step: kernel "
                f"{ms[v] * 1e6:.3f} ns (whole chip, above) vs plain "
                f"{plain_ms[v] * 1e6:.1f} ns, bound "
                f"{bnd[v]['bound_ms'] * 1e6:.3f} ns by "
                f"{bnd[v]['bound_by']} (share "
                f"{bnd[v]['bound_ms'] / ms[v]:.3f}), shared-memory floor "
                f"{floor_ms[v] * 1e6:.3f} ns (share "
                f"{floor_ms[v] / ms[v]:.3f}); {2 * n_ratio} against "
                f"{n_ratio} steps {ratio[v]:.3f}x; a launch of one step "
                f"{one_ms[v]:.4f} ms [{card}]")
            if not ratio[v] > 1.5:
                raise AssertionError(
                    f"{name} {v}: {2 * n_ratio} steps took {ratio[v]:.3f}x "
                    f"the time of {n_ratio}: a step's work left the step")
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
            shared_floor_ms_by_variant={str(v): t
                                        for v, t in floor_ms.items()},
            two_n_over_n={str(v): t for v, t in ratio.items()},
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


def gate_bf16(name: str, y, ref: np.ndarray) -> float:
    """max |y - golden| <= BF16_GOLD_RTOL |golden| + BF16_GOLD_ATOL
    element by element for a bf16 y (tensor) against the float64 golden;
    returns max |y - golden| / max(1, |golden|)."""
    import torch
    if y.dtype != torch.bfloat16 or tuple(y.shape) != ref.shape:
        raise AssertionError(f"{name}: y {y.dtype} {tuple(y.shape)}")
    y = y.float().cpu().numpy().astype(np.float64)
    if not np.isfinite(y).all():
        raise AssertionError(f"{name}: non-finite y")
    err = np.abs(y - ref)
    bad = err > BF16_GOLD_RTOL * np.abs(ref) + BF16_GOLD_ATOL
    if bad.any():
        i = int(np.argmax(bad))
        raise AssertionError(f"{name}: bf16 gate failed on {int(bad.sum())}"
                             f" rows; row {i}: {y[i]} vs {ref[i]}")
    return float(np.max(err / np.maximum(1.0, np.abs(ref))))


def bf16_phase(dev, card, csrs, ops32, f32_results) -> list:
    """Phase 11 (see the module doc); `ops32` are phase 2's f32
    operators and `f32_results` phases 4 and 7's kernel entries. Returns
    the bf16 kernels' results."""
    import torch
    from tilespmv_tpu_torch import TileSpMV
    from tilespmv_tpu_torch.ops.cuda import kernels, reference
    from tilespmv_tpu_torch.utils import profiling
    t_phase = time.perf_counter()
    ops = {}
    for name in FLAGSHIP:
        t0 = time.perf_counter()
        ops[name] = TileSpMV(csrs[name], device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"plan bf16 {name}: convert+plan+upload "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{ops[name].summary['plan_mbytes']} MB, "
            f"{json.dumps(ops[name].summary['classes'])}")

    # main path: op(x) and matmat at K_MM, counters reset just before
    xs = {n: bench_x(csrs[n].n) for n in FLAGSHIP}
    xms = {n: bench_xs(csrs[n].n, K_MM) for n in FLAGSHIP}
    xd = {n: torch.from_numpy(xs[n]).to(dev) for n in FLAGSHIP}
    xmd = {n: torch.from_numpy(xms[n]).to(dev) for n in FLAGSHIP}
    kernels.reset_launch_counts()
    ys = {n: ops[n](xd[n]) for n in FLAGSHIP}
    yms = {n: ops[n].matmat(xmd[n]) for n in FLAGSHIP}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"bf16 main path launches: {launches}")
    for name in (*BF16_KERNELS, *BF16_SPMM_KERNELS):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "bf16 path")
    per_call = per_call_launches({n: (lambda n=n: ops[n](xd[n]))
                                  for n in FLAGSHIP})
    per_mm = per_call_launches({n: (lambda n=n: ops[n].matmat(xmd[n]))
                                for n in FLAGSHIP})
    log(f"launches per bf16 op(x): {json.dumps(per_call)}; per bf16 "
        f"matmat (k {K_MM}): {json.dumps(per_mm)}")
    for n in FLAGSHIP:
        err = gate_bf16(f"bf16 {n}", ys[n], golden(csrs[n], xs[n]))
        errs = [gate_bf16(f"bf16 matmat {n} column {r}", yms[n][:, r],
                          golden(csrs[n], xms[n][:, r]))
                for r in range(K_MM)]
        log(f"gate bf16 {n}: ok, max |y - golden| / max(1, |golden|) "
            f"{err:.3e}; matmat (k {K_MM}) {max(errs):.3e}")

    # each bf16 kernel against its plain version, on its f32 y
    wrap = {"band_bf16": kernels.band_spmv, "dense_bf16": kernels.dense_spmv,
            "sparse_bf16": kernels.sparse_spmv,
            "stream_bf16": kernels.stream_spmv,
            "band_spmm_bf16": kernels.band_spmm,
            "dense_spmm_bf16": kernels.dense_spmm,
            "sparse_spmm_bf16": kernels.sparse_spmm,
            "stream2_bf16": kernels.stream_spmm}
    plain = {"band_bf16": reference.band_reference,
             "dense_bf16": reference.dense_reference,
             "sparse_bf16": reference.sparse_rows_reference,
             "stream_bf16": reference.stream_rows_reference,
             "band_spmm_bf16": reference.band_spmm_reference,
             "dense_spmm_bf16": reference.dense_spmm_reference,
             "sparse_spmm_bf16": reference.sparse_rows_reference,
             "stream2_bf16": reference.stream_rows_reference}
    results = compare_kernels(dev, card, BF16_KERNELS, wrap, plain, ops,
                              csrs, launches, per_call)
    results += compare_kernels(dev, card, BF16_SPMM_KERNELS, wrap, plain,
                               ops, csrs, launches, per_mm, k=K_MM)
    f32 = {r["name"]: r["ms"] for r in f32_results}
    for r in results:
        r["f32_ms"] = f32[r["name"].removesuffix("_bf16")]
        log(f"kernel {r['name']}: {r['ms']:.4f} ms vs the f32 kernel "
            f"{r['f32_ms']:.4f} ms, bf16 / f32 {r['ms'] / r['f32_ms']:.3f}"
            f"; bound {r['bound_ms']:.4f} ms, share "
            f"{r['share_of_bound']:.3f}; library (f32 on the bf16 values) "
            f"{r['library_ms']:.4f} ms, kernel / library "
            f"{r['kernel_over_library']:.3f}; bf16 library "
            + (f"{r['library_bf16_ms']:.4f} ms" if "library_bf16_ms" in r
               else r["library_bf16_error"]) + f" [{card}]")

    # end to end: bf16 (x held in bf16) between two timings of the f32
    # operator, then the bf16 call's device time under trace_context
    for n in FLAGSHIP:
        op, x, xm = ops[n], xd[n], xmd[n]
        x16 = x.to(torch.bfloat16)
        plan = op.device_plan()
        f32_before = cuda_ms(lambda: ops32[n](x))
        ms = cuda_ms(lambda: op(x16))
        f32_after = cuda_ms(lambda: ops32[n](x))
        cols = [xm[:, r].contiguous() for r in range(K_MM)]
        mm_ms = cuda_ms(lambda: op.matmat(xm))
        spmv_ms = cuda_ms(lambda: [op(c) for c in cols])
        plain_ms = cuda_ms(lambda: reference.spmv_reference(plan, x16),
                           iters=3)
        dev_us, top = traced_device_us(profiling, op, TRACE_CALLS)
        dev_ms = dev_us / TRACE_CALLS / 1e3
        flops = 2.0 * op.nnz
        log(f"e2e bf16 {n}: kernels {ms:.4f} ms {flops / ms / 1e6:.2f} "
            f"GFLOPS, f32 {f32_before:.4f} / {f32_after:.4f} ms (before /"
            f" after), bf16 / f32 {2 * ms / (f32_before + f32_after):.3f}, "
            f"plain {plain_ms:.4f} ms; device {dev_ms:.4f} ms per call, "
            f"busy {dev_ms / ms:.2f}; " + ", ".join(
                f"{k} {v / TRACE_CALLS / 1e3:.4f}" for k, v in top)
            + f"; matmat (k {K_MM}) {mm_ms:.4f} ms vs {K_MM} x SpMV "
            f"{spmv_ms:.4f} ms; plan {op.summary['plan_mbytes']} MB "
            f"[{card}]")

    out = run_cli(card, ["banded_large", "--dtype", "bf16", "--csv", "",
                         "--iters", "20", "--reps", "3"], ("band_bf16",))
    if "PASS!" not in out or "dtype=bf16" not in out:
        raise AssertionError("cli banded_large --dtype bf16: no PASS!")
    log(f"phase 11 (bf16): {time.perf_counter() - t_phase:.1f} s [{card}]")
    return results


def xla_phase(dev, card, csrs, ops) -> dict:
    """Phase 12 (a), the xla engines (see the module doc); `ops` are
    phase 2's lane-plan operators. Returns the per-matrix entry of the
    JSON line: the xla path's ms (graph replay) and eager_ms at tile
    sizes 16 and XLA_TILE, the lane plan's beside them, cuSPARSE's on
    the whole matrix, and the seconds of conversion and planning."""
    import torch
    from tilespmv_tpu_torch import TileConfig, TileSpMV
    from tilespmv_tpu_torch.bench.harness import benchmark_op
    from tilespmv_tpu_torch.core.convert import tile_create
    from tilespmv_tpu_torch.ops.cuda import kernels
    xops, tms, out = {}, {}, {n: {} for n in FLAGSHIP}
    for n in FLAGSHIP:
        for b, backend in ((16, "xla"), (XLA_TILE, "auto")):
            t0 = time.perf_counter()
            tms[n, b] = tile_create(csrs[n], TileConfig(tile_size=b))
            t1 = time.perf_counter()
            op = xops[n, b] = TileSpMV(tms[n, b], device=dev,
                                       backend=backend)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if op.backend != "xla":
                raise AssertionError(f"{n} tile {b} backend={backend}: "
                                     f"backend {op.backend}")
            out[n][f"convert_s_{b}"] = t1 - t0
            out[n][f"plan_s_{b}"] = t2 - t1
            out[n][f"plan_mb_{b}"] = op.summary["plan_mbytes"]
            log(f"xla plan {n} tile {b} (backend={backend}): backend "
                f"{op.backend}, convert {t1 - t0:.2f} s, plan+upload "
                f"{t2 - t1:.2f} s, {op.summary['plan_mbytes']} MB, engines "
                f"{json.dumps(op.summary['engines'])}")

    # main path: one op(x) per matrix and tile size, counters reset just
    # before; no class kernel may launch
    xs = {n: bench_x(csrs[n].n) for n in FLAGSHIP}
    xd = {n: torch.from_numpy(xs[n]).to(dev) for n in FLAGSHIP}
    kernels.reset_launch_counts()
    ys = {k: op(xd[k[0]]) for k, op in xops.items()}
    torch.cuda.synchronize()
    cnt = kernels.launch_counts()
    if any(cnt.values()):
        raise AssertionError(f"the xla path launched class kernels: {cnt}")
    for (n, b), y in ys.items():
        if y.device.type != "cuda":
            raise AssertionError(f"xla {n} tile {b}: y on {y.device}")
        ref = golden(csrs[n], xs[n])
        y = y.cpu().numpy()
        gate(f"xla {n} tile {b}", y, ref)
        log(f"gate xla {n} tile {b}: ok, max |y - golden| "
            f"{float(np.abs(y - ref).max()):.3e}, no class kernel launched")

    # f64 on mixed_large, bf16 on banded_large, matmat at K_MM
    n = "mixed_large"
    op64 = TileSpMV(tms[n, XLA_TILE], device=dev, dtype=torch.float64)
    for xn, x in (("bench", xs[n].astype(np.float64)),
                  ("uniform", np.random.default_rng(1).uniform(
                      -1, 1, csrs[n].n))):
        err = gate64(f"xla f64 {n} tile {XLA_TILE} ({xn} x)", csrs[n],
                     op64(x).cpu().numpy(), x)
        log(f"gate xla f64 {n} tile {XLA_TILE}: ok, max |y - golden| / "
            f"(1 + |A||x|) {err:.3e} ({xn} x)")
    xm = bench_xs(csrs[n].n, K_MM)
    gate_mm(f"xla matmat {n} tile {XLA_TILE}", csrs[n], xops[
        n, XLA_TILE].matmat(torch.from_numpy(xm).to(dev)).cpu().numpy(), xm)
    log(f"gate xla matmat {n} tile {XLA_TILE} (k {K_MM}): ok")
    n = "banded_large"
    y16 = TileSpMV(tms[n, XLA_TILE], device=dev, dtype=torch.bfloat16)(
        xd[n])
    ref = golden(csrs[n], xs[n])
    rows = np.repeat(np.arange(csrs[n].m), np.diff(csrs[n].indptr))
    mag = np.bincount(rows, weights=np.abs(
        csrs[n].data * xs[n][csrs[n].indices]), minlength=csrs[n].m)
    err = np.abs(y16.float().cpu().numpy().astype(np.float64) - ref)
    if y16.dtype != torch.bfloat16 or not np.all(
            err <= XLA_BF16_RTOL * mag + XLA_BF16_ATOL):
        raise AssertionError(f"xla bf16 {n}: y {y16.dtype}, worst "
                             f"{float(err.max()):.3e}")
    over = int(np.sum(err > 0.01 * np.abs(ref) + 1e-3))
    log(f"gate xla bf16 {n} tile {XLA_TILE}: ok, max |y - golden| "
        f"{float(err.max()):.3e}, max / (|A||x|) "
        f"{float(np.max(err / np.maximum(mag, 1e-30))):.3e} (bound "
        f"{XLA_BF16_RTOL} |A||x| + {XLA_BF16_ATOL}); rows over the "
        f"reference test's 1% + 1e-3 gate: {over} (not gated: the "
        f"reference's bf16 sums miss it too, ROADMAP.md C)")
    cnt = kernels.launch_counts()
    if any(cnt.values()):
        raise AssertionError(f"the xla path launched class kernels: {cnt}")

    # times: the xla path beside the lane plan and cuSPARSE
    for n in FLAGSHIP:
        csr = csrs[n]
        mat = torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr.astype(np.int32)).to(dev),
            torch.from_numpy(csr.indices.astype(np.int32)).to(dev),
            torch.from_numpy(csr.data).to(dev, torch.float32),
            size=(csr.m, csr.n))
        lib_ms = out[n]["library_ms"] = library_ms(
            "cusparse", lambda: torch.mv(mat, xd[n]))
        lane = benchmark_op(ops[n], x=xs[n], name=n, warmup=2, timed_reps=5,
                            iters_per_rep=20)
        out[n].update(lane_ms=lane.ms, lane_eager_ms=lane.eager_ms)
        for b in (16, XLA_TILE):
            res = benchmark_op(xops[n, b], x=xs[n], name=n, warmup=2,
                               timed_reps=5, iters_per_rep=20)
            out[n][f"ms_{b}"], out[n][f"eager_ms_{b}"] = res.ms, res.eager_ms
            log(f"xla {n} tile {b}: {res.ms:.4f} ms (graph replay), eager "
                f"{res.eager_ms:.4f} ms, spread {res.spread:.1%}; lane plan"
                f" {lane.ms:.4f} ms, eager {lane.eager_ms:.4f} ms; cuSPARSE"
                f" on the whole matrix {lib_ms:.4f} ms; xla / lane "
                f"{res.ms / lane.ms:.2f} [{card}]")

    # the command-line tool
    iters = ["--csv", "", "--iters", "20", "--reps", "3"]
    for args in (["mixed_large", "--tile-size", str(XLA_TILE)],
                 ["banded_large", "--backend", "xla"]):
        text = run_cli(card, args + iters)
        if "PASS!" not in text or "backend=xla" not in text:
            raise AssertionError(f"cli {args}: no PASS! / backend=xla")
    return out


def distributed_options(tm) -> dict:
    """The lane-plan options the reference's distributed layer plans a
    shard with (tilespmv_tpu/parallel/distributed.py:483-498)."""
    from tilespmv_tpu_torch.ops.cuda.lane_plan import STREAM_MIN_ENTRIES
    coo = int(tm.coo.val.shape[0]) if tm.coo.num_tiles else 0
    return dict(force_t=128, use_stream=coo >= STREAM_MIN_ENTRIES,
                stream_s_batch=8, stream_span_rows=64)


def class_shape(kind: str, cls) -> str:
    """The layout numbers of a class that the forcing options pin."""
    if kind.startswith("stream"):
        return (f"S {cls.s_batch} span {cls.span_rows} dual {cls.dual} "
                f"fp {cls.xmap is not None} slabs {cls.nslabs} active "
                f"steps {int(cls.sactive.sum())}/{cls.nsteps}")
    if kind.startswith("band"):
        return f"C {cls.c_cols} chunks {cls.val.shape[0]}"
    w = f"W {cls.width} " if kind.startswith("sparse") else ""
    return (f"{w}T {cls.t_lanes} c_batch {cls.c_batch} K {cls.k_panels} "
            f"chunks {cls.val.shape[0]}")


def forced_phase(dev, card, csrs, results) -> None:
    """Phase 12 (b), lane plans forced by the planner options (see the
    module doc). Adds a "forced" list to each kernel's entry of
    `results`: per plan its error against the plain version, its ms and
    the ms on the automatic plan of the same matrix (phases 4, 7, 8,
    11) where that was timed."""
    import torch
    from tilespmv_tpu_torch import TileSpMV
    from tilespmv_tpu_torch.core.convert import tile_create
    from tilespmv_tpu_torch.ops.cuda import kernels, reference
    from tilespmv_tpu_torch.ops.cuda.lane_plan import build_lane_plan
    from tilespmv_tpu_torch.utils import profiling
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    sfx = {f32: "", f64: "_f64", bf16: "_bf16"}
    tms = {n: tile_create(csrs[n]) for n in FLAGSHIP}
    specs = [(f"{n} f32 distributed", n, f32, distributed_options(tms[n]))
             for n in FLAGSHIP]
    specs += [("mixed_large f64 distributed", "mixed_large", f64,
               distributed_options(tms["mixed_large"])),
              ("mixed_large bf16 distributed", "mixed_large", bf16,
               distributed_options(tms["mixed_large"])),
              ("powerlaw_large f32 use_stream=False", "powerlaw_large", f32,
               dict(use_stream=False)),
              ("mixed_large f32 use_stream=True", "mixed_large", f32,
               dict(use_stream=True)),
              ("banded_large f32 use_stream=True", "banded_large", f32,
               dict(use_stream=True))]
    entry = {r["name"]: r for r in results}
    mats = {k: (m,) if isinstance(m, str) else m
            for t in (KERNELS, SPMM_KERNELS, F64_KERNELS, BF16_KERNELS,
                      BF16_SPMM_KERNELS) for k, (_, _, m) in t.items()}
    wrap = {"band": kernels.band_spmv, "dense": kernels.dense_spmv,
            "sparse": kernels.sparse_spmv, "stream": kernels.stream_spmv,
            "band_spmm": kernels.band_spmm, "dense_spmm": kernels.dense_spmm,
            "sparse_spmm": kernels.sparse_spmm,
            "stream2": kernels.stream_spmm}
    plain = {"band": reference.band_reference,
             "dense": reference.dense_reference,
             "sparse": reference.sparse_rows_reference,
             "stream": reference.stream_rows_reference,
             "band_spmm": reference.band_spmm_reference,
             "dense_spmm": reference.dense_spmm_reference,
             "sparse_spmm": reference.sparse_rows_reference,
             "stream2": reference.stream_rows_reference}
    for label, n, dt, opts in specs:
        csr = csrs[n]
        t0 = time.perf_counter()
        plan = build_lane_plan(tms[n], compute_dtype=str(dt).removeprefix(
            "torch."), **opts)
        t1 = time.perf_counter()
        op = TileSpMV.from_plan(plan, device=dev, dtype=dt)
        torch.cuda.synchronize()
        dplan = op.device_plan()
        cl = class_lists(dplan)
        log(f"forced plan {label} {json.dumps(opts)}: plan {t1 - t0:.1f} s, "
            f"upload {time.perf_counter() - t1:.1f} s, "
            f"{op.summary['plan_mbytes']} MB, "
            f"{json.dumps(op.summary['classes'])}")
        spmv_k = [k for k in ("band", "dense", "sparse", "stream") if cl[k]]
        spmm_k = ([k for k in ("band_spmm", "dense_spmm", "sparse_spmm",
                               "stream2") if cl[k]] if dt != f64 else [])
        # the main path: op(x) and matmat(X), counters reset just before
        x = bench_x(csr.n)
        xm = bench_xs(csr.n, K_MM)
        if dt == f64:
            x, xm = x.astype(np.float64), xm.astype(np.float64)
        kernels.reset_launch_counts()
        y = op(x)
        ym = op.matmat(xm)
        torch.cuda.synchronize()
        cnt = kernels.launch_counts()
        missing = [k + sfx[dt] for k in spmv_k + spmm_k
                   if not cnt[k + sfx[dt]]]
        if missing:
            raise AssertionError(f"forced plan {label}: {missing} never "
                                 f"launched ({cnt})")
        if dt == f32:
            gate(f"forced {label}", y.cpu().numpy(), golden(csr, x))
            gate_mm(f"forced {label} matmat", csr, ym.cpu().numpy(), xm)
        elif dt == f64:
            gate64(f"forced {label}", csr, y.cpu().numpy(), x)
            ymc = ym.cpu().numpy()
            for r in range(K_MM):
                gate64(f"forced {label} matmat column {r}", csr,
                       ymc[:, r].copy(), xm[:, r].copy())
        else:
            gate_bf16(f"forced {label}", y, golden(csr, x))
            for r in range(K_MM):
                gate_bf16(f"forced {label} matmat column {r}", ym[:, r],
                          golden(csr, xm[:, r]))
        log(f"gate forced {label}: ok (y and matmat k {K_MM}), launches "
            f"{json.dumps({k: v for k, v in cnt.items() if v})}")

        # each class kernel against its plain version, and its time
        tol = KERNEL_TOL_F64 if dt == f64 else KERNEL_TOL
        for kind in spmv_k + spmm_k:
            k = None if kind in ("band", "dense", "sparse", "stream") \
                else K_MM
            rhs = () if k is None else (k,)
            xr = np.random.default_rng(0).uniform(-1, 1, (csr.n,) + rhs)
            xp = reference.pad_x(dplan, torch.from_numpy(xr).to(dev, dt))
            ylen = max(dplan.y_padded_len, dplan.n_stream_windows * 1024)
            yk = torch.zeros((ylen,) + rhs, dtype=xp.dtype, device=dev)
            yp = torch.zeros_like(yk)
            for c in cl[kind]:
                wrap[kind](c, xp, yk)
                plain[kind](c, xp, yp)
            torch.cuda.synchronize()
            err = float((yk - yp).abs().max())
            bound = tol * max(1.0, float(yp.abs().max()))
            if not err <= bound:
                raise AssertionError(f"forced {label} {kind}{sfx[dt]}: max "
                                     f"|kernel - plain| {err:.3e} > "
                                     f"{bound:.3e}")
            ms = profiling.graph_ms(lambda: [wrap[kind](c, xp, yk)
                                             for c in cl[kind]])
            name = kind + sfx[dt]
            e = entry[name]
            auto = (e.get("by_matrix", {}).get(n, {}).get("ms")
                    if n in mats[name] else None)
            if auto is None and mats[name][0] == n:
                auto = e["ms"]
            e.setdefault("forced", []).append(dict(
                plan=label, matrix=n, max_abs_err=err, ms=ms,
                auto_ms=auto))
            log(f"kernel {name} on forced {label}"
                f"{'' if k is None else f' (k {k})'}: "
                + "; ".join(class_shape(kind, c) for c in cl[kind])
                + f": max abs err {err:.3e} (bound {bound:.3e}), {ms:.4f} ms"
                + (f" vs {auto:.4f} ms on the automatic plan"
                   if auto is not None else "") + f" [{card}]")


def dist_kernel_names(op) -> set:
    """Names of the SpMV class kernels the shard plans of a distributed
    operator hold (its dtype's instances)."""
    import torch
    sfx = {torch.float32: "", torch.float64: "_f64",
           torch.bfloat16: "_bf16"}[op.dtype]
    out = set()
    for sh in op.shards + (getattr(op, "foreign_shards", None) or []):
        if sh.backend != "pallas":
            continue
        cl = class_lists(sh.device_plan())
        out |= {k + sfx for k in ("band", "dense", "sparse", "stream")
                if cl[k]}
    return out


def dist_shards_line(op) -> str:
    """Per shard: its plan MB and classes (kind and chunks or slabs)."""
    parts = []
    for label, shards in (("", op.shards),
                          ("foreign ", getattr(op, "foreign_shards", None)
                           or [])):
        for d, sh in enumerate(shards):
            cls = " ".join(f"{c['kind']}:{c.get('chunks', c.get('slabs'))}"
                           for c in sh.summary.get("classes", []))
            parts.append(f"{label}{d}: {sh.summary['plan_mbytes']} MB "
                         f"[{cls}]")
    return "; ".join(parts)


def distributed_phase(dev, card, csrs, ys, ops, ops64) -> tuple:
    """Phase 13 (see the module doc); `ys` and `ops` are phase 3's f32 y
    and phase 2's operators, `ops64` phase 8's. Returns the JSON line's
    "distributed" entry, the class kernels' launches summed over the
    phase's main-path calls, and each operator's y on the host by its
    label."""
    import collections
    import torch
    from tilespmv_tpu_torch import TileConfig, TileSpMV
    from tilespmv_tpu_torch.bench.harness import _reps_cuda
    from tilespmv_tpu_torch.bench.scaling import scaling_sweep, time_op
    from tilespmv_tpu_torch.examples import distributed_run
    from tilespmv_tpu_torch.ops.cuda import kernels
    from tilespmv_tpu_torch.parallel import (DistributedSpMV,
                                             DistributedSpMV2D, make_mesh,
                                             make_mesh2d)
    t_phase = time.perf_counter()
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    dname = {f32: "f32", f64: "f64", bf16: "bf16"}
    devices = [dev] * VIRTUAL_SHARDS
    mesh = make_mesh(VIRTUAL_SHARDS, devices=devices)
    launched = collections.Counter()
    out = {n: {} for n in FLAGSHIP}
    single = {}
    kept = {}

    def single_ms(n, dt):
        """Graph and eager ms of the single-device operator."""
        if (n, dt) not in single:
            if dt == bf16:
                op1 = TileSpMV(csrs[n], device=dev, dtype=bf16)
            else:
                op1 = (ops if dt == f32 else ops64)[n]
            xt = torch.from_numpy(bench_x(csrs[n].n)).to(dev, dt)
            g, e = _reps_cuda(op1, xt, 2, 5, 20)
            single[n, dt] = (statistics.median(g), statistics.median(e))
        return single[n, dt]

    def run(label, n, op, dt, plan_s):
        """The main-path call (counters reset just before), its gates
        and its times; returns its JSON entry."""
        csr = csrs[n]
        x = bench_x(csr.n)
        xin = x.astype(np.float64) if dt == f64 else x
        kernels.reset_launch_counts()
        y = op(xin)
        torch.cuda.synchronize()
        cnt = kernels.launch_counts()
        want = dist_kernel_names(op)
        missing = [k for k in want if not cnt[k]]
        if missing:
            raise AssertionError(f"{label}: {missing} never launched "
                                 f"({cnt})")
        launched.update(cnt)
        if y.device != dev:
            raise AssertionError(f"{label}: y on {y.device}")
        kept[label] = y.cpu()
        ref = golden(csr, x)
        if dt == f32:
            yc = y.cpu().numpy()
            gate(label, yc, ref)
            y1 = ys[n].cpu().numpy()
            err = float(np.abs(yc - y1).max())
            bound = KERNEL_TOL * max(1.0, float(np.abs(y1).max()))
        elif dt == f64:
            yc = y.cpu().numpy()
            gate64(label, csr, yc, xin)
            y1 = ops64[n](xin).cpu().numpy()
            err = float(np.abs(yc - y1).max())
            bound = KERNEL_TOL_F64 * max(1.0, float(np.abs(y1).max()))
        else:
            err = gate_bf16(label, y, ref)
            bound = None
        if bound is not None and not err <= bound:
            raise AssertionError(f"{label}: max |y - single-device y| "
                                 f"{err:.3e} > {bound:.3e}")
        ms, eager = time_op(op, x, warmup=2, reps=5, iters=20)
        s_ms, s_eager = single_ms(n, dt)
        halo = getattr(op, "halo", None)
        xb = op.exchange_bytes() if hasattr(op, "exchange_bytes") else None
        log(f"{label}: x_mode {getattr(op, 'x_mode', '2-D')}, "
            f"{'max |y - single-device y| ' if bound else 'bf16 gate err '}"
            f"{err:.3e}, launches "
            f"{json.dumps({k: v for k, v in cnt.items() if v})}; "
            f"{ms:.4f} ms (graph replay), eager {eager:.4f} ms; "
            f"single device {s_ms:.4f} / {s_eager:.4f} ms; ratio "
            f"{ms / s_ms:.2f} / {eager / s_eager:.2f} (virtual shards on "
            f"one card) [{card}]")
        return dict(x_mode=getattr(op, "x_mode", "2d"), ms=ms,
                    eager_ms=eager, single_ms=s_ms, single_eager_ms=s_eager,
                    ratio=ms / s_ms, eager_ratio=eager / s_eager,
                    max_abs_err=err, plan_s=plan_s,
                    traffic_ratio=halo.traffic_ratio if halo else None,
                    max_pk=halo.max_pk if halo else None,
                    exchange_bytes=xb, use_stream=list(op.use_stream))

    # (a) 1-D: the trio in every x mode in f32, mixed_large in f64 and
    # bf16; (b) 2-D on a 2 x 2 mesh
    specs = [(n, m, f32) for n in FLAGSHIP for m in
             ("allgather", "replicated", "halo", "auto")]
    specs += [("mixed_large", "allgather", f64), ("mixed_large", "halo", f64),
              ("mixed_large", "allgather", bf16)]
    specs += [(n, "2d", f32) for n in FLAGSHIP]
    specs += [("mixed_large", "2d", f64)]
    for n, mode, dt in specs:
        t0 = time.perf_counter()
        if mode == "2d":
            op = DistributedSpMV2D(csrs[n], mesh=make_mesh2d(
                2, 2, devices=devices), dtype=dt)
        else:
            op = DistributedSpMV(csrs[n], mesh=mesh, x_mode=mode, dtype=dt)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        label = f"distributed {n} {mode} {dname[dt]}"
        halo = getattr(op, "halo", None)
        log(f"{label}: convert+plan+upload {plan_s:.2f} s, use_stream "
            f"{op.use_stream}"
            + (f", halo max_pk {halo.max_pk} traffic_ratio "
               f"{halo.traffic_ratio:.4f}" if halo else "")
            + (f", x bytes exchanged per call {op.exchange_bytes()}"
               if hasattr(op, "exchange_bytes") else "")
            + f"; shards {dist_shards_line(op)}")
        out[n][f"{mode}_{dname[dt]}"] = run(label, n, op, dt, plan_s)
        del op

    # (c) the xla engines per shard: no class kernel launches
    n = "mixed_large"
    op = DistributedSpMV(csrs[n], mesh=mesh,
                         config=TileConfig(tile_size=XLA_TILE))
    x = bench_x(csrs[n].n)
    kernels.reset_launch_counts()
    y = op(x)
    torch.cuda.synchronize()
    cnt = kernels.launch_counts()
    if op.backend != "xla" or any(cnt.values()):
        raise AssertionError(f"distributed xla: backend {op.backend}, "
                             f"launches {cnt}")
    gate(f"distributed {n} xla tile {XLA_TILE}", y.cpu().numpy(),
         golden(csrs[n], x))
    ms, eager = time_op(op, x)
    out[n]["xla_allgather_f32"] = dict(ms=ms, eager_ms=eager)
    log(f"distributed {n} xla tile {XLA_TILE}: gate ok, no class kernel "
        f"launched; {ms:.4f} ms (graph replay), eager {eager:.4f} ms "
        f"[{card}]")
    del op

    # (d) the sweep, (e) the command-line tool and the example
    for n in ("mixed_large", "powerlaw_large"):
        log(f"scaling sweep {n} (virtual shards on one card) [{card}]:")
        pts = scaling_sweep(csrs[n], device_counts=[1, 2, VIRTUAL_SHARDS],
                            devices=devices)
        out[n]["sweep"] = [dataclasses.asdict(p) for p in pts]
    run_cli(card, ["--scaling", "mixed_large", "--csv", "", "--iters", "20",
                   "--reps", "3"])
    err = distributed_run.main(quick=True)
    if not err < 1e-4:
        raise AssertionError(f"distributed_run: error {err:.3e}")
    log(f"distributed_run.main(quick=True): error {err:.3e}")
    log(f"phase 13 (multi-device, {VIRTUAL_SHARDS} virtual shards): "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return out, launched, kept


def mp_label(n: str, mode: str, dt: str) -> str:
    """Phase 13's label of an operator (phase 14 (a) keeps it)."""
    return f"distributed {n} {mode} {dt}"


def mp_worker(out_dir: str, init: str, backend: str) -> int:
    """One process of a phase-14 world (see the module doc): builds the
    operators of its world on its own shards, checks each against the
    gates and phase 13's y (saved by the parent in `out_dir`), times it,
    and writes its results to out_dir/rank<r>.json. Raises on any
    failure, which the parent's spawn turns into a failed run."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from tilespmv_tpu_torch.bench.scaling import time_op
    from tilespmv_tpu_torch.io import generate
    from tilespmv_tpu_torch.ops.cuda import build, kernels
    from tilespmv_tpu_torch.parallel import (DistributedSpMV,
                                             DistributedSpMV2D, make_mesh,
                                             make_mesh2d)
    from tilespmv_tpu_torch.parallel.mesh import (initialize_multihost,
                                                  local_rank)
    out_dir = pathlib.Path(out_dir)
    initialize_multihost(init, backend=backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", local_rank())
    torch.cuda.set_device(dev)
    build.load()
    shards = [dev] * (VIRTUAL_SHARDS // world)
    dtypes = {"f32": torch.float32, "f64": torch.float64,
              "bf16": torch.bfloat16}
    specs = NCCL1_SPECS if world == 1 else MP_SPECS
    csrs = {n: generate.get_matrix(n) for n in {s[0] for s in specs}}
    results = []
    for n, mode, dt in specs:
        csr, label = csrs[n], mp_label(n, mode, dt)
        t0 = time.perf_counter()
        if mode.startswith("2d"):
            grid = (1, 4) if mode == "2d_1x4" else (2, 2)
            op = DistributedSpMV2D(csr, mesh=make_mesh2d(
                *grid, devices=shards), dtype=dtypes[dt])
        else:
            op = DistributedSpMV(csr, mesh=make_mesh(devices=shards),
                                 x_mode=mode, dtype=dtypes[dt])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        x = bench_x(csr.n)
        xin = x.astype(np.float64) if dt == "f64" else x
        kernels.reset_launch_counts()
        y = op(xin)
        torch.cuda.synchronize()
        cnt = kernels.launch_counts()
        want = dist_kernel_names(op)
        missing = sorted(k for k in want if not cnt[k])
        if missing:
            raise AssertionError(f"rank {rank} {label}: {missing} never "
                                 f"launched ({cnt})")
        ref = golden(csr, x)
        if dt == "f32":
            gate(f"rank {rank} {label}", y.cpu().numpy(), ref)
        elif dt == "f64":
            gate64(f"rank {rank} {label}", csr, y.cpu().numpy(), xin)
        else:
            gate_bf16(f"rank {rank} {label}", y, ref)
        # phase 13's one-process y on the same layout ((1, 4): phase 3's)
        y1 = np.load(out_dir / ((f"single {n}" if mode == "2d_1x4"
                                 else label) + ".npy"))
        yh = y.float().cpu().numpy() if dt == "bf16" else y.cpu().numpy()
        tol = KERNEL_TOL_F64 if dt == "f64" else KERNEL_TOL
        diff = np.abs(yh.astype(np.float64) - y1)
        slack = (BF16_GOLD_RTOL * np.abs(y1) if dt == "bf16"
                 else np.zeros_like(y1))
        bound = tol * max(1.0, float(np.abs(y1).max()))
        if not np.all(diff <= slack + bound):
            raise AssertionError(f"rank {rank} {label}: max |y - phase 13 "
                                 f"y| {diff.max():.3e} over the bound")
        eager, _ = time_op(op, x, warmup=2, reps=5, iters=20)
        results.append(dict(
            label=label, backend=backend, world=world,
            positions=op.mesh.size, build_s=build_s,
            plan_mb=sum(sh.summary["plan_mbytes"] for sh in
                        op.shards + (getattr(op, "foreign_shards", None)
                                     or [])),
            launches={k: v for k, v in cnt.items() if v},
            want=sorted(want), err=float(diff.max()), bound=bound,
            eager_ms=eager))
        del op
    (out_dir / f"rank{rank}.json").write_text(json.dumps(results))
    dist.destroy_process_group()
    return 0


def multiprocess_phase(dev, card, repo, csrs, ys, kept, dist13) -> tuple:
    """Phase 14 (a) (see the module doc); `ys` is phase 3's f32 y, `kept`
    phase 13's ys by label and `dist13` its JSON entry. Returns the JSON
    line's "multiprocess" list and the class kernels' launches summed
    over the workers' main-path calls."""
    import collections
    import tempfile
    import torch
    from tilespmv_tpu_torch.parallel.launch import spawn
    launched = collections.Counter()
    runs = ([("nccl", 2, None)] if torch.cuda.device_count() >= 2
            else [("gloo", 2, lambda r: 0)]) + [("nccl", 1, lambda r: 0)]
    entries = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for n in FLAGSHIP:
            np.save(tmp / f"single {n}.npy", ys[n].cpu().numpy())
        for label, y in kept.items():
            np.save(tmp / f"{label}.npy", y.float().numpy()
                    if y.dtype == torch.bfloat16 else y.numpy())
        for backend, world, lrank in runs:
            wdir = tmp / f"{backend}{world}"
            wdir.mkdir()
            for f in tmp.glob("*.npy"):
                (wdir / f.name).symlink_to(f)
            t0 = time.perf_counter()
            spawn([sys.executable, str(repo / "chip_smoke.py"),
                   "--phase14-worker", str(wdir),
                   (wdir / "store").as_uri(), backend], world,
                  timeout=MP_TIMEOUT, local_rank=lrank, cwd=str(repo))
            wall = time.perf_counter() - t0
            per = [json.loads((wdir / f"rank{r}.json").read_text())
                   for r in range(world)]
            one_card = backend == "gloo"
            log(f"multiprocess world of {world} over {backend}: "
                f"{wall:.1f} s wall, start and build included [{card}]")
            for ops in zip(*per):
                r0 = ops[0]
                n, mode, dt = r0["label"].split()[1:]
                e13 = (None if mode == "2d_1x4" else
                       dist13[n][f"{mode}_{dt}"]["eager_ms"])
                errs = [f"{r['err']:.3e}" for r in ops]
                for r in ops:
                    launched.update(r["launches"])
                log(f"multiprocess {r0['label']}: backend {backend}, "
                    f"world {world}, {r0['positions']} positions "
                    f"({r0['positions'] // world} a process)"
                    + ("; gloo copies the CUDA tensors of its "
                       "collectives through host memory" if one_card else "")
                    + f"; build s {[round(r['build_s'], 2) for r in ops]}, "
                    f"plan MB {[round(r['plan_mb'], 2) for r in ops]}; "
                    f"launches {[r['launches'] for r in ops]}; gates ok, "
                    f"max |y - {'phase 3' if e13 is None else 'phase 13'} "
                    f"y| {errs} (bound "
                    f"{r0['bound']:.3e}); slowest process eager "
                    f"{r0['eager_ms']:.4f} ms"
                    + ("" if e13 is None else
                       f" vs phase 13 one-process eager {e13:.4f} ms")
                    + (" (one card over gloo: host copies and process "
                       "overhead, not scaling)" if one_card else "")
                    + f" [{card}]")
                entries.append(dict(
                    label=r0["label"], backend=backend, world=world,
                    positions=r0["positions"], eager_ms=r0["eager_ms"],
                    phase13_eager_ms=e13,
                    build_s=[r["build_s"] for r in ops],
                    plan_mb=[r["plan_mb"] for r in ops],
                    launches=[r["launches"] for r in ops],
                    max_abs_err=[r["err"] for r in ops], wall_s=wall))
    return entries, launched


def routing_phase(dev, card, csrs, ops) -> dict:
    """Phase 14 (b) (see the module doc): the JSON line's "routing"
    entry."""
    import torch
    from tilespmv_tpu_torch import TileSpMV
    from tilespmv_tpu_torch.core.convert import tile_create
    from tilespmv_tpu_torch.ops.cuda import kernels, lane_plan
    from tilespmv_tpu_torch.utils.profiling import graph_ms
    n = "mixed_large"
    csr = csrs[n]
    x = torch.from_numpy(bench_x(csr.n)).to(dev)
    ref = golden(csr, bench_x(csr.n))
    tm = tile_create(csr)

    classes = class_counts
    fixed_ms = graph_ms(lambda: ops[n](x))
    out = {"fixed": dict(ms=fixed_ms, classes=classes(ops[n]))}
    arms = [("model", "model", None)] + [
        (f"theta {t}", "fixed", t) for t in range(len(lane_plan.W_CHOICES)
                                                 + 1)]
    for label, mode, theta in arms:
        old = lane_plan.ROUTE_MODE, lane_plan.ROUTE_FORCE_THETA
        try:
            lane_plan.ROUTE_MODE, lane_plan.ROUTE_FORCE_THETA = mode, theta
            t0 = time.perf_counter()
            plan = lane_plan.build_lane_plan(tm)
            plan_s = time.perf_counter() - t0
        finally:
            lane_plan.ROUTE_MODE, lane_plan.ROUTE_FORCE_THETA = old
        op = TileSpMV.from_plan(plan, device=dev)
        kernels.reset_launch_counts()
        y = op(x)
        torch.cuda.synchronize()
        cnt = kernels.launch_counts()
        cl = class_lists(op.device_plan())
        missing = [k for k in ("band", "dense", "sparse", "stream")
                   if cl[k] and not cnt[k]]
        if missing:
            raise AssertionError(f"routing {label}: {missing} never "
                                 f"launched ({cnt})")
        gate(f"routing {n} {label}", y.cpu().numpy(), ref)
        ms = graph_ms(lambda: op(x))
        out[label] = dict(ms=ms, classes=classes(op), plan_s=plan_s)
        log(f"routing {n} {label}: classes {classes(op)}; launches "
            f"{json.dumps({k: v for k, v in cnt.items() if v})}; gates "
            f"ok; plan {plan_s:.2f} s; {ms:.4f} ms (graph replay) vs the "
            f"fixed arm's {fixed_ms:.4f} ms ({out['fixed']['classes']}) "
            f"[{card}]")
        del op
    return out


# phase 15: each arm kernel's wrapper, plain version and RHS count
def _arm_pairs() -> dict:
    from tilespmv_tpu_torch.ops.cuda import kernels, reference
    return {"stream": (kernels.stream_spmv,
                       reference.stream_rows_reference, None),
            "stream2": (kernels.stream_spmm,
                        reference.stream_rows_reference, K_MM),
            "dense": (kernels.dense_spmv, reference.dense_reference, None),
            "sparse": (kernels.sparse_spmv,
                       reference.sparse_rows_reference, None),
            "dense_spmm": (kernels.dense_spmm,
                           reference.dense_spmm_reference, K_MM),
            "sparse_spmm": (kernels.sparse_spmm,
                            reference.sparse_spmm_reference, K_MM)}


_ARM_DTYPES = {"f32": "float32", "f64": "float64", "bf16": "bfloat16"}
_ARM_SUFFIX = {"f32": "", "f64": "_f64", "bf16": "_bf16"}


def in_turns(default, arm) -> tuple:
    """(default ms, arm ms): graph_ms of each callable in turns default,
    arm, arm, default, each the mean of its two."""
    from tilespmv_tpu_torch.utils.profiling import graph_ms
    ts = {default: [], arm: []}
    for fn in (default, arm, arm, default):
        ts[fn].append(graph_ms(fn))
    return statistics.mean(ts[default]), statistics.mean(ts[arm])


def arm_gates(label: str, csr, dt: str, y, ym, x, xm) -> None:
    """Phase 3's gates (f32), phase 8's (f64) or phase 11's (bf16) on y
    and, f32 and bf16, on every column of Y (ym) = A @ xm."""
    if dt == "f64":
        gate64(label, csr, y.cpu().numpy(), x)
        return
    if dt == "bf16":
        gate_bf16(label, y, golden(csr, x))
        for r in range(xm.shape[1]):
            gate_bf16(f"{label} column {r}", ym[:, r], golden(csr, xm[:, r]))
        return
    gate(label, y.cpu().numpy(), golden(csr, x))
    gate_mm(label, csr, ym.cpu().numpy(), xm)


def arm_kernel(card, label, kname, sfx, aplan, dplan, tdt, csr, dev) -> dict:
    """Kernel `kname` (in the plan's dtype) on every class of its kind of
    the arm's plan `aplan` against its plain version (a seeded
    uniform(-1, 1) x, KERNEL_TOL or KERNEL_TOL_F64 of max(1,
    max|plain|)), and its graph ms beside that on the default plan
    `dplan`'s classes, in turns; printed and returned."""
    import torch
    from tilespmv_tpu_torch.ops.cuda import reference
    wrap, plain, k = _arm_pairs()[kname]
    classes = class_lists(aplan)[kname]
    dclasses = class_lists(dplan)[kname]
    if not classes or not dclasses:
        raise AssertionError(f"{label}: no {kname} class")
    rhs = () if k is None else (k,)
    xr = np.random.default_rng(0).uniform(-1, 1, (csr.n,) + rhs)
    xp = reference.pad_x(aplan, torch.from_numpy(xr).to(dev, tdt))
    ylen = max(aplan.y_padded_len, aplan.n_stream_windows * 1024)
    yk, yp, yd = (torch.zeros((ylen,) + rhs, dtype=xp.dtype, device=dev)
                  for _ in range(3))
    for c in classes:
        wrap(c, xp, yk)
        plain(c, xp, yp)
    torch.cuda.synchronize()
    err = float((yk - yp).abs().max())
    tol = KERNEL_TOL_F64 if tdt == torch.float64 else KERNEL_TOL
    bound = tol * max(1.0, float(yp.abs().max()))
    if not err <= bound:
        raise AssertionError(f"{label} {kname}{sfx}: max |kernel - plain| "
                             f"{err:.3e} > {bound:.3e}")
    d_ms, a_ms = in_turns(lambda: [wrap(c, xp, yd) for c in dclasses],
                          lambda: [wrap(c, xp, yk) for c in classes])
    log(f"arms {label}: kernel {kname}{sfx} on {len(classes)} class(es)"
        f"{'' if k is None else f', k {k}'}: max abs err {err:.3e} (bound "
        f"{bound:.3e}); {a_ms:.4f} ms vs the default plan's {d_ms:.4f} ms "
        f"({a_ms / d_ms:.3f}x) [{card}]")
    return dict(max_abs_err=err, ms=a_ms, default_ms=d_ms)


def class_counts(op) -> str:
    """The operator's classes as "kind:chunks or slabs" words."""
    return " ".join(f"{c['kind']}:{c.get('chunks', c.get('slabs'))}"
                    for c in op.summary["classes"])


def arms_phase(dev, card) -> tuple:
    """Phase 15 (see the module doc); returns (the JSON line's "arms"
    entry, {kernel: {arm label: its error and times}})."""
    import torch
    from tilespmv_tpu_torch import TileSpMV
    from tilespmv_tpu_torch.core.serialize import load_lane_plan
    from tilespmv_tpu_torch.io import generate
    from tilespmv_tpu_torch.ops.cuda import kernels, lane_plan
    from tilespmv_tpu_torch.utils.profiling import graph_ms

    files = pathlib.Path(__file__).resolve().parent / ARM_PLANS
    out, by_kernel = {}, {}
    for spec in json.loads((files / "manifest.json").read_text()):
        arm, (fn, args, kw) = spec["arm"], spec["matrix"]
        m = spec["file"].rsplit("_", 2)[0]
        csr = getattr(generate, fn)(*args, **kw)
        t0 = time.perf_counter()
        f_plan = load_lane_plan(str(files / spec["file"]))
        load_s = time.perf_counter() - t0
        for dt in (("f64",) if spec["dtype"] == "f64" else ("f32", "bf16")):
            label = f"{arm} {m} {dt}"
            tdt, sfx = getattr(torch, _ARM_DTYPES[dt]), _ARM_SUFFIX[dt]
            plan = lane_plan.as_bf16(f_plan) if dt == "bf16" else f_plan
            op = TileSpMV.from_plan(plan, device=dev, dtype=tdt)
            base = TileSpMV(csr, device=dev, dtype=tdt)
            aplan, dplan = op.device_plan(), base.device_plan()
            # the arm's layout, and (scatter arms) the own plan's erow
            if arm == "prefix":
                routed = [c for c in (aplan.dense, *aplan.sparses)
                          if c is not None]
                if not routed or any(c.route != arm for c in routed):
                    raise AssertionError(f"{label}: not a prefix plan")
            else:
                pairs = list(zip(class_lists(aplan)["stream"],
                                 class_lists(dplan)["stream"]))
                if not pairs or any(a.scatter != arm or not torch.equal(
                        a.erow, d.erow) for a, d in pairs):
                    raise AssertionError(f"{label}: stream classes not "
                                         f"{arm} or erow not the rounds "
                                         "plan's")
            # the arm's run, launch counters reset just before
            x = bench_x(csr.n).astype(np.float64 if dt == "f64"
                                      else np.float32)
            xm = bench_xs(csr.n, K_MM)
            xd = torch.from_numpy(x).to(dev, tdt)
            xmd = torch.from_numpy(xm).to(dev, tdt)
            kernels.reset_launch_counts()
            y = op(xd)
            ym = op.matmat(xmd) if dt != "f64" else None
            torch.cuda.synchronize()
            cnt = kernels.launch_counts()
            names = [k for k in ARM_KERNELS[arm]
                     if class_lists(aplan)[k]
                     and (dt != "f64" or _arm_pairs()[k][2] is None)]
            missing = [k + sfx for k in names if not cnt[k + sfx]]
            if not names or missing:
                raise AssertionError(f"{label}: {missing or 'no class of '}"
                                     f"{ARM_KERNELS[arm]} never launched "
                                     f"({cnt})")
            arm_gates(f"arms {label}", csr, dt, y, ym, x, xm)
            for k in names:
                by_kernel.setdefault(k + sfx, {})[f"{arm} {m}"] = \
                    arm_kernel(card, label, k, sfx, aplan, dplan, tdt, csr,
                               dev)
            d_ms, a_ms = in_turns(lambda: base(xd), lambda: op(xd))
            row = dict(file=spec["file"], plan_mb=op.summary["plan_mbytes"],
                       default_plan_mb=base.summary["plan_mbytes"],
                       load_s=load_s, ms=a_ms, default_ms=d_ms,
                       classes=class_counts(op),
                       default_classes=class_counts(base),
                       launches={k: v for k, v in cnt.items() if v})
            if dt != "f64":
                row["default_matmat_ms"], row["matmat_ms"] = in_turns(
                    lambda: base.matmat(xmd), lambda: op.matmat(xmd))
            out[label] = row
            log(f"arms {label}: gates ok; plan {row['plan_mb']} MB, "
                f"{row['classes']} (own plan {row['default_plan_mb']} MB, "
                f"{row['default_classes']}), loaded in {load_s:.2f} s; "
                f"op(x) {a_ms:.4f} ms vs own plan {d_ms:.4f} ms"
                + (f"; matmat(k {K_MM}) {row['matmat_ms']:.4f} ms vs own "
                   f"plan {row['default_matmat_ms']:.4f} ms"
                   if dt != "f64" else "")
                + f"; launches {json.dumps(row['launches'])} [{card}]")
            del op, base, y, ym

    # (c) column parts of a matrix 4M columns wide
    csr = generate.rectangular(*COL_PARTS_MATRIX)
    x = bench_x(csr.n)
    xd = torch.from_numpy(x).to(dev)
    ref = golden(csr, x)
    rows = []
    for limit in COL_PARTS_LIMITS:
        t0 = time.perf_counter()
        op = TileSpMV(csr, device=dev, max_cols_per_plan=limit)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        y = op(xd)
        torch.cuda.synchronize()
        cnt = kernels.launch_counts()
        parts = op.parts if op.parts is not None else [op]
        for part in parts:
            for k, cl in class_lists(part.device_plan()).items():
                if k in KERNELS and cl and not cnt[k]:
                    raise AssertionError(f"col parts {limit}: {k} never "
                                         f"launched ({cnt})")
        gate(f"col parts {limit}", y.cpu().numpy(), ref)
        ms = graph_ms(lambda: op(xd))
        eager = cuda_ms(lambda: op(xd), iters=20)
        rows.append(dict(limit=limit, parts=len(parts),
                         plan_mb=op.summary["plan_mbytes"], build_s=build_s,
                         ms=ms, eager_ms=eager,
                         launches={k: v for k, v in cnt.items() if v}))
        log(f"arms col parts {csr.m}x{csr.n} nnz {csr.nnz}, "
            f"max_cols_per_plan {limit}: {len(parts)} part(s), "
            f"{op.summary['plan_mbytes']} MB, built in {build_s:.2f} s; "
            f"gates ok; {ms:.4f} ms (graph replay), {eager:.4f} ms eager; "
            f"launches {json.dumps(rows[-1]['launches'])} [{card}]")
        del op, y
    out["col_parts"] = rows
    return out, by_kernel


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--phase14-worker"]:
        return mp_worker(*sys.argv[2:5])
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
    results += bf16_phase(dev, card, csrs, ops, results)

    # 12. the xla engines, and lane plans forced by the planner options
    t_phase = time.perf_counter()
    xla = xla_phase(dev, card, csrs, ops)
    forced_phase(dev, card, csrs, results)
    log(f"phase 12 (xla engines and forced lane plans): "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")

    # 13. the multi-device layer on virtual shards of the card
    dist, dist_launches, kept = distributed_phase(dev, card, csrs, ys, ops,
                                                  ops64)
    for r in results:
        if r["name"] in KERNELS or r["name"] in F64_KERNELS \
                or r["name"] in BF16_KERNELS:
            r["distributed_launches"] = dist_launches[r["name"]]
    for k in ("band", "dense", "sparse", "stream", "dense_f64",
              "stream_f64", "dense_bf16", "sparse_bf16", "stream_bf16"):
        if not dist_launches[k]:
            raise AssertionError(f"phase 13: kernel {k} never launched")

    # 14. one process per shard group over a process group, and the
    # planner's routing arms
    t_phase = time.perf_counter()
    mp, mp_launches = multiprocess_phase(dev, card, repo, csrs, ys, kept,
                                         dist)
    del kept
    for r in results:
        if "distributed_launches" in r:
            r["multiprocess_launches"] = mp_launches[r["name"]]
    for k in ("band", "dense", "sparse", "stream", "dense_f64",
              "stream_f64", "dense_bf16", "sparse_bf16", "stream_bf16"):
        if not mp_launches[k]:
            raise AssertionError(f"phase 14: kernel {k} never launched")
    routing = routing_phase(dev, card, csrs, ops)
    log(f"phase 14 (multi-process and routing): "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")

    # 15. the planner's other arms and the column parts
    t_phase = time.perf_counter()
    arms, arm_kernels = arms_phase(dev, card)
    for r in results:
        if r["name"] in arm_kernels:
            r["arms"] = arm_kernels[r["name"]]
    log(f"phase 15 (planner arms and column parts): "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")

    log(json.dumps({"kernels": results, "xla": xla, "distributed": dist,
                    "multiprocess": mp, "routing": routing, "arms": arms}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
