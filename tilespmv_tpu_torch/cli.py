"""Benchmark / validation command-line tool.

Port of tilespmv_tpu/cli.py, the equivalent of the reference's benchmark
binary (reference: src/main.cu:15-205, usage `./test -d <device>
matrix.mtx`): loads a matrix, converts it, validates the CPU tiled path
exactly against the scalar CSR golden model (tilespmv_cpu.h:274-284),
runs the operator on the card (or, with `-d cpu`, the kernels' plain
versions on the CPU), checks it at 1% relative tolerance
(main.cu:186-197), prints runtime + GFLOPS and appends to results.csv
(tilespmv_cuda.h:1141-1147).

Usage:
    python -m tilespmv_tpu_torch.cli [options] <matrix.mtx | corpus-name>
    python -m tilespmv_tpu_torch.cli --sweep    # whole synthetic corpus

Without a CUDA card it fails unless given `-d cpu`; it never falls back
to the CPU by itself.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from .bench.harness import append_results_csv, benchmark_op
from .bench.sweep import sweep
from .config import TileConfig
from .core.convert import tile_create
from .core.serialize import (load_lane_plan, load_tile_matrix,
                             save_lane_plan, save_tile_matrix)
from .io import generate, mmio
from .ops.cpu_reference import spmv_cpu
from .ops.spmv import TileSpMV
from .utils.profiling import profile_engines

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# options of the reference this package does not serve yet, with the
# ROADMAP.md item that ports them
NOT_PORTED = {
    "scaling": "--scaling (multi-device) is not ported yet: ROADMAP.md "
               "A.12",
    "bf16": "--dtype bf16 is not ported yet: ROADMAP.md A.14",
    "tile_size": "--tile-size other than 16 (the reference's XLA "
                 "engines) is not ported yet: ROADMAP.md A.13",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tilespmv_tpu_torch",
        description="tiled SpMV benchmark/validation tool (PyTorch, "
                    "CUDA)")
    p.add_argument("matrix", nargs="?",
                   help=".mtx path or synthetic corpus name")
    p.add_argument("--sweep-dir", default=None, metavar="DIR",
                   help="benchmark every .mtx/.mtx.gz under DIR "
                        "(recursive) into the results CSV — the "
                        "drop-in real-corpus mode (reference "
                        "bench0.sh over the SuiteSparse list)")
    p.add_argument("--sweep-manifest", default=None, metavar="CSV",
                   help="benchmark the matrices of an id,group,name,"
                        "rows,cols,nnz manifest (the reference's "
                        "2757-matrix.csv schema; ships as "
                        "tilespmv_tpu/bench/suitesparse_2757.csv — "
                        "fetch the corpus with "
                        "scripts/fetch_suitesparse.py)")
    p.add_argument("--matrix-dir", default=".", metavar="DIR",
                   help="with --sweep-manifest: corpus root holding "
                        "<group>/<name>/<name>.mtx (bench0.sh layout; "
                        "falls back to <name>.mtx directly under DIR)")
    p.add_argument("--sweep", action="store_true",
                   help="benchmark the whole synthetic corpus")
    p.add_argument("--scaling", action="store_true",
                   help="strong-scaling sweep over devices (not ported "
                        "yet)")
    p.add_argument("-d", "--device", default="cuda",
                   choices=["cuda", "cpu"],
                   help="where the operator runs (reference main.cu -d): "
                        "the CUDA card (default; fails without one) or "
                        "the kernels' plain versions on the CPU")
    p.add_argument("--dtype", default="f32",
                   choices=["f32", "f64", "bf16"])
    p.add_argument("--tile-size", type=int, default=16)
    p.add_argument("--force-format", default=None,
                   choices=["csr", "coo", "ell", "dns"],
                   help="bypass the selector (forced-format mode)")
    p.add_argument("--truncate-rows", action="store_true",
                   help="truncate rows to a tile multiple "
                        "(reference main.cu:71 parity)")
    p.add_argument("--iters", type=int, default=100,
                   help="SpMVs per timed repetition")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--csv", default="results.csv",
                   help="append results here ('' disables)")
    p.add_argument("--no-check", action="store_true",
                   help="skip correctness validation")
    p.add_argument("--device-check", action="store_true",
                   help="full-vector device check over the whole "
                        "synthetic corpus")
    p.add_argument("--profile", action="store_true",
                   help="per-format-class cost breakdown "
                        "(reference DEBUG_FORMATCOST parity)")
    p.add_argument("--save-tiles", default=None, metavar="PATH.npz",
                   help="checkpoint the converted TileMatrix")
    p.add_argument("--load-tiles", default=None, metavar="PATH.npz",
                   help="load a converted TileMatrix instead of converting")
    p.add_argument("--save-plan", default=None, metavar="PATH.npz",
                   help="checkpoint the compiled LanePlan (plan build is "
                        "the largest host cost on large matrices)")
    p.add_argument("--load-plan", default=None, metavar="PATH.npz",
                   help="load a LanePlan (written by either package) "
                        "instead of converting+planning (skips the CPU "
                        "check)")
    p.add_argument("--resume", action="store_true",
                   help="with --sweep-dir/--sweep-manifest: skip "
                        "matrices that already have a row in --csv "
                        "(restart an interrupted sweep where it "
                        "stopped; pairs with --plan-cache)")
    p.add_argument("--plan-cache", default=None, metavar="DIR",
                   help="with --sweep-dir: reuse cached plans from DIR "
                        "(written on first visit, keyed by file name + "
                        "dtype)")
    p.add_argument("--x-pattern", default="mod10",
                   choices=["mod10", "ones", "random"],
                   help="mod10 matches the reference's main.cu "
                        "(main.cu:93-97)")
    return p


def _load(name: str):
    if name in generate.CORPUS:
        return generate.get_matrix(name)
    return mmio.load_mtx(name)


def _bench_line(res) -> str:
    """The reference's result line (its Mnnz/ms printed Gnnz/s times
    1e3; 1 Gnnz/s is 1 Mnnz/ms), with eager_ms and the spread."""
    qual = "" if res.reliable else "  [UNRELIABLE]"
    return (f"TileSpMV: {res.ms:.4f} ms, {res.gflops:.2f} GFLOPS, "
            f"{res.gnnz_per_s:.2f} Mnnz/ms, "
            f"{res.gbytes_per_s:.1f} GB/s "
            f"({res.roofline_frac:.1%} of {res.chip} HBM roofline); "
            f"eager {res.eager_ms:.4f} ms, spread {res.spread:.1%}{qual}")


def _gate(y_golden: np.ndarray, y_dev: np.ndarray) -> int:
    """Rows outside the reference's 1% gate (main.cu:186-197)."""
    bad = np.abs(y_golden - y_dev) > 0.01 * np.abs(y_dev) + 1e-6
    return int(bad.sum())


def _sweep_files(args) -> list:
    """The matrix files of --sweep-manifest or --sweep-dir; prints what
    was found. Empty when none was."""
    if args.sweep_manifest:
        # reference bench0.sh: iterate the manifest rows over a local
        # UFget-layout mirror; rows whose file is absent are counted and
        # skipped (a partial fetch still sweeps)
        import csv as _csv
        files, missing = [], 0
        with open(args.sweep_manifest, newline="") as f:
            for row in _csv.reader(f):
                if len(row) < 3 or not row[0].strip().isdigit():
                    continue
                group, name = row[1].strip(), row[2].strip()
                cands = [os.path.join(args.matrix_dir, group, name,
                                      f"{name}.mtx"),
                         os.path.join(args.matrix_dir, f"{name}.mtx")]
                hit = next((c for c in cands if os.path.exists(c)), None)
                if hit is None:
                    missing += 1
                else:
                    files.append(hit)
        if not files:
            print(f"error: no manifest matrices found under "
                  f"{args.matrix_dir} (fetch them with "
                  f"scripts/fetch_suitesparse.py)", file=sys.stderr)
        else:
            print(f"sweeping {len(files)} manifest matrices "
                  f"({missing} not fetched)")
        return files
    files = sorted(
        glob.glob(os.path.join(args.sweep_dir, "**", "*.mtx"),
                  recursive=True)
        + glob.glob(os.path.join(args.sweep_dir, "**", "*.mtx.gz"),
                    recursive=True))
    if not files:
        print(f"error: no .mtx files under {args.sweep_dir}",
              file=sys.stderr)
    else:
        print(f"sweeping {len(files)} matrices under {args.sweep_dir}")
    return files


def _sweep_dir(args, dev, dtype, config) -> int:
    files = _sweep_files(args)
    if not files:
        return 2
    if args.plan_cache:
        os.makedirs(args.plan_cache, exist_ok=True)
    done: set = set()
    if args.resume and args.csv and os.path.exists(args.csv):
        # results.csv schema: name,m,n,nnz,ms,gflops (append-only); a
        # name present = that matrix completed in a prior run
        with open(args.csv) as f:
            done = {line.split(",", 1)[0] for line in f if "," in line}
    failures = skipped = 0
    for path in files:
        if os.path.basename(path) in done:
            skipped += 1
            continue
        try:
            cpath = None
            if args.plan_cache:
                cpath = os.path.join(
                    args.plan_cache,
                    f"{os.path.basename(path)}.{args.dtype}.plan.npz")
            if cpath and os.path.exists(cpath):
                op = TileSpMV.from_plan(load_lane_plan(cpath), device=dev,
                                        dtype=dtype)
            else:
                op = TileSpMV(_load(path), device=dev, dtype=dtype,
                              config=config)
                if cpath:
                    save_lane_plan(cpath, op.device_plan())
            res = benchmark_op(
                op, name=os.path.basename(path),
                iters_per_rep=args.iters, timed_reps=args.reps,
                warmup=args.warmup)
            print(f"{res.name}: ms={res.ms:.4f} eager_ms={res.eager_ms:.4f} "
                  f"GFLOPS={res.gflops:.2f} reliable={res.reliable}")
            if args.csv:
                if res.reliable:
                    append_results_csv(args.csv, res)
                else:
                    # noise-floor row: surfaced but never recorded
                    # (append_results_csv refuses it); NOT a failure
                    print(f"  not recorded (spread={res.spread:.2f} over "
                          "the reliability gate)", file=sys.stderr)
        except Exception:
            failures += 1
            print(f"FAILED: {path}", file=sys.stderr)
            traceback.print_exc()
    if skipped:
        print(f"resumed: {skipped} matrices already in {args.csv}")
    print(f"sweep-dir done: {len(files) - failures}/{len(files)} ok")
    return 0 if failures == 0 else 1


def _device_check(dev, dtype, config) -> int:
    """The reference's gate (main.cu:186-197) on every corpus
    archetype, with the full y vector, on `dev`."""
    bad_total = 0
    for name in sorted(generate.CORPUS):
        csr = generate.get_matrix(name)
        op = TileSpMV(csr, device=dev, dtype=dtype, config=config)
        x = (np.arange(csr.n) % 10) / 4.0
        y = op(x).cpu().numpy().astype(np.float64)
        ref = csr.matvec(x)
        bad = int(np.sum(np.abs(ref - y) > 0.01 * np.abs(ref) + 1e-4))
        bad_total += bad
        print(f"{name}: {'PASS' if bad == 0 else f'NO PASS ({bad})'}")
    print("device-check:", "PASS" if bad_total == 0 else "NO PASS")
    return 0 if bad_total == 0 else 1


def _run_plan(args, dev, dtype) -> int:
    """--load-plan: no conversion, no CPU check (the plan carries no
    TileMatrix); checks the device y against the matrix's golden only
    when a matrix is given."""
    t0 = time.perf_counter()
    op = TileSpMV.from_plan(load_lane_plan(args.load_plan), device=dev,
                            dtype=dtype)
    m, n = op.shape
    print(f"plan loaded in {time.perf_counter() - t0:.3f}s: "
          f"m={m} n={n} nnz={op.nnz}")
    x = (np.arange(n) % 10) / 4.0
    if not args.no_check and args.matrix:
        y_golden = _load(args.matrix).matvec(x)[:m]
        errors = _gate(y_golden, op(x).cpu().numpy().astype(np.float64))
        print(f"Check... {'PASS!' if not errors else 'NO PASS'} "
              f"(errors = {errors})")
        if errors:
            return 1
    res = benchmark_op(op, x=x, name=args.matrix or args.load_plan,
                       warmup=args.warmup, timed_reps=args.reps,
                       iters_per_rep=args.iters)
    print(_bench_line(res))
    if args.csv and res.reliable:
        append_results_csv(args.csv, res)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.scaling:
        print(f"error: {NOT_PORTED['scaling']}", file=sys.stderr)
        return 2
    if args.dtype == "bf16":
        print(f"error: {NOT_PORTED['bf16']}", file=sys.stderr)
        return 2
    if args.tile_size != 16:
        print(f"error: {NOT_PORTED['tile_size']}", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA card found; pass -d cpu to run the kernels' "
              "plain versions on the CPU", file=sys.stderr)
        return 2
    dev, dtype = args.device, DTYPES[args.dtype]
    config = TileConfig(tile_size=args.tile_size,
                        force_format=args.force_format,
                        truncate_rows_to_tile=args.truncate_rows)

    if args.sweep:
        sweep(config=config, compute_dtype=dtype, csv_path=args.csv or None,
              device=dev, iters_per_rep=args.iters, timed_reps=args.reps,
              warmup=args.warmup)
        return 0
    if args.sweep_dir or args.sweep_manifest:
        return _sweep_dir(args, dev, dtype, config)
    if args.device_check:
        return _device_check(dev, dtype, config)
    if args.load_plan:
        return _run_plan(args, dev, dtype)
    if not args.matrix:
        print("error: provide a matrix path/name or --sweep",
              file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    csr = _load(args.matrix)
    print(f"input matrix A: ( {csr.m}, {csr.n} ) nnz = {csr.nnz} "
          f"[loaded in {time.perf_counter() - t0:.3f}s]")

    t0 = time.perf_counter()
    if args.load_tiles:
        tm = load_tile_matrix(args.load_tiles)
    else:
        tm = tile_create(csr, config)
    if args.save_tiles:
        save_tile_matrix(args.save_tiles, tm)
    hist = {k: v for k, v in tm.format_histogram().items() if v}
    print(f"tiles: {tm.tilenum} ({tm.tilem} x {tm.tilen} grid) "
          f"formats = {hist} "
          f"residual nnz = {tm.residual.nnz} "
          f"[converted in {time.perf_counter() - t0:.3f}s]")

    x = {
        "mod10": ((np.arange(tm.n) % 10) / 4.0),
        "ones": np.ones(tm.n),
        "random": np.random.default_rng(0).standard_normal(tm.n),
    }[args.x_pattern]

    if not args.no_check:
        # CPU tiled path, exact-equality count vs golden
        # (tilespmv_cpu.h:274-284)
        y_golden = csr.matvec(x)[: tm.m]
        errs = int(np.sum(spmv_cpu(tm, x) != y_golden))
        print(f"CPU TileSpMV errcount = {errs}")

    t0 = time.perf_counter()
    op = TileSpMV(tm, device=dev, dtype=dtype)
    print(f"plan built in {time.perf_counter() - t0:.3f}s")
    if args.save_plan:
        save_lane_plan(args.save_plan, op.device_plan())
        print(f"plan saved to {args.save_plan}")
    t0 = time.perf_counter()
    y_dev = op(x).cpu().numpy().astype(np.float64)
    kind = (torch.cuda.get_device_name(op.device) if op.device.type == "cuda"
            else "cpu")
    print(f"device path ran in {time.perf_counter() - t0:.2f}s "
          f"(dtype={args.dtype}, device={kind})")

    if not args.no_check:
        # 1% relative tolerance gate (main.cu:186-197)
        errors = _gate(csr.matvec(x)[: tm.m], y_dev)
        print(f"Check... {'PASS!' if errors == 0 else 'NO PASS'} "
              f"(errors = {errors})")
        if errors:
            return 1

    if args.profile:
        print("plan summary: " + json.dumps(op.summary))
        print("per-format-class cost profile:")
        for cls_name, stats in profile_engines(op, x=x).items():
            print(f"  {cls_name}: " + "  ".join(
                f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in stats.items()))

    res = benchmark_op(op, x=x, name=args.matrix, warmup=args.warmup,
                       timed_reps=args.reps, iters_per_rep=args.iters)
    print(_bench_line(res))
    if args.csv:
        if res.reliable:
            append_results_csv(args.csv, res)
        else:
            print(f"not recording unreliable row to {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
