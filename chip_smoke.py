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
   rtol 2e-4 / atol 1e-4);
4. kernels — each class kernel against its plain PyTorch version on the
   card, on the flagship plan that uses it and a seeded uniform(-1, 1)
   x (bench.py's dyadic x makes every f32 sum exact): one launch per
   class, max |kernel - plain| <= 1e-5 * max(1, max|plain|) (the bound
   allows for atomics adding in any order), and the median time of each
   (CUDA events, after warm-up);
5. end to end — median ms and GFLOPS (2*nnz/t) per matrix for the
   kernel path and for the plain path;
6. .mtx — tests/fixtures/bcsstk_style_sym.mtx through load_mtx and
   TileSpMV against the golden.

Prints the card's name and power limit (nvidia-smi), then one JSON line
of per-kernel results, then the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA device or the repo.
"""
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

FLAGSHIP = ("banded_large", "powerlaw_large", "mixed_large")
# kernel vs plain version on the card: the order of float32 atomic adds
KERNEL_TOL = 1e-5
# end to end vs the float64 CSR golden (tests/test_pallas.py's bound)
GOLD_RTOL, GOLD_ATOL = 2e-4, 1e-4
_SRC = "tilespmv_tpu_torch/ops/cuda/csrc/"
_TPU = "tilespmv_tpu/ops/pallas/kernels.py:"
# name: (source, TPU kernel it replaces, matrix whose plan runs it)
KERNELS = {
    "band": (_SRC + "band.cu", _TPU + "772", "banded_large"),
    "stream": (_SRC + "stream.cu", _TPU + "1853", "powerlaw_large"),
    "dense": (_SRC + "dense.cu", _TPU + "679", "mixed_large"),
    "sparse": (_SRC + "sparse.cu", _TPU + "724", "mixed_large"),
}
MTX = "tests/fixtures/bcsstk_style_sym.mtx"


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_x(n: int) -> np.ndarray:
    """bench.py's x: ((i % 10) / 4) as float32."""
    return ((np.arange(n) % 10) / 4.0).astype(np.float32)


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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def class_lists(plan) -> dict:
    """The plan's classes per kernel name."""
    return {"band": [plan.band] if plan.band is not None else [],
            "dense": [plan.dense] if plan.dense is not None else [],
            "sparse": list(plan.sparses),
            "stream": [s for s in (plan.stream, plan.stream2)
                       if s is not None]}


def class_bytes(cls) -> int:
    """Bytes of a class's plan tensors (what one call must read)."""
    return sum(t.numel() * t.element_size()
               for f in dataclasses.fields(cls)
               if hasattr(t := getattr(cls, f.name), "element_size"))


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
    for name, cnt in launches.items():
        if cnt == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
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
             "sparse": reference.sparse_reference,
             "stream": reference.stream_reference}
    results = []
    for kname, (src, replaces, mname) in KERNELS.items():
        plan = ops[mname].device_plan()
        classes = class_lists(plan)[kname]
        if not classes:
            raise AssertionError(f"{mname}'s plan has no {kname} class")
        xr = np.random.default_rng(0).uniform(-1, 1, csrs[mname].n)
        xp = reference.pad_x(plan, torch.from_numpy(
            xr.astype(np.float32)).to(dev))
        ylen = max(plan.y_padded_len, plan.n_stream_windows * 1024)
        yk = torch.zeros(ylen, device=dev)
        yp = torch.zeros(ylen, device=dev)
        before = kernels.launch_counts()[kname]
        for c in classes:
            wrap[kname](c, xp, yk)
            plain[kname](c, xp, yp)
        torch.cuda.synchronize()
        delta = kernels.launch_counts()[kname] - before
        if delta != len(classes):
            raise AssertionError(f"{kname}: {delta} launches for "
                                 f"{len(classes)} classes")
        err = float((yk - yp).abs().max())
        bound = KERNEL_TOL * max(1.0, float(yp.abs().max()))
        rel = float(((yk - yp).abs() / yp.abs().clamp(min=1e-30)).max())
        if not err <= bound:
            raise AssertionError(f"{kname}: max |kernel - plain| {err:.3e}"
                                 f" > {bound:.3e}")

        def run(fns, y=yk):
            for c in classes:
                fns(c, xp, y)
        ms = cuda_ms(lambda: run(wrap[kname]), iters=20)
        plain_ms = cuda_ms(lambda: run(plain[kname], yp), iters=3)
        mb = sum(class_bytes(c) for c in classes) / 1e6
        log(f"kernel {kname} on {mname} ({len(classes)} class(es), "
            f"{mb:.1f} MB of plan, launches +{delta}): max abs err {err:.3e} (bound "
            f"{bound:.3e}), max rel err {rel:.3e}, {ms:.4f} ms "
            f"({mb / ms:.0f} GB/s) vs plain {plain_ms:.4f} ms [{card}]")
        results.append(dict(name=kname, route="cuda", source=src,
                            replaces=replaces, launches=launches[kname],
                            max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # 5. end to end
    for n in FLAGSHIP:
        op, x = ops[n], xs[n]
        plan = op.device_plan()
        ms = cuda_ms(lambda: op(x))
        plain_ms = cuda_ms(lambda: reference.spmv_reference(plan, x),
                           iters=3)
        flops = 2.0 * op.nnz
        log(f"e2e {n}: kernels {ms:.4f} ms {flops / ms / 1e6:.2f} GFLOPS, "
            f"plain {plain_ms:.4f} ms {flops / plain_ms / 1e6:.2f} GFLOPS "
            f"[{card}]")

    # 6. the .mtx entry point
    csr = load_mtx(str(repo / MTX))
    x = bench_x(csr.n)
    y = TileSpMV(csr, device=dev)(x).cpu().numpy()
    gate(MTX, y, golden(csr, x))
    log(f"mtx {MTX}: {csr.m}x{csr.n} nnz {csr.nnz} ok")

    log(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
