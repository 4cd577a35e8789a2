"""Corpus sweep runner.

Port of tilespmv_tpu/bench/sweep.py, the equivalent of the reference's
shell-driven SuiteSparse sweep (external/CSR5_cuda/bench0.sh over
2757-matrix.csv): iterates a corpus of matrices, benchmarks each, and
accumulates results.csv (reference schema) plus a structured JSON report
with the extended metrics.
"""
from __future__ import annotations

import json
import time
from typing import Iterable, Optional

import torch

from ..config import TileConfig
from ..core.convert import tile_create
from ..io import generate
from ..ops.spmv import TileSpMV
from .harness import BenchResult, append_results_csv, benchmark_op


def sweep(names: Optional[Iterable[str]] = None,
          config: TileConfig = TileConfig(),
          compute_dtype: torch.dtype = torch.float32,
          csv_path: Optional[str] = "results.csv",
          json_path: Optional[str] = None,
          verbose: bool = True,
          device=None,
          **bench_kw) -> list[BenchResult]:
    """Benchmarks each corpus matrix of `names` (default: all of
    io/generate.py's CORPUS), converted with `config`, through
    `TileSpMV(tm, device, compute_dtype)`; reliable rows go to
    `csv_path`."""
    names = list(names) if names is not None else sorted(generate.CORPUS)
    results = []
    for name in names:
        t0 = time.perf_counter()
        csr = generate.get_matrix(name)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        tm = tile_create(csr, config)
        op = TileSpMV(tm, device=device, dtype=compute_dtype)
        t_convert = time.perf_counter() - t0
        res = benchmark_op(op, name=name, **bench_kw)
        results.append(res)
        if csv_path and res.reliable:
            append_results_csv(csv_path, res)
        if verbose:
            hist = tm.format_histogram()
            qual = ("" if res.reliable else
                    f"  [UNRELIABLE spread={res.spread:.0%} — row NOT "
                    "recorded]")
            print(f"{name}: m={res.m} nnz={res.nnz} "
                  f"ms={res.ms:.4f} eager_ms={res.eager_ms:.4f} "
                  f"GFLOPS={res.gflops:.2f} "
                  f"GB/s={res.gbytes_per_s:.1f} "
                  f"roofline={res.roofline_frac:.1%} "
                  f"(gen {t_load:.2f}s, convert+plan {t_convert:.2f}s) "
                  f"formats={ {k: v for k, v in hist.items() if v} }"
                  f"{qual}")
    if json_path:
        with open(json_path, "w") as f:
            json.dump([r.to_dict() for r in results], f, indent=2)
    return results
