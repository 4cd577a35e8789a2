#!/usr/bin/env python3
"""Runs one cell of BENCHMARK.json once and prints its result as the last
line of standard output, one JSON object.

    python3 benchmark/run.py --workload kron21.loop1 --seed 7 \\
        --seconds 10 --trace 0

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics: the glue from an untraced window, the rest from a torch.profiler
trace of a second window. The numbers compared
against the reference are printed beside their limits as the last lines
of standard error. Exits 2, printing no result, without a CUDA card or
with fewer cards than the cell asks for, and 3 where a module of JAX or
of tilespmv_tpu is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout, not this folder, is where imports start
sys.path[0] = str(ROOT)
# kernel caches that torch itself keeps, at fixed paths in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(ROOT / "build" / "benchmark" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness
    man = harness.manifest()
    cell, config, traffic = harness.resolve(args.workload, man)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(man, cell, config, traffic, args.seed,
                                     args.seconds, bool(args.trace), "cuda",
                                     T0)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"modules loaded that the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
