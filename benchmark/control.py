#!/usr/bin/env python3
"""The readings that each limit of the check is set from: y_err of the
program on many seeds, and of the control on a few, in every cell of a
configuration, each over a short window of the cell's own loop at the
cell's own size. The control is the program's own path in the nearest
lower precision (the configuration's `control_dtype`): it has to come
out as not correct. The benchmark's runs never run it.

    python3 benchmark/control.py --config kron21 --seeds 11 12 13 \\
        --control-seeds 11 12 13 --seconds 2

Prints one JSON line per seed and side. Runs on the card; exits 2
without one.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(man: dict, config: dict, seed: int, seconds: float,
             control: bool, device: str = "cuda") -> dict:
    """The seed's set-up times, the plan's bytes on the device and,
    under "cells", {cell: {"y_err", "compared", "iters", "ms",
    "nonfinite", "limit"}} of every cell of `config`, the program (or
    the control) built once for the seed."""
    from benchmark import harness
    t = time.perf_counter()
    bench = harness.Bench(config, seed, device,
                          config["control_dtype"] if control else None)
    out = {"seed": seed, "side": "control" if control else "program",
           "setup_s": time.perf_counter() - t, "plan_s": bench.plan_s,
           "nnz": bench.nnz,
           "plan_bytes": sum(b.numel() * b.element_size()
                             for b in bench.op.buffers()),
           "cells": {}}
    for cell in man["workloads"]:
        if cell["config"] != config["name"]:
            continue
        _, _, traffic = harness.resolve(cell["name"], man)
        lp = bench.loop(traffic, seed)
        bench.warm(lp)
        lp.reset(harness.derive_seed(seed, 2, traffic["k"]))
        iters, secs, _ = bench.iterate(lp, seconds)
        samples = [(x.double().cpu().numpy(), y.double().cpu().numpy())
                   for x, y in (s for s in lp.samples if s is not None)]
        gaps = bench.gaps(samples)
        out["cells"][cell["name"]] = {
            "y_err": max(gaps), "compared": len(gaps), "iters": iters,
            "ms": secs * 1e3 / iters, "nonfinite": lp.nonfinite,
            "limit": config["limits"]["y_err"]}
    bench.free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    man = harness.manifest()
    entry = next(c for c in man["configs"] if c["name"] == args.config)
    config = json.loads((ROOT / entry["file"]).read_text())
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            print(json.dumps(readings(man, config, seed, args.seconds,
                                      control)), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout, not this folder, is where imports start
    sys.path[0] = str(ROOT)
    sys.exit(main())
