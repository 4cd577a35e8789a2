"""Measure the lane planner's routing arms on the card, for refitting its
cost model (lane_plan.COST).

Port of scripts/calibrate_cost.py. For each matrix it forces every
"densify bands >= theta" routing (lane_plan.ROUTE_FORCE_THETA, theta 0
to len(W_CHOICES)), times the whole operator with
`bench.harness.benchmark_op` (CUDA-graph replay), then times the two
automatic arms, ROUTE_MODE "fixed" (the default) and "model", and
prints each arm's regret against the best forced theta (flagged above
10%), and the model arm's per-class times (`profile_engines`). It
changes no default: the globals are restored after every operator.

    python -m tilespmv_tpu_torch.scripts.calibrate_cost [names...]

Exits 2 without a card unless given `--device cpu` (the plain versions,
host-clock times: a check of the script, not a measurement).
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..bench.harness import benchmark_op
from ..io import generate
from ..ops.cuda import lane_plan
from ..ops.spmv import TileSpMV
from ..utils.profiling import card_line, profile_engines

NB = len(lane_plan.W_CHOICES)
NAMES = ["mixed_large", "ell_medium", "uniform_sparse",
         "dense_blocks_medium", "mixed_medium"]


def run(csr, device: str, iters: int, theta=None, mode=None):
    """(operator, BenchResult) with the routing globals set, then
    restored."""
    old_t, old_m = lane_plan.ROUTE_FORCE_THETA, lane_plan.ROUTE_MODE
    try:
        lane_plan.ROUTE_FORCE_THETA = theta
        if mode is not None:
            lane_plan.ROUTE_MODE = mode
        op = TileSpMV(csr, backend="pallas", device=device)
        return op, benchmark_op(op, warmup=1, timed_reps=3,
                                iters_per_rep=iters)
    finally:
        lane_plan.ROUTE_FORCE_THETA, lane_plan.ROUTE_MODE = old_t, old_m


def classes(op) -> list:
    plan = op.device_plan()
    out = [f"W{s.width}:{s.val.shape[0]}c" for s in plan.sparses]
    if plan.dense is not None:
        out.append(f"D:{plan.dense.val.shape[0]}cT{plan.dense.t_lanes}")
    return out


def calibrate(name: str, device: str = "cuda", iters: int = 100) -> dict:
    """One matrix's table: {"theta": {theta: (ms, classes)}, "fixed" and
    "model": (ms, regret, classes), "best_theta"}; printed as it goes."""
    csr = generate.get_matrix(name)
    rows = {}
    for theta in range(NB + 1):
        op, res = run(csr, device, iters, theta=theta)
        rows[theta] = (res.ms, classes(op))
        print(f"{name} theta={theta}: {res.ms:.4f} ms  {rows[theta][1]}",
              flush=True)
    best = min(rows, key=lambda t: rows[t][0])
    out = {"theta": rows, "best_theta": best}
    for mode in ("fixed", "model"):
        op, res = run(csr, device, iters, mode=mode)
        regret = res.ms / rows[best][0] - 1.0
        flag = "" if regret <= 0.10 else "  ** REGRET > 10% **"
        print(f"{name} auto[{mode}]: {res.ms:.4f} ms {classes(op)} "
              f"(best theta={best} {rows[best][0]:.4f} ms, "
              f"regret {regret:+.1%}){flag}", flush=True)
        out[mode] = (res.ms, regret, classes(op))
        if mode == "model":
            for k, v in profile_engines(op).items():
                extra = {kk: vv for kk, vv in v.items()
                         if kk not in ("us", "bytes", "gbps")}
                print(f"    {k:12s} {v['us']:9.1f} us  {extra}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("names", nargs="*", default=NAMES)
    p.add_argument("-d", "--device", choices=("cuda", "cpu"),
                   default="cuda")
    p.add_argument("--iters", type=int, default=100,
                   help="op(x) calls per timed rep")
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("calibrate_cost: no CUDA card (pass -d cpu to check the "
                  "script on the plain versions)", file=sys.stderr)
            return 2
        print(card_line(), flush=True)
    for name in args.names:
        calibrate(name, args.device, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
