"""Interleaved end-to-end A/B harness.

Port of tilespmv_tpu/utils/abtest.py, the reference's way of settling
kernel and routing defaults: time the FULL operation per arm, with the
arms alternated within one process (A, B / B, A / ...) so that slow
drift in the machine's state (clocks, temperature, neighbours on the
host) biases neither arm, each timing by `profiling._timed`'s difference
method. The reference also needed a fresh jit partial per arm, because
flipping a module variable does not re-trace a jit cache; here a fresh
operator per arm (`build_op_variant`) is what a flip needs.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ..ops.spmv import TileSpMV
from .profiling import _timed


def interleaved_ab(arms: Mapping[str, Sequence], rounds: int = 4,
                   verbose: bool = True, **timed_kw) -> dict:
    """Time each arm `rounds` times, interleaved within one process.

    `arms`: name -> (fn, *args). Each timing calls
    profiling._timed(fn, *args, **timed_kw). Round r runs the arms in
    forward order when r is even, reversed when odd, so a drifting
    environment biases neither arm.

    Returns {"times_us": {name: [..]}, "median_us": {name: ..},
    "winner": name, "margin": runner-up / best median ratio}.
    """
    names = list(arms)
    times: dict[str, list] = {k: [] for k in names}
    for r in range(rounds):
        order = names if r % 2 == 0 else list(reversed(names))
        for name in order:
            fn, *args = arms[name]
            dt = _timed(fn, *args, **timed_kw)
            times[name].append(dt * 1e6)
            if verbose:
                print(f"  round {r} {name}: {dt * 1e6:.1f} us",
                      flush=True)
    med = {k: float(np.median(v)) for k, v in times.items()}
    ranked = sorted(med, key=med.get)
    winner = ranked[0]
    margin = (med[ranked[1]] / med[winner]
              if len(ranked) > 1 and med[winner] > 0 else float("inf"))
    if verbose:
        for k in ranked:
            a = np.asarray(times[k])
            print(f"{k}: median {med[k]:.1f} us  min {a.min():.1f}  "
                  f"max {a.max():.1f}", flush=True)
        print(f"winner: {winner} (x{margin:.3f} vs runner-up)",
              flush=True)
    return dict(times_us=times, median_us=med, winner=winner,
                margin=margin)


def spmv_arms(ops: Mapping[str, object], x) -> dict:
    """interleaved_ab arms from {name: TileSpMV}: the full SpMV
    (`op.forward`) on x cast to each operator's dtype and device."""
    return {name: (op.forward, torch.as_tensor(x, dtype=op.dtype,
                                               device=op.device))
            for name, op in ops.items()}


def build_op_variant(csr, module, variants: Mapping[str, object],
                     **op_kw):
    """A fresh TileSpMV(csr, **op_kw) built under temporarily flipped
    module variables (e.g. of ops/cuda/lane_plan.py or stream_plan.py),
    restored afterwards."""
    old = {k: getattr(module, k) for k in variants}
    try:
        for k, v in variants.items():
            setattr(module, k, v)
        return TileSpMV(csr, **op_kw)
    finally:
        for k, v in old.items():
            setattr(module, k, v)
