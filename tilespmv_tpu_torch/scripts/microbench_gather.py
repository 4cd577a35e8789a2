"""Gather microbenchmark on the card: gathers from a table held in
shared memory, against the width R of a row group.

Port of scripts/microbench_gather.py (the reference's TPU lane-gather
microbenchmark); the kernel is ops/cuda/csrc/microbench_gather.cu and
its plain version reference.microbench_gather_reference. One step
gathers src (512, 128) f32 at idx (512, 128) int8 in groups of R rows
and folds the result to (8, 128), for R in {8, 16, 32, 64}: every R
does the same 512 * 128 gathers. The kernel loads src and idx into
shared memory once a launch (two blocks of a cluster hold half each)
and walks the steps on a persistent grid of G clusters; R is the
gathers a thread has in flight, R / 8.

    python -m tilespmv_tpu_torch.scripts.microbench_gather

Times each R by the difference over launches of WAVES[0] * G and
WAVES[1] * G steps (kernels.microbench_grid's G: every cluster runs
the same number of steps, and the input load cancels), and prints the
card's name and power limit, then per R:

    R=  8: ... ns/step, ... ns/gather, ... ns per 8-row group; floor ... ns (... wavefronts); G=.. clusters of 2

ns/step is the chip's time per step with every SM running steps
together; a gather is one group's (R, 128) gather (512/R per step); an
8-row group is 8 gathered rows (64 per step); floor is the step's
shared-memory wavefronts on these inputs (`wavefronts`) over every SM
at one a cycle at the highest SM clock. Inputs are drawn from
np.random.default_rng(seed). Needs a CUDA device: exits 2 without one,
and never times the plain version in the kernel's place.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.cuda import kernels
from ..ops.cuda.reference import LANES, MB_GATHER_R, MB_ROWS, SUBS
from ..utils.profiling import (bank_wavefronts, card_line,
                               shared_floor_ns, step_time)

# steps each unit of the persistent grid runs in the two timed launches
WAVES = (4, 64)
# warps of a block (1024 threads, a target (i, l) each); a cluster has two
WARPS = 1024 // 32


def inputs(seed: int = 0, device=None) -> tuple:
    """src (512, 128) float32 uniform [0, 1), idx (512, 128) int8 uniform
    in [0, 128), as the reference script draws them, but seeded."""
    rng = np.random.default_rng(seed)
    src = rng.random((MB_ROWS, LANES), dtype=np.float32)
    idx = rng.integers(0, LANES, (MB_ROWS, LANES)).astype(np.int8)
    return (torch.from_numpy(src).to(device),
            torch.from_numpy(idx).to(device))


def wavefronts(r: int, idx) -> int:
    """Shared-memory wavefronts of one step of the width-r kernel on idx
    (512, 128): each warp's gather of one row (its 32 lanes' columns,
    idx & 127, in the row's banks), its index loads (R / 8 bytes a
    thread, one load a group of R rows: one wavefront, two at R = 64)
    and the partial the second block hands the first (a store and a
    load of 32 warps)."""
    cols = np.asarray(torch.as_tensor(idx).cpu(), dtype=np.int64)
    words = np.arange(MB_ROWS)[:, None] * LANES + (cols & (LANES - 1))
    gathers = int(bank_wavefronts(words.reshape(-1, 32)).sum())
    per = r // SUBS
    loads = 2 * WARPS * (MB_ROWS // 2 // SUBS // per) * (1 + (per == 8))
    return gathers + loads + 2 * WARPS


def timeit(r: int, src: torch.Tensor, idx: torch.Tensor) -> float:
    """Time width r on the card (src, idx on it); prints its line and
    returns ns/step."""
    units, cluster = kernels.microbench_grid("microbench_gather", r)
    ns = 1e9 * step_time(
        lambda n: kernels.microbench_gather(src, idx, r, n),
        WAVES[0] * units, WAVES[1] * units)
    w = wavefronts(r, idx)
    print(f"R={r:3d}: {ns:8.3f} ns/step, {ns / (MB_ROWS // r):7.4f} "
          f"ns/gather, {ns / (MB_ROWS // 8):6.4f} ns per 8-row group; "
          f"floor {shared_floor_ns(w, src.device):.3f} ns ({w} "
          f"wavefronts); G={units} clusters of {cluster}", flush=True)
    return ns


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench_gather: needs a CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    src, idx = inputs(device="cuda")
    for r in MB_GATHER_R:
        timeit(r, src, idx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
