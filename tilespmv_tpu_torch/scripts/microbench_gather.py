"""Gather microbenchmark on the card: shared-memory lane gathers against
the width R of the staged row group.

Port of scripts/microbench_gather.py (the reference's TPU lane-gather
microbenchmark); the kernel is ops/cuda/csrc/microbench_gather.cu and
its plain version reference.microbench_gather_reference. One step
gathers src (512, 128) f32 at idx (512, 128) int8 in groups of R rows
and folds the result to (8, 128), for R in {8, 16, 32, 64}: every R
does the same 512 * 128 gathers.

    python -m tilespmv_tpu_torch.scripts.microbench_gather

Times each R by the difference over two grid sizes of WAVES[0] and
WAVES[1] whole waves (a wave: SM count * resident blocks per SM), and
prints the card's name and power limit, then per R:

    R=  8: ... ns/step, ... ns/gather, ... ns per 8-row group; ... SM-ns/step

ns/step is the chip's time per step with every SM running steps
together; a gather is one group's (R, 128) gather (512/R per step); an
8-row group is 8 gathered rows (64 per step); SM-ns/step is ns/step
times the SM count, the time one SM spends on one step. Inputs are
drawn from np.random.default_rng(seed). Needs a CUDA device: exits 2
without one, and never times the plain version in the kernel's place.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.cuda import kernels
from ..ops.cuda.reference import LANES, MB_GATHER_R, MB_ROWS
from ..utils.profiling import card_line, step_time

WAVES = (4, 64)


def inputs(seed: int = 0, device=None) -> tuple:
    """src (512, 128) float32 uniform [0, 1), idx (512, 128) int8 uniform
    in [0, 128), as the reference script draws them, but seeded."""
    rng = np.random.default_rng(seed)
    src = rng.random((MB_ROWS, LANES), dtype=np.float32)
    idx = rng.integers(0, LANES, (MB_ROWS, LANES)).astype(np.int8)
    return (torch.from_numpy(src).to(device),
            torch.from_numpy(idx).to(device))


def timeit(r: int, src: torch.Tensor, idx: torch.Tensor) -> float:
    """Time width r on the card (src, idx on it); prints its line and
    returns ns/step."""
    sms = torch.cuda.get_device_properties(src.device).multi_processor_count
    per_sm = kernels.microbench_blocks_per_sm("microbench_gather", r)
    wave = sms * per_sm
    ns = 1e9 * step_time(
        lambda n: kernels.microbench_gather(src, idx, r, n),
        WAVES[0] * wave, WAVES[1] * wave)
    print(f"R={r:3d}: {ns:8.3f} ns/step, {ns / (MB_ROWS // r):7.4f} "
          f"ns/gather, {ns / (MB_ROWS // 8):6.4f} ns per 8-row group; "
          f"{ns * sms:9.1f} SM-ns/step ({per_sm} blocks/SM)", flush=True)
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
