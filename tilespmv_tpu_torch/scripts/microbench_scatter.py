"""Scatter microbenchmark on the card: the stream kernel's round walk
against the offsets encoding.

Port of scripts/microbench_scatter.py (the reference's TPU
rounds-vs-offs microbenchmark); the kernel is
ops/cuda/csrc/microbench_scatter.cu and its plain version
reference.microbench_scatter_reference. One step walks S = 13 slabs of
a csum block (104, 128) f32 with the int8 index planes pe (2496, 128):

  rounds:      per (round t < 8, slab s): 2 lane gathers of csum, a
               subtract and a sublane gather (stream.cu's round walk);
  offs:        per slab: 2 lane gathers and a subtract into diff, then 8
               lane gathers of diff, each pick's sum rolled by d sublanes;
  offs_nodep:  offs with the picks reading csum (no diff dependency);
  offs_noroll: offs without the rolls.

    python -m tilespmv_tpu_torch.scripts.microbench_scatter [ARM ...]

(all four arms by default). Times each arm by the difference over two
grid sizes of WAVES[0] and WAVES[1] whole waves (a wave: SM count *
resident blocks per SM), and prints the card's name and power limit,
then per arm:

    rounds      : ... ns/slab (... us/step); ... SM-ns/slab

ns/slab is the chip's time per step over S, with every SM running steps
together; us/step is the same per step; SM-ns/slab is ns/slab times the
SM count, the time one SM spends on one slab. rounds draws its lane
indices from [0, 8), as the reference script does, where stream.cu's
planes span [0, 128): its bank conflicts are not the real kernel's.
Inputs are drawn from np.random.default_rng(seed). Needs a CUDA device:
exits 2 without one, and never times the plain version in the kernel's
place.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.cuda import kernels
from ..ops.cuda.reference import (LANES, MB_PE_ROWS, MB_SCATTER_ARMS,
                                  MB_SLABS, SUBS)
from ..utils.profiling import card_line, step_time

WAVES = (4, 64)


def inputs(arm: str, seed: int = 0, device=None) -> tuple:
    """csum (104, 128) float32 uniform [0, 1), pe (2496, 128) int8
    uniform in [0, 8) for rounds and [0, 128) otherwise, as the reference
    script draws them, but seeded."""
    rng = np.random.default_rng(seed)
    csum = rng.random((MB_SLABS * SUBS, LANES), dtype=np.float32)
    pe = rng.integers(0, SUBS if arm == "rounds" else LANES,
                      (MB_PE_ROWS, LANES)).astype(np.int8)
    return (torch.from_numpy(csum).to(device),
            torch.from_numpy(pe).to(device))


def timeit(arm: str, csum: torch.Tensor, pe: torch.Tensor) -> float:
    """Time `arm` on the card (csum, pe on it); prints its line and
    returns ns per step (of MB_SLABS slabs)."""
    sms = torch.cuda.get_device_properties(csum.device).multi_processor_count
    per_sm = kernels.microbench_blocks_per_sm("microbench_scatter", arm)
    wave = sms * per_sm
    ns = 1e9 * step_time(
        lambda n: kernels.microbench_scatter(arm, csum, pe, n),
        WAVES[0] * wave, WAVES[1] * wave)
    print(f"{arm:12s}: {ns / MB_SLABS:7.3f} ns/slab  "
          f"({ns / 1e3:.4f} us/step); {ns * sms / MB_SLABS:8.1f} "
          f"SM-ns/slab ({per_sm} blocks/SM)", flush=True)
    return ns


def main(argv=None) -> int:
    arms = (sys.argv[1:] if argv is None else argv) or list(MB_SCATTER_ARMS)
    bad = [a for a in arms if a not in MB_SCATTER_ARMS]
    if bad:
        print(f"microbench_scatter: unknown arm(s) {bad}; arms are "
              f"{MB_SCATTER_ARMS}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("microbench_scatter: needs a CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    for arm in arms:
        timeit(arm, *inputs(arm, device="cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
