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

(all four arms by default). The kernel loads csum and pe into shared
memory once a launch and walks the steps on a persistent grid of G
units: one block for the offs arms, a cluster of two for rounds (each
block holds the planes of 4 of the 8 rounds). Times each arm by the
difference over launches of WAVES[0] * G and WAVES[1] * G steps
(kernels.microbench_grid's G: every unit runs the same number of steps,
and the input load cancels), and prints the card's name and power
limit, then per arm:

    rounds      : ... ns/slab (... us/step); floor ... ns/slab (... wavefronts); G=.. units of 2

ns/slab is the chip's time per step over S, with every SM running steps
together; us/step is the same per step; floor is the step's
shared-memory wavefronts on these inputs (`wavefronts`) over every SM
at one a cycle at the highest SM clock, per slab. rounds draws its lane
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
from ..ops.cuda.reference import (LANES, MB_PE_ROWS, MB_ROUNDS,
                                  MB_SCATTER_ARMS, MB_SLABS, SUBS)
from ..utils.profiling import (bank_wavefronts, card_line,
                               shared_floor_ns, step_time)

# steps each unit of the persistent grid runs in the two timed launches
WAVES = (4, 64)
# warps of a block (1024 threads, a target (q, l) each)
WARPS = 1024 // 32


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


def _byte_words(rows):
    """Words of the bytes pe_s[rows, l] for every lane l (rows (..., 128)
    or (..., 1)), 128 bytes a row."""
    return (rows * LANES + np.arange(LANES)) // 4


def wavefronts(arm: str, pe) -> int:
    """Shared-memory wavefronts of one step of `arm` on pe (2496, 128),
    as the kernel walks it: for each warp (32 lanes of one target row q)
    the byte loads from pe (a row of bytes, or for rounds' e and st the
    rows that src picks, four lanes to a bank) and the csum / diff
    gathers (columns in a row's banks; rounds': rows src and columns in
    [0, 8)); offs and offs_noroll also store diff; rounds' second block
    hands its partial to the first (a store and a load of 32 warps)."""
    p = np.asarray(torch.as_tensor(pe).cpu(), dtype=np.int64)
    lanes = np.arange(LANES)
    s = np.arange(MB_SLABS)[:, None, None]
    q = np.arange(SUBS)[None, :, None]
    if arm == "rounds":
        t = np.arange(MB_ROUNDS)[:, None, None, None]
        o = t * 3 * MB_SLABS * SUBS + s * SUBS             # (8, 13, 1, 1)
        r_src = o + 2 * MB_SLABS * SUBS + q                # (8, 13, 8, 1)
        src = p[r_src, lanes] & (SUBS - 1)                 # (8, 13, 8, 128)
        e = p[o + src, lanes] & (LANES - 1)
        st = p[o + MB_SLABS * SUBS + src, lanes] & (LANES - 1)
        words = [_byte_words(r_src), _byte_words(o + src),
                 _byte_words(o + MB_SLABS * SUBS + src),
                 (s * SUBS + src) * LANES + e, (s * SUBS + src) * LANES + st]
        extra = 2 * WARPS
    else:
        base = s * 96                                       # (13, 1, 1)
        words, extra = [], 0
        if arm != "offs_nodep":
            r_e, r_st = base + q, base + SUBS + q
            words += [_byte_words(r_e), _byte_words(r_st),
                      q * LANES + (p[r_e, lanes] & (LANES - 1)),
                      q * LANES + (p[r_st, lanes] & (LANES - 1))]
            extra = MB_SLABS * WARPS                        # diff stores
        for d in range(SUBS):
            i = q if arm == "offs_noroll" else (q - d) % SUBS
            r_c = base + (2 + d) * SUBS + i
            words += [_byte_words(r_c),
                      i * LANES + (p[r_c, lanes] & (LANES - 1))]
    return extra + sum(int(bank_wavefronts(w.reshape(-1, 32)).sum())
                       for w in words)


def timeit(arm: str, csum: torch.Tensor, pe: torch.Tensor) -> float:
    """Time `arm` on the card (csum, pe on it); prints its line and
    returns ns per step (of MB_SLABS slabs)."""
    units, cluster = kernels.microbench_grid("microbench_scatter", arm)
    ns = 1e9 * step_time(
        lambda n: kernels.microbench_scatter(arm, csum, pe, n),
        WAVES[0] * units, WAVES[1] * units)
    w = wavefronts(arm, pe)
    floor = shared_floor_ns(w, csum.device)
    print(f"{arm:12s}: {ns / MB_SLABS:7.3f} ns/slab  "
          f"({ns / 1e3:.4f} us/step); floor {floor / MB_SLABS:.3f} "
          f"ns/slab ({w} wavefronts); G={units} units of {cluster}",
          flush=True)
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
