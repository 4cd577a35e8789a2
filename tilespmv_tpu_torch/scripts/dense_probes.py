"""The dense-class kernel (dense.cu) against copies of it without one or
both of its two savings, on the card.

    python -m tilespmv_tpu_torch.scripts.dense_probes

Builds ops/cuda/csrc/dense.cu as the port does and three copies of it,
each with one or both of two edits (build.build_edited), and runs them
as four arms:

  groups+mask: dense.cu itself, which the wrapper runs: a block for each
               lane group that holds an active tile (`DenseChunks.groups`),
               each tile's zero columns not loaded (`cmask`);
  groups:      the same blocks, every column's values loaded (the mask
               taken as all 16 columns);
  all+mask:    a block for every lane group of the class (`groups` not
               read), a block with no active tile exiting whole;
  all:         both edits.

Every arm computes the same y. Runs them on the dense class of
mixed_large (io/generate.py CORPUS, full size) in f32 and f64
(utils.profiling.ab_arms: each arm held to reference.dense_reference
within 1e-5 (f32) or 1e-12 (f64) of max(1, max|plain|), then the device
time of one launch by graph_ms, the arms in turns, forward then
backward, ROUNDS times). Prints the card's name and power limit, then
per dtype and arm:

    mixed_large f64 groups+mask: median ... ms (min ..., max ...), ...x first arm, max abs err ...

Needs a CUDA device and nvcc: exits 2 without a device.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..io import generate
from ..ops.cuda import build, kernels, reference
from ..ops.cuda.lane_plan import DENSE_GROUP
from ..ops.spmv import TileSpMV
from ..utils.profiling import ab_arms, card_line

MATRIX = "mixed_large"
ROUNDS = 2
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
_MASK = ("  const unsigned mask = active ? cmask[(long long)c * t_lanes + t0"
         " + l] : 0u;\n")
_GROUP = "  const int g = groups[blockIdx.x];\n"


def no_mask(src: str) -> str:
    """dense.cu or dense_spmm.cu with every tile's mask taken as all 16
    columns."""
    return build.edit_once(src, _MASK,
                           "  const unsigned mask = active ? 0xFFFFu : 0u;\n")


def every_group(src: str) -> str:
    """dense.cu or dense_spmm.cu with a block for every lane group in
    place of the group list."""
    return build.edit_once(src, _GROUP,
                           "  const int g = blockIdx.x * kLanes;\n")


# arm: the edit of dense.cu (groups+mask: none)
EDITS = {"groups": no_mask, "all+mask": every_group,
         "all": lambda src: every_group(no_mask(src))}
ARMS = ("groups+mask", *EDITS)


def _launcher(arm: str, d, xp, y):
    """One launch of `arm` on class `d`, with the wrapper's arguments
    (kernels.dense_spmv); the "all" arms get a block per lane group."""
    lib = build.arm_libs("dense.cu", ARMS[0], EDITS,
                         ("tsp_dense", "tsp_dense_f64"))[arm]
    entry = lib.tsp_dense_f64 if xp.dtype == torch.float64 else lib.tsp_dense
    nblocks = (d.val.shape[0] * d.t_lanes // DENSE_GROUP
               if arm.startswith("all") else d.groups.shape[0])
    p = kernels._p
    args = (p(d.val), p(d.meta), p(d.cmask), p(d.groups), nblocks, p(d.pb),
            p(d.cw), p(xp), p(y), d.t_lanes, d.meta.shape[1], d.k_panels,
            d.c_batch)

    def run():
        err = entry(*args, kernels._stream())
        if err:
            raise RuntimeError(f"dense arm {arm}: CUDA error {err}")
    return run


def run_arms(d, xp: torch.Tensor, ylen: int,
             rounds: int = ROUNDS) -> dict:
    """utils.profiling.ab_arms of ARMS on dense class `d` with the padded
    x `xp` (CUDA tensors), against dense_reference."""
    want = reference.dense_reference(
        d, xp, torch.zeros(ylen, dtype=xp.dtype, device=xp.device))
    return ab_arms(lambda arm, y: _launcher(arm, d, xp, y), ARMS, want,
                   TOL[xp.dtype], (), rounds, "dense")


def main() -> int:
    if not torch.cuda.is_available():
        print("dense_probes: needs a CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    csr = generate.get_matrix(MATRIX)
    for dtype in (torch.float32, torch.float64):
        plan = TileSpMV(csr, dtype=dtype).device_plan()
        x = np.random.default_rng(0).uniform(-1, 1, csr.n)
        xp = reference.pad_x(plan, torch.from_numpy(x).cuda())
        res = run_arms(plan.dense, xp, reference.zero_y(plan, xp).shape[0])
        first = res[ARMS[0]]["ms"]
        for arm, r in res.items():
            print(f"{MATRIX} {str(dtype)[6:].replace('float', 'f')} "
                  f"{arm}: median {r['ms']:.4f} ms (min {r['min_ms']:.4f}, "
                  f"max {r['max_ms']:.4f}), {r['ms'] / first:.3f}x first "
                  f"arm, max abs err {r['err']:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
