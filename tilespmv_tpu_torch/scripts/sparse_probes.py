"""The W-class kernel (sparse.cu) against copies of it at other numbers
of warps a block or with a part of its work taken out, on the card.

    python -m tilespmv_tpu_torch.scripts.sparse_probes

Builds ops/cuda/csrc/sparse.cu as the port does and copies of it
(build.build_edited). A block is one group of 32 lanes of a chunk by
ceil(W / kSlots) warps, kSlots the slots of a thread, so the kSlots
arms are the warps-per-block choice:

  kept:    sparse.cu itself, which the wrapper runs (kSlots 8: one meta
           column word a thread; W24: 3 warps, W96: 12);
  slots8,
  slots16,
  slots32: kSlots set to 8, 16 or 32 (W24: 3, 2, 1 warps; W96: 12, 6,
           3), one of them the kept arm's twin;
  tile_atomics: the kept arm with no leader lanes: one atomicAdd into y
           per (tile, row), where the kept arm adds a group's tiles of
           one tile row together first;

and, as where the kept arm's time goes, three copies of it whose y is
wrong (timed, never held to the plain version):

  empty:   every block returns at once: the launch and its blocks alone;
  nox:     the x blocks are not loaded (the products read whatever the
           shared memory holds);
  noflush: no atomicAdd into y.

Every other arm computes the same y. First prints each class's tiles,
tile rows and the most tiles on one tile row, then runs the arms on
mixed_large's W-classes (io/generate.py CORPUS, full size, f32: f64
plans have none), each class alone and the two as one call
(utils.profiling.ab_arms: each arm but those held to
reference.sparse_rows_reference within 1e-5 of max(1, max|plain|), then
the device time by graph_ms, the arms in turns, forward then backward,
ROUNDS times). Prints the card's name and power limit, then per class
and arm:

    mixed_large w96 kept: median ... ms (min ..., max ...), ...x first arm, max abs err ...

Needs a CUDA device and nvcc: exits 2 without a device. About 15 s on
an H100.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..io import generate
from ..ops.cuda import build, kernels, reference
from ..ops.spmv import TileSpMV
from ..utils.profiling import ab_arms, card_line

MATRIX = "mixed_large"
ROUNDS = 2
TOL = 1e-5
SLOTS = (8, 16, 32)


def _slots(k: int):
    return lambda src: build.edit_const(src, "kSlots", k)


_BODY = "  __shared__ float xs[kLanes * kPad];\n"
_X = "  if (active) {\n    int panel"
_FLUSH = "    if (srow[lane] >= 0 && slead[lane] == lane && (smask[lane]"
_LEAD = ("    const int lead =\n"
         "        __ffs(__match_any_sync(0xffffffffu, active ? tr : -1 - l))"
         " - 1;\n")

KEPT = "kept"
# arm: the edit of sparse.cu (the kept arm: none)
EDITS = {**{f"slots{k}": _slots(k) for k in SLOTS},
         "tile_atomics": lambda src: build.edit_once(
             src, _LEAD, "    const int lead = l;\n"),
         "empty": lambda src: build.edit_once(src, _BODY,
                                              _BODY + "  return;\n"),
         "nox": lambda src: build.edit_once(src, _X,
                                            "  if (false) {\n    int panel"),
         "noflush": lambda src: build.edit_once(
             src, _FLUSH, "    if (false && (smask[lane]")}
ARMS = (KEPT, *EDITS)
# arms whose y is wrong: timed only
TIMED_ONLY = ("empty", "nox", "noflush")


def class_tiles(s) -> dict:
    """{"tiles", "tile_rows", "most"}: the active tiles of W-class `s`,
    the tile rows they lie on and the most tiles on one tile row (each a
    y row's atomics without the kernel's leader lanes)."""
    step = torch.arange(s.val.shape[0], device=s.meta.device) // s.c_batch
    act = s.meta[:, 0] >= 0
    trow = (s.cw.long()[step][:, None] * 256 + s.meta[:, 1].long())[act]
    _, counts = torch.unique(trow, return_counts=True)
    return {"tiles": int(act.sum()), "tile_rows": int(counts.numel()),
            "most": int(counts.max())}


def _launcher(arm: str, classes, xp, y):
    """One launch of `arm` per class, with the wrapper's arguments
    (kernels.sparse_spmv)."""
    entry = build.arm_libs("sparse.cu", KEPT, EDITS,
                           ("tsp_sparse",))[arm].tsp_sparse
    p = kernels._p
    args = [(p(s.val), p(s.meta), p(s.pb), p(s.cw), p(xp), p(y),
             s.val.shape[0], s.width, s.t_lanes, s.meta.shape[1],
             s.k_panels, s.c_batch)
            for s in classes]

    def run():
        for a in args:
            err = entry(*a, kernels._stream())
            if err:
                raise RuntimeError(f"sparse arm {arm}: CUDA error {err}")
    return run


def run_arms(classes, xp: torch.Tensor, ylen: int,
             rounds: int = ROUNDS) -> dict:
    """utils.profiling.ab_arms of ARMS on the W-classes `classes` as one
    call, with the padded x `xp` (CUDA tensors), against
    sparse_rows_reference."""
    want = torch.zeros(ylen, dtype=xp.dtype, device=xp.device)
    for s in classes:
        reference.sparse_rows_reference(s, xp, want)
    return ab_arms(lambda arm, y: _launcher(arm, classes, xp, y), ARMS,
                   want, TOL, TIMED_ONLY, rounds, "sparse")


def main() -> int:
    if not torch.cuda.is_available():
        print("sparse_probes: needs a CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    csr = generate.get_matrix(MATRIX)
    plan = TileSpMV(csr).device_plan()
    x = np.random.default_rng(0).uniform(-1, 1, csr.n).astype(np.float32)
    xp = reference.pad_x(plan, torch.from_numpy(x).cuda())
    ylen = reference.zero_y(plan, xp).shape[0]
    for s in plan.sparses:
        t = class_tiles(s)
        print(f"{MATRIX} w{s.width}: {t['tiles']} tiles on {t['tile_rows']} "
              f"tile rows, at most {t['most']} on one", flush=True)
    cases = {f"w{s.width}": [s] for s in plan.sparses}
    cases["call"] = list(plan.sparses)
    for name, classes in cases.items():
        res = run_arms(classes, xp, ylen)
        first = res[ARMS[0]]["ms"]
        for arm, r in res.items():
            err = ("wrong y, timed only" if r["err"] is None
                   else f"max abs err {r['err']:.3e}")
            print(f"{MATRIX} {name} {arm}: median {r['ms']:.4f} ms (min "
                  f"{r['min_ms']:.4f}, max {r['max_ms']:.4f}), "
                  f"{r['ms'] / first:.3f}x first arm, {err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
