"""The W-class kernel (sparse.cu) against copies of it at other numbers
of threads a lane or ring stages, or with a part of its work taken out,
on the card.

    python -m tilespmv_tpu_torch.scripts.sparse_probes [MATRIX ...]

MATRIX is mixed_large (io/generate.py CORPUS, full size; the default)
or hpcg<N>, HPCG's 27-point stencil on an N^3 grid
(generate.stencil_27), whose f32 plan puts nearly every nonzero in
W-classes (hpcg200: 213.8M nonzeros, about 2 minutes of plan). Builds
ops/cuda/csrc/sparse.cu as the port does and copies of it
(build.build_edited). A block walks chunks through a ring of stages
fed by bulk copies; kRowGroups threads a lane each sum kRows = 16 /
kRowGroups of the tile's rows, so the rows arms are the threads-a-chunk
choice:

  kept:    sparse.cu itself, which the wrapper runs (4 rows a thread,
           16 warps a chunk; at most 4 stages);
  rows4,
  rows8,
  rows16:  kRowGroups set to 4, 2 or 1 (16, 8 or 4 warps a chunk), one
           of them the kept arm's twin;
  stages1,
  stages2: the ring cut to 1 or 2 stages (stages1: no chunk's copy is in
           flight while a block computes);
  blocks3: up to 3 blocks an SM where each holds two stages (the kept
           arm: 2);
  tile_atomics: the kept arm with no leader lanes: one atomic into y
           per (tile, 4 rows with entries), where the kept arm adds a
           warp's tiles of one tile row together first;

and, as where the kept arm's time goes, four copies of it whose y is
wrong (timed, never held to the plain version):

  empty:   every block returns at once: the launch and its blocks alone;
  nox:     the x blocks are not loaded (the products read whatever the
           shared memory holds);
  noflush: no atomicAdd into y (nor the merge that feeds it);
  nocompute: no row sums a slot (the stream, x blocks and flush kept).

Every other arm computes the same y. First prints each class's chunks,
the megabytes its kernel streams (lane_plan.kernel_bytes), its tiles,
tile rows and the most tiles on one tile row, then runs the arms on the
matrix's W-classes (f32: f64 plans have none), each class alone and all
as one call (utils.profiling.ab_arms: each arm but those held to
reference.sparse_rows_reference within 1e-5 of max(1, max|plain|), then
the device time by graph_ms, the arms in turns, forward then backward,
ROUNDS times). Prints the card's name and power limit, then per class
and arm:

    mixed_large w96 kept: median ... ms (min ..., max ...), ...x first arm, ... TB/s, max abs err ...

(TB/s: the class's kernel bytes over the median). Needs a CUDA device
and nvcc: exits 2 without a device. About 15 s on an H100 for
mixed_large, about 3 minutes more for hpcg200.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..io import generate
from ..ops.cuda import build, kernels, reference
from ..ops.cuda.lane_plan import kernel_bytes
from ..ops.spmv import TileSpMV
from ..utils.profiling import ab_arms, card_line

# matrix: its maker (io/generate.py); "hpcg<N>" (see matrix()) is HPCG's
# 27-point stencil at N^3
MATRICES = {"mixed_large": lambda: generate.get_matrix("mixed_large")}
DEFAULT = ("mixed_large",)
ROUNDS = 2
TOL = 1e-5
# rows a thread: kRowGroups = 16 / rows
ROWS = (4, 8, 16)
STAGES = (1, 2)
BLOCKS = (3,)


def _const(name: str, value: int):
    return lambda src: build.edit_const(src, name, value)


_BODY = "  extern __shared__ __align__(128) unsigned char smem[];\n"
_X = "  if (u.xloc >= 0) {\n    const float* xg"
_FLUSH = "      if (!bits) continue;\n"
_SLOTS = "      for (int s = lo; s <= end[i]; ++s) {\n"
_LEAD = ("      const unsigned members =\n"
         "          __match_any_sync(0xffffffffu, active ? cur.lrow : -1 - "
         "lane);\n")

KEPT = "kept"
# arm: the edit of sparse.cu (the kept arm: none)
EDITS = {**{f"rows{r}": _const("kRowGroups", 16 // r) for r in ROWS},
         **{f"stages{n}": _const("kMaxStages", n) for n in STAGES},
         **{f"blocks{n}": _const("kMaxBlocks", n) for n in BLOCKS},
         "tile_atomics": lambda src: build.edit_once(
             src, _LEAD, "      const unsigned members = 1u << lane;\n"),
         "empty": lambda src: build.edit_once(src, _BODY,
                                              _BODY + "  return;\n"),
         "nox": lambda src: build.edit_once(
             src, _X, "  if (false) {\n    const float* xg"),
         "noflush": lambda src: build.edit_once(
             src, _FLUSH, "      if (true) continue;\n"),
         "nocompute": lambda src: build.edit_once(
             src, _SLOTS, "      for (int s = lo; false; ++s) {\n")}
ARMS = (KEPT, *EDITS)
# arms whose y is wrong: timed only
TIMED_ONLY = ("empty", "nox", "noflush", "nocompute")


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


def matrix(name: str):
    """The CSRMatrix `name`: a key of MATRICES or hpcg<N>."""
    if name in MATRICES:
        return MATRICES[name]()
    if name.startswith("hpcg") and name[4:].isdigit():
        n = int(name[4:])
        return generate.stencil_27(n, n, n, seed=0, dtype=np.float32)
    raise KeyError(f"unknown matrix {name!r}: {sorted(MATRICES)} or hpcg<N>")


def probe(name: str) -> None:
    """Prints the class counts and each case's arms on matrix `name`."""
    csr = matrix(name)
    plan = TileSpMV(csr, dtype=torch.float32).device_plan()
    n = csr.n
    del csr
    x = np.random.default_rng(0).uniform(-1, 1, n).astype(np.float32)
    xp = reference.pad_x(plan, torch.from_numpy(x).cuda())
    ylen = reference.zero_y(plan, xp).shape[0]
    for s in plan.sparses:
        t = class_tiles(s)
        print(f"{name} w{s.width}: {s.val.shape[0]} chunks, "
              f"{kernel_bytes(s) / 1e6:.1f} MB; {t['tiles']} tiles on "
              f"{t['tile_rows']} tile rows, at most {t['most']} on one",
              flush=True)
    cases = {f"w{s.width}": [s] for s in plan.sparses}
    cases["call"] = list(plan.sparses)
    for case, classes in cases.items():
        res = run_arms(classes, xp, ylen)
        first = res[ARMS[0]]["ms"]
        mb = sum(kernel_bytes(s) for s in classes) / 1e6
        for arm, r in res.items():
            err = ("wrong y, timed only" if r["err"] is None
                   else f"max abs err {r['err']:.3e}")
            print(f"{name} {case} {arm}: median {r['ms']:.4f} ms (min "
                  f"{r['min_ms']:.4f}, max {r['max_ms']:.4f}), "
                  f"{r['ms'] / first:.3f}x first arm, "
                  f"{mb / r['ms'] / 1e3:.3f} TB/s, {err}", flush=True)


def main(argv=None) -> int:
    """Probes each matrix named in `argv` (DEFAULT where none is)."""
    if not torch.cuda.is_available():
        print("sparse_probes: needs a CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    for name in argv or DEFAULT:
        probe(name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
