"""The fused SpMM kernels (stream2.cu, sparse_spmm.cu, band_spmm.cu,
dense_spmm.cu) against copies of them with other design choices, on
the card, at k = 8 and k = 16.

    python -m tilespmv_tpu_torch.scripts.spmm_probes

Builds the sources as the port does and copies of each with one
constant set or one line edited (build.build_edited, build.edit_const):

stream2.cu, on powerlaw_large's two stream classes as one call:

  kept:       stream2.cu itself as the wrapper runs it (a segmented warp
              scan, each run's sums added straight into Y by vector
              atomics, kProducts 32: 4 lanes a thread at k = 8, 2 at
              k = 16; kernels.STREAM_GROUP slabs a block);
  noscan:     kScan 0: no warp scan, each thread's runs add into Y;
  window:     kWindowed 1: the runs add into the block's window of 1024
              rows of k floats in shared memory (float atomics there are
              compare-and-swap loops), which is then added into Y by
              vector atomics, one a row and 4 columns with a nonzero;
  window_noscan: both;
  products16,
  products64: kProducts 16 or 64, the lanes a thread takes (printed);
  scalar_atomics: VEC_ATOMICS 0: one column an atomicAdd into Y where
              the kept kernel adds 4 (float4 atomicAdd);
  blocks4:    kMinBlocks 4: registers capped so that 4 blocks fit an SM;
  group1 ... groupS: the kept kernel at 1, 2, 4, 8 or all S slabs a
              block;
  pairs:      k/2 launches of the kept kernel at K = 2, each on columns
              (2p, 2p+1) of X and Y read at their row stride k: the TPU
              kernel's one RHS pair a call, on per-entry rows;

  and, as where the kept arm's time goes, a copy of it whose y is wrong
  (timed, never held to the plain version):
  noadd:      the runs' sums are formed but not added anywhere;

sparse_spmm.cu, on mixed_large's two W-classes as one call:

  kept:       sparse_spmm.cu itself (kSlots 8, kLanes 32, one float4
              atomicAdd per (tile row, row, 4 columns));
  slots16:    kSlots 16 (half the slot groups a block);
  lanes16:    kLanes 16 (blocks of half the lanes and shared memory);
  atomic_rows: kOwnRows 0: a thread's row sums all go into shared memory
              by atomics (compare-and-swap loops), where the kept kernel
              stores those of the rows whose slots are all its own;
  scalar_atomics: VEC_ATOMICS 0: one column an atomicAdd;

band_spmm.cu, on banded_large's band class (C = 3):

  kept:       band_spmm.cu itself (kRows tile rows a thread: 4 up to
              k = 8, 2 above; X staged one column block at a time in a
              ring of kStages 2, the block's Y rows added once through
              shared memory);
  rows1,
  rows2,
  rows4:      kRows 1, 2 or 4 at every k (rows4 the kept arm's twin at
              k = 8, rows2 at k = 16);
  stage_all:  kStages BAND_MAX_COLS: every column block staged at once;
  y_adds:     kYShared 0: each thread adds its own rows into Y;

dense_spmm.cu, on mixed_large's dense class:

  kept:       dense_spmm.cu itself (the lane groups in `groups`, each
              tile's `cmask` columns, 4 columns an atomicAdd);
  all_groups: a block for every lane group (dense_probes.every_group);
  all_columns: every column's values loaded (dense_probes.no_mask);
  scalar_atomics: VEC_ATOMICS 0: one column an atomicAdd;
  warps4:     kWarps 4: blocks of 4 of the 16 tile rows (4 a lane group,
              each staging the group's X), for more blocks in flight.

Every arm but noadd computes the same y: each is first held to
its plain version in float64 (reference.stream_rows_reference,
sparse_rows_reference, band_reference, dense_active_reference on the
class's values and X as float64: the f32 atomics of a hub row's
thousands of adds, in any order, come near 1e-5 of max|y| against an
f32 plain version doing the same) within 1e-5 of max(1, max|plain|),
then timed by utils.profiling.ab_arms (graph_ms, the arms in turns,
forward then backward, ROUNDS times). Prints the card's name and power
limit, then per kernel, k and arm:

    stream2 k 8 window: median ... ms (min ..., max ...), ...x kept, max abs err ...

Needs a CUDA device and nvcc: exits 2 without a device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import re
import sys

import numpy as np
import torch

from ..io import generate
from ..ops.cuda import build, kernels, reference
from ..ops.cuda.lane_plan import BAND_MAX_COLS, DENSE_GROUP
from ..ops.spmv import TileSpMV
from ..utils.profiling import ab_arms, card_line
from . import dense_probes

STREAM_MATRIX = "powerlaw_large"
SPARSE_MATRIX = "mixed_large"
BAND_MATRIX = "banded_large"
DENSE_MATRIX = "mixed_large"
KS = (8, 16)
ROUNDS = 2
TOL = 1e-5
KEPT = "kept"
PRODUCTS = (16, 32)
GROUPS = {"group1": 1, "group2": 2, "group4": 4, "group8": 8,
          "groupS": 1 << 30}


def _const(name: str, value: int):
    return lambda src: build.edit_const(src, name, value)


def _scalar_atomics(src: str) -> str:
    return build.edit_once(src, "#define VEC_ATOMICS 1\n",
                           "#define VEC_ATOMICS 0\n")


_RUN_END = "if (end && r[u] >= 0) {"

# arm: the edit of the kernel source (the kept arm, the group arms and
# pairs run the port's own library)
STREAM_EDITS = {"noscan": _const("kScan", 0),
                "window": _const("kWindowed", 1),
                "window_noscan": lambda src: build.edit_const(
                    build.edit_const(src, "kWindowed", 1), "kScan", 0),
                **{f"products{p}": _const("kProducts", p) for p in PRODUCTS},
                "scalar_atomics": _scalar_atomics,
                "blocks4": _const("kMinBlocks", 4),
                "noadd": lambda src: build.edit_once(
                    src, _RUN_END, _RUN_END.replace(
                        "r[u] >= 0", "r[u] >= 0 && c[u][0] == 1e30f"))}
STREAM_TIMED_ONLY = ("noadd",)
STREAM_ARMS = (KEPT, *STREAM_EDITS, *GROUPS, "pairs")
SPARSE_EDITS = {"slots16": _const("kSlots", 16),
                "lanes16": _const("kLanes", 16),
                "atomic_rows": _const("kOwnRows", 0),
                "scalar_atomics": _scalar_atomics}
SPARSE_ARMS = (KEPT, *SPARSE_EDITS)
BAND_EDITS = {**{f"rows{r}": _const("kRows", r) for r in (1, 2, 4)},
              "stage_all": _const("kStages", BAND_MAX_COLS),
              "y_adds": _const("kYShared", 0)}
BAND_ARMS = (KEPT, *BAND_EDITS)
DENSE_EDITS = {"all_groups": dense_probes.every_group,
               "all_columns": dense_probes.no_mask,
               "scalar_atomics": _scalar_atomics,
               "warps4": _const("kWarps", 4)}
DENSE_ARMS = (KEPT, *DENSE_EDITS)


def lanes_per_thread(products: int, k: int) -> int:
    """stream2.cu's lanes a thread at K = k under kProducts = products."""
    return 4 if products // k >= 4 else 2 if products // k >= 2 else 1


def kept_products() -> int:
    """kProducts as stream2.cu sets it."""
    src = (build.CSRC_DIR / "stream2.cu").read_text()
    return int(re.search(r"constexpr int kProducts = (\d+);", src)[1])


def _ptr(t: torch.Tensor, col: int = 0):
    """The address of column `col` of t's first row."""
    return ctypes.c_void_p(t.data_ptr() + col * t.element_size())


def _runner(name: str, arm: str, entry, args):
    """A callable that calls `entry` once on each argument tuple of
    `args` on the current stream, raising on a CUDA error."""
    def run():
        for a in args:
            err = entry(*a, kernels._stream())
            if err:
                raise RuntimeError(f"{name} arm {arm}: CUDA error {err}")
    return run


def _stream_launcher(arm: str, classes, xp, y):
    """One call of `arm` on the stream classes, with the wrapper's
    arguments (kernels.stream_spmm) but the arm's group and columns."""
    libs = build.arm_libs("stream2.cu", KEPT, STREAM_EDITS, ("tsp_stream2",))
    entry = libs.get(arm, libs[KEPT]).tsp_stream2
    k = xp.shape[1]
    group = GROUPS.get(arm, kernels.STREAM_GROUP)
    parts = [(r, 2) for r in range(0, k, 2)] if arm == "pairs" else [(0, k)]
    p = kernels._p
    args = []
    for st in classes:
        sb2 = st.sbase2 if st.sbase2 is not None else st.sbase
        for c0, kk in parts:
            args.append((p(st.val), p(st.vidx), p(st.erow), p(st.sbase),
                         p(sb2), p(st.xmap), p(st.cw), p(st.sactive),
                         _ptr(xp, c0), _ptr(y, c0), st.cw.shape[0],
                         st.s_batch, st.span_rows, min(group, st.s_batch),
                         kk, k))
    return _runner("stream2", arm, entry, args)


def _sparse_launcher(arm: str, classes, xp, y):
    """One call of `arm` on the W-classes, with the wrapper's arguments
    (kernels.sparse_spmm)."""
    entry = build.arm_libs("sparse_spmm.cu", KEPT, SPARSE_EDITS,
                           ("tsp_sparse_spmm",))[arm].tsp_sparse_spmm
    p = kernels._p
    args = [(p(s.val), p(s.meta), p(s.pb), p(s.cw), p(xp), p(y),
             s.val.shape[0], s.width, s.t_lanes, s.meta.shape[1],
             s.k_panels, s.c_batch, xp.shape[1]) for s in classes]
    return _runner("sparse_spmm", arm, entry, args)


def _band_launcher(arm: str, classes, xp, y):
    """One call of `arm` on the band classes, with the wrapper's arguments
    (kernels.band_spmm)."""
    entry = build.arm_libs("band_spmm.cu", KEPT, BAND_EDITS,
                           ("tsp_band_spmm",))[arm].tsp_band_spmm
    p = kernels._p
    args = [(p(b.val), p(b.bloc), p(b.pb), p(b.cw), p(xp), p(y),
             b.val.shape[0], b.val.shape[1], b.k_panels, xp.shape[1])
            for b in classes]
    return _runner("band_spmm", arm, entry, args)


def _dense_launcher(arm: str, classes, xp, y):
    """One call of `arm` on the dense classes, with the wrapper's
    arguments (kernels.dense_spmm); all_groups gets a block per lane
    group."""
    entry = build.arm_libs("dense_spmm.cu", KEPT, DENSE_EDITS,
                           ("tsp_dense_spmm",))[arm].tsp_dense_spmm
    p = kernels._p
    args = [(p(d.val), p(d.meta), p(d.cmask), p(d.groups),
             (d.val.shape[0] * d.t_lanes // DENSE_GROUP
              if arm == "all_groups" else d.groups.shape[0]),
             p(d.pb), p(d.cw), p(xp), p(y), d.t_lanes, d.meta.shape[1],
             d.k_panels, d.c_batch, xp.shape[1]) for d in classes]
    return _runner("dense_spmm", arm, entry, args)


def plain64(plain, classes, xp: torch.Tensor, ylen: int) -> torch.Tensor:
    """The classes' plain version `plain` on their values and xp as
    float64, summed into one (ylen, k) y, returned as float32."""
    want = torch.zeros(ylen, xp.shape[1], dtype=torch.float64,
                       device=xp.device)
    for c in classes:
        plain(dataclasses.replace(c, val=c.val.double()), xp.double(), want)
    return want.float()


def run_stream(classes, xp: torch.Tensor, ylen: int,
               rounds: int = ROUNDS) -> dict:
    """utils.profiling.ab_arms of STREAM_ARMS on the stream classes
    `classes` as one call, X the padded (rows, k) `xp` (CUDA tensors, k
    even), against stream_rows_reference in float64."""
    want = plain64(reference.stream_rows_reference, classes, xp, ylen)
    return ab_arms(lambda arm, y: _stream_launcher(arm, classes, xp, y),
                   STREAM_ARMS, want, TOL, STREAM_TIMED_ONLY, rounds,
                   "stream2")


def run_sparse(classes, xp: torch.Tensor, ylen: int,
               rounds: int = ROUNDS) -> dict:
    """utils.profiling.ab_arms of SPARSE_ARMS on the W-classes `classes`
    as one call, X the padded (rows, k) `xp` (CUDA tensors), against
    sparse_rows_reference in float64."""
    want = plain64(reference.sparse_rows_reference, classes, xp, ylen)
    return ab_arms(lambda arm, y: _sparse_launcher(arm, classes, xp, y),
                   SPARSE_ARMS, want, TOL, (), rounds, "sparse_spmm")


def run_band(classes, xp: torch.Tensor, ylen: int,
             rounds: int = ROUNDS) -> dict:
    """utils.profiling.ab_arms of BAND_ARMS on the band classes `classes`
    (stage_all needs C column blocks of staging in one block: banded_large
    has C = 3), X the padded (rows, k) `xp` (CUDA tensors), against
    band_reference in float64."""
    want = plain64(reference.band_reference, classes, xp, ylen)
    return ab_arms(lambda arm, y: _band_launcher(arm, classes, xp, y),
                   BAND_ARMS, want, TOL, (), rounds, "band_spmm")


def run_dense(classes, xp: torch.Tensor, ylen: int,
              rounds: int = ROUNDS) -> dict:
    """utils.profiling.ab_arms of DENSE_ARMS on the dense classes
    `classes`, X the padded (rows, k) `xp` (CUDA tensors), against
    dense_active_reference in float64."""
    want = plain64(reference.dense_active_reference, classes, xp, ylen)
    return ab_arms(lambda arm, y: _dense_launcher(arm, classes, xp, y),
                   DENSE_ARMS, want, TOL, (), rounds, "dense_spmm")


def _print(name: str, k: int, res: dict, notes: dict) -> None:
    first = res[KEPT]["ms"]
    for arm, r in res.items():
        print(f"{name} k {k} {arm}{notes.get(arm, '')}: median "
              f"{r['ms']:.4f} ms (min {r['min_ms']:.4f}, max "
              f"{r['max_ms']:.4f}), {r['ms'] / first:.3f}x kept, "
              + ("wrong y, timed only" if r["err"] is None
                 else f"max abs err {r['err']:.3e}"), flush=True)


# kernel: (matrix, run, the plan's classes it runs)
RUNS = {"stream2": (STREAM_MATRIX, run_stream,
                    lambda plan: [st for st in (plan.stream, plan.stream2)
                                  if st is not None]),
        "sparse_spmm": (SPARSE_MATRIX, run_sparse,
                        lambda plan: list(plan.sparses)),
        "band_spmm": (BAND_MATRIX, run_band, lambda plan: [plan.band]),
        "dense_spmm": (DENSE_MATRIX, run_dense, lambda plan: [plan.dense])}


def main() -> int:
    if not torch.cuda.is_available():
        print("spmm_probes: needs a CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    plans = {}
    for name, (mname, run, classes_of) in RUNS.items():
        if mname not in plans:
            csr = generate.get_matrix(mname)
            plans[mname] = csr, TileSpMV(csr).device_plan()
        csr, plan = plans[mname]
        classes = classes_of(plan)
        print(f"{name} on {mname}: {len(classes)} classes", flush=True)
        for k in KS:
            x = np.random.default_rng(k).uniform(-1, 1, (csr.n, k))
            xp = reference.pad_x(plan, torch.from_numpy(x).cuda())
            ylen = reference.zero_y(plan, xp).shape[0]
            notes = {}
            if name == "stream2":
                notes = {arm: f" ({lanes_per_thread(p, k)} lanes a thread)"
                         for arm, p in (
                             (KEPT, kept_products()),
                             *((f"products{p}", p) for p in PRODUCTS))}
            _print(name, k, run(classes, xp, ylen), notes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
