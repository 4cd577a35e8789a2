"""Where the SpMV stream kernel's time goes, on the card: stream.cu
against copies of it with one part of its work taken out.

    python -m tilespmv_tpu_torch.scripts.stream_probes

Builds ops/cuda/csrc/stream.cu as the port does ("base") and three
probes, each a copy of that source with one edit (a probe's sums are
wrong: it is timed, never held to the plain version):

  nogather: x is not read (each product takes 1 in place of x[col]);
  noscan:   no segmented scan: each thread adds its 4 products into one
            window entry;
  loads:    both edits, which leaves the loads of erow, val and vidx,
            the window's zeroing and its flush.

Times each on all the stream classes of powerlaw_large and of
mixed_large (io/generate.py CORPUS, full size), in f32 and f64, at the
wrapper's slabs per block (kernels.STREAM_GROUP), one call of the
matrix's stream classes (utils.profiling.ab_arms: base held to
reference.stream_rows_reference within 1e-5 (f32) or 1e-12 (f64) of
max(1, max|plain|), then the device time by graph_ms, the variants in
turns, forward then backward, ROUNDS times). Prints the card's name and
power limit, then per matrix, dtype and variant:

    powerlaw_large f32 nogather: median ... ms (min ..., max ...), ...x base

Needs a CUDA device and nvcc: exits 2 without a device.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..io import generate
from ..ops.cuda import build, kernels, reference
from ..ops.spmv import TileSpMV
from ..utils.profiling import ab_arms, card_line

MATRICES = ("powerlaw_large", "mixed_large")
ROUNDS = 2
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
_GATHER = "        c[u] = v[u] * x[row * kLanes + (cv & 127u)];\n"
_SCAN_FROM = "    // segmented inclusive sums within the thread's 4 lanes\n"
_SCAN_TO = ("      if (end && r[u] >= 0) atomicAdd(&win[r[u]], c[u]);\n"
            "    }\n")


def _no_gather(src: str) -> str:
    return build.edit_once(
        src, _GATHER, "        c[u] = v[u] + static_cast<V>(row & 1);\n")


def _no_scan(src: str) -> str:
    i = src.index(_SCAN_FROM)
    j = src.index(_SCAN_TO, i) + len(_SCAN_TO)
    return (src[:i] + "    atomicAdd(&win[tid * 4 & (kWindow - 1)], "
            "c[0] + c[1] + c[2] + c[3]);\n" + src[j:])


PROBES = {"nogather": _no_gather, "noscan": _no_scan,
          "loads": lambda src: _no_scan(_no_gather(src))}
VARIANTS = ("base", *PROBES)


def _call(variant: str, classes, xp, y):
    """One call of the stream classes through `variant`'s library
    (build.arm_libs: "base" the port's own, each probe an edited copy of
    stream.cu), with the wrapper's arguments (kernels.stream_spmv)."""
    lib = build.arm_libs("stream.cu", "base", PROBES,
                         ("tsp_stream", "tsp_stream_f64"))[variant]
    entry = lib.tsp_stream_f64 if xp.dtype == torch.float64 \
        else lib.tsp_stream
    p = kernels._p
    args = []
    for st in classes:
        sb2 = st.sbase2 if st.sbase2 is not None else st.sbase
        args.append((p(st.val), p(st.vidx), p(st.erow), p(st.sbase),
                     p(sb2), p(st.xmap), p(st.cw), p(st.sactive), p(xp),
                     p(y), st.cw.shape[0], st.s_batch, st.span_rows,
                     min(kernels.STREAM_GROUP, st.s_batch)))

    def run():
        for a in args:
            err = entry(*a, kernels._stream())
            if err:
                raise RuntimeError(f"stream probe launch: CUDA error {err}")
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_probes: needs a CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    for mname in MATRICES:
        csr = generate.get_matrix(mname)
        for dtype in (torch.float32, torch.float64):
            plan = TileSpMV(csr, dtype=dtype).device_plan()
            classes = [st for st in (plan.stream, plan.stream2)
                       if st is not None]
            x = np.random.default_rng(0).uniform(-1, 1, csr.n)
            xp = reference.pad_x(plan, torch.from_numpy(x).cuda())
            want = reference.zero_y(plan, xp)
            for st in classes:
                reference.stream_rows_reference(st, xp, want)
            res = ab_arms(lambda v, y: _call(v, classes, xp, y), VARIANTS,
                          want, TOL[dtype], tuple(PROBES), ROUNDS, "stream")
            base = res["base"]["ms"]
            for v, r in res.items():
                print(f"{mname} {str(dtype)[6:].replace('float', 'f')} "
                      f"{v:8s}: median {r['ms']:.4f} ms (min "
                      f"{r['min_ms']:.4f}, max {r['max_ms']:.4f}), "
                      f"{r['ms'] / base:.3f}x base", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
