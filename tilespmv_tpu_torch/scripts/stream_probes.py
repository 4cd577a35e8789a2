"""Where the SpMV stream kernel's time goes, on the card: stream.cu
against copies of it with one part of its work taken out.

    python -m tilespmv_tpu_torch.scripts.stream_probes

Builds ops/cuda/csrc/stream.cu as the port does and three probes, each a
copy of that source with one edit (a probe's sums are wrong: it is
timed, never used):

  nogather: x is not read (each product takes 1 in place of x[col]);
  noscan:   no segmented scan: each thread adds its 4 products into one
            window entry;
  loads:    both edits, which leaves the loads of erow, val and vidx,
            the window's zeroing and its flush.

Times each on all the stream classes of powerlaw_large and of
mixed_large (io/generate.py CORPUS, full size), in f32 and f64, at the
wrapper's slabs per block (kernels.STREAM_GROUP): the device time of
one call of the matrix's stream classes (utils.profiling.graph_ms), the
variants taken in turns, forward then backward, ROUNDS times. Prints the
card's name and power limit, then per matrix, dtype and variant:

    powerlaw_large f32 nogather: median ... ms (min ..., max ...), ...x base

Needs a CUDA device and nvcc: exits 2 without a device.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..io import generate
from ..ops.cuda import build, kernels, reference
from ..ops.spmv import TileSpMV
from ..utils.profiling import card_line, graph_ms

MATRICES = ("powerlaw_large", "mixed_large")
ROUNDS = 2
_GATHER = "        c[u] = v[u] * x[row * kLanes + (cv & 127u)];\n"
_SCAN_FROM = "    // segmented inclusive sums within the thread's 4 lanes\n"
_SCAN_TO = ("      if (end && r[u] >= 0) atomicAdd(&win[r[u]], c[u]);\n"
            "    }\n")


def _no_gather(src: str) -> str:
    return _edit(src, _GATHER,
                 "        c[u] = v[u] + static_cast<V>(row & 1);\n")


def _no_scan(src: str) -> str:
    i = src.index(_SCAN_FROM)
    j = src.index(_SCAN_TO, i) + len(_SCAN_TO)
    return (src[:i] + "    atomicAdd(&win[tid * 4 & (kWindow - 1)], "
            "c[0] + c[1] + c[2] + c[3]);\n" + src[j:])


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"stream.cu no longer holds {old.strip()!r} "
                           "once: update the probe")
    return src.replace(old, new)


PROBES = {"nogather": _no_gather, "noscan": _no_scan,
          "loads": lambda src: _no_scan(_no_gather(src))}


def build_probes() -> dict:
    """{variant: ctypes library}: "base" the port's own library, then
    each probe built from an edited copy of stream.cu, all nvcc runs
    started together, into build/cuda/probes/."""
    src = (build.CSRC_DIR / "stream.cu").read_text()
    out = build.BUILD_DIR / "probes"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    jobs = {}
    for name, edit in PROBES.items():
        cu, so = out / f"stream_{name}.cu", out / f"stream_{name}.so"
        cu.write_text(edit(src))
        jobs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stderr=subprocess.PIPE, text=True))
    libs = {"base": build.load()}
    for name, (so, proc) in jobs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on probe {name}:\n{err}")
        lib = ctypes.CDLL(str(so))
        for entry in ("tsp_stream", "tsp_stream_f64"):
            fn = getattr(lib, entry)
            fn.argtypes = build.ENTRY_POINTS[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _call(lib, classes, xp, y):
    """One call of the stream classes through `lib`'s entry, with the
    wrapper's arguments (kernels.stream_spmv)."""
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
    libs = build_probes()
    for mname in MATRICES:
        csr = generate.get_matrix(mname)
        for dtype in (torch.float32, torch.float64):
            plan = TileSpMV(csr, dtype=dtype).device_plan()
            classes = [st for st in (plan.stream, plan.stream2)
                       if st is not None]
            x = np.random.default_rng(0).uniform(-1, 1, csr.n)
            xp = reference.pad_x(plan, torch.from_numpy(x).cuda())
            y = reference.zero_y(plan, xp)
            runs = {v: _call(lib, classes, xp, y) for v, lib in libs.items()}
            times = {v: [] for v in runs}
            order = list(runs)
            for _ in range(ROUNDS):
                for v in order + order[::-1]:
                    times[v].append(graph_ms(runs[v]))
            base = statistics.median(times["base"])
            for v, ts in times.items():
                med = statistics.median(ts)
                print(f"{mname} {str(dtype)[6:].replace('float', 'f')} "
                      f"{v:8s}: median {med:.4f} ms (min {min(ts):.4f}, "
                      f"max {max(ts):.4f}), {med / base:.3f}x base",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
