"""The band-class kernel (band.cu) against copies of it, on the card.

    python -m tilespmv_tpu_torch.scripts.band_probes

Builds ops/cuda/csrc/band.cu as the port does and copies of it, each
with one or two edits (build.build_edited), and runs them as arms:

  kept:    band.cu itself, which the wrapper runs: a thread computes
           band.cu's kRows tile rows of its lane (2 in f32, 1 in f64),
           the 32 lanes' x blocks staged once in shared memory;
  rows1,
  rows2,
  rows4:   the same with kRows set to 1, 2 or 4 in both dtypes (16 /
           rows warps a block), one of them the kept arm's twin;
  lane_x:  no staging: each thread reads its own lane's x block from
           device memory, a 32-byte sector per lane of a warp (the
           access of the kernel before the staging);
  one_x:   no staging, and every lane reads one x block (the window's
           first): the value stream alone. Its y is wrong: it is timed,
           never held to the plain version.

Times each on the band class of banded_large (io/generate.py CORPUS,
full size) in f32 and f64 (utils.profiling.ab_arms: each arm but one_x
held to reference.band_reference within 1e-5 (f32) or 1e-12 (f64) of
max(1, max|plain|), then the device time of one launch by graph_ms, the
arms in turns, forward then backward, ROUNDS times). Prints the card's
name and power limit, then per dtype and arm:

    banded_large f64 kept: median ... ms (min ..., max ...), ...x first arm, max abs err ...

Needs a CUDA device and nvcc: exits 2 without a device. About 20 s on
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

MATRIX = "banded_large"
ROUNDS = 2
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
_XL = "    const V* xl = xs + (cb * kLanes + l) * kPad;\n"
_STAGE = "  const int nstage = c_cols * kLanes * kB;\n"


def _rows(r: int):
    return lambda src: build.edit_const(src, "kRows", r)


def _x_from(xl: str):
    """No staging; each thread's x block at `xl` in device memory."""
    def edit(src: str) -> str:
        src = build.edit_once(src, _STAGE, "  const int nstage = 0;\n")
        return build.edit_once(src, _XL, xl)
    return edit


_LANE_X = ("    const int loc = bw[l] + cb;\n"
           "    const V* xl =\n"
           "        x + ((long long)pbw[loc >> 8] * 256 + (loc & 255)) * kB;\n")
_ONE_X = "    const V* xl = x + (long long)pbw[0] * 256 * kB;\n"

KEPT = "kept"
# arm: the edit of band.cu (the kept arm: none)
EDITS = {**{f"rows{r}": _rows(r) for r in (1, 2, 4)},
         "lane_x": _x_from(_LANE_X), "one_x": _x_from(_ONE_X)}
ARMS = (KEPT, *EDITS)
# arms whose y is wrong: timed only
TIMED_ONLY = ("one_x",)


def _launcher(arm: str, bd, xp, y):
    """One launch of `arm` on class `bd`, with the wrapper's arguments
    (kernels.band_spmv)."""
    lib = build.arm_libs("band.cu", KEPT, EDITS,
                         ("tsp_band", "tsp_band_f64"))[arm]
    entry = lib.tsp_band_f64 if xp.dtype == torch.float64 else lib.tsp_band
    p = kernels._p
    args = (p(bd.val), p(bd.bloc), p(bd.pb), p(bd.cw), p(xp), p(y),
            bd.val.shape[0], bd.val.shape[1], bd.k_panels)

    def run():
        err = entry(*args, kernels._stream())
        if err:
            raise RuntimeError(f"band arm {arm}: CUDA error {err}")
    return run


def run_arms(bd, xp: torch.Tensor, ylen: int,
             rounds: int = ROUNDS) -> dict:
    """utils.profiling.ab_arms of ARMS on band class `bd` with the padded
    x `xp` (CUDA tensors), against band_reference."""
    want = reference.band_reference(
        bd, xp, torch.zeros(ylen, dtype=xp.dtype, device=xp.device))
    return ab_arms(lambda arm, y: _launcher(arm, bd, xp, y), ARMS, want,
                   TOL[xp.dtype], TIMED_ONLY, rounds, "band")


def main() -> int:
    if not torch.cuda.is_available():
        print("band_probes: needs a CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    csr = generate.get_matrix(MATRIX)
    for dtype in (torch.float32, torch.float64):
        plan = TileSpMV(csr, dtype=dtype).device_plan()
        x = np.random.default_rng(0).uniform(-1, 1, csr.n)
        xp = reference.pad_x(plan, torch.from_numpy(x).cuda())
        res = run_arms(plan.band, xp, reference.zero_y(plan, xp).shape[0])
        first = res[ARMS[0]]["ms"]
        for arm, r in res.items():
            err = ("wrong y, timed only" if r["err"] is None
                   else f"max abs err {r['err']:.3e}")
            print(f"{MATRIX} {str(dtype)[6:].replace('float', 'f')} "
                  f"{arm}: median {r['ms']:.4f} ms (min {r['min_ms']:.4f}, "
                  f"max {r['max_ms']:.4f}), {r['ms'] / first:.3f}x first "
                  f"arm, {err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
