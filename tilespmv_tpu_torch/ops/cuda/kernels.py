"""Wrappers of the four CUDA class kernels, and the SpMV they assemble.

Each wrapper `*_spmv(cls, x, y)` checks its inputs and adds its class's
contribution into the flat f32 `y` in place (see reference.py for the
index arithmetic). `x` must be padded by `reference.pad_x` and `y` span
the plan's windows, as `reference.assemble` allocates them: the kernels
index both from plan values. Given CPU tensors a wrapper runs the
class's plain PyTorch version; given CUDA tensors it launches the kernel
on the current stream (building the library on first use) or raises.
`LAUNCHES` counts kernel launches per wrapper; it moves only where a
kernel is launched.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .lane_plan import ROW_WINDOW, LanePlan, sparse_meta_rows
from .reference import (assemble, band_reference, dense_reference,
                        sparse_reference, stream_reference)
from .stream_plan import LANES, SPAN_ROWS, SUBS, step_plane_rows

LAUNCHES = {"band": 0, "dense": 0, "sparse": 0, "stream": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _check(name: str, t, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _use_kernel(y: torch.Tensor) -> bool:
    """True for CUDA tensors (launch), False for CPU ones (plain
    version); anything else raises."""
    if y.device.type == "cpu":
        return False
    if y.device.type != "cuda":
        raise ValueError(f"kernels run on CUDA or CPU tensors, not "
                         f"{y.device}")
    return True


def _check_xy(x, y) -> None:
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError("x and y must be float32")
    if x.dim() != 1 or y.dim() != 1 or not x.is_contiguous() \
            or not y.is_contiguous():
        raise ValueError("x and y must be contiguous 1-D tensors")
    if x.device != y.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")


def _p(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def band_spmv(bd, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Band (brick) class: y[(cw*256 + t)*16 + i] += brick row sums."""
    _check_xy(x, y)
    dev = y.device
    nch, C = bd.val.shape[0], bd.val.shape[1]
    _check("band.val", bd.val, torch.float32, (nch, C, 16, 16, ROW_WINDOW),
           dev)
    _check("band.bloc", bd.bloc, torch.int32, (nch, 1, ROW_WINDOW), dev)
    _check("pb", bd.pb, torch.int32, (nch * bd.k_panels,), dev)
    _check("band.cw", bd.cw, torch.int32, (nch,), dev)
    if not _use_kernel(y):
        return band_reference(bd, x, y)
    err = build.load().tsp_band(
        _p(bd.val), _p(bd.bloc), _p(bd.pb), _p(bd.cw), _p(x), _p(y),
        nch, C, bd.k_panels, _stream())
    _launched("band", err)
    return y


def dense_spmv(d, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dense class: densified 16x16 tiles, routed by meta[LROW]."""
    _check_xy(x, y)
    dev = y.device
    nch, T = d.val.shape[0], d.t_lanes
    if nch % d.c_batch:
        raise ValueError("dense: chunk count not a multiple of c_batch")
    nsteps = nch // d.c_batch
    _check("dense.val", d.val, torch.float32, (nch, 16, 16, T), dev)
    _check("dense.meta", d.meta, torch.int32, (nch, 2, T), dev)
    _check("pb", d.pb, torch.int32, (nsteps * d.k_panels,), dev)
    _check("dense.cw", d.cw, torch.int32, (nsteps,), dev)
    if not _use_kernel(y):
        return dense_reference(d, x, y)
    err = build.load().tsp_dense(
        _p(d.val), _p(d.meta), _p(d.pb), _p(d.cw), _p(x), _p(y),
        nch, T, d.k_panels, d.c_batch, _stream())
    _launched("dense", err)
    return y


def sparse_spmv(s, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """W-class: packed sparse-entry tiles, routed by meta[LROW]."""
    _check_xy(x, y)
    dev = y.device
    nch, W, T = s.val.shape[0], s.width, s.t_lanes
    if nch % s.c_batch:
        raise ValueError("sparse: chunk count not a multiple of c_batch")
    nsteps = nch // s.c_batch
    _check("sparse.val", s.val, torch.float32, (nch, W, T), dev)
    _check("sparse.meta", s.meta, torch.int32,
           (nch, sparse_meta_rows(W), T), dev)
    _check("pb", s.pb, torch.int32, (nsteps * s.k_panels,), dev)
    _check("sparse.cw", s.cw, torch.int32, (nsteps,), dev)
    if not _use_kernel(y):
        return sparse_reference(s, x, y)
    err = build.load().tsp_sparse(
        _p(s.val), _p(s.meta), _p(s.pb), _p(s.cw), _p(x), _p(y),
        nch, W, T, s.k_panels, s.c_batch, _stream())
    _launched("sparse", err)
    return y


def stream_spmv(st, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Stream class: entry slabs, lane prefix + round-plane scatter."""
    _check_xy(x, y)
    dev = y.device
    S, R = st.s_batch, st.rounds
    nsteps = st.cw.shape[0]
    nsl = nsteps * S
    _check("stream.val", st.val, torch.float32, (nsl, SUBS, LANES), dev)
    _check("stream.vidx", st.vidx, torch.int16, (nsl, SUBS, LANES), dev)
    _check("stream.planes", st.planes, torch.int8,
           (nsteps, step_plane_rows(R, S), LANES), dev)
    _check("stream.sbase", st.sbase, torch.int32, (nsl,), dev)
    if st.sbase2 is not None:
        _check("stream.sbase2", st.sbase2, torch.int32, (nsl,), dev)
    if st.xmap is not None:
        _check("stream.xmap", st.xmap, torch.int32, (nsl * SPAN_ROWS,),
               dev)
    _check("stream.cw", st.cw, torch.int32, (nsteps,), dev)
    _check("stream.sactive", st.sactive, torch.int32, (nsteps,), dev)
    if not _use_kernel(y):
        return stream_reference(st, x, y)
    sb2 = st.sbase2 if st.sbase2 is not None else st.sbase
    err = build.load().tsp_stream(
        _p(st.val), _p(st.vidx), _p(st.planes), _p(st.sbase), _p(sb2),
        _p(st.xmap), _p(st.cw), _p(st.sactive), _p(x), _p(y),
        nsteps, S, R, st.span_rows, _stream())
    _launched("stream", err)
    return y


def spmv_cuda(plan: LanePlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through the class kernels (plan tensors and x on one
    CUDA device; on CPU tensors every class runs its plain version)."""
    return assemble(plan, x, band_spmv, dense_spmv, sparse_spmv,
                    stream_spmv)
