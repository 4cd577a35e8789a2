"""Wrappers of the CUDA class kernels.

Each SpMV wrapper `*_spmv(cls, x, y)` checks its inputs and adds its
class's contribution into the flat `y` in place (see reference.py for
the index arithmetic), in the compute dtype of the class's `val`
(lane_plan.acc_dtype), which x and y share: float32 for float32 and
bfloat16 values (the `*_bf16` kernels read bf16 values and compute in
f32), float64 for the band, dense and stream classes of an f64 plan (the
`*_f64` kernels); each SpMM wrapper (`band_spmm`, `dense_spmm`,
`sparse_spmm`, `stream_spmm`, for k in SPMM_K) does the same for x
(rows, k) and y (ylen, k), row-major, in float32, on f32 or bf16 values
(an f64 operator runs one SpMV per column). `x` must be padded by
`reference.pad_x` and `y` span the plan's windows, as
`reference.assemble` allocates them: the kernels index both from plan
values. Given CPU tensors a wrapper runs the class's plain PyTorch
version (reference.PLAIN); given CUDA tensors it launches the kernel on
the current stream (building the library on first use) or raises.
`LAUNCHES` counts kernel launches per kernel (`band` the f32 band
kernel, `band_f64` the f64 one, `band_bf16` the bf16 one, ...); it moves
only where a kernel is launched. Each wrapper makes a `ClassLaunch` (the
class's checks, entry point and plan arguments) and calls it; an
operator keeps one per class and calls it, which checks x and y alone.

`microbench_gather` and `microbench_scatter` wrap the two
microbenchmark kernels (the reference's scripts/microbench_*.py), whose
inputs and plain versions are in reference.py; the scripts in
tilespmv_tpu_torch/scripts time them.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .lane_plan import (DENSE_GROUP, DENSE_MROWS, PANEL_TC, ROW_WINDOW,
                        acc_dtype, prefix_rows, sparse_meta_rows)
from .reference import (MB_GATHER_R, MB_PE_ROWS, MB_ROWS,
                        MB_SCATTER_ARMS, MB_SLABS, PLAIN,
                        microbench_gather_reference,
                        microbench_scatter_reference)
from .stream_plan import LANES, SPAN_ROWS, SUBS, step_rows

# k the fused SpMM kernels are built for (csrc/spmm_k.cuh): the range the
# reference fuses (tilespmv_tpu/ops/spmv.py:84)
SPMM_K = range(2, 17)
# tile rows of one dense.cu and dense_spmm.cu block (their kWarps): a
# block is one lane group of DENSE_GROUP tiles by DENSE_ROWS of the 16 rows
DENSE_ROWS = 8
# lanes of one band.cu and band_spmm.cu block (their kLanes), by all 16
# rows
BAND_GROUP = 32
# slabs per block of the stream kernels (stream.cu, stream2.cu): a block
# takes up to this many consecutive slabs of one step. 2 was the fastest
# of {1, 2, 4, S} on the flagship stream classes of both dtypes, and
# stream2.cu's of {1, 2, 4, 8, S} at k = 8 and 16 (PERF.md)
STREAM_GROUP = 2
# value dtypes of the kernels: the suffix of their LAUNCHES key and C
# entry (tsp_<kernel><suffix>)
_SUFFIX = {torch.float32: "", torch.float64: "_f64", torch.bfloat16: "_bf16"}
# value dtypes of the W-class and SpMM kernels (no f64 instances)
_F32_BF16 = (torch.float32, torch.bfloat16)
LAUNCHES = {"band": 0, "dense": 0, "sparse": 0, "stream": 0,
            "band_spmm": 0, "dense_spmm": 0, "sparse_spmm": 0, "stream2": 0,
            "band_f64": 0, "dense_f64": 0, "stream_f64": 0,
            **{k + "_bf16": 0 for k in (
                "band", "dense", "sparse", "stream", "band_spmm",
                "dense_spmm", "sparse_spmm", "stream2")},
            "microbench_gather": 0, "microbench_scatter": 0}


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


def _use_kernel(dev: torch.device) -> bool:
    """True for CUDA tensors' device (launch), False for the CPU (plain
    version); anything else raises."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"kernels run on CUDA or CPU tensors, not {dev}")
    return True


def _value_dtype(val, dtypes=tuple(_SUFFIX)) -> torch.dtype:
    """The class's value dtype, one of `dtypes`."""
    if not isinstance(val, torch.Tensor) or val.dtype not in dtypes:
        raise TypeError(f"class values: {getattr(val, 'dtype', val)}, "
                        f"expected one of {dtypes}")
    return val.dtype


def _check_xy(x, y, dtype=torch.float32) -> None:
    """x and y of a class of value dtype `dtype`: in its compute
    dtype."""
    want = acc_dtype(dtype)
    if x.dtype != want or y.dtype != want:
        raise TypeError(f"x and y must be {want} for {dtype} class values, "
                        f"got {x.dtype} and {y.dtype}")
    if x.dim() != 1 or y.dim() != 1 or not x.is_contiguous() \
            or not y.is_contiguous():
        raise ValueError("x and y must be contiguous 1-D tensors")
    if x.device != y.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")


def _check_xy_mm(name: str, x, y) -> int:
    """k of x (rows, k) and y (ylen, k), checked against SPMM_K."""
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"{name}: x and y must be float32")
    if x.dim() != 2 or y.dim() != 2 or not x.is_contiguous() \
            or not y.is_contiguous():
        raise ValueError(f"{name}: x and y must be contiguous 2-D tensors")
    if x.device != y.device:
        raise ValueError(f"{name}: x on {x.device}, y on {y.device}")
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError(f"{name}: x and y must start 16-byte aligned "
                         "(the kernels read whole rows as vectors)")
    k = x.shape[1]
    if y.shape[1] != k:
        raise ValueError(f"{name}: x has {k} columns, y {y.shape[1]}")
    if k not in SPMM_K:
        raise ValueError(f"{name}: k = {k}, the kernel takes "
                         f"{SPMM_K.start} <= k < {SPMM_K.stop}")
    return k


def _check_aligned16(name: str, x, y) -> None:
    """x and y of the W-class kernel: 16-byte aligned (it reads x blocks
    as float4 and adds into y by float4 atomics)."""
    for arg, t in (("x", x), ("y", y)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start 16-byte aligned, "
                             f"it starts at byte {t.data_ptr() % 16} of 16")


def _p(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check_band(bd, dev, dtype=torch.float32) -> tuple:
    nch, C = bd.val.shape[0], bd.val.shape[1]
    _check("band.val", bd.val, dtype, (nch, C, 16, 16, ROW_WINDOW), dev)
    _check("band.bloc", bd.bloc, torch.int32, (nch, 1, ROW_WINDOW), dev)
    _check("pb", bd.pb, torch.int32, (nch * bd.k_panels,), dev)
    _check("band.cw", bd.cw, torch.int32, (nch,), dev)
    return nch, C


def _check_dense(d, dev, dtype=torch.float32) -> int:
    nch, T = d.val.shape[0], d.t_lanes
    if nch % d.c_batch:
        raise ValueError("dense: chunk count not a multiple of c_batch")
    nsteps = nch // d.c_batch
    _check("dense.val", d.val, dtype, (nch, 16, 16, T), dev)
    _check("dense.meta", d.meta, torch.int32,
           (nch, DENSE_MROWS + prefix_rows(T, d.route), T), dev)
    _check("pb", d.pb, torch.int32, (nsteps * d.k_panels,), dev)
    _check("dense.cw", d.cw, torch.int32, (nsteps,), dev)
    return nch


def _check_dense_derived(d, nch: int, dev) -> int:
    """dense.cu's derived arrays (cmask, groups); returns the group
    count."""
    _check("dense.cmask", d.cmask, torch.int32, (nch, d.t_lanes), dev)
    ng = d.groups.shape[0] if isinstance(d.groups, torch.Tensor) else -1
    _check("dense.groups", d.groups, torch.int32, (ng,), dev)
    return ng


def _check_sparse(s, dev, dtype=torch.float32) -> int:
    nch, W, T = s.val.shape[0], s.width, s.t_lanes
    if nch % s.c_batch:
        raise ValueError("sparse: chunk count not a multiple of c_batch")
    nsteps = nch // s.c_batch
    _check("sparse.val", s.val, dtype, (nch, W, T), dev)
    _check("sparse.meta", s.meta, torch.int32,
           (nch, sparse_meta_rows(W) + prefix_rows(T, s.route), T), dev)
    _check("pb", s.pb, torch.int32, (nsteps * s.k_panels,), dev)
    _check("sparse.cw", s.cw, torch.int32, (nsteps,), dev)
    return nch


def _check_stream(st, dev, dtype=torch.float32) -> int:
    S, R = st.s_batch, st.rounds
    nsteps = st.cw.shape[0]
    nsl = nsteps * S
    _check("stream.val", st.val, dtype, (nsl, SUBS, LANES), dev)
    _check("stream.vidx", st.vidx, torch.int16, (nsl, SUBS, LANES), dev)
    _check("stream.erow", st.erow, torch.int16, (nsl, SUBS, LANES), dev)
    _check("stream.planes", st.planes, torch.int8,
           (nsteps, step_rows(st.scatter, R, S), LANES), dev)
    _check("stream.sbase", st.sbase, torch.int32, (nsl,), dev)
    if st.sbase2 is not None:
        _check("stream.sbase2", st.sbase2, torch.int32, (nsl,), dev)
    if st.xmap is not None:
        _check("stream.xmap", st.xmap, torch.int32, (nsl * SPAN_ROWS,),
               dev)
    _check("stream.cw", st.cw, torch.int32, (nsteps,), dev)
    _check("stream.sactive", st.sactive, torch.int32, (nsteps,), dev)
    return nsteps


def stream_blocks(st, group: int = STREAM_GROUP) -> int:
    """Blocks of one stream.cu launch on class `st`: ceil(S / group) per
    step, `group` clamped to [1, S]."""
    g = min(max(1, group), st.s_batch)
    return st.cw.shape[0] * -(-st.s_batch // g)


def dense_launch(d, table: bool = True, k: int = 1) -> dict:
    """One dense.cu launch on class `d` (tensors on any device), or at
    k > 1 one dense_spmm.cu launch (the same grid): "blocks" and
    "threads"; "active" tiles of "slots" lanes; "val_bytes", the 32-byte
    sectors of values that its warps load (a sector of lanes
    t..t+32/vbytes-1 of (c, j, i) wherever one of its lanes has column
    j), and "bytes", those plus the indices of each group (its entry,
    meta's two rows and cmask over its lanes), each active tile's x block
    and its 16 y rows, k values each. `table` False: the arm over every
    lane group."""
    nch, T = d.val.shape[0], d.t_lanes
    vb = d.val.element_size()
    per = 32 // vb
    ng = int(d.groups.shape[0]) if table else nch * T // DENSE_GROUP
    bits = torch.arange(16, device=d.cmask.device, dtype=torch.int32)
    cols = ((d.cmask[:, None, :] >> bits[None, :, None]) & 1) != 0
    sectors = int(cols.view(nch, 16, T // per, per).any(dim=3).sum())
    active = int((d.meta[:, 0] >= 0).sum())
    val_bytes = sectors * 16 * 32
    xb = acc_dtype(d.val.dtype).itemsize
    nbytes = (val_bytes + ng * (1 + 3 * DENSE_GROUP) * 4
              + active * 2 * 16 * xb * k)
    return dict(blocks=ng * (16 // DENSE_ROWS),
                threads=ng * 16 * DENSE_GROUP, active=active,
                slots=nch * T, val_bytes=val_bytes, bytes=nbytes)


def band_launch(bd, k: int = 1) -> dict:
    """One band.cu launch on class `bd` (tensors on any device), or at
    k > 1 one band_spmm.cu launch (the same grid): "blocks", one for each
    group of BAND_GROUP lanes of a window; "val_bytes", the brick (zeros
    included); "bytes", the layout floor's bytes: the brick, bloc, pb and
    cw, each distinct x block the class reads once (16 rows of k values)
    and its y rows read and written (k values each)."""
    nch, C = bd.val.shape[0], bd.val.shape[1]
    vb = bd.val.element_size()
    pb = bd.pb.view(nch, bd.k_panels).long()
    loc = (bd.bloc.view(nch, 1, ROW_WINDOW).long()
           + torch.arange(C, device=pb.device)[None, :, None])
    tc = (pb.gather(1, (loc >> 8).view(nch, -1)) * PANEL_TC
          + (loc & (PANEL_TC - 1)).view(nch, -1))
    xblocks = int(torch.unique(tc).numel())
    val_bytes = bd.val.numel() * vb
    index = sum(t.numel() * t.element_size()
                for t in (bd.bloc, bd.pb, bd.cw))
    xb = acc_dtype(bd.val.dtype).itemsize
    nbytes = (val_bytes + index + xblocks * 16 * xb * k
              + 2 * nch * ROW_WINDOW * 16 * xb * k)
    return dict(blocks=nch * ROW_WINDOW // BAND_GROUP, val_bytes=val_bytes,
                bytes=nbytes)


def _band_args(bd, dev, dt) -> tuple:
    nch, C = _check_band(bd, dev, dt)
    return (bd.val, bd.bloc, bd.pb, bd.cw), (nch, C, bd.k_panels)


def _dense_args(d, dev, dt) -> tuple:
    nch = _check_dense(d, dev, dt)
    ng = _check_dense_derived(d, nch, dev)
    return ((d.val, d.meta, d.cmask, d.groups, ng, d.pb, d.cw),
            (d.t_lanes, d.meta.shape[1], d.k_panels, d.c_batch))


def _sparse_args(s, dev, dt) -> tuple:
    nch = _check_sparse(s, dev, dt)
    return ((s.val, s.meta, s.pb, s.cw),
            (nch, s.width, s.t_lanes, s.meta.shape[1], s.k_panels,
             s.c_batch))


def _stream_args(st, dev, dt, group: int) -> tuple:
    nsteps = _check_stream(st, dev, dt)
    sb2 = st.sbase2 if st.sbase2 is not None else st.sbase
    return ((st.val, st.vidx, st.erow, st.sbase, sb2, st.xmap, st.cw,
             st.sactive),
            (nsteps, st.s_batch, st.span_rows, min(max(1, group),
                                                   st.s_batch)))


# kind: (its checks and launch arguments, SpMV kernel, SpMM kernel); the
# plain versions are reference.PLAIN's
_KINDS = {"band": (_band_args, "band", "band_spmm"),
          "dense": (_dense_args, "dense", "dense_spmm"),
          "sparse": (_sparse_args, "sparse", "sparse_spmm"),
          "stream": (_stream_args, "stream", "stream2")}


class ClassLaunch:
    """One class kernel over one class, its plan side done once: the
    class's value dtype and plan arrays checked on `dev` (`_check_*`),
    its entry point resolved from `build.load()` and its plan arguments
    made. `kind` is "band", "dense", "sparse" or "stream"; `mm` picks the
    SpMM kernel (f32 and bf16 values; the stream classes' is stream2.cu);
    `group` is stream_spmv's. Calling it with a padded x and a y checks
    those alone and launches; on the CPU it runs the class's plain
    version. The plan arrays must stay where they are: a launch passes
    the addresses it took when it was made."""

    __slots__ = ("cls", "name", "dtype", "mm", "device", "fn", "head",
                 "tail", "nk", "plain")

    def __init__(self, kind: str, cls, dev: torch.device, mm: bool = False,
                 group: int = STREAM_GROUP):
        args, mv, mmk = _KINDS[kind]
        kernel, self.plain = (mmk if mm else mv), PLAIN[mm][kind]
        self.dtype = _value_dtype(cls.val, _F32_BF16 if mm or kind == "sparse"
                                  else tuple(_SUFFIX))
        extra = (group,) if kind == "stream" else ()
        head, self.tail = args(cls, dev, self.dtype, *extra)
        # the LAUNCHES key; the C entry is tsp_<name>
        self.name = kernel + _SUFFIX[self.dtype]
        self.cls, self.mm, self.device = cls, mm, dev
        # k follows the tail once, twice for stream2 (k and X's stride)
        self.nk = (2 if kind == "stream" else 1) if mm else 0
        self.fn = self.head = None
        if _use_kernel(dev):
            self.fn = getattr(build.load(), "tsp_" + self.name)
            self.head = tuple(_p(a) if isinstance(a, torch.Tensor) else a
                              for a in head)

    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 stream=None) -> torch.Tensor:
        """Checks x and y (dtype, contiguity, device; for SpMM k, for
        SpMM and the W-class 16-byte alignment), then launches on
        `stream` (a cudaStream_t handle; None: the current stream), or
        runs the plain version on the CPU."""
        if self.mm:
            _check_xy_mm(self.name, x, y)
        else:
            _check_xy(x, y, self.dtype)
            if self.name.startswith("sparse"):
                _check_aligned16(self.name, x, y)
        if y.device != self.device:
            raise ValueError(f"{self.name}: x and y on {y.device}, the "
                             f"class on {self.device}")
        if self.fn is None:
            return self.plain(self.cls, x, y)
        err = self.fn(*self.head, x.data_ptr(), y.data_ptr(), *self.tail,
                      *x.shape[1:] * self.nk,
                      _stream() if stream is None else stream)
        _launched(self.name, err)
        return y


def band_spmv(bd, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Band (brick) class: y[(cw*256 + t)*16 + i] += brick row sums
    (f32, f64 or bf16 values)."""
    return ClassLaunch("band", bd, y.device)(x, y)


def dense_spmv(d, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dense class: densified 16x16 tiles, routed by meta[LROW] (f32, f64
    or bf16 values); the kernel runs the lane groups in `groups` and, in
    each tile, the columns in its `cmask`."""
    return ClassLaunch("dense", d, y.device)(x, y)


def sparse_spmv(s, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """W-class: packed sparse-entry tiles, routed by meta[LROW] (f32 or
    bf16 values); each row sums its own slots (sparse_rows_reference).
    x and y must start 16-byte aligned, as torch allocates them (a view
    such as y[1:] is refused: ValueError)."""
    return ClassLaunch("sparse", s, y.device)(x, y)


def stream_spmv(st, x: torch.Tensor, y: torch.Tensor,
                group: int = STREAM_GROUP) -> torch.Tensor:
    """Stream class: entry slabs, each entry added into its own output
    row `erow` (f32, f64 or bf16 values); a block takes `group` slabs of
    a step."""
    return ClassLaunch("stream", st, y.device, group=group)(x, y)


def band_spmm(bd, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Band class (f32 or bf16 values) over the k columns of x (rows, k)
    into y (ylen, k), every product taken (band_reference)."""
    return ClassLaunch("band", bd, y.device, mm=True)(x, y)


def dense_spmm(d, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dense class (f32 or bf16 values) over the k columns of x (rows, k)
    into y (ylen, k); the kernel runs the lane groups in `groups` and, in
    each tile, the columns in its `cmask` (dense_active_reference)."""
    return ClassLaunch("dense", d, y.device, mm=True)(x, y)


def sparse_spmm(s, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """W-class (f32 or bf16 values) over the k columns of x (rows, k)
    into y (ylen, k); each row sums its own slots
    (sparse_spmm_reference)."""
    return ClassLaunch("sparse", s, y.device, mm=True)(x, y)


def stream_spmm(st, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Stream class (f32 or bf16 values) over the k columns of x (rows, k)
    into y (ylen, k) in one launch: each entry added into its own output
    row `erow` of every column (stream_rows_reference); a block takes
    STREAM_GROUP slabs of a step."""
    return ClassLaunch("stream", st, y.device, mm=True)(x, y)


def _mb_out(dev, nsteps: int) -> torch.Tensor:
    if not 1 <= nsteps < 2 ** 31:
        raise ValueError(f"nsteps = {nsteps}: a launch runs 1 <= nsteps "
                         "< 2**31 steps")
    return torch.empty((SUBS, LANES), dtype=torch.float32, device=dev)


def microbench_gather(src: torch.Tensor, idx: torch.Tensor, r: int,
                      nsteps: int = 1) -> torch.Tensor:
    """The gather microbenchmark at group width r in MB_GATHER_R: src
    (512, 128) float32, idx (512, 128) int8 in [0, 128); returns the
    (8, 128) result of reference.microbench_gather_reference. On CUDA
    one launch runs `nsteps` steps on min(G, nsteps) clusters
    (microbench_grid), each step computing and storing that same
    result."""
    dev = src.device
    _check("src", src, torch.float32, (MB_ROWS, LANES), dev)
    _check("idx", idx, torch.int8, (MB_ROWS, LANES), dev)
    if r not in MB_GATHER_R:
        raise ValueError(f"microbench_gather: R = {r}, not in {MB_GATHER_R}")
    out = _mb_out(dev, nsteps)
    if not _use_kernel(out.device):
        return microbench_gather_reference(src, idx, r)
    units = min(microbench_grid("microbench_gather", r)[0], nsteps)
    err = build.load().tsp_mb_gather(_p(src), _p(idx), _p(out), r, nsteps,
                                     units, _stream())
    _launched("microbench_gather", err)
    return out


def microbench_scatter(arm: str, csum: torch.Tensor, pe: torch.Tensor,
                       nsteps: int = 1) -> torch.Tensor:
    """The scatter microbenchmark's `arm` (MB_SCATTER_ARMS): csum
    (104, 128) float32, pe (MB_PE_ROWS, 128) int8 in [0, 8) for rounds
    and [0, 128) otherwise; returns the (8, 128) result of
    reference.microbench_scatter_reference. On CUDA one launch runs
    `nsteps` steps on min(G, nsteps) units (microbench_grid), each step
    computing and storing that result."""
    dev = csum.device
    _check("csum", csum, torch.float32, (MB_SLABS * SUBS, LANES), dev)
    _check("pe", pe, torch.int8, (MB_PE_ROWS, LANES), dev)
    if arm not in MB_SCATTER_ARMS:
        raise ValueError(f"microbench_scatter: arm {arm!r}, not one of "
                         f"{MB_SCATTER_ARMS}")
    out = _mb_out(dev, nsteps)
    if not _use_kernel(out.device):
        return microbench_scatter_reference(arm, csum, pe)
    units = min(microbench_grid("microbench_scatter", arm)[0], nsteps)
    err = build.load().tsp_mb_scatter(_p(csum), _p(pe), _p(out),
                                      MB_SCATTER_ARMS.index(arm), nsteps,
                                      units, _stream())
    _launched("microbench_scatter", err)
    return out


_MB_GRID = {}


def microbench_grid(name: str, variant) -> tuple[int, int]:
    """(G, blocks a unit) of a microbenchmark kernel on the current card:
    `name` "microbench_gather" with R, or "microbench_scatter" with an
    arm. A unit is one block or a cluster of two that computes a step;
    G is the most units resident at once (SMs x blocks an SM, or
    cudaOccupancyMaxActiveClusters), the persistent grid a launch of
    nsteps >= G steps runs on. Needs the card; cached per card."""
    if name == "microbench_gather" and variant in MB_GATHER_R:
        entry, arg = "tsp_mb_gather_grid", variant
    elif name == "microbench_scatter" and variant in MB_SCATTER_ARMS:
        entry, arg = "tsp_mb_scatter_grid", MB_SCATTER_ARMS.index(variant)
    else:
        raise ValueError(f"no microbenchmark kernel {name!r} {variant!r}")
    key = (name, variant, torch.cuda.current_device())
    if key not in _MB_GRID:
        n, cluster = ctypes.c_int(0), ctypes.c_int(0)
        err = getattr(build.load(), entry)(arg, ctypes.byref(n),
                                           ctypes.byref(cluster))
        if err != 0 or n.value < 1 or cluster.value not in (1, 2):
            raise RuntimeError(f"{name} {variant}: grid query failed (CUDA "
                               f"error {err}, {n.value} units of "
                               f"{cluster.value} blocks)")
        _MB_GRID[key] = (n.value, cluster.value)
    return _MB_GRID[key]
