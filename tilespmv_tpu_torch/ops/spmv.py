"""Public SpMV / SpMM operator.

`TileSpMV` converts a matrix (CSR or an already-converted TileMatrix)
into the lane-major execution plan of its `dtype` (float32; float64 as
the reference's f64 plan with native-FP64 values; or bfloat16, the f32
plan with bf16 values, summed in float32 as the reference sums them) and
computes
y = A @ x (`forward`) and Y = A @ X for X (n, k) (`matmat`; `op @ x`
takes either); `op.T` is the transposed operator (`rmatvec`), and
`TileSpMV.from_plan` takes an already-built plan (core/serialize.py's
`load_lane_plan`). It is an `nn.Module` whose plan arrays are registered
buffers, so `.to(device)` moves the plan. It is built on the card unless
the caller asks for another device.

`max_cols_per_plan` splits the columns into parts of (limit // B) * B
columns, each its own operator (`op.parts`), whose partial y's are
summed, as the reference's column partitioning does. It is there so
that the reference's callers run unchanged: on the card the parts only
add launches, and one plan gives the same y. The default is None: no
partitioning. The reference partitions above 2**21 columns because its
engines keep the whole x resident in on-chip memory; the card's kernels
read x from global memory, so a plan of any width runs as one.

`backend` takes the reference's names (tilespmv_tpu/ops/spmv.py):

* "pallas" — the lane plan (ops/cuda/lane_plan.py) and its class
  kernels, which are the hand-written CUDA kernels on the card (their
  plain PyTorch versions on the CPU); tile size 16 only;
* "xla"    — the SpMVPlan (ops/plan.py) and the plain torch engines of
  ops/xla_spmv.py (the reference computes them as plain XLA ops), on
  the card or the CPU; any tile size 1..16;
* "auto"   — "pallas" exactly when the tile size is 16, as the
  reference picks.

An operator builds its call state at its first call (`_CallState`: the
device plan, each class's checked launch, a padded x kept per stream)
and every later call reuses it; moving its buffers (`.to()`) drops it.
The functional `spmv(plan, x)` / `spmm(plan, X)` run a device plan
through a call state of their own, made for the call: an SpMVPlan
through the xla engines, a LanePlan through the class kernels on a CUDA
device and their plain versions on the CPU, each class's launch inside
ops/cuda/reference.py::assemble. No path gives way to another device or
backend.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..config import DEFAULT_CONFIG, TileConfig
from ..core.convert import tile_create
from ..core.tile_matrix import TileMatrix
from ..io.mmio import CSRMatrix
from ..spans import phase, record_plan, span, state_built
from .cuda.kernels import SPMM_K, ClassLaunch
from .cuda.lane_plan import LanePlan, build_lane_plan, map_arrays
from .cuda.reference import (assemble, checked_x, class_order, pad_x,
                             plan_tensor)
from .plan import SpMVPlan, build_plan, map_plan_arrays
from .xla_spmv import spmm_xla, spmv_xla

BACKENDS = ("auto", "xla", "pallas")


def spmv(plan: Union[LanePlan, SpMVPlan], x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a plan whose tensors lie on x's device, x cast to
    the plan's value dtype: an SpMVPlan through the xla engines; a
    LanePlan through the class kernels on a CUDA device, their plain
    versions on the CPU."""
    x = checked_x(x, plan.dtype, plan.n, 1)
    return _CallState(plan, x.device).spmv(x)


def spmm(plan: Union[LanePlan, SpMVPlan], x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for X (n, k) over a plan whose tensors lie on X's
    device, as `_CallState.spmm` runs it."""
    x = checked_x(x, plan.dtype, plan.n, 2)
    return _CallState(plan, x.device).spmm(x)


class _CallState:
    """The work of an operator's call that no x changes, done once: the
    device plan; for a LanePlan each class's launch, checked and made
    (kernels.ClassLaunch; the SpMM ones too on an f32 or bf16 plan); and
    one zero-padded x per trailing shape of x and stream, whose padding
    no kernel writes, so that a call copies x into its first n rows
    alone. The functional `spmv` / `spmm` run a state made for the call.
    A call while a CUDA graph is captured pads x afresh."""

    def __init__(self, plan: Union[LanePlan, SpMVPlan],
                 device: torch.device):
        self.plan, self.device, self.n = plan, device, plan.n
        self.pads = {}
        self.mv = self.mm = None
        if isinstance(plan, SpMVPlan):
            return
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"TileSpMV runs on CUDA or CPU, not {device}")
        order = class_order(plan)
        self.mv = [(name, ClassLaunch(kind, c, device))
                   for name, kind, c in order]
        if plan.dtype != torch.float64:
            self.mm = [(name, ClassLaunch(kind, c, device, mm=True))
                       for name, kind, c in order]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x, x (n,) checked and in the plan's value dtype."""
        if self.mv is None:
            return spmv_xla(self.plan, x)
        return assemble(self.plan, x, self.mv, self._pad)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A @ X, X (n, k) checked and in the plan's value dtype: an
        SpMVPlan through the xla engines on all k columns at once; a
        LanePlan through the fused SpMM kernels for k in SPMM_K (2..16)
        on an f32 or bf16 plan, one SpMV per column otherwise and on an
        f64 one, as the reference dispatches
        (tilespmv_tpu/ops/spmv.py:69-89)."""
        if self.mv is None:
            return spmm_xla(self.plan, x)
        if self.mm is None or x.shape[1] not in SPMM_K:
            return torch.stack([self.spmv(x[:, r])
                                for r in range(x.shape[1])], dim=1)
        return assemble(self.plan, x, self.mm, self._pad)

    def _pad(self, x: torch.Tensor, stream) -> torch.Tensor:
        """x in the first n rows of the kept padded x of its trailing
        shape on `stream` (made by pad_x at its first use)."""
        if stream is not None and torch.cuda.is_current_stream_capturing():
            return pad_x(self.plan, x)
        key = (tuple(x.shape[1:]), stream)
        kept = self.pads.get(key)
        if kept is None:
            xp = pad_x(self.plan, x)
            self.pads[key] = xp, xp[: self.n]
            return xp
        xp, head = kept
        head.copy_(x)
        return xp


class TileSpMV(nn.Module):
    """Tiled f32, f64 or bf16 SpMV / SpMM operator.

    >>> op = TileSpMV(csr)                  # convert + plan + upload
    >>> y = op(x)                           # y = A @ x on op's device
    >>> Y = op.matmat(X)                    # Y = A @ X, X (n, k)
    >>> y, Y = op @ x, op @ X
    >>> z = op.T(y)                         # A^T @ y (op.rmatvec(y))
    >>> op64 = TileSpMV(csr, dtype=torch.float64)
    >>> op16 = TileSpMV(csr, dtype=torch.bfloat16)  # bf16 values and y
    >>> op_cpu = TileSpMV(csr, device="cpu")  # the plain versions
    >>> op8 = TileSpMV(csr, config=TileConfig(tile_size=8))  # xla
    >>> opx = TileSpMV(csr, backend="xla")  # the xla engines at B = 16
    >>> op2 = TileSpMV.from_plan(load_lane_plan(path))
    >>> opc = TileSpMV(csr, max_cols_per_plan=1 << 20)  # column parts
    """

    DTYPES = (torch.float32, torch.float64, torch.bfloat16)

    def __init__(self, a: Union[CSRMatrix, TileMatrix],
                 device: Union[str, torch.device, None] = None,
                 dtype: torch.dtype = torch.float32,
                 config: TileConfig = DEFAULT_CONFIG,
                 backend: str = "auto",
                 max_cols_per_plan: Optional[int] = None):
        """`a`: a CSRMatrix (converted with `config`) or a TileMatrix
        from tile_create with any config (`config` is then not used; its
        own tile size counts). `device`: where the plan lives and the
        SpMV runs; None is the card ("cuda"), and raises RuntimeError
        where there is none. `dtype`: the compute dtype, torch.float32,
        torch.float64 or torch.bfloat16 (the reference's
        `compute_dtype`); x is cast to it and y has it (bf16 on the
        pallas backend: the values and x are bf16, every product and sum
        is taken in float32, and y is rounded to bf16 once, as in the
        reference; on the xla backend the engines compute in bf16 as the
        reference's do). `backend`: "auto", "xla" or "pallas" (see the
        module doc); "pallas" with a tile size other than 16 raises
        NotImplementedError, as the reference's lane planner does.
        `max_cols_per_plan`: a matrix wider than this many columns is
        split into column parts (see the module doc; a TileMatrix that
        wide raises ValueError, as it cannot be split, and so does a
        limit below the tile size); None, the default, never splits."""
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: one of "
                             f"{BACKENDS}")
        device = self._setup(device, dtype)
        # kept for .T: the transpose is planned from the source CSR (a
        # TileMatrix cannot be transposed without re-tiling anyway)
        self._source_csr = a if isinstance(a, CSRMatrix) else None
        self._config = config
        limit = max_cols_per_plan
        tile = (a.config if isinstance(a, TileMatrix) else config).tile_size
        if limit is not None and limit < tile:
            raise ValueError(f"max_cols_per_plan={limit} is below the tile "
                             f"size {tile}: a part holds whole tile columns")
        if limit is not None and a.n > limit:
            if not isinstance(a, CSRMatrix):
                raise ValueError(
                    f"matrix is wider (n={a.n}) than max_cols_per_plan="
                    f"{limit}; pass the CSRMatrix so TileSpMV can "
                    "column-partition it")
            self._init_col_partitioned(a, device, dtype, config, backend,
                                       limit)
            return
        if not isinstance(a, TileMatrix):
            a = tile_create(a, config)
        if backend == "auto":
            backend = "pallas" if a.config.tile_size == 16 else "xla"
        build = build_lane_plan if backend == "pallas" else build_plan
        with phase("plan.classes"):
            plan = build(a, compute_dtype=str(dtype).removeprefix("torch."))
        self._register_plan(plan, device)

    @classmethod
    def from_plan(cls, plan: Union[LanePlan, SpMVPlan],
                  device: Union[str, torch.device, None] = None,
                  dtype: torch.dtype = torch.float32) -> "TileSpMV":
        """The operator over an already-built plan, a LanePlan (backend
        "pallas") or an SpMVPlan (backend "xla"), arrays NumPy or
        tensors (e.g. core/serialize.py's load_lane_plan), skipping
        conversion and planning, which are the largest one-time host
        cost. `dtype` must be the plan's value dtype (ValueError
        otherwise); `device` as in the constructor. Such an operator has
        no source CSR, so it has no `.T`."""
        op = cls.__new__(cls)
        nn.Module.__init__(op)
        device = op._setup(device, dtype)
        if plan.dtype != dtype:
            raise ValueError(f"the plan holds {plan.dtype} values, not "
                             f"{dtype}")
        op._source_csr = op._config = None
        op._register_plan(plan, device)
        return op

    def _init_col_partitioned(self, csr: CSRMatrix, device, dtype, config,
                              backend: str, limit: int) -> None:
        """The parts of the reference's column partitioning
        (tilespmv_tpu/ops/spmv.py:_init_col_partitioned): columns c0 ..
        c0 + width - 1, width = (limit // B) * B, as a CSR of shape
        (m, width) (the last part narrower), each an operator of its
        own."""
        width = (limit // config.tile_size) * config.tile_size
        starts = list(range(0, csr.n, width))
        rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
        parts = []
        for c0 in starts:
            c1 = min(c0 + width, csr.n)
            sel = (csr.indices >= c0) & (csr.indices < c1)
            sub = CSRMatrix(
                (csr.m, c1 - c0),
                np.concatenate([[0], np.cumsum(np.bincount(
                    rows[sel], minlength=csr.m))]).astype(np.int64),
                (csr.indices[sel] - c0).astype(csr.indices.dtype),
                csr.data[sel])
            parts.append(TileSpMV(sub, device=device, dtype=dtype,
                                  config=config, backend=backend))
        self.parts = nn.ModuleList(parts)
        self._col_starts = starts
        self._shape = csr.shape
        self.backend = parts[0].backend
        self.nnz = sum(p.nnz for p in parts)
        self._bytes_accessed = sum(p.bytes_accessed() for p in parts)
        self.summary = dict(
            m=csr.m, n=csr.n, nnz=self.nnz, dtype=parts[0].summary["dtype"],
            plan_mbytes=round(self._bytes_accessed / 1e6, 2),
            col_parts=len(parts),
            classes=[dict(c, part=i) for i, p in enumerate(parts)
                     for c in p.summary.get("classes", ())],
            residual_nnz=sum(p.summary.get("residual_nnz", 0)
                             for p in parts),
            residual_bytes=sum(p.summary.get("residual_bytes", 0)
                               for p in parts))
        record_plan(self.summary)

    def _setup(self, device, dtype) -> Union[str, torch.device]:
        """Checks dtype and resolves device; returns the device."""
        if dtype not in self.DTYPES:
            raise ValueError(f"dtype {dtype}: TileSpMV computes in "
                             f"{' or '.join(map(str, self.DTYPES))}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TileSpMV runs on the CUDA card by default and finds "
                    "none; pass device=\"cpu\" to run the kernels' plain "
                    "PyTorch versions on the CPU")
            device = "cuda"
        self.dtype = dtype
        # the column parts of a column-partitioned operator (an
        # nn.ModuleList, so that .to() moves them), else None
        self.parts = None
        # the transposed operator, built at first use of .T; set past
        # nn.Module's __setattr__ so that op and op.T, which refer to
        # each other, are not each other's submodules
        object.__setattr__(self, "_transpose", None)
        # the call state (_CallState), built at the first call
        self._state = None
        return device

    def _register_plan(self, plan: Union[LanePlan, SpMVPlan],
                       device) -> None:
        """Sets the backend from the plan's type, records the plan's
        summary (phase `plan.census`; `spans.plan_census()` reads it),
        registers each plan array as a buffer and moves them to `device`
        (phase `plan.upload`)."""
        with phase("plan.census"):
            self.summary = plan.summary()
        record_plan(self.summary)
        with phase("plan.upload"):
            self.backend = "xla" if isinstance(plan, SpMVPlan) else "pallas"
            self._map = (map_plan_arrays if isinstance(plan, SpMVPlan)
                         else map_arrays)
            self.nnz = plan.nnz
            self._bytes_accessed = plan.bytes_accessed()

            def register(name, arr):
                self.register_buffer(name, plan_tensor(arr))
            self._map(plan, register)
            # the plan with each array replaced by its buffer's name
            self._skeleton = self._map(plan, lambda n, _: n)
            self.to(device)

    def _apply(self, fn, *args, **kwargs):
        # .to(), .cuda(), .cpu(), .half(), ... replace the buffers that
        # the call state points at: the next call builds it anew
        self._state = None
        return super()._apply(fn, *args, **kwargs)

    def __setattr__(self, name, value):
        if name in self.__dict__.get("_buffers", ()):
            # a buffer replaced (load_state_dict(assign=True), ...)
            self._state = None
        super().__setattr__(name, value)

    def __getstate__(self):
        # copies and pickles leave the state behind: it holds the
        # addresses of this operator's buffers
        state = super().__getstate__()
        state["_state"] = None
        return state

    @property
    def shape(self) -> tuple[int, int]:
        if self.parts is not None:
            return self._shape
        return (self._skeleton.m, self._skeleton.n)

    @property
    def device(self) -> torch.device:
        if self.parts is not None:
            return self.parts[0].device
        return self.residual_val.device

    def device_plan(self) -> Union[LanePlan, SpMVPlan]:
        """The plan with its arrays as this module's (device) buffers.
        A column-partitioned operator has one plan per part (`parts`)
        and raises ValueError, as the reference's --save-plan refuses
        one."""
        if self.parts is not None:
            raise ValueError(
                f"a column-partitioned operator has {len(self.parts)} "
                "plans, one per part: take op.parts[i].device_plan()")
        return self._map(self._skeleton, lambda n, _: getattr(self, n))

    def flops(self) -> int:
        """Floating-point operations of one SpMV: 2 * nnz."""
        return 2 * self.nnz

    def bytes_accessed(self) -> int:
        """Plan bytes one SpMV streams (class payloads + x + y)."""
        return self._bytes_accessed

    @property
    def T(self) -> "TileSpMV":
        """The transposed operator (y = A^T @ x), converted and planned
        on first use (on this operator's device, in its dtype, config
        and backend) and cached; `op.T.T is op`. It is planned from the
        source CSR (utils/host.py::csr_transpose, the reference's
        CSR->CSC pass): A^T's tiles differ from A's, so it gets its own
        format selection and plan. Raises ValueError for an operator
        built from a TileMatrix or a plan."""
        if self._transpose is None:
            if self._source_csr is None:
                raise ValueError(
                    ".T needs the source CSRMatrix; construct TileSpMV "
                    "from a CSRMatrix (not a TileMatrix or a "
                    "deserialized plan) to use the transposed operator")
            from ..utils.host import csr_transpose
            t = TileSpMV(csr_transpose(self._source_csr), device=self.device,
                         dtype=self.dtype, config=self._config,
                         backend=self.backend)
            object.__setattr__(t, "_transpose", self)
            object.__setattr__(self, "_transpose", t)
        return self._transpose

    def rmatvec(self, x) -> torch.Tensor:
        """y = A^T @ x (scipy.sparse.linalg.LinearOperator convention)."""
        return self.T(x)

    def _sum_parts(self, x: torch.Tensor, fn) -> torch.Tensor:
        """The sum over the column parts of fn(part, its rows of x)."""
        y = None
        for c0, part in zip(self._col_starts, self.parts):
            yk = fn(part, x[c0: c0 + part.shape[1]])
            y = yk if y is None else y + yk
        return y

    def _prep(self, x, ndim: int):
        """(x cast to the operator's dtype and device, checked; the call
        state, None for a column-partitioned operator), in span
        `tsp.prep` (the state built, at the first call, in
        `tsp.device_plan`)."""
        with span("tsp.prep"):
            st = None
            if self.parts is not None:
                device, n = self.device, self.shape[1]
            else:
                st = self._state
                if st is None:
                    with span("tsp.device_plan"):
                        st = _CallState(self.device_plan(), self.device)
                    self._state = st
                    state_built()
                device, n = st.device, st.n
            return checked_x(x, self.dtype, n, ndim, device), st

    def forward(self, x) -> torch.Tensor:
        """y = A @ x, in span `tsp.forward` (spans.py)."""
        with span("tsp.forward"):
            x, st = self._prep(x, 1)
            if st is None:
                return self._sum_parts(x, TileSpMV.forward)
            return st.spmv(x)

    def matmat(self, x) -> torch.Tensor:
        """Y = A @ X for X (n, k) (see `spmm`), in span `tsp.matmat`."""
        with span("tsp.matmat"):
            x, st = self._prep(x, 2)
            if st is None:
                return self._sum_parts(x, TileSpMV.matmat)
            return st.spmm(x)

    def __matmul__(self, x) -> torch.Tensor:
        """op @ x: SpMV for 1-D x, SpMM for 2-D x."""
        x = torch.as_tensor(x)
        if x.dim() == 1:
            return self(x)
        if x.dim() == 2:
            return self.matmat(x)
        raise ValueError(f"op @ x needs x of rank 1 or 2, got {x.dim()}")
