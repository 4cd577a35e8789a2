"""Public SpMV / SpMM operator.

`TileSpMV` converts a matrix (CSR or an already-converted TileMatrix)
into the lane-major execution plan of its `dtype` (float32, or float64
as the reference's f64 plan with native-FP64 values) and computes
y = A @ x (`forward`) and Y = A @ X for X (n, k) (`matmat`; `op @ x`
takes either); `op.T` is the transposed operator (`rmatvec`), and
`TileSpMV.from_plan` takes an already-built plan (core/serialize.py's
`load_lane_plan`). It is an `nn.Module` whose plan arrays are registered
buffers, so `.to(device)` moves the plan. It is built on the card unless
the caller asks for another device. The functional `spmv(plan, x)` /
`spmm(plan, X)` run a device plan: on a CUDA device the hand-written
class kernels (ops/cuda/kernels.py::spmv_cuda / spmm_cuda), on the CPU
their plain PyTorch versions (ops/cuda/reference.py::spmv_reference /
spmm_reference).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch
from torch import nn

from ..config import DEFAULT_CONFIG, TileConfig
from ..core.convert import tile_create
from ..core.tile_matrix import TileMatrix
from ..io.mmio import CSRMatrix
from .cuda.kernels import SPMM_K, spmm_cuda, spmv_cuda
from .cuda.lane_plan import LanePlan, build_lane_plan, map_arrays
from .cuda.reference import spmm_reference, spmv_reference


def _run(plan: LanePlan, x: torch.Tensor, cuda_fn, cpu_fn) -> torch.Tensor:
    if x.device.type == "cuda":
        return cuda_fn(plan, x)
    if x.device.type == "cpu":
        return cpu_fn(plan, x)
    raise ValueError(f"TileSpMV runs on CUDA or CPU, not {x.device}")


def spmv(plan: LanePlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a plan whose tensors lie on x's device: the class
    kernels on a CUDA device, their plain versions on the CPU."""
    return _run(plan, x, spmv_cuda, spmv_reference)


def spmm(plan: LanePlan, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for X (n, k) over a plan whose tensors lie on X's
    device: the fused SpMM kernels for k in SPMM_K (2..16) on an f32
    plan, one SpMV per column otherwise and on an f64 one, as the
    reference dispatches (tilespmv_tpu/ops/spmv.py:69-89)."""
    if x.shape[1] not in SPMM_K or plan.dtype != torch.float32:
        return torch.stack([spmv(plan, x[:, r])
                            for r in range(x.shape[1])], dim=1)
    return _run(plan, x, spmm_cuda, spmm_reference)


def _torch_dtype(dt) -> torch.dtype:
    """A plan's value dtype (NumPy or torch) as a torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.empty(0, dt)).dtype


class TileSpMV(nn.Module):
    """Tiled f32 or f64 SpMV / SpMM operator.

    >>> op = TileSpMV(csr)                  # convert + plan + upload
    >>> y = op(x)                           # y = A @ x on op's device
    >>> Y = op.matmat(X)                    # Y = A @ X, X (n, k)
    >>> y, Y = op @ x, op @ X
    >>> z = op.T(y)                         # A^T @ y (op.rmatvec(y))
    >>> op64 = TileSpMV(csr, dtype=torch.float64)
    >>> op_cpu = TileSpMV(csr, device="cpu")  # the plain versions
    >>> op2 = TileSpMV.from_plan(load_lane_plan(path))
    """

    DTYPES = (torch.float32, torch.float64)

    def __init__(self, a: Union[CSRMatrix, TileMatrix],
                 device: Union[str, torch.device, None] = None,
                 dtype: torch.dtype = torch.float32,
                 config: TileConfig = DEFAULT_CONFIG):
        """`a`: a CSRMatrix (converted with `config`) or a TileMatrix
        from tile_create with any config of tile size 16 (`config` is
        then not used). `device`: where the plan lives and the SpMV
        runs; None is the card ("cuda"), and raises RuntimeError where
        there is none. `dtype`: the compute dtype, torch.float32 or
        torch.float64 (the reference's `compute_dtype`); x is cast to it
        and y has it. A tile size other than 16 raises
        NotImplementedError."""
        super().__init__()
        device = self._setup(device, dtype)
        # kept for .T: the transpose is planned from the source CSR (a
        # TileMatrix cannot be transposed without re-tiling anyway)
        self._source_csr = a if isinstance(a, CSRMatrix) else None
        self._config = config
        if not isinstance(a, TileMatrix):
            a = tile_create(a, config)
        self._register_plan(build_lane_plan(a, compute_dtype=np.dtype(
            str(dtype).replace("torch.", ""))), device)

    @classmethod
    def from_plan(cls, plan: LanePlan,
                  device: Union[str, torch.device, None] = None,
                  dtype: torch.dtype = torch.float32) -> "TileSpMV":
        """The operator over an already-built plan (arrays NumPy or
        tensors, e.g. core/serialize.py's load_lane_plan), skipping
        conversion and planning, which are the largest one-time host
        cost. `dtype` must be the plan's value dtype (ValueError
        otherwise); `device` as in the constructor. Such an operator has
        no source CSR, so it has no `.T`."""
        op = cls.__new__(cls)
        nn.Module.__init__(op)
        device = op._setup(device, dtype)
        if _torch_dtype(plan.dtype) != dtype:
            raise ValueError(f"the plan holds {plan.dtype} values, not "
                             f"{dtype}")
        op._source_csr = op._config = None
        op._register_plan(plan, device)
        return op

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
        # the transposed operator, built at first use of .T; set past
        # nn.Module's __setattr__ so that op and op.T, which refer to
        # each other, are not each other's submodules
        object.__setattr__(self, "_transpose", None)
        return device

    def _register_plan(self, plan: LanePlan, device) -> None:
        """Registers each plan array as a buffer and moves them to
        `device`."""
        self.summary = plan.summary()
        self.nnz = plan.nnz
        self._bytes_accessed = plan.bytes_accessed()

        def register(name, arr):
            self.register_buffer(name, arr if isinstance(arr, torch.Tensor)
                                 else torch.from_numpy(
                                     np.ascontiguousarray(arr)))
        map_arrays(plan, register)
        # the plan with each array replaced by its buffer's name
        self._skeleton: LanePlan = map_arrays(plan, lambda n, _: n)
        self.to(device)

    @property
    def shape(self) -> tuple[int, int]:
        return (self._skeleton.m, self._skeleton.n)

    @property
    def device(self) -> torch.device:
        return self.residual_val.device

    def device_plan(self) -> LanePlan:
        """The plan with its arrays as this module's (device) buffers."""
        return map_arrays(self._skeleton, lambda n, _: getattr(self, n))

    def flops(self) -> int:
        """Floating-point operations of one SpMV: 2 * nnz."""
        return 2 * self.nnz

    def bytes_accessed(self) -> int:
        """Plan bytes one SpMV streams (class payloads + x + y)."""
        return self._bytes_accessed

    @property
    def T(self) -> "TileSpMV":
        """The transposed operator (y = A^T @ x), converted and planned
        on first use (on this operator's device, in its dtype and
        config) and cached; `op.T.T is op`. It is planned from the
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
                         dtype=self.dtype, config=self._config)
            object.__setattr__(t, "_transpose", self)
            object.__setattr__(self, "_transpose", t)
        return self._transpose

    def rmatvec(self, x) -> torch.Tensor:
        """y = A^T @ x (scipy.sparse.linalg.LinearOperator convention)."""
        return self.T(x)

    def forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if x.shape != (self._skeleton.n,):
            raise ValueError(f"x has shape {tuple(x.shape)}, "
                             f"expected ({self._skeleton.n},)")
        return spmv(self.device_plan(), x)

    def matmat(self, x) -> torch.Tensor:
        """Y = A @ X for X (n, k) (see `spmm`)."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if x.dim() != 2 or x.shape[0] != self._skeleton.n:
            raise ValueError(f"X has shape {tuple(x.shape)}, expected "
                             f"({self._skeleton.n}, k)")
        return spmm(self.device_plan(), x)

    def __matmul__(self, x) -> torch.Tensor:
        """op @ x: SpMV for 1-D x, SpMM for 2-D x."""
        x = torch.as_tensor(x)
        if x.dim() == 1:
            return self(x)
        if x.dim() == 2:
            return self.matmat(x)
        raise ValueError(f"op @ x needs x of rank 1 or 2, got {x.dim()}")
