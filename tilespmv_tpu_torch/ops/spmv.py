"""Public SpMV / SpMM operator.

`TileSpMV` converts a matrix (CSR or an already-converted TileMatrix)
into the lane-major execution plan of its `dtype` (float32, or float64
as the reference's f64 plan with native-FP64 values) and computes
y = A @ x (`forward`) and Y = A @ X for X (n, k) (`matmat`; `op @ x`
takes either). It is an
`nn.Module` whose plan arrays are registered buffers, so `.to(device)`
moves the plan. It is built on the card unless the caller asks for
another device: on a CUDA device it runs the hand-written class kernels
(ops/cuda/kernels.py::spmv_cuda / spmm_cuda); built with
`device="cpu"` it runs their plain PyTorch versions
(ops/cuda/reference.py::spmv_reference / spmm_reference).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch
from torch import nn

from ..core.convert import tile_create
from ..core.tile_matrix import TileMatrix
from ..io.mmio import CSRMatrix
from .cuda.kernels import SPMM_K, spmm_cuda, spmv_cuda
from .cuda.lane_plan import LanePlan, build_lane_plan, map_arrays
from .cuda.reference import spmm_reference, spmv_reference


class TileSpMV(nn.Module):
    """Tiled f32 or f64 SpMV / SpMM operator.

    >>> op = TileSpMV(csr)                  # convert + plan + upload
    >>> y = op(x)                           # y = A @ x on op's device
    >>> Y = op.matmat(X)                    # Y = A @ X, X (n, k)
    >>> y, Y = op @ x, op @ X
    >>> op64 = TileSpMV(csr, dtype=torch.float64)
    >>> op_cpu = TileSpMV(csr, device="cpu")  # the plain versions
    """

    DTYPES = (torch.float32, torch.float64)

    def __init__(self, a: Union[CSRMatrix, TileMatrix],
                 device: Union[str, torch.device, None] = None,
                 dtype: torch.dtype = torch.float32):
        """`a`: a CSRMatrix (converted with the default TileConfig) or
        a TileMatrix from tile_create with any config of tile size 16.
        `device`: where the plan lives and the SpMV runs; None is the
        card ("cuda"), and raises RuntimeError where there is none.
        `dtype`: the compute dtype, torch.float32 or torch.float64 (the
        reference's `compute_dtype`); x is cast to it and y has it."""
        super().__init__()
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
        if not isinstance(a, TileMatrix):
            a = tile_create(a)
        plan = build_lane_plan(a, compute_dtype=np.dtype(
            str(dtype).replace("torch.", "")))
        self.summary = plan.summary()
        self.nnz = plan.nnz
        self._bytes_accessed = plan.bytes_accessed()

        def register(name, arr):
            self.register_buffer(name, torch.from_numpy(
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

    def _run(self, x: torch.Tensor, cuda_fn, cpu_fn) -> torch.Tensor:
        plan = self.device_plan()
        if x.device.type == "cuda":
            return cuda_fn(plan, x)
        if x.device.type == "cpu":
            return cpu_fn(plan, x)
        raise ValueError(f"TileSpMV runs on CUDA or CPU, not {x.device}")

    def forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if x.shape != (self._skeleton.n,):
            raise ValueError(f"x has shape {tuple(x.shape)}, "
                             f"expected ({self._skeleton.n},)")
        return self._run(x, spmv_cuda, spmv_reference)

    def matmat(self, x) -> torch.Tensor:
        """Y = A @ X for X (n, k): the fused SpMM kernels for k in SPMM_K
        (2..16) on an f32 operator, one SpMV per column otherwise and on
        an f64 one, as the reference dispatches
        (tilespmv_tpu/ops/spmv.py:69-89)."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if x.dim() != 2 or x.shape[0] != self._skeleton.n:
            raise ValueError(f"X has shape {tuple(x.shape)}, expected "
                             f"({self._skeleton.n}, k)")
        if x.shape[1] not in SPMM_K or self.dtype != torch.float32:
            return torch.stack([self.forward(x[:, r])
                                for r in range(x.shape[1])], dim=1)
        return self._run(x, spmm_cuda, spmm_reference)

    def __matmul__(self, x) -> torch.Tensor:
        """op @ x: SpMV for 1-D x, SpMM for 2-D x."""
        x = torch.as_tensor(x)
        if x.dim() == 1:
            return self(x)
        if x.dim() == 2:
            return self.matmat(x)
        raise ValueError(f"op @ x needs x of rank 1 or 2, got {x.dim()}")
