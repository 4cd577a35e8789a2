"""Public SpMV operator.

`TileSpMV` converts a matrix (CSR or an already-converted TileMatrix)
into the lane-major execution plan and computes y = A @ x. It is an
`nn.Module` whose plan arrays are registered buffers, so `.to(device)`
moves the plan. On a CUDA device `forward` runs the hand-written class
kernels (ops/cuda/kernels.py::spmv_cuda); on the CPU it runs their plain
PyTorch versions (ops/cuda/reference.py::spmv_reference).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch
from torch import nn

from ..core.convert import tile_create
from ..core.tile_matrix import TileMatrix
from ..io.mmio import CSRMatrix
from .cuda.kernels import spmv_cuda
from .cuda.lane_plan import LanePlan, build_lane_plan, map_arrays
from .cuda.reference import spmv_reference


class TileSpMV(nn.Module):
    """Tiled f32 SpMV operator.

    >>> op = TileSpMV(csr, device="cuda")   # convert + plan + upload
    >>> y = op(x)                           # y = A @ x on op's device
    """

    def __init__(self, a: Union[CSRMatrix, TileMatrix],
                 device: Union[str, torch.device, None] = None):
        """`a`: a CSRMatrix (converted with the default TileConfig) or
        a TileMatrix from tile_create with any config of tile size 16."""
        super().__init__()
        if not isinstance(a, TileMatrix):
            a = tile_create(a)
        plan = build_lane_plan(a)
        self.summary = plan.summary()
        self.nnz = plan.nnz

        def register(name, arr):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(arr)))
        map_arrays(plan, register)
        # the plan with each array replaced by its buffer's name
        self._skeleton: LanePlan = map_arrays(plan, lambda n, _: n)
        if device is not None:
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

    def forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.shape != (self._skeleton.n,):
            raise ValueError(f"x has shape {tuple(x.shape)}, "
                             f"expected ({self._skeleton.n},)")
        plan = self.device_plan()
        if x.device.type == "cuda":
            return spmv_cuda(plan, x)
        if x.device.type == "cpu":
            return spmv_reference(plan, x)
        raise ValueError(f"TileSpMV runs on CUDA or CPU, not {x.device}")
