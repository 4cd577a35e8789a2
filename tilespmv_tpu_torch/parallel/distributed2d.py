"""2-D block-partitioned SpMV over a (rows x cols) device mesh.

Port of tilespmv_tpu/parallel/distributed2d.py:

* device (i, j) holds block A_ij (row stripe i x column stripe j) as a
  `TileSpMV` of its own, converted and planned on its own (the 1-D
  partition's shard-uniform options, distributed._plan_blocks);
* device (i, j) receives x_j, the column stripe its block reads, and
  no other x;
* each device computes the partial y_ij = A_ij @ x_j, and the row
  stripe is summed over the column axis with `mesh.psum`;
* y's row stripes stay on devices (i, 0) (`shard_outputs`) or come back
  as one y on the first mesh device (`op(x)`).

As in the 1-D operator, shards run their own plans unpadded, and the
operator is not an `nn.Module`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULT_CONFIG, TileConfig
from ..core.convert import tile_create
from ..io.mmio import CSRMatrix
from .distributed import _gather_to, _row_block, resolve_backend, shard_ops
from .mesh import COL_AXIS, Mesh, make_mesh2d, on, psum


def _col_slice(csr: CSRMatrix, c0: int, c1: int, cols_padded: int):
    sel = (csr.indices >= c0) & (csr.indices < c1)
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))[sel]
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=csr.m))]).astype(
            np.int64)
    return CSRMatrix((csr.m, cols_padded), indptr,
                     (csr.indices[sel] - c0).astype(csr.indices.dtype),
                     csr.data[sel])


class DistributedSpMV2D:
    """Block-partitioned SpMV: y_i = psum_j(A_ij @ x_j).

    >>> op = DistributedSpMV2D(csr, mesh=make_mesh2d(2, 4))
    >>> y = op(x)                     # y on the mesh's first device
    """

    def __init__(self, csr: CSRMatrix,
                 mesh: Optional[Mesh] = None,
                 config: TileConfig = DEFAULT_CONFIG,
                 dtype: torch.dtype = torch.float32,
                 backend: str = "auto"):
        backend = resolve_backend(backend, config)
        self.mesh = mesh if mesh is not None else make_mesh2d(1, 1)
        nrow, ncol = self.mesh.shape
        b = config.tile_size
        m, n = csr.shape
        rows_per = -(- -(-m // b) // nrow) * b
        cols_per = -(-n // (ncol * b)) * b
        self.m, self.n = m, n
        self.rows_per, self.cols_per = rows_per, cols_per
        self.dtype = dtype
        self.backend = backend

        blocks = []
        for i in range(nrow):
            stripe = _row_block(csr, i * rows_per, (i + 1) * rows_per,
                                rows_per)
            for j in range(ncol):
                blocks.append(_col_slice(stripe, j * cols_per,
                                         min((j + 1) * cols_per, n),
                                         cols_per))
        self.tile_matrices = [tile_create(blk, config) for blk in blocks]
        self.shards, use = shard_ops(self.tile_matrices, self.mesh.flat(),
                                     backend, dtype)
        self.use_stream = (use,)
        self.n_x_pad = ncol * cols_per
        self.nnz = sum(op.nnz for op in self.shards)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.m, self.n)

    def flops(self) -> int:
        """2 * nnz of the whole matrix."""
        return 2 * self.nnz

    def shard_outputs(self, x) -> list:
        """y's row stripes: stripe i (`rows_per` rows) on mesh device
        (i, 0)."""
        devs = self.mesh.flat()
        nrow, ncol = self.mesh.shape
        x = torch.as_tensor(x, dtype=self.dtype, device=devs[0])
        if x.shape != (self.n,):
            raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                             f"({self.n},)")
        xj = F.pad(x, (0, self.n_x_pad - self.n)).split(self.cols_per)
        parts = []
        for d, (op, dev) in enumerate(zip(self.shards, devs)):
            with on(dev):
                parts.append(op(xj[d % ncol].to(dev)))
        sums = psum(parts, self.mesh, COL_AXIS)
        return [sums[i * ncol] for i in range(nrow)]

    def __call__(self, x) -> torch.Tensor:
        """y = A @ x on the mesh's first device."""
        return _gather_to(self.shard_outputs(x), self.mesh.flat()[0], self.m)
