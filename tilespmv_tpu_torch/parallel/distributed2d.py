"""2-D block-partitioned SpMV over a (rows x cols) device mesh.

Port of tilespmv_tpu/parallel/distributed2d.py:

* device (i, j) holds block A_ij (row stripe i x column stripe j) as a
  `TileSpMV` of its own, converted and planned on its own (the 1-D
  partition's shard-uniform options, distributed.shard_ops);
* device (i, j) receives x_j, the column stripe its block reads, and
  no other x;
* each device computes the partial y_ij = A_ij @ x_j, and the row
  stripe is summed over the column axis with `mesh.psum`;
* y's row stripes stay on devices (i, 0) (`shard_outputs`) or come back
  as one y on the first mesh device (`op(x)`).

As in the 1-D operator, shards run their own plans unpadded, and the
operator is not an `nn.Module`. On a mesh that spans processes each
process converts and plans only its own blocks, `psum` adds a line
across processes by one all_reduce, `shard_outputs` gives the stripes
at this process's positions (i, 0), and `op(x)` the whole y on this
process's first device, by one all_reduce of the stripes at (i, 0)
into a zero y.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULT_CONFIG, TileConfig
from ..core.convert import tile_create
from ..io.mmio import CSRMatrix
from .distributed import (_row_block, global_counts, resolve_backend,
                          shard_ops)
from .mesh import COL_AXIS, Mesh, make_mesh2d, on, process_sum, psum


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

        # this process's blocks (i, j), row stripe by row stripe
        blocks, stripe = [], None
        for d in self.mesh.local():
            i, j = divmod(d, ncol)
            if stripe is None or stripe[0] != i:
                stripe = (i, _row_block(csr, i * rows_per,
                                        (i + 1) * rows_per, rows_per))
            blocks.append(_col_slice(stripe[1], j * cols_per,
                                     min((j + 1) * cols_per, n), cols_per))
        self.tile_matrices = [tile_create(blk, config) for blk in blocks]
        use, self.nnz = global_counts([self.tile_matrices], backend,
                                      self.mesh)
        self.shards = shard_ops(self.tile_matrices,
                                self.mesh.local_devices(), backend, dtype,
                                use[0])
        self.use_stream = tuple(use)
        self.n_x_pad = ncol * cols_per

    @property
    def shape(self) -> tuple[int, int]:
        return (self.m, self.n)

    def flops(self) -> int:
        """2 * nnz of the whole matrix."""
        return 2 * self.nnz

    def _sums(self, x) -> list:
        """psum of the partial products, at this process's positions."""
        devs = self.mesh.local_devices()
        ncol = self.mesh.shape[1]
        x = torch.as_tensor(x, dtype=self.dtype, device=devs[0])
        if x.shape != (self.n,):
            raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                             f"({self.n},)")
        xj = F.pad(x, (0, self.n_x_pad - self.n)).split(self.cols_per)
        parts = []
        for d, op, dev in zip(self.mesh.local(), self.shards, devs):
            with on(dev):
                parts.append(op(xj[d % ncol].to(dev)))
        return psum(parts, self.mesh, COL_AXIS)

    def shard_outputs(self, x) -> list:
        """y's row stripes: stripe i (`rows_per` rows) on mesh device
        (i, 0); on a mesh that spans processes, the stripes whose (i, 0)
        is this process's."""
        ncol = self.mesh.shape[1]
        return [s for d, s in zip(self.mesh.local(), self._sums(x))
                if d % ncol == 0]

    def __call__(self, x) -> torch.Tensor:
        """y = A @ x on the mesh's first device (on a mesh that spans
        processes, this process's first). Each process puts the stripes
        at its positions (i, 0) into a zero y, and one all_reduce over
        the processes adds theirs: a process may own no (i, 0) (a (1, 4)
        mesh over two processes), which an all-gather of equal parts
        cannot take, and every other entry it adds is a zero."""
        sums = self._sums(x)
        nrow, ncol = self.mesh.shape
        y = sums[0].new_zeros((nrow, self.rows_per))
        for d, s in zip(self.mesh.local(), sums):
            if d % ncol == 0:
                y[d // ncol] = s
        return process_sum(y, self.mesh).view(-1)[: self.m]
