"""The XLA-engine path: plain torch engines over an SpMVPlan.

Counterpart of tilespmv_tpu/ops/xla_spmv.py and of the `backend="xla"`
branch of tilespmv_tpu/ops/spmv.py, which the reference computes as
plain XLA ops, not Pallas kernels. So these are plain torch ops, run on
the plan's device (CPU or CUDA) with no hand-written kernel: a gather of
x blocks, `torch.einsum` for the dense tile products, products and sums
for the row, column and ELL engines, and `index_add_` to add each
engine's partial y blocks and the residual into y. Each engine consumes
one plan bucket (ops/plan.py) and returns partial y contributions;
`spmv_xla` assembles them into y, `spmm_xla` runs the same engines on
all k columns of X at once (the reference vmaps SpMV over them, the same
function). Nothing here syncs with the host, so a call can be captured
in a CUDA graph. x, y and each engine's output are in the plan's value
dtype, as in the reference. In bf16 each engine rounds where the
reference's compiled XLA program rounds (measured on the CPU, where the
port's bf16 y is then bit-equal to the reference's,
tests/test_torch_xla_spmv.py): the ELL and dense-row engines take their
products and sums in float32 and round each sum once (XLA keeps a fused
multiply-and-reduce in float32); the CSR engine rounds each product to
bf16 and sums them in float32 (the reference's one-hot einsum); the
dense einsum and the column engine round once; the adds into y, the
residual's products and its sum by row are bf16 operations, each add
rounded. On the card the atomics of `index_add_` add in any order.
"""
from __future__ import annotations

import torch

from .cuda.reference import checked_x
from .plan import (ColEngine, CsrEngine, DenseEngine, EllEngine,
                   ResidualEngine, RowEngine, SpMVPlan)


def _rhs(v: torch.Tensor, x: torch.Tensor, dims: int) -> torch.Tensor:
    """v with a trailing unit dimension per RHS dimension of x past its
    first `dims`, so that it broadcasts against x's gathered values."""
    return v.reshape(v.shape + (1,) * (x.dim() - dims))


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in float32 if it is bf16 (the sums the reference's XLA program
    takes in float32), as it is otherwise."""
    return t.float() if t.dtype == torch.bfloat16 else t


def dense_blocks(e: DenseEngine, x2d: torch.Tensor) -> torch.Tensor:
    """(nt, B[, k]) per-tile y block: the full B x B tile times its x
    block."""
    xblk = x2d[e.tilecol]                                 # (nt, B[, k])
    if x2d.dim() == 2:
        return torch.einsum("tij,tj->ti", e.val, xblk)
    return torch.einsum("tij,tjk->tik", e.val, xblk)


def dense_rows(e: RowEngine, x2d: torch.Tensor) -> torch.Tensor:
    """(R[, k]) dot product per stored full row."""
    return (_wide(_rhs(e.val, x2d, 2)) * _wide(x2d[e.tilecol])).sum(
        dim=1).to(x2d.dtype)


def dense_cols(e: ColEngine, x_pad: torch.Tensor) -> torch.Tensor:
    """(C, B[, k]) AXPY per stored full column."""
    return _rhs(e.val, x_pad, 1) * x_pad[e.gcol][:, None]


def _tiles(e, x2d: torch.Tensor) -> torch.Tensor:
    """(nt, 1, 1) tile numbers, to index per-tile blocks."""
    return torch.arange(e.tilecol.shape[0], device=x2d.device)[:, None,
                                                              None]


def ell_blocks(e: EllEngine, x2d: torch.Tensor) -> torch.Tensor:
    """(nt, B[, k]) per-tile y block of one ELL width class: slot w of
    row i reads x block column col[t, w, i]. Padded slots carry
    val == 0."""
    xblk = x2d[e.tilecol]                                 # (nt, B[, k])
    g = xblk[_tiles(e, x2d), e.col.long()]                # (nt, W, B[, k])
    return (_wide(_rhs(e.val, x2d, 2)) * _wide(g)).sum(dim=1).to(
        x2d.dtype)


def csr_blocks(e: CsrEngine, x2d: torch.Tensor) -> torch.Tensor:
    """(nt, B[, k]) per-tile y block of one CSR nnz class: each pair
    (value, row << 4 | col) adds value * x[col] into its row, by
    `index_add_` over the tile rows (the reference's one-hot einsum
    computes the same sums). Padded pairs carry val == 0 at (0, 0)."""
    nt, b = e.val.shape[0], x2d.shape[1]
    rowcol = e.rowcol.long()
    row, col = rowcol >> 4, rowcol & 15
    xblk = x2d[e.tilecol]                                 # (nt, B[, k])
    xv = xblk[_tiles(e, x2d)[:, :, 0], col]               # (nt, W[, k])
    contrib = _wide(_rhs(e.val, x2d, 2) * xv)
    out = torch.zeros((nt * b,) + x2d.shape[2:], dtype=contrib.dtype,
                      device=x2d.device)
    dest = (_tiles(e, x2d)[:, :, 0] * b + row).reshape(-1)
    out.index_add_(0, dest, contrib.reshape((-1,) + x2d.shape[2:]))
    return out.reshape((nt, b) + x2d.shape[2:]).to(x2d.dtype)


def residual_rows(e: ResidualEngine, x_pad: torch.Tensor,
                  y_len: int) -> torch.Tensor:
    """(y_len[, k]) sum by row of the residual's products."""
    contrib = _rhs(e.val, x_pad, 1) * x_pad[e.col]
    out = torch.zeros((y_len,) + x_pad.shape[1:], dtype=contrib.dtype,
                      device=x_pad.device)
    return out.index_add_(0, e.row, contrib)


def _assemble(plan: SpMVPlan, x: torch.Tensor) -> torch.Tensor:
    """y (m[, k]) = A @ x for x (n[, k]) in the plan's value dtype, in
    the reference's order (tilespmv_tpu/ops/spmv.py:39-62): pad x, add
    the dense, ELL, CSR and column blocks into y by tile row, the rows
    by global row, then the residual, and cut y to m."""
    b, tail = plan.tile_size, x.shape[1:]
    x_pad = torch.zeros((plan.x_padded_len,) + tail, dtype=x.dtype,
                        device=x.device)
    x_pad[: plan.n] = x
    x2d = x_pad.view((plan.tilen, b) + tail)
    y2d = torch.zeros((plan.tilem, b) + tail, dtype=x.dtype,
                      device=x.device)
    if plan.dense.tilerow.shape[0]:
        y2d.index_add_(0, plan.dense.tilerow, dense_blocks(plan.dense, x2d))
    for e in plan.ells:
        y2d.index_add_(0, e.tilerow, ell_blocks(e, x2d))
    for e in plan.csrs:
        y2d.index_add_(0, e.tilerow, csr_blocks(e, x2d))
    if plan.cols.gcol.shape[0]:
        y2d.index_add_(0, plan.cols.tilerow, dense_cols(plan.cols, x_pad))
    y = y2d.view((-1,) + tail)
    if plan.rows.grow.shape[0]:
        y.index_add_(0, plan.rows.grow, dense_rows(plan.rows, x2d))
    if plan.residual.val.shape[0]:
        y = y + residual_rows(plan.residual, x_pad, plan.y_padded_len)
    return y[: plan.m]


def spmv_xla(plan: SpMVPlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over an SpMVPlan whose tensors lie on x's device, x cast
    to the plan's value dtype."""
    return _assemble(plan, checked_x(x, plan.dtype, plan.n, 1))


def spmm_xla(plan: SpMVPlan, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for X (n, k) over an SpMVPlan, all k columns through
    each engine at once."""
    return _assemble(plan, checked_x(x, plan.dtype, plan.n, 2))
