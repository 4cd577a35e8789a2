"""Execution plan of the XLA-engine path, and plan pieces the lane plan
shares.

NumPy port of tilespmv_tpu/ops/plan.py, held bit-equal to it by
tests/test_torch_xla_plan.py. `build_plan` compiles a TileMatrix of any
tile size B in 1..16 into static-shaped, format-segregated, padded
arrays, one "engine" input per format family, each a rectangular array
the plain torch engines of ops/xla_spmv.py run branch-free:

* dense tiles   -> (nt, B, B) tiles times their x blocks;
* dense rows    -> (R, B) row dot products, scattered by global row;
* dense cols    -> (C, B) column AXPYs, scattered by tile row;
* ELL tiles     -> width-class buckets (nt, W, B) of slots; HYB tiles'
                   ELL parts are folded in here;
* CSR tiles     -> nnz-class buckets (nt, W) of (value, packed
                   row << 4 | col) pairs;
* COO tiles and the HYB overflow -> the residual, a row-sorted COO list
                   summed by row (also the lane plan's leftover
                   entries).

Engine leading dimensions are padded to a multiple of `pad_tiles_to`
with tiles that point at tile (0, 0) with zero values (ELL and CSR slots
with value 0 and column 0): a zero times a non-finite x still puts NaN
into those rows, as in the reference.

Value arrays are float32, float64, or bfloat16 held as their uint16 bit
patterns (stream_plan.BF16_BITS: NumPy has no bfloat16), rounded to
nearest even as the reference's NumPy bfloat16 assignment rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..core.tile_matrix import TileMatrix
from .cuda.stream_plan import BF16, bf16_bits, is_bf16

# nnz classes for CSR tiles (tile nnz is in (coo_th, dense_th) = (12, 192)
# for the default config) and width classes for ELL tiles
CSR_NNZ_CLASSES = (16, 32, 64, 128, 256)
ELL_WIDTH_CLASSES = (1, 2, 4, 8, 16)


def _round_class(values: np.ndarray, classes: tuple[int, ...]) -> np.ndarray:
    """Smallest class >= value."""
    classes_arr = np.asarray(classes)
    idx = np.searchsorted(classes_arr, values, side="left")
    if np.any(idx >= len(classes)):
        raise ValueError(f"value exceeds largest class {classes[-1]}")
    return classes_arr[idx]


@dataclasses.dataclass(frozen=True)
class DenseEngine:
    """Dense tiles: val[t] is the full B x B tile (row-major)."""
    val: Any        # (nt, B, B) values
    tilerow: Any    # (nt,) int32
    tilecol: Any    # (nt,) int32


@dataclasses.dataclass(frozen=True)
class RowEngine:
    """Dense-row tiles, flattened to independent full rows."""
    val: Any        # (R, B)
    grow: Any       # (R,) int32 global output row
    tilecol: Any    # (R,) int32


@dataclasses.dataclass(frozen=True)
class ColEngine:
    """Dense-col tiles, flattened to independent full columns."""
    val: Any        # (C, B)
    gcol: Any       # (C,) int32 global input column
    tilerow: Any    # (C,) int32


@dataclasses.dataclass(frozen=True)
class EllEngine:
    """One ELL width class: column-of-slots grid per tile."""
    val: Any        # (nt, W, B)
    col: Any        # (nt, W, B) uint8 intra-tile column (0 where padded)
    tilerow: Any    # (nt,) int32
    tilecol: Any    # (nt,) int32


@dataclasses.dataclass(frozen=True)
class CsrEngine:
    """One CSR nnz class: flat (val, packed row|col) pairs per tile."""
    val: Any        # (nt, W)
    rowcol: Any     # (nt, W) uint8 packed (row<<4)|col; padded -> val 0
    tilerow: Any    # (nt,) int32
    tilecol: Any    # (nt,) int32


@dataclasses.dataclass(frozen=True)
class ResidualEngine:
    """Sorted-COO residual (global indices), segment-sum by row."""
    val: Any        # (nnz,) values
    row: Any        # (nnz,) int32 sorted ascending
    col: Any        # (nnz,) int32


def _nbytes(a) -> int:
    """Bytes of a NumPy array or a tensor."""
    return int(np.prod(a.shape)) * a.itemsize


@dataclasses.dataclass(frozen=True)
class SpMVPlan:
    """Everything the XLA-engine path needs (ops/xla_spmv.py)."""
    dense: DenseEngine
    rows: RowEngine
    cols: ColEngine
    ells: tuple  # of EllEngine (one per active width class)
    csrs: tuple  # of CsrEngine (one per active nnz class)
    residual: ResidualEngine

    m: int
    n: int
    tilem: int
    tilen: int
    tile_size: int
    nnz: int

    @property
    def x_padded_len(self) -> int:
        return self.tilen * self.tile_size

    @property
    def y_padded_len(self) -> int:
        return self.tilem * self.tile_size

    @property
    def dtype(self):
        """The plan's value dtype as a torch dtype (float32, float64 or
        bfloat16), for NumPy arrays and tensors alike; x, y and every
        engine compute in it."""
        from .cuda.lane_plan import value_dtype
        return value_dtype(self.dense.val)

    def bytes_accessed(self) -> int:
        """Bytes one SpMV streams (A payloads + x + y), the reference's
        count: each engine's arrays, 8 bytes of indices per tile, row or
        column, and x and y at the value size."""
        total = _nbytes(self.dense.val) + 8 * self.dense.tilerow.shape[0]
        total += _nbytes(self.rows.val) + 8 * self.rows.grow.shape[0]
        total += _nbytes(self.cols.val) + 8 * self.cols.gcol.shape[0]
        for e in self.ells:
            total += _nbytes(e.val) + _nbytes(e.col) + 8 * e.tilerow.shape[0]
        for e in self.csrs:
            total += (_nbytes(e.val) + _nbytes(e.rowcol)
                      + 8 * e.tilerow.shape[0])
        total += (_nbytes(self.residual.val) + _nbytes(self.residual.row)
                  + _nbytes(self.residual.col))
        total += (self.x_padded_len + self.m) * self.dense.val.itemsize
        return total

    def flops(self) -> int:
        """2 * nnz useful flops (reference GFLOPS metric,
        tilespmv_cuda.h:1138)."""
        return 2 * self.nnz

    def summary(self) -> dict:
        """Static per-engine plan statistics."""
        dt = str(self.dtype).replace("torch.", "")
        return dict(
            m=self.m, n=self.n, nnz=self.nnz, dtype=dt,
            tile_size=self.tile_size,
            plan_mbytes=round(self.bytes_accessed() / 1e6, 2),
            engines=dict(dense=int(self.dense.val.shape[0]),
                         rows=int(self.rows.val.shape[0]),
                         cols=int(self.cols.val.shape[0]),
                         ells={int(e.val.shape[1]): int(e.val.shape[0])
                               for e in self.ells},
                         csrs={int(e.val.shape[1]): int(e.val.shape[0])
                               for e in self.csrs},
                         residual=int(self.residual.val.shape[0])))


def map_plan_arrays(plan: SpMVPlan, fn) -> SpMVPlan:
    """Copy of `plan` with every array field `a` of every engine
    replaced by fn(name, a); `name` ("dense_val", "ell2_col",
    "csr0_rowcol", ...) is unique within the plan and a valid
    identifier. Moves a plan between NumPy and torch, and between
    devices."""
    def conv(prefix, obj):
        return dataclasses.replace(obj, **{
            f.name: fn(f"{prefix}_{f.name}", getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return dataclasses.replace(
        plan, dense=conv("dense", plan.dense), rows=conv("rows", plan.rows),
        cols=conv("cols", plan.cols),
        ells=tuple(conv(f"ell{i}", e) for i, e in enumerate(plan.ells)),
        csrs=tuple(conv(f"csr{i}", e) for i, e in enumerate(plan.csrs)),
        residual=conv("residual", plan.residual))


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """Pad axis 0 to `rows` (appending zeros)."""
    if a.shape[0] == rows:
        return a
    pad = [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def build_plan(tm: TileMatrix, compute_dtype=np.float32,
               pad_tiles_to: int = 8) -> SpMVPlan:
    """Compile a TileMatrix (any tile size) into an SpMVPlan of NumPy
    arrays with `compute_dtype` values: float32, float64 or BF16 (bf16
    bits).

    `pad_tiles_to`: engine leading dims are padded up to a multiple of
    this (padding tiles point at tile (0, 0) with zero values).
    """
    b = tm.config.tile_size
    bf16 = is_bf16(compute_dtype)
    cdt = np.dtype(np.float32) if bf16 else np.dtype(compute_dtype)
    if cdt not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError(f"compute_dtype {cdt}: float32, float64 or "
                         f"{BF16}")
    # bf16 values are rounded from their float64 sums once, at the end
    work = np.dtype(np.float64) if bf16 else cdt

    def values(a: np.ndarray) -> np.ndarray:
        return bf16_bits(a) if bf16 else a
    pt = pad_tiles_to

    def pad_nt(nt):
        return max(pt, -(-nt // pt) * pt)

    # ---------- dense engine ----------
    bk = tm.dns
    nt = bk.num_tiles
    ntp = pad_nt(nt)
    val = np.zeros((ntp, b, b), dtype=work)
    if nt:
        trow = tm.tile_rowidx[bk.tile_ids].astype(np.int64)
        tcol = tm.tile_columnidx[bk.tile_ids].astype(np.int64)
        rowlen = tm.rowlen(trow)
        sizes = np.diff(bk.ptr)
        owner = np.repeat(np.arange(nt), sizes)
        off = np.arange(int(bk.ptr[-1])) - bk.ptr[owner]
        ri = off % rowlen[owner]
        ci = off // rowlen[owner]
        val[owner, ri, ci] = bk.val  # column-major storage -> row-major tile
        tilerow = _pad_rows(trow.astype(np.int32), ntp)
        tilecol = _pad_rows(tcol.astype(np.int32), ntp)
    else:
        tilerow = np.zeros(ntp, np.int32)
        tilecol = np.zeros(ntp, np.int32)
    dense = DenseEngine(val=values(val), tilerow=tilerow, tilecol=tilecol)

    # ---------- dense-row engine ----------
    bk = tm.dnsrow
    nrows = int(bk.row_ids.shape[0])
    nrp = pad_nt(nrows)
    rval = np.zeros((nrp, b), dtype=work)
    grow = np.zeros(nrp, np.int32)
    rtcol = np.zeros(nrp, np.int32)
    if nrows:
        per_tile_rows = np.diff(bk.row_ptr)
        owner = np.repeat(np.arange(bk.num_tiles), per_tile_rows)
        trow = tm.tile_rowidx[bk.tile_ids[owner]].astype(np.int64)
        tcol = tm.tile_columnidx[bk.tile_ids[owner]].astype(np.int64)
        # values are packed rows: row r of tile t occupies collen[t] slots
        row_sizes = tm.collen(tcol)
        starts = np.concatenate([[0], np.cumsum(row_sizes)[:-1]])
        eowner = np.repeat(np.arange(nrows), row_sizes)
        eoff = np.arange(int(row_sizes.sum())) - starts[eowner]
        rval[eowner, eoff] = bk.val
        grow[:nrows] = (trow * b + bk.row_ids.astype(np.int64)).astype(
            np.int32)
        rtcol[:nrows] = tcol.astype(np.int32)
    rows = RowEngine(val=values(rval), grow=grow, tilecol=rtcol)

    # ---------- dense-col engine ----------
    bk = tm.dnscol
    ncols = int(bk.col_ids.shape[0])
    ncp = pad_nt(ncols)
    cval = np.zeros((ncp, b), dtype=work)
    gcol = np.zeros(ncp, np.int32)
    ctrow = np.zeros(ncp, np.int32)
    if ncols:
        per_tile_cols = np.diff(bk.col_ptr)
        owner = np.repeat(np.arange(bk.num_tiles), per_tile_cols)
        trow = tm.tile_rowidx[bk.tile_ids[owner]].astype(np.int64)
        tcol = tm.tile_columnidx[bk.tile_ids[owner]].astype(np.int64)
        col_sizes = tm.rowlen(trow)
        starts = np.concatenate([[0], np.cumsum(col_sizes)[:-1]])
        eowner = np.repeat(np.arange(ncols), col_sizes)
        eoff = np.arange(int(col_sizes.sum())) - starts[eowner]
        cval[eowner, eoff] = bk.val
        gcol[:ncols] = (tcol * b + bk.col_ids.astype(np.int64)).astype(
            np.int32)
        ctrow[:ncols] = trow.astype(np.int32)
    cols = ColEngine(val=values(cval), gcol=gcol, tilerow=ctrow)

    # ---------- ELL engines (ELL tiles + HYB ell-parts) ----------
    # one logical list of ELL tiles and HYB ell-parts, bucketed by width
    # class, all flat entries scattered in one shot
    srcs = []
    if tm.ell.num_tiles:
        srcs.append((tm.ell.tile_ids, tm.ell.width.astype(np.int64),
                     tm.ell.ptr, tm.ell.val, tm.ell.col))
    if tm.hyb.num_tiles:
        srcs.append((tm.hyb.tile_ids, tm.hyb.width.astype(np.int64),
                     tm.hyb.ell_ptr, tm.hyb.ell_val, tm.hyb.ell_col))
    ells = []
    if srcs:
        all_tids = np.concatenate([s[0] for s in srcs])
        all_w = np.concatenate([s[1] for s in srcs])
        all_val = np.concatenate([s[3] for s in srcs])
        all_col = np.concatenate([s[4] for s in srcs])
        sizes = np.concatenate(
            [np.diff(s[2]) for s in srcs]).astype(np.int64)
        all_ptr = np.concatenate([[0], np.cumsum(sizes)])
        trow_all = tm.tile_rowidx[all_tids].astype(np.int64)
        tcol_all = tm.tile_columnidx[all_tids].astype(np.int64)
        rowlen_all = tm.rowlen(trow_all)
        n_all = all_tids.shape[0]
        owner = np.repeat(np.arange(n_all), sizes)
        off = np.arange(int(all_ptr[-1])) - all_ptr[owner]
        slot_e = off // rowlen_all[owner]
        ri_e = off % rowlen_all[owner]
        classes = _round_class(all_w, ELL_WIDTH_CLASSES)
        for wc in ELL_WIDTH_CLASSES:
            idx = np.nonzero(classes == wc)[0]
            if idx.size == 0:
                continue
            ntp = pad_nt(idx.size)
            val = np.zeros((ntp, wc, b), dtype=work)
            col = np.zeros((ntp, wc, b), dtype=np.uint8)
            local = np.full(n_all, -1, np.int64)
            local[idx] = np.arange(idx.size)
            sel = classes[owner] == wc
            val[local[owner[sel]], slot_e[sel], ri_e[sel]] = all_val[sel]
            col[local[owner[sel]], slot_e[sel], ri_e[sel]] = all_col[sel]
            ells.append(EllEngine(
                val=values(val), col=col,
                tilerow=_pad_rows(trow_all[idx].astype(np.int32), ntp),
                tilecol=_pad_rows(tcol_all[idx].astype(np.int32), ntp)))

    # ---------- CSR engines ----------
    csrs = []
    bk = tm.csr
    if bk.num_tiles:
        counts = np.diff(bk.nnz_ptr)
        classes = _round_class(counts, CSR_NNZ_CLASSES)
        owner = np.repeat(np.arange(bk.num_tiles), counts)
        off = np.arange(int(bk.nnz_ptr[-1])) - bk.nnz_ptr[owner]
        packed_all = ((bk.row.astype(np.uint8) << 4)
                      | bk.col.astype(np.uint8))
        for wc in CSR_NNZ_CLASSES:
            idx = np.nonzero(classes == wc)[0]
            if idx.size == 0:
                continue
            ntp = pad_nt(idx.size)
            val = np.zeros((ntp, wc), dtype=work)
            rowcol = np.zeros((ntp, wc), dtype=np.uint8)
            local = np.full(bk.num_tiles, -1, np.int64)
            local[idx] = np.arange(idx.size)
            sel = classes[owner] == wc
            val[local[owner[sel]], off[sel]] = bk.val[sel]
            rowcol[local[owner[sel]], off[sel]] = packed_all[sel]
            csrs.append(CsrEngine(
                val=values(val), rowcol=rowcol,
                tilerow=_pad_rows(
                    tm.tile_rowidx[bk.tile_ids[idx]].astype(np.int32), ntp),
                tilecol=_pad_rows(
                    tm.tile_columnidx[bk.tile_ids[idx]].astype(np.int32),
                    ntp)))

    # ---------- residual engine ----------
    r = tm.residual
    rn = r.nnz
    rnp = max(pt, -(-max(rn, 1) // pt) * pt) if rn else pt
    rval = np.zeros(rnp, dtype=work)
    rrow = np.zeros(rnp, np.int32)
    rcol = np.zeros(rnp, np.int32)
    if rn:
        rows_g = np.repeat(np.arange(tm.m, dtype=np.int64),
                           np.diff(r.indptr))
        rval[:rn] = r.val
        rrow[:rn] = rows_g.astype(np.int32)
        rcol[:rn] = r.indices
        # padding entries take the last row (the list stays sorted) with
        # value 0
        rrow[rn:] = rrow[rn - 1]
    residual = ResidualEngine(val=values(rval), row=rrow, col=rcol)

    return SpMVPlan(
        dense=dense, rows=rows, cols=cols, ells=tuple(ells),
        csrs=tuple(csrs), residual=residual,
        m=tm.m, n=tm.n, tilem=tm.tilem, tilen=tm.tilen, tile_size=b,
        nnz=tm.nnz)
