"""Lane-major chunked execution plan (f32), as NumPy arrays.

NumPy port of tilespmv_tpu/ops/pallas/lane_plan.py, held bit-equal to
it by tests/test_torch_plan.py, so both frameworks execute the very
same plan. The classes and their layouts are the reference package's:

* the **band (brick) class** — tile-row stripes whose non-COO tiles
  span at most BAND_MAX_COLS consecutive tile-columns become dense
  (16, 16*C) bricks, one chunk per 256-tile-row output window, lane =
  tile-row;
* the **dense class** — densified 16x16 tiles, T per chunk, routed to
  their output row by meta[LROW];
* the **W-classes** — packed sparse-entry tiles: W value slots (slot 0
  reserved zero, entries row-sorted), 4-bit columns packed 8 per int32
  and 16 packed row-end bytes in the meta rows;
* the **stream class** (stream_plan.py) for near-singleton COO tiles;
* a residual of leftover entries (HYB overflow).

x is addressed through 256-tile-column *panels*: a chunk lane's x block
starts at flat index (pb[step*K + (loc >> 8)] * 256 + (loc & 255)) * 16
with loc = meta[XLOC] (dense, W) or bloc + column block (band).

The routing and chunking cost constants are the reference planner's
(measured on its own device). They are kept unchanged so the plans stay
identical; re-fitting them to the H100 is later work. df64 and the
distributed-layer options (force_t, forced s_batch) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ...core.tile_matrix import TileMatrix
from ..plan import ResidualEngine
from .stream_plan import (MAX_SPAN_ROWS, RW_ROWS, SPAN_ROWS, StreamChunks,
                          build_stream_classes)
from . import stream_plan as sp

T_CHOICES = (128, 256, 512)   # tiles per chunk (lane-dim width classes)
STREAM_MIN_ENTRIES = 2048     # below this the per-tile COO class wins
PANEL_TC = 256         # tile-columns per x panel
K_CHOICES = (1, 2, 4, 8)      # x panels addressable by one step
ROW_WINDOW = 256       # tile-rows per output window
# sparse-entry class widths (slot 0 is a reserved zero pad, so a width-W
# class holds tiles with <= W-1 stored entries); tiles at or above
# DENSE_MIN_NNZ stored entries densify instead
W_CHOICES = (16, 24, 32, 48, 64, 96)
DENSE_MIN_NNZ = 96
SPARSE_T = 128         # sparse classes pin T=128
MIN_CLASS_TILES = 512  # merge thinner classes upward (per-call overhead)
# COO tiles go to a sparse class instead of the stream engine when their
# mean entry count crosses this
COO_SPARSE_MIN_AVG = 4.0
# window-sparse COO populations leave the stream engine when the absorb
# estimate beats the stream estimate by this factor
STREAM_ABSORB_MARGIN = 0.7

# dense-class meta rows (int32): x location and window-local tile row
META_XLOC = 0
META_LROW = 1
DENSE_MROWS = 2

# band (brick) class selection
BAND_MAX_COLS = 8
BAND_MIN_STRIPE_FILL = 0.30   # stripe nnz / (ext*256) to qualify
BAND_MIN_CLASS_FILL = 0.30    # selected nnz / (nchunks*C*256*T)
BAND_MIN_WINDOW_FRAC = 0.7    # fraction of windows with a band chunk
BAND_K = 4                    # panels per band step

# chunk-batch cost model: per-step fixed cost and streaming bandwidth
STEP_FIXED_S = 0.25e-6
HBM_BPS = 800e9
COST = dict(
    step_ns=250.0,          # per-step fixed cost
    call_ns=3000.0,         # per-call dispatch
    hbm_b_per_ns=800.0,     # streaming bytes per ns
    vpu_ns_per_el=2.2e-3,   # ns per lane element
    sparse_chunk_ns=120.0,  # per sparse chunk: prefix + decode
    sparse_slot_ns=1.3,     # per value slot
)


def sparse_meta_rows(width: int) -> int:
    """Meta rows of a width-W sparse class: xloc, lrow, W/8 packed-nibble
    column rows, 4 packed-byte row-pointer rows."""
    return 2 + width // 8 + 4


@dataclasses.dataclass(frozen=True)
class DenseChunks:
    """Densified-tile class: (nchunks, 16, 16, T) value blocks, j-major
    ([c, j, i, t] = tile t's entry (i, j)). `cw`/`cfirst` are per step
    (`c_batch` same-window chunks)."""
    val: Any       # (nchunks, 16, 16, T) f32
    meta: Any      # (nchunks, DENSE_MROWS, T) int32
    pb: Any        # (nsteps*K,) int32 x panel ids
    cw: Any        # (nsteps,) int32 output window id
    cfirst: Any    # (nsteps,) int32 1 if first step of its window

    t_lanes: int
    k_panels: int = 1
    c_batch: int = 1


@dataclasses.dataclass(frozen=True)
class BandChunks:
    """Brick class: one chunk per output window, lane = tile-row; val
    holds C j-major (16, T) column slabs per brick."""
    val: Any       # (nchunks, C, 16, 16, T): [w, col_blk, j, i, t]
    bloc: Any      # (nchunks, 1, T) int32: panel-slot*256 + col offset
    pb: Any        # (nchunks*K,) int32 panel ids
    cw: Any        # (nchunks,) int32
    cfirst: Any    # (nchunks,) int32

    c_cols: int
    k_panels: int = BAND_K


@dataclasses.dataclass(frozen=True)
class SparseChunks:
    """Packed sparse-entry class: (nchunks, W, T) value slots (slot 0
    reserved zero, entries row-sorted), 4-bit columns and row pointers
    packed into the meta rows (see sparse_meta_rows)."""
    val: Any       # (nchunks, W, T) f32
    meta: Any      # (nchunks, sparse_meta_rows(W), T) int32
    pb: Any        # (nsteps*K,) int32
    cw: Any        # (nsteps,) int32
    cfirst: Any    # (nsteps,) int32

    width: int
    t_lanes: int
    k_panels: int = 1
    c_batch: int = 1


@dataclasses.dataclass(frozen=True)
class LanePlan:
    dense: Optional[DenseChunks]
    band: Optional[BandChunks]
    sparses: tuple  # of SparseChunks, ascending width
    residual: ResidualEngine  # leftover entries (HYB overflow)
    stream: Optional[StreamChunks]  # entry-level engine (COO tiles)

    m: int
    n: int
    tilem: int
    tilen: int
    tile_size: int
    nnz: int
    n_windows: int

    # heavy half of a split stream pair: disjoint window set
    stream2: Optional[StreamChunks] = None

    @property
    def n_panels(self) -> int:
        return max(1, -(-self.tilen // PANEL_TC))

    @property
    def x_padded_len(self) -> int:
        return self.n_panels * PANEL_TC * self.tile_size

    @property
    def y_padded_len(self) -> int:
        return self.n_windows * ROW_WINDOW * self.tile_size

    @property
    def x_padded_len128(self) -> int:
        # stream-class x layout: (rows, 128) with max-span slack
        rows = -(-self.n // 128) + MAX_SPAN_ROWS
        return -(-rows // SPAN_ROWS) * SPAN_ROWS * 128

    @property
    def n_stream_windows(self) -> int:
        return max(1, -(-self.m // RW_ROWS))

    def bytes_accessed(self) -> int:
        """Plan bytes one SpMV streams (class payloads + x + y)."""
        def nbytes(a):
            return int(np.prod(a.shape)) * a.dtype.itemsize
        total = 0
        if self.dense is not None:
            total += nbytes(self.dense.val) + nbytes(self.dense.meta)
        if self.band is not None:
            total += nbytes(self.band.val) + nbytes(self.band.bloc)
        for s in self.sparses:
            total += nbytes(s.val) + nbytes(s.meta)
        for st in (self.stream, self.stream2):
            if st is not None:
                total += (nbytes(st.val) + nbytes(st.vidx)
                          + nbytes(st.planes))
        total += (nbytes(self.residual.val) + nbytes(self.residual.row)
                  + nbytes(self.residual.col))
        total += self.x_padded_len * 4 + self.m * 4
        return total

    def summary(self) -> dict:
        """Static per-class plan statistics."""
        s: dict = dict(m=self.m, n=self.n, nnz=self.nnz,
                       plan_mbytes=round(self.bytes_accessed() / 1e6, 2),
                       classes=[])
        if self.dense is not None:
            d = self.dense
            s["classes"].append(dict(
                kind="dense", chunks=int(d.val.shape[0]),
                t_lanes=d.t_lanes, k_panels=d.k_panels,
                c_batch=d.c_batch))
        if self.band is not None:
            s["classes"].append(dict(
                kind="band", c_cols=int(self.band.c_cols),
                chunks=int(self.band.val.shape[0])))
        for w in self.sparses:
            s["classes"].append(dict(
                kind=f"w{w.width}", chunks=int(w.val.shape[0]),
                k_panels=w.k_panels))
        for tag, st in (("stream", self.stream),
                        ("stream2", self.stream2)):
            if st is not None:
                s["classes"].append(dict(
                    kind=tag, slabs=int(st.nslabs), s_batch=st.s_batch,
                    rounds=st.rounds, span_rows=st.span_rows,
                    dual=bool(st.dual)))
        s["residual_nnz"] = int(self.residual.val.shape[0])
        return s


def map_arrays(plan: LanePlan, fn) -> LanePlan:
    """Copy of `plan` with every array field `a` (annotated `Any`, not
    None) of every class replaced by fn(name, a); `name` ("dense_val",
    "sparse0_meta", "stream2_planes", ...) is unique within the plan and
    a valid identifier. Moves a plan between NumPy and torch, and
    between devices."""
    def conv(prefix, obj):
        if obj is None:
            return None
        kw = {f.name: fn(f"{prefix}_{f.name}", getattr(obj, f.name))
              for f in dataclasses.fields(obj)
              if f.type == "Any" and getattr(obj, f.name) is not None}
        return dataclasses.replace(obj, **kw)
    return dataclasses.replace(
        plan, dense=conv("dense", plan.dense), band=conv("band", plan.band),
        sparses=tuple(conv(f"sparse{i}", s)
                      for i, s in enumerate(plan.sparses)),
        residual=conv("residual", plan.residual),
        stream=conv("stream", plan.stream),
        stream2=conv("stream2", plan.stream2))


def _expand(ptr):
    sizes = np.diff(ptr)
    owner = np.repeat(np.arange(sizes.shape[0]), sizes)
    off = np.arange(int(ptr[-1])) - ptr[owner]
    return owner, off


def _all_entries(tm: TileMatrix):
    """Every non-COO tile's stored entries as intra-tile triplets.

    Returns (trow, tcol, counts, r, c, v) with tiles sorted by
    (trow, tcol) and entries grouped per tile, sorted by (row, col).
    ELL/HYB padding slots are kept (zero value at column 0)."""
    parts = []   # (trow, tcol, owner, r, c, v) per bucket

    def geom(tile_ids):
        trow = tm.tile_rowidx[tile_ids].astype(np.int64)
        tcol = tm.tile_columnidx[tile_ids].astype(np.int64)
        return trow, tcol

    bk = tm.dns
    if bk.num_tiles:
        trow, tcol = geom(bk.tile_ids)
        rowlen = tm.rowlen(trow)
        owner, off = _expand(bk.ptr)
        parts.append((trow, tcol, owner, off % rowlen[owner],
                      off // rowlen[owner], bk.val))

    bk = tm.csr
    if bk.num_tiles:
        trow, tcol = geom(bk.tile_ids)
        owner, _ = _expand(bk.nnz_ptr)
        parts.append((trow, tcol, owner, bk.row.astype(np.int64),
                      bk.col.astype(np.int64), bk.val))

    bk = tm.ell
    if bk.num_tiles:
        trow, tcol = geom(bk.tile_ids)
        rowlen = tm.rowlen(trow)
        owner, off = _expand(bk.ptr)
        parts.append((trow, tcol, owner, off % rowlen[owner],
                      bk.col.astype(np.int64), bk.val))

    # HYB: ELL part only (overflow entries live in the residual)
    bk = tm.hyb
    if bk.num_tiles:
        trow, tcol = geom(bk.tile_ids)
        rowlen = tm.rowlen(trow)
        owner, off = _expand(bk.ell_ptr)
        parts.append((trow, tcol, owner, off % rowlen[owner],
                      bk.ell_col.astype(np.int64), bk.ell_val))

    bk = tm.dnsrow
    if bk.num_tiles:
        trow, tcol = geom(bk.tile_ids)
        collen = tm.collen(tcol)
        owner, off = _expand(bk.ptr)
        rank = off // collen[owner]
        ci = off % collen[owner]
        ri = bk.row_ids[bk.row_ptr[owner] + rank].astype(np.int64)
        parts.append((trow, tcol, owner, ri, ci, bk.val))

    bk = tm.dnscol
    if bk.num_tiles:
        trow, tcol = geom(bk.tile_ids)
        rowlen = tm.rowlen(trow)
        owner, off = _expand(bk.ptr)
        rank = off // rowlen[owner]
        ri = off % rowlen[owner]
        ci = bk.col_ids[bk.col_ptr[owner] + rank].astype(np.int64)
        parts.append((trow, tcol, owner, ri, ci, bk.val))

    if not parts:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z, np.zeros(0, np.float64)

    ntiles = 0
    own_all, tr_all, tc_all, r_all, c_all, v_all = [], [], [], [], [], []
    for trow, tcol, owner, r, c, v in parts:
        own_all.append(owner + ntiles)
        tr_all.append(trow)
        tc_all.append(tcol)
        r_all.append(r)
        c_all.append(c)
        v_all.append(v.astype(np.float64))
        ntiles += trow.shape[0]
    trow = np.concatenate(tr_all)
    tcol = np.concatenate(tc_all)
    owner = np.concatenate(own_all)
    r = np.concatenate(r_all)
    c = np.concatenate(c_all)
    v = np.concatenate(v_all)

    # sort tiles by (trow, tcol); entries by (tile, row, col)
    tilen_span = int(tcol.max()) + 1 if ntiles else 1
    order_t = np.argsort(trow * tilen_span + tcol, kind="stable")
    rank_t = np.empty(ntiles, np.int64)
    rank_t[order_t] = np.arange(ntiles)
    trow, tcol = trow[order_t], tcol[order_t]
    counts = np.bincount(rank_t[owner], minlength=ntiles)
    order_e = np.argsort((rank_t[owner] << 8) | (r << 4) | c,
                         kind="stable")
    return trow, tcol, counts, r[order_e], c[order_e], v[order_e]


def _densify(trow, tcol, counts, r, c, v, b: int):
    """(nt, b, b) dense blocks from per-tile triplets (tiles stay in
    order). np.add, not assign: ELL pad slots share (r, 0) with real
    entries; adding keeps the real value (pads add zero)."""
    nt = trow.shape[0]
    owner = np.repeat(np.arange(nt), counts)
    blocks = np.zeros((nt, b, b), np.float64)
    np.add.at(blocks, (owner, r, c), v)
    return blocks


def _window_stats(trow, tcol):
    """Per output window: tile count and distinct x-panel count."""
    win = trow // ROW_WINDOW
    key = win * (1 << 24) + (tcol >> 8)          # (window, panel)
    cnt = np.unique(win, return_counts=True)[1].astype(np.float64)
    wp = np.unique(key) >> 24
    panels = np.unique(wp, return_counts=True)[1].astype(np.float64)
    return cnt, panels


def _pick_k(trow, tcol, cap_tiles) -> int:
    """Panels per step: enough that step cutting is count-limited, not
    panel-limited."""
    cnt, panels = _window_stats(trow, tcol)
    per_panel = max(1.0, float(cnt.sum() / panels.sum()))
    need = cap_tiles / per_panel + 1.0
    for k in K_CHOICES:
        if k >= need:
            return k
    return K_CHOICES[-1]


def _pick_cb(trow: np.ndarray, tcol: np.ndarray, tilem: int,
             t_lanes: int, k_panels: int, chunk_bytes: int) -> int:
    """Chunks per step, minimizing (step fixed cost + padding bytes +
    one step's un-overlapped fetch) over the per-window chunk counts."""
    cnt, panels = _window_stats(trow, tcol)
    ln = max(len(cnt), len(panels))
    cnt = np.pad(cnt, (0, ln - len(cnt)))
    panels = np.pad(panels, (0, ln - len(panels)))
    nch = np.ceil(cnt / t_lanes)
    best, best_cost = 1, None
    for cb in (1, 2, 4, 8):
        steps = np.maximum(np.ceil(nch / cb), np.ceil(panels / k_panels))
        pad = steps * cb - nch
        cost = float((steps * STEP_FIXED_S
                      + pad * chunk_bytes / HBM_BPS).sum()
                     ) + cb * chunk_bytes / HBM_BPS
        if best_cost is None or cost < best_cost * 0.98:
            best, best_cost = cb, cost
    return best


def _est_class_cost(trow, tcol, t_lanes, k_panels, c_batch,
                    chunk_bytes, vpu_chunk_ns) -> float:
    """Predicted execution ns of one chunked class (see COST)."""
    cnt, panels = _window_stats(trow, tcol)
    ln = max(len(cnt), len(panels))
    cnt = np.pad(cnt, (0, ln - len(cnt)))
    panels = np.pad(panels, (0, ln - len(panels)))
    nch = np.ceil(cnt / t_lanes)
    steps = np.maximum(np.ceil(nch / c_batch), np.ceil(panels / k_panels))
    nchunks = float((steps * c_batch).sum())
    panel_bytes = k_panels * 16 * PANEL_TC * 4
    return (float(steps.sum()) * (COST["step_ns"]
                                  + panel_bytes / COST["hbm_b_per_ns"])
            + nchunks * chunk_bytes / COST["hbm_b_per_ns"]
            + nchunks * vpu_chunk_ns
            + COST["call_ns"])


def _merge_thin_classes(widx: np.ndarray) -> np.ndarray:
    """Merge thin W classes upward; small matrices collapse all sparse
    classes into the widest one in use."""
    widx = widx.copy()
    for k in range(len(W_CHOICES)):
        cnt_k = int(np.sum(widx == k))
        if 0 < cnt_k < MIN_CLASS_TILES:
            widx[widx == k] = k + 1
    sp_mask = widx < len(W_CHOICES)
    if 0 < int(sp_mask.sum()) < 4 * MIN_CLASS_TILES:
        widx[sp_mask] = int(widx[sp_mask].max())
    return widx


def _sparse_cost(str_, stc, width: int, tilem: int) -> float:
    t = SPARSE_T
    cbytes = (width * t + sparse_meta_rows(width) * t) * 4
    kp = _pick_k(str_, stc, t)
    cb = _pick_cb(str_, stc, tilem, t, kp, cbytes)
    kp = _pick_k(str_, stc, cb * t)
    return _est_class_cost(
        str_, stc, t, kp, cb, cbytes,
        COST["sparse_chunk_ns"] + width * COST["sparse_slot_ns"])


def _route_classes(counts: np.ndarray) -> np.ndarray:
    """Assign each non-band tile to the dense class or a W class by the
    fixed DENSE_MIN_NNZ threshold. Returns widx in [0, len(W_CHOICES)];
    len(W_CHOICES) = dense."""
    widx = np.searchsorted(np.asarray(W_CHOICES), counts + 1)
    widx[counts >= DENSE_MIN_NNZ] = len(W_CHOICES)
    return _merge_thin_classes(widx)


def _pick_t(trow: np.ndarray, tcol: np.ndarray, tilem: int) -> int:
    """Lane width per chunk from the tile-weighted per-window count."""
    cnt, _ = _window_stats(trow, tcol)
    per_chunk = float(np.average(cnt, weights=cnt))
    for t in reversed(T_CHOICES):
        if per_chunk >= 0.75 * t:
            return t
    return T_CHOICES[0]


def _chunk_metadata(trow: np.ndarray, tcol: np.ndarray, tilem: int,
                    t_lanes: int, k_panels: int, c_batch: int = 1):
    """Cut row-window-local steps of `c_batch` chunks x `t_lanes` tiles
    over <= `k_panels` distinct x panels per step.

    Tiles must arrive sorted by (trow, tcol). Within each ROW_WINDOW of
    tile-rows, tiles are re-sorted by tile-column and packed greedily: a
    step closes after c_batch*t_lanes tiles or when it would need a
    (k_panels+1)-th distinct x panel; the step's tiles are then split
    into c_batch chunks (trailing chunks inert). Returns per-step
    cw/cfirst, the (nchunks, T) source permutation (`src`, -1 = inert
    lane), the flat (nsteps*K,) panel ids, and xloc/lrow planes (xloc =
    panel-slot * 256 + column-within-panel, -1 on inert lanes)."""
    T = t_lanes
    K = k_panels
    cap = c_batch * T
    n_windows = max(1, -(-tilem // ROW_WINDOW))
    win_of_tile = trow // ROW_WINDOW

    chunks_src, cw, pb_list, slot_all = [], [], [], []
    for w in range(n_windows):
        sel = np.nonzero(win_of_tile == w)[0]
        nst = 0
        if sel.size:
            order = np.argsort(tcol[sel], kind="stable")
            s = sel[order]
            pan = tcol[s] >> 8
            newp = np.ones(s.size, bool)
            newp[1:] = pan[1:] != pan[:-1]
            prank = np.cumsum(newp) - 1
            start = 0
            while start < s.size:
                # close at cap tiles or at the K-th new panel
                stop = int(np.searchsorted(prank, prank[start] + K,
                                           side="left"))
                stop = min(stop, start + cap, s.size)
                step_tiles = s[start:stop]
                step_pan = pan[start:stop]
                pans = np.unique(step_pan)
                pb_list.append(np.concatenate(
                    [pans, np.full(K - pans.size, pans[0], np.int64)]))
                slot = np.searchsorted(pans, step_pan)
                for cbi in range(c_batch):
                    lane = step_tiles[cbi * T:(cbi + 1) * T]
                    sl = slot[cbi * T:(cbi + 1) * T]
                    chunks_src.append(np.concatenate(
                        [lane, np.full(T - lane.size, -1, np.int64)]))
                    slot_all.append(np.concatenate(
                        [sl, np.zeros(T - sl.size, np.int64)]))
                cw.append(w)
                nst += 1
                start = stop
        if nst == 0:
            # >= 1 step per window (reference layout)
            for cbi in range(c_batch):
                chunks_src.append(np.full(T, -1, np.int64))
                slot_all.append(np.zeros(T, np.int64))
            pb_list.append(np.zeros(K, np.int64))
            cw.append(w)
    src = np.stack(chunks_src)
    slot = np.stack(slot_all)
    pb = np.stack(pb_list).astype(np.int32)          # (nsteps, K)
    cw_steps = np.asarray(cw, np.int32)
    cfirst = np.ones(cw_steps.shape[0], np.int32)
    cfirst[1:] = (cw_steps[1:] != cw_steps[:-1]).astype(np.int32)

    valid = src >= 0
    safe = np.where(valid, src, 0)
    tr = np.where(valid, trow[safe], 0)
    tc = np.where(valid, tcol[safe], 0)
    lrow = (tr - np.repeat(cw_steps.astype(np.int64), c_batch)[:, None]
            * ROW_WINDOW).astype(np.int32)
    lrow = np.where(valid, lrow, 0).astype(np.int32)
    xloc = (slot * PANEL_TC + (tc & (PANEL_TC - 1))).astype(np.int32)
    xloc = np.where(valid, xloc, -1).astype(np.int32)
    return dict(src=src, valid=valid, xloc=xloc, lrow=lrow, cw=cw_steps,
                cfirst=cfirst, pb=pb.reshape(-1), n_windows=n_windows,
                nchunks=src.shape[0])


def _pack_sparse_class(trow, tcol, counts, r, c, v, width: int,
                       tilem: int):
    """Pack per-tile triplets (tiles sorted by (trow, tcol), entries
    row-sorted per tile, counts <= width-1) into a width-W class.
    Returns (SparseChunks, n_windows)."""
    W = width
    T = SPARSE_T
    chunk_bytes = (W * T + sparse_meta_rows(W) * T) * 4
    K = _pick_k(trow, tcol, T)
    cb = _pick_cb(trow, tcol, tilem, T, K, chunk_bytes)
    K = _pick_k(trow, tcol, cb * T)
    md = _chunk_metadata(trow, tcol, tilem, T, K, cb)
    nchunks = md["nchunks"]

    # tile -> (chunk, lane)
    nt = trow.shape[0]
    src, valid = md["src"], md["valid"]
    chunk_of = np.zeros(nt, np.int64)
    lane_of = np.zeros(nt, np.int64)
    ci, li = np.nonzero(valid)
    chunk_of[src[ci, li]] = ci
    lane_of[src[ci, li]] = li

    owner = np.repeat(np.arange(nt), counts)
    off = np.arange(owner.shape[0]) - np.concatenate(
        [[0], np.cumsum(counts)])[:-1][owner]
    slot = off + 1                       # slot 0 reserved zero
    ech, eln = chunk_of[owner], lane_of[owner]

    val = np.zeros((nchunks, W, T), np.float32)
    val[ech, slot, eln] = v.astype(np.float32)

    meta = np.zeros((nchunks, sparse_meta_rows(W), T), np.int32)
    meta[:, META_XLOC] = md["xloc"]
    meta[:, META_LROW] = md["lrow"]
    # 4-bit columns, 8 per int32 word: slot s -> word s//8, nibble s%8
    colw = np.zeros((nchunks, W // 8, T), np.uint32)
    np.add.at(colw, (ech, slot // 8, eln),
              (c.astype(np.uint32) << ((slot % 8) * 4)).astype(np.uint32))
    meta[:, 2: 2 + W // 8] = colw.view(np.int32)
    # packed row pointers: rend[r] = slot of last entry in rows <= r
    # (= cumulative count, slot-indexed); 4 bytes per int32 word
    rc = np.zeros((nt, 16), np.int64)
    np.add.at(rc, (owner, r), 1)
    rend = np.cumsum(rc, axis=1)         # (nt, 16) in [0, W-1]
    rw = np.zeros((nchunks, 4, T), np.uint32)
    for k in range(16):
        np.add.at(rw, (chunk_of, k // 4, lane_of),
                  (rend[:, k].astype(np.uint32) << ((k % 4) * 8)))
    meta[:, 2 + W // 8: 2 + W // 8 + 4] = rw.view(np.int32)

    return SparseChunks(
        val=val, meta=meta, pb=md["pb"], cw=md["cw"], cfirst=md["cfirst"],
        width=W, t_lanes=T, k_panels=K, c_batch=cb), md["n_windows"]


def _select_band(trow, tcol, counts, tilem, n_windows, er, ec, ev):
    """Pick brick-able stripes and pack them; returns (BandChunks | None,
    selected-tile mask)."""
    T = ROW_WINDOW
    nt = trow.shape[0]
    stripes, sfirst = np.unique(trow, return_index=True)
    smin = np.minimum.reduceat(tcol, sfirst)
    smax = np.maximum.reduceat(tcol, sfirst)
    snnz = np.add.reduceat(counts, sfirst)
    ext = smax - smin + 1
    ok = (ext <= BAND_MAX_COLS) & (snnz >= BAND_MIN_STRIPE_FILL
                                   * ext * 256)
    if not ok.any():
        return None, None
    C = int(ext[ok].max())
    # per-window panel budget: the union of [b, b+C) panels must fit
    sel_w = stripes[ok] // T
    okw = np.zeros(n_windows, bool)
    for w in np.unique(sel_w):
        m_ = ok & (stripes // T == w)
        pans = np.unique(np.concatenate(
            [smin[m_] >> 8, (smin[m_] + C - 1) >> 8]))
        if pans.size <= BAND_K:
            okw[w] = True
    ok &= okw[stripes // T]
    if not ok.any():
        return None, None
    # coverage guards: enough windows and enough fill to justify the
    # per-window zero-padded brick chunks
    nsel_w = int(okw.sum())
    fill = float(snnz[ok].sum()) / (max(1, int(ok.sum())) * C * 256)
    lane_frac = int(ok.sum()) / (nsel_w * T)
    if (nsel_w < BAND_MIN_WINDOW_FRAC * n_windows
            or fill < BAND_MIN_CLASS_FILL
            or lane_frac < 0.25 * min(1.0, tilem / T)):
        return None, None

    nchunks = n_windows
    val = np.zeros((nchunks, C, 16, 16, T), np.float32)
    bloc = np.zeros((nchunks, 1, T), np.int32)
    pb = np.zeros((nchunks, BAND_K), np.int32)
    base_of_stripe = np.zeros(tilem + 1, np.int64)
    for w in range(n_windows):
        m_ = ok & (stripes // T == w)
        if not m_.any():
            continue
        pans = np.unique(np.concatenate(
            [smin[m_] >> 8, (smin[m_] + C - 1) >> 8]))
        pb[w, : pans.size] = pans
        pb[w, pans.size:] = pans[0]
        lanes = stripes[m_] % T
        slot = np.searchsorted(pans, smin[m_] >> 8)
        bloc[w, 0, lanes] = (slot * PANEL_TC
                             + (smin[m_] - (pans[slot] << 8))).astype(
                                 np.int32)
    ok_set = np.zeros(tilem, bool)
    ok_set[stripes[ok]] = True
    base_of_stripe[stripes] = smin
    tile_mask = ok_set[trow]
    # scatter entries of selected tiles (np.add: ELL/HYB pad slots share
    # (row, col 0) with real entries; pads add zero)
    e_owner = np.repeat(np.arange(nt), counts)
    e_sel = tile_mask[e_owner]
    et = e_owner[e_sel]
    cbv = (tcol[et] - base_of_stripe[trow[et]])
    win = trow[et] // T
    lane = trow[et] % T
    np.add.at(val, (win, cbv, ec[e_sel], er[e_sel], lane),
              ev[e_sel].astype(np.float32))

    band = BandChunks(
        val=val, bloc=bloc, pb=pb.reshape(-1),
        cw=np.arange(n_windows, dtype=np.int32),
        cfirst=np.ones(n_windows, np.int32), c_cols=C, k_panels=BAND_K)
    return band, tile_mask


def _coo_stream_cost_ns(g_row: np.ndarray, g_col: np.ndarray, m: int):
    """Stream-engine cost estimate for an entry population at the
    geometry and s_batch the builder itself would pick. Returns
    (cost_ns, span_rows, dual) so the caller can hand the picked
    geometry to the builder — (cost, None, None) when the
    free-placement geometry wins."""
    cells = sp._occupied_cells(g_row, g_col)
    span, dual, fp = sp.pick_geometry_fp(g_row, g_col, m, cells=cells)
    uw, uq, uc, nq = cells
    if fp:
        _, wcnt_fp = sp._fp_cost(cells)
        nwin = max(1, -(-m // sp.RW_ROWS))
        wcnt = np.zeros(nwin, np.int64)
        wcnt[: wcnt_fp.shape[0]] = wcnt_fp
        s1, s2, heavy = sp.pick_stream_split(wcnt)
        if s2 is None:
            step_ns = float(sp._window_costs(wcnt, s1).sum())
        else:
            step_ns = float(np.where(heavy, sp._window_costs(wcnt, s2),
                                     sp._window_costs(wcnt, s1)).sum()
                            ) + sp.EXTRA_CLASS_NS
        xcopy_ns = float(wcnt.sum()) * sp.SPAN_ROWS * 128 * 4 * 2 / 800.0
        return step_ns + xcopy_ns, None, None
    C, gwin = sp._group_counts_cells(uw, uq, uc, nq, span)
    per_group = (-(-C.max(axis=1) // sp.CAP)).astype(np.int64)
    nwin = max(1, -(-m // sp.RW_ROWS))
    wcnt = np.zeros(nwin, np.int64)
    np.add.at(wcnt, gwin, per_group)
    if dual:
        # scale the mono per-window counts to the dual total (estimate)
        ratio = sp._dual_slab_count(C, gwin) / max(1, per_group.sum())
        wcnt = np.maximum(wcnt > 0, np.rint(wcnt * ratio).astype(
            np.int64))
    s1, s2, heavy = sp.pick_stream_split(wcnt)
    if s2 is None:
        cost = float(sp._window_costs(wcnt, s1).sum())
    else:
        cost = float(np.where(heavy, sp._window_costs(wcnt, s2),
                              sp._window_costs(wcnt, s1)).sum()
                     ) + sp.EXTRA_CLASS_NS
    return cost, span, dual


def _coo_absorb_cost_ns(ctr: np.ndarray, ctc: np.ndarray,
                        ccounts: np.ndarray, tilem: int) -> float:
    """Cost estimate of absorbing the COO tiles into the W-classes, per
    width class the tiles would land in."""
    band_idx = np.searchsorted(np.asarray(W_CHOICES), ccounts + 1)
    cost = 0.0
    for k in np.unique(band_idx):
        sel = band_idx == k
        W = W_CHOICES[min(int(k), len(W_CHOICES) - 1)]
        cost += _sparse_cost(ctr[sel], ctc[sel], W, tilem)
    return cost


def build_lane_plan(tm: TileMatrix) -> LanePlan:
    """Compile a TileMatrix into the f32 lane-major plan (NumPy arrays).
    COO tiles go to the entry-level stream engine by entry count,
    per-tile density and the absorb-vs-stream cost estimate."""
    b = tm.config.tile_size
    if b != 16:
        raise NotImplementedError("the lane plan requires tile_size=16")

    trow, tcol, counts, er, ec, ev = _all_entries(tm)
    n_windows = max(1, -(-tm.tilem // ROW_WINDOW))

    # --- COO tiles: the entry-level stream engine when they are many and
    # near-singleton; otherwise they join the per-tile routing below
    bk = tm.coo
    coo_entries = int(bk.val.shape[0]) if bk.num_tiles else 0
    coo_avg = coo_entries / max(1, bk.num_tiles) if bk.num_tiles else 0.0
    use_stream = (coo_entries >= STREAM_MIN_ENTRIES
                  and coo_avg < COO_SPARSE_MIN_AVG)
    if use_stream:
        ccounts0 = np.diff(bk.nnz_ptr)
        owner0 = np.repeat(np.arange(bk.num_tiles), ccounts0)
        ctr0 = tm.tile_rowidx[bk.tile_ids].astype(np.int64)
        g_row = ctr0[owner0] * b + bk.row
        g_col = (tm.tile_columnidx[bk.tile_ids[owner0]]
                 .astype(np.int64) * b + bk.col)
        # the picked geometry goes to the builder (the occupied-cells
        # sort dominates stream planning; don't pay it twice)
        stream_ns, span_rows, dual = _coo_stream_cost_ns(g_row, g_col,
                                                         tm.m)
        ctc0 = tm.tile_columnidx[bk.tile_ids].astype(np.int64)
        absorb_ns = _coo_absorb_cost_ns(ctr0, ctc0, ccounts0, tm.tilem)
        use_stream = absorb_ns >= STREAM_ABSORB_MARGIN * stream_ns
    if not use_stream and bk.num_tiles:
        ccounts = np.diff(bk.nnz_ptr)
        ctr = tm.tile_rowidx[bk.tile_ids].astype(np.int64)
        ctc = tm.tile_columnidx[bk.tile_ids].astype(np.int64)
        trow = np.concatenate([trow, ctr])
        tcol = np.concatenate([tcol, ctc])
        counts = np.concatenate([counts, ccounts])
        er = np.concatenate([er, bk.row.astype(np.int64)])
        ec = np.concatenate([ec, bk.col.astype(np.int64)])
        ev = np.concatenate([ev, bk.val.astype(np.float64)])
        order_t = np.argsort(trow * (int(tcol.max()) + 1) + tcol,
                             kind="stable")
        rank_t = np.empty(trow.shape[0], np.int64)
        rank_t[order_t] = np.arange(trow.shape[0])
        e_owner = np.repeat(np.arange(trow.shape[0]), counts)
        order_e = np.argsort((rank_t[e_owner] << 8) | (er << 4) | ec,
                             kind="stable")
        trow, tcol, counts = trow[order_t], tcol[order_t], counts[order_t]
        er, ec, ev = er[order_e], ec[order_e], ev[order_e]

    # --- band (brick) class: qualifying tile-row stripes leave the
    # per-tile routing entirely
    band = None
    if trow.size:
        band, band_tile_mask = _select_band(trow, tcol, counts, tm.tilem,
                                            n_windows, er, ec, ev)
        if band is not None:
            esel = ~band_tile_mask[np.repeat(np.arange(trow.shape[0]),
                                             counts)]
            trow, tcol, counts, er, ec, ev = (
                trow[~band_tile_mask], tcol[~band_tile_mask],
                counts[~band_tile_mask], er[esel], ec[esel], ev[esel])

    # --- execution routing: per tile, dense block vs sparse-entry class
    widx = _route_classes(counts)
    dense_mask = widx >= len(W_CHOICES)

    entry_owner = np.repeat(np.arange(trow.shape[0]), counts)
    dense = None
    if dense_mask.any():
        sel = np.nonzero(dense_mask)[0]
        esel = dense_mask[entry_owner]
        blocks = _densify(trow[sel], tcol[sel], counts[sel],
                          er[esel], ec[esel], ev[esel], b)
        dtr, dtc = trow[sel], tcol[sel]
        t_lanes = _pick_t(dtr, dtc, tm.tilem)
        chunk_bytes = (16 * 16 * t_lanes + DENSE_MROWS * t_lanes) * 4
        kp = _pick_k(dtr, dtc, t_lanes)
        cb = _pick_cb(dtr, dtc, tm.tilem, t_lanes, kp, chunk_bytes)
        kp = _pick_k(dtr, dtc, cb * t_lanes)
        md = _chunk_metadata(dtr, dtc, tm.tilem, t_lanes, kp, cb)
        valid = md["valid"]
        safe = np.where(valid, md["src"], 0)
        vt = blocks[safe]                   # (nchunks, T, b_i, b_j) f64
        vt[~valid] = 0.0
        # j-major layout (nchunks, b_j, b_i, T)
        vt = np.ascontiguousarray(vt.transpose(0, 3, 2, 1))
        meta = np.zeros((md["nchunks"], DENSE_MROWS, t_lanes), np.int32)
        meta[:, META_XLOC] = md["xloc"]
        meta[:, META_LROW] = md["lrow"]
        dense = DenseChunks(
            val=vt.astype(np.float32), meta=meta, pb=md["pb"],
            cw=md["cw"], cfirst=md["cfirst"], t_lanes=t_lanes,
            k_panels=kp, c_batch=cb)
        n_windows = max(n_windows, md["n_windows"])

    sparses = []                      # ascending width
    for k, W in enumerate(W_CHOICES):
        sel_mask = widx == k
        if not sel_mask.any():
            continue
        sel = np.nonzero(sel_mask)[0]
        esel = sel_mask[entry_owner]
        sc, nw = _pack_sparse_class(
            trow[sel], tcol[sel], counts[sel], er[esel], ec[esel],
            ev[esel], W, tm.tilem)
        sparses.append(sc)
        n_windows = max(n_windows, nw)

    # --- stream engine for the COO tiles (decided above)
    stream = stream2 = None
    if use_stream:
        stream, stream2 = build_stream_classes(
            g_row, g_col, bk.val.astype(np.float64), tm.m,
            span_rows=span_rows, dual=dual)

    # leftover residual: the HYB overflow entries
    hb = tm.hyb
    owner = np.repeat(np.arange(hb.num_tiles), np.diff(hb.coo_ptr))
    g_row = (tm.tile_rowidx[hb.tile_ids[owner]].astype(np.int64) * b
             + hb.coo_row)
    g_col = (tm.tile_columnidx[hb.tile_ids[owner]].astype(np.int64) * b
             + hb.coo_col)
    g_val = hb.coo_val.astype(np.float64)
    order = np.lexsort((g_col, g_row))
    residual = ResidualEngine(
        val=g_val[order].astype(np.float32),
        row=g_row[order].astype(np.int32),
        col=g_col[order].astype(np.int32))

    return LanePlan(dense=dense, band=band, sparses=tuple(sparses),
                    residual=residual, stream=stream, stream2=stream2,
                    m=tm.m, n=tm.n, tilem=tm.tilem, tilen=tm.tilen,
                    tile_size=b, nnz=tm.nnz, n_windows=n_windows)
