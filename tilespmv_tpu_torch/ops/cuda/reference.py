"""Plain PyTorch versions of the class kernels, and the steps of a call:
`assemble`, which the operator runs with the class kernels and
`spmv_reference` / `spmm_reference` with their plain versions.

Each `*_reference(cls, x, y)` adds its class's contribution into the
output `y` in place and returns it. `x` is the padded x (see
`pad_x`); the class's plan arrays are tensors on x's device. x, y and
the sums have the plan's compute dtype (`lane_plan.acc_dtype`): float32 for an f32
plan, float64 for an f64 one (band, dense and stream classes; the plain
versions of the f64 kernels) and float32 for a bf16 one, whose bf16
values are widened to float32 as the reference's kernels widen them
(tilespmv_tpu/ops/pallas/kernels.py:357, :430, :537, :1937; each product
of a bf16 value and a bf16 x is exact in float32). For SpMV
x is flat (rows,) and y (ylen,); for SpMM over k right-hand sides x is
(rows, k) and y (ylen, k), row-major, and every index below reads
x[i] as x[i, r] and y[i] as y[i, r] for each RHS r. They use the same
index arithmetic as the CUDA kernels (ops/cuda/csrc) and exact
elementwise products, `cumsum` and `index_add_`, so each kernel is held
to its plain version, and the plain versions to tilespmv_tpu's Pallas
kernels in interpret mode (tests/test_torch_*).

Global indices, shared with the kernels:

* a chunk lane's x block starts at
  (pb[step*K + (loc >> 8)] * 256 + (loc & 255)) * 16, loc = meta[XLOC]
  (dense, W-classes) or bloc + column block (band);
* dense/W/band results for tile row-in-window l, row-in-tile i go to
  y[(cw*256 + l)*16 + i];
* a stream entry at (slab si, sublane k, vidx v) reads
  x[row*128 + (v & 127)] with row = sbase + k*(R/8) + ((v >> 7) & (R/8-1))
  (sbase2 when bit 13 of v is set; xmap[si*64 + chunk*8 + k] for
  free-placement classes), and target (q, j) of window w is
  y[w*1024 + q*128 + j]; the entry's own target is q*128 + j = its
  `erow` (stream_plan.entry_rows).

`class_coo` lists a class's nonzeros as global (row, col, value) by the
same arithmetic: what the class computes, whatever layout holds it.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...spans import span
from ..plan import ResidualEngine
from .lane_plan import (DENSE_GROUP, PANEL_TC, ROW_WINDOW, BandChunks,
                        DenseChunks, LanePlan, SparseChunks, acc_dtype,
                        map_arrays, value_dtype)
from .stream_plan import (BF16_BITS, LANES, RW_ROWS, SPAN_ROWS, SUBS,
                          StreamChunks)

_B = 16
# slab-RHS pairs per pass of stream_reference (bounds its gather
# temporaries: a pass of k RHS takes 2048 // k slabs)
_STREAM_SLABS_PER_PASS = 2048


def _rhs(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """v with a trailing unit dimension per RHS dimension of x, so that
    it broadcasts against x's gathered values."""
    return v.reshape(v.shape + (1,) * (x.dim() - 1))


def _take(a: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """a.gather(dim, idx), idx broadcast over a's trailing RHS dims."""
    tail = a.shape[idx.dim():]
    idx = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    return a.gather(dim, idx)


def _x_cols(pb: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """(rows, 16, T) x indices of the lanes at `loc` (rows, T) given each
    row's (rows, K) panel ids: x block tc = panel*256 + (loc & 255), then
    its 16 columns."""
    tc = pb.gather(1, loc >> 8) * PANEL_TC + (loc & (PANEL_TC - 1))
    j = torch.arange(_B, device=pb.device)
    return tc[:, None, :] * _B + j[None, :, None]


def _x_blocks(pb: torch.Tensor, loc: torch.Tensor, x: torch.Tensor):
    """(rows, 16, T[, k]) x blocks of the lanes at `loc` (rows, T) given
    each row's (rows, K) panel ids."""
    return x[_x_cols(pb, loc)]


def _route(yc, cw_of_chunk, lrow, valid, y):
    """Add chunk results yc (nchunks, 16, T[, k]) at rows
    (cw*256 + lrow)*16 + i of y, valid lanes only."""
    i = torch.arange(_B, device=y.device)
    rows = ((cw_of_chunk[:, None] * ROW_WINDOW + lrow) * _B)[:, None, :] \
        + i[None, :, None]
    mask = valid[:, None, :].expand_as(rows)
    return y.index_add_(0, rows[mask], yc[mask])


def band_reference(bd, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Band (brick) class: y[(w*256 + t)*16 + i] +=
    sum_cb sum_j val[w, cb, j, i, t] * x[block(bloc[t] + cb) + j]."""
    nch, C = bd.val.shape[0], bd.val.shape[1]
    T = ROW_WINDOW
    pb = bd.pb.view(nch, bd.k_panels).long()
    bloc = bd.bloc.view(nch, T).long()
    acc = torch.zeros((nch, _B, T) + x.shape[1:], dtype=x.dtype,
                      device=y.device)
    for cb in range(C):
        xq = _x_blocks(pb, bloc + cb, x)                 # (nch, 16j, T)
        acc += (_rhs(bd.val[:, cb], x) * xq[:, :, None]).sum(dim=1)
    valid = torch.ones(nch, T, dtype=torch.bool, device=y.device)
    lane = torch.arange(T, device=y.device).expand(nch, T)
    return _route(acc, bd.cw.long(), lane, valid, y)


def dense_reference(d, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dense class: yc[c, i, t] = sum_j val[c, j, i, t] * xg[c, j, t],
    routed to window row meta[LROW] of step c // c_batch."""
    nch = d.val.shape[0]
    step = torch.arange(nch, device=y.device) // d.c_batch
    xloc = d.meta[:, 0].long()
    pb = d.pb.view(-1, d.k_panels).long()[step]
    xg = _x_blocks(pb, xloc.clamp(min=0), x)              # (nch, 16j, T)
    yc = (_rhs(d.val, x) * xg[:, :, None]).sum(dim=1)     # (nch, 16i, T)
    return _route(yc, d.cw.long()[step], d.meta[:, 1].long(), xloc >= 0, y)


def dense_active_reference(d, x: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
    """Dense class as dense.cu and dense_spmm.cu walk it (the plain
    version of dense_spmm, x (rows, k)): only the DENSE_GROUP-lane groups
    listed in `groups` (chunk*T + first lane), and in each active tile
    only the values of the columns j set in its `cmask` (the others
    taken as 0): y[(cw*256 + lrow)*16 + i] += sum_j val[c, j, i, t] *
    x[tilecol*16 + j]. Every product is taken, so it equals
    dense_reference for any x, a non-finite x times a zero column
    included."""
    T = d.t_lanes
    dev = y.device
    g = d.groups.long()
    lane = (g % T)[:, None] + torch.arange(DENSE_GROUP, device=dev)
    c = (g // T)[:, None].expand_as(lane)                 # (ng, 32)
    xloc = d.meta[c, 0, lane].long()
    act = xloc >= 0
    step = c // d.c_batch
    loc = xloc.clamp(min=0)
    tc = (d.pb.view(-1, d.k_panels).long()[step, loc >> 8] * PANEL_TC
          + (loc & (PANEL_TC - 1)))
    j = torch.arange(_B, device=dev)
    xg = x[tc[..., None] * _B + j]                        # (ng, 32, 16j[, k])
    on = ((d.cmask[c, lane].long()[..., None] >> j) & 1).bool()
    v = torch.where(on[..., None], d.val[c, :, :, lane], 0)  # (ng, 32, j, i)
    yc = (_rhs(v, x) * xg[:, :, :, None]).sum(dim=2)     # (ng, 32, i[, k])
    rows = ((d.cw.long()[step] * ROW_WINDOW + d.meta[c, 1, lane].long())
            * _B)[..., None] + j
    return y.index_add_(0, rows[act].reshape(-1),
                        yc[act].reshape((-1,) + x.shape[1:]))


def _sparse_rend(s) -> torch.Tensor:
    """(nch, 16, T) row ends of a W-class: rend[r] = last slot of the
    tile's rows <= r (byte r % 4 of meta row 2 + W/8 + r // 4)."""
    r = torch.arange(_B, device=s.meta.device)
    rwords = s.meta[:, 2 + s.width // 8 + r // 4]
    return (rwords >> ((r % 4) * 8)[None, :, None]) & 255


def _sparse_cols(s, slot: torch.Tensor) -> torch.Tensor:
    """(nch, len(slot), T) 4-bit column of each slot (nibble s % 8 of
    meta row 2 + s // 8)."""
    words = s.meta[:, 2 + slot // 8]
    return (words >> ((slot % 8) * 4)[None, :, None]) & 15


def sparse_reference(s, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """W-class as the Pallas kernel forms it: contrib[c, s, t] = val *
    xg[col(s)], an inclusive prefix over slots, row r's sum = cs[rend[r]]
    - cs[rend[r-1]] (slot 0 is a reserved zero, so rend = 0 reads 0).
    The W-class kernels' plain version is sparse_rows_reference (SpMV and
    SpMM). The two differ only where x is not finite: the prefix takes every
    slot (the reserved zero and the padding as 0 * x[column 0]) and
    carries Inf - Inf into later rows, so NaN reaches rows whose CSR sum
    is finite."""
    nch, W, T = s.val.shape
    dev = y.device
    step = torch.arange(nch, device=dev) // s.c_batch
    xloc = s.meta[:, 0].long()
    pb = s.pb.view(-1, s.k_panels).long()[step]
    xg = _x_blocks(pb, xloc.clamp(min=0), x)              # (nch, 16, T)
    col = _sparse_cols(s, torch.arange(W, device=dev))    # (nch, W, T)
    cs = torch.cumsum(_rhs(s.val, x) * _take(xg, 1, col.long()), dim=1)
    g = _take(cs, 1, _sparse_rend(s).long())
    yc = g - torch.cat([torch.zeros_like(g[:, :1]), g[:, :-1]], dim=1)
    return _route(yc, s.cw.long()[step], s.meta[:, 1].long(), xloc >= 0, y)


def sparse_rows_reference(s, x: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
    """W-class as sparse.cu and sparse_spmm.cu walk it (the plain version
    of sparse_spmv and, x (rows, k), of sparse_spmm): slot
    s >= 1 of an active tile lies in row r = #{r' : rend[r'] < s} and
    adds val * x[tilecol*16 + col(s)] into the tile's row-r sum; slots
    past rend[15] hold nothing; the tiles' row sums are then added into
    y[(cw*256 + lrow)*16 + r]. Each row sums its own slots, so a
    non-finite x reaches only the rows whose entries read it, as in the
    CSR product."""
    nch, W, T = s.val.shape
    dev = y.device
    step = torch.arange(nch, device=dev) // s.c_batch
    xloc = s.meta[:, 0].long()
    pb = s.pb.view(-1, s.k_panels).long()[step]
    base = _x_cols(pb, xloc.clamp(min=0))[:, :1]          # (nch, 1, T)
    slot = torch.arange(W, device=dev)
    rend = _sparse_rend(s).long()
    row = torch.searchsorted(rend.transpose(1, 2).contiguous(),
                             slot.expand(nch, T, W).contiguous())
    keep = ((xloc >= 0)[:, None, :] & (slot >= 1)[None, :, None]
            & (slot[None, :, None] <= rend[:, -1:]))      # (nch, W, T)
    cell = ((torch.arange(nch, device=dev)[:, None, None] * _B
             + row.transpose(1, 2)) * T + torch.arange(T, device=dev))
    cols = base + _sparse_cols(s, slot).long()
    yc = torch.zeros((nch, _B, T) + x.shape[1:], dtype=x.dtype, device=dev)
    yc.view((-1,) + x.shape[1:]).index_add_(
        0, cell[keep], _rhs(s.val[keep], x) * x[cols[keep]])
    return _route(yc, s.cw.long()[step], s.meta[:, 1].long(), xloc >= 0, y)


def _stream_cols(st, sl: slice) -> torch.Tensor:
    """(slabs, 8, 128) x index of every entry slot of the slabs `sl`."""
    span = st.span_rows
    v = st.vidx[sl].int() & 0xFFFF
    nsl = v.shape[0]
    k = torch.arange(SUBS, device=v.device)[None, :, None]
    ch = (v >> 7) & (span // 8 - 1)
    if st.xmap is not None:
        xrow = st.xmap.view(-1, SPAN_ROWS)[sl].long().gather(
            1, (ch * SUBS + k).view(nsl, -1).long()).view_as(v)
    else:
        sb = st.sbase[sl].long()[:, None, None]
        if st.sbase2 is not None:
            sb = torch.where(((v >> 13) & 1) == 1,
                             st.sbase2[sl].long()[:, None, None], sb)
        xrow = sb + k * (span // 8) + ch
    return xrow * LANES + (v & (LANES - 1))


def stream_reference(st, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Stream class in the planes' form (the Pallas kernel's): per slab,
    contrib = val * x[entry column], an inclusive prefix along lanes,
    then per round t target (q, j) adds csum[src, rend[src, j]] -
    csum[src, rstart[src, j]], src = rsrc[q, j]. The stream kernels'
    plain version is stream_rows_reference (stream.cu, stream2.cu)."""
    S, R = st.s_batch, st.rounds
    dev = y.device
    rhs = x.shape[1:]
    nsteps = st.cw.shape[0]
    planes = st.planes.view(nsteps, R, 3, S, SUBS, LANES)
    qj = torch.arange(SUBS * LANES, device=dev).view(1, SUBS, LANES)
    per = max(1, _STREAM_SLABS_PER_PASS // (S * x[0].numel()))
    for s0 in range(0, nsteps, per):
        s1 = min(nsteps, s0 + per)
        sl = slice(s0 * S, s1 * S)
        nsl = (s1 - s0) * S
        contrib = _rhs(st.val[sl], x) * x[_stream_cols(st, sl)]
        csum = torch.cumsum(contrib, dim=2)                # (nsl, 8, 128)
        p = planes[s0:s1].permute(0, 3, 1, 2, 4, 5).reshape(
            nsl, R, 3, SUBS, LANES).long()
        cs = csum[:, None].expand((nsl, R) + csum.shape[1:])
        diff = _take(cs, 3, p[:, :, 0]) - _take(cs, 3, p[:, :, 1])
        yv = _take(diff, 2, p[:, :, 2]).sum(dim=1)         # (nsl, 8, 128)
        win = st.cw[s0:s1].long().repeat_interleave(S)
        rows = win[:, None, None] * RW_ROWS + qj
        y.index_add_(0, rows.reshape(-1), yv.reshape((-1,) + rhs))
    return y


def stream_rows_reference(st, x: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
    """Stream class by per-entry rows (the plain version of stream.cu and,
    x (rows, k), of stream2.cu): every slot with erow >= 0 adds
    val * x[entry column] into y[cw*1024 + erow]."""
    hit = st.erow >= 0
    win = st.cw.long().repeat_interleave(st.s_batch)
    rows = win[:, None, None] * RW_ROWS + st.erow.long()
    cols = _stream_cols(st, slice(0, st.val.shape[0]))[hit]
    return y.index_add_(0, rows[hit], _rhs(st.val[hit], x) * x[cols])


# The class versions above take k right-hand sides as well: they are the
# plain versions of the fused SpMM kernels (band_spmm.cu, dense_spmm.cu,
# sparse_spmm.cu; stream2.cu's is stream_rows_reference). The dense
# class's is dense.cu's walk (the active groups and columns), the
# W-class's the rows form, as their kernels walk them.
band_spmm_reference = band_reference
dense_spmm_reference = dense_active_reference
sparse_spmm_reference = sparse_rows_reference
# the plain version of each kind's SpMV (False) and SpMM (True) kernel
PLAIN = {False: dict(band=band_reference, dense=dense_reference,
                     sparse=sparse_rows_reference,
                     stream=stream_rows_reference),
         True: dict(band=band_spmm_reference, dense=dense_spmm_reference,
                    sparse=sparse_spmm_reference,
                    stream=stream_rows_reference)}


def stream2_reference(st, x: torch.Tensor, y: torch.Tensor,
                      r: int) -> torch.Tensor:
    """The stream class on RHS r and r+1 of x (rows, k) into y (ylen, k)
    in the planes' form: what the Pallas stream_class_call2 computes for
    that pair, to which the tests hold stream_rows_reference."""
    stream_reference(st, x[:, r:r + 2], y[:, r:r + 2])
    return y


def _band_coo(bd):
    nch, C = bd.val.shape[0], bd.val.shape[1]
    T = ROW_WINDOW
    pb = bd.pb.view(nch, bd.k_panels).long()
    bloc = bd.bloc.view(nch, T).long()
    i = torch.arange(_B)[None, :, None]
    rows = (bd.cw.long()[:, None, None] * T
            + torch.arange(T)[None, None, :]) * _B + i    # (nch, 16i, T)
    out = []
    for cb in range(C):
        cols = _x_cols(pb, bloc + cb)                     # (nch, 16j, T)
        out.append((rows[:, None].expand(bd.val[:, cb].shape),
                    cols[:, :, None].expand(bd.val[:, cb].shape),
                    bd.val[:, cb]))
    return [torch.cat([o[f].reshape(-1) for o in out]) for f in range(3)]


def _dense_coo(d):
    nch = d.val.shape[0]
    step = torch.arange(nch) // d.c_batch
    xloc, lrow = d.meta[:, 0].long(), d.meta[:, 1].long()
    pb = d.pb.view(-1, d.k_panels).long()[step]
    cols = _x_cols(pb, xloc.clamp(min=0))                 # (nch, 16j, T)
    rows = ((d.cw.long()[step][:, None] * ROW_WINDOW + lrow) * _B)[
        :, None, :] + torch.arange(_B)[None, :, None]     # (nch, 16i, T)
    shape = d.val.shape                                   # (nch, j, i, T)
    keep = (xloc >= 0)[:, None, None, :].expand(shape)
    return (rows[:, None].expand(shape)[keep],
            cols[:, :, None].expand(shape)[keep], d.val[keep])


def _sparse_coo(s):
    nch, W, T = s.val.shape
    step = torch.arange(nch) // s.c_batch
    xloc, lrow = s.meta[:, 0].long(), s.meta[:, 1].long()
    pb = s.pb.view(-1, s.k_panels).long()[step]
    tc = _x_cols(pb, xloc.clamp(min=0))[:, 0]             # (nch, T)
    slot = torch.arange(W)
    cols = tc[:, None, :] + _sparse_cols(s, slot).long()  # (nch, W, T)
    rend = _sparse_rend(s).long()                         # (nch, 16, T)
    # slot t of a lane belongs to the first row r with rend[r] >= t
    ge = rend[:, :, None, :] >= slot[None, None, :, None]  # (nch, r, W, T)
    rin = ge.int().argmax(dim=1)                          # (nch, W, T)
    rows = ((s.cw.long()[step][:, None] * ROW_WINDOW + lrow) * _B)[
        :, None, :] + rin
    keep = (xloc >= 0)[:, None, :] & ge.any(dim=1)
    return rows[keep], cols[keep], s.val[keep]


def _stream_coo(st):
    hit = st.erow >= 0
    win = st.cw.long().repeat_interleave(st.s_batch)
    rows = win[:, None, None] * RW_ROWS + st.erow.long()
    cols = _stream_cols(st, slice(0, st.val.shape[0]))
    return rows[hit], cols[hit], st.val[hit]


def class_coo(cls) -> tuple:
    """The nonzeros of one plan class (BandChunks, DenseChunks,
    SparseChunks, StreamChunks or ResidualEngine; arrays as tensors on
    any device, or NumPy) as NumPy (row, col, val): global y row, global
    x column and value, by the plain versions' index arithmetic (stream
    classes by `erow`). Padding (zero values, masked lanes) is left out,
    so a plan's classes together list each entry of its matrix once.
    bf16 values come as float32 (NumPy has no bfloat16; exact)."""
    cls = dataclasses.replace(cls, **{
        f.name: plan_tensor(getattr(cls, f.name)).cpu()
        for f in dataclasses.fields(cls)
        if f.type == "Any" and getattr(cls, f.name) is not None})
    if isinstance(cls, BandChunks):
        row, col, val = _band_coo(cls)
    elif isinstance(cls, DenseChunks):
        row, col, val = _dense_coo(cls)
    elif isinstance(cls, SparseChunks):
        row, col, val = _sparse_coo(cls)
    elif isinstance(cls, StreamChunks):
        row, col, val = _stream_coo(cls)
    elif isinstance(cls, ResidualEngine):
        row, col, val = cls.row.long(), cls.col.long(), cls.val
    else:
        raise TypeError(f"class_coo: not a plan class: {type(cls)}")
    nz = val != 0
    return (row[nz].numpy().astype(np.int64),
            col[nz].numpy().astype(np.int64),
            val[nz].to(acc_dtype(val.dtype)).numpy())


def plan_tensor(a) -> torch.Tensor:
    """A plan array as a tensor: NumPy bf16 values (lane_plan.value_dtype:
    bits or 2-byte void items) viewed as torch.bfloat16, other NumPy arrays through torch.from_numpy (sharing
    their memory), tensors as they are."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if value_dtype(a) == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def plan_array(t: torch.Tensor) -> np.ndarray:
    """A plan tensor as a NumPy array on the host: plan_tensor's inverse
    (torch.bfloat16 as BF16_BITS)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def to_torch(plan: LanePlan, device=None) -> LanePlan:
    """`plan` (NumPy arrays) with its arrays copied into tensors on
    `device` (plan_tensor)."""
    return map_arrays(plan, lambda _, a: plan_tensor(a).to(device,
                                                            copy=True))


def pad_x(plan: LanePlan, x: torch.Tensor) -> torch.Tensor:
    """x, (n,) or (n, k), in the plan's compute dtype (acc_dtype; a bf16
    x widens exactly to float32), zero-padded along its rows to cover
    every class's x reads: the panel classes' x_padded_len and the stream
    classes' x_padded_len128."""
    xp = torch.zeros((max(plan.x_padded_len, plan.x_padded_len128),)
                     + x.shape[1:], dtype=acc_dtype(plan.dtype),
                     device=x.device)
    xp[: plan.n] = x
    return xp


def zero_y(plan: LanePlan, x: torch.Tensor) -> torch.Tensor:
    """One zero y, (ylen,) or (ylen, k), in the plan's compute dtype,
    spanning the panel classes' and the stream classes' windows: every
    class adds into it."""
    ylen = plan.y_padded_len
    if plan.stream is not None:
        ylen = max(ylen, plan.n_stream_windows * RW_ROWS)
    return torch.zeros((ylen,) + x.shape[1:], dtype=acc_dtype(plan.dtype),
                       device=x.device)


def class_order(plan: LanePlan) -> list:
    """(span, kind, class) of each class of the plan in the reference's
    class order: dense, band, the W-classes, stream, stream2; `kind` is
    "dense", "band", "sparse" or "stream", the span
    `tsp.launch.<class>`."""
    out = [(f"tsp.launch.{kind}", kind, c) for kind, c in
           (("dense", plan.dense), ("band", plan.band)) if c is not None]
    out += [(f"tsp.launch.sparse_w{s.width}", "sparse", s)
            for s in plan.sparses]
    out += [(f"tsp.launch.{name}", "stream", st) for name, st in
            (("stream", plan.stream), ("stream2", plan.stream2))
            if st is not None]
    return out


def residual_add(plan: LanePlan, x, y) -> None:
    """Add the residual entries' products into y (x unpadded, in the
    plan's value dtype). Values and x are widened to y's compute dtype
    first, so a bf16 product is exact in float32, as the reference's
    `plan.residual.val * x[col]` (tilespmv_tpu/ops/pallas/kernels.py:
    2037-2039, :1137-1139) runs once jitted: XLA keeps that bf16 product
    in float32."""
    r = plan.residual
    if r.val.shape[0]:
        y.index_add_(0, r.row.long(), _rhs(r.val.to(y.dtype), x)
                     * x[r.col.long()].to(y.dtype))


def finish(plan: LanePlan, x: torch.Tensor,
           y: torch.Tensor) -> torch.Tensor:
    """The residual added into y (residual_add) and y's first m rows in
    the plan's value dtype, in span `tsp.finish`."""
    with span("tsp.finish"):
        residual_add(plan, x, y)
        return y[: plan.m].to(plan.dtype)


def checked_x(x, dtype: torch.dtype, n: int, ndim: int,
              device=None) -> torch.Tensor:
    """x as a tensor of `dtype` on `device` (None: where x is), of shape
    (n,) for ndim 1 or (n, k) for ndim 2; ValueError naming both shapes
    otherwise."""
    x = torch.as_tensor(x, dtype=dtype, device=device)
    if x.dim() != ndim or x.shape[0] != n:
        want = f"({n},)" if ndim == 1 else f"({n}, k)"
        raise ValueError(f"{'x' if ndim == 1 else 'X'} has shape "
                         f"{tuple(x.shape)}, expected {want}")
    return x


def assemble(plan: LanePlan, x: torch.Tensor, launches,
             pad=None) -> torch.Tensor:
    """y = A @ x for x (n,), or Y = A @ X for X (n, k) all k columns a
    launch, x in the plan's value dtype, in the reference's class order
    (spmm_pallas's for X, tilespmv_tpu/ops/pallas/kernels.py:1069-1140).
    In span `tsp.prep` (spans.py): the current CUDA stream's handle read
    once (None on the CPU), x padded by `pad(x, stream)` (None: pad_x),
    y zeroed (zero_y); then each (span, launch) of `launches`, one a
    class in class_order, runs launch(x padded, y, stream) in its span;
    then `finish`."""
    with span("tsp.prep"):
        stream = None
        if x.is_cuda:
            stream = torch.cuda.current_stream().cuda_stream
        xp = pad_x(plan, x) if pad is None else pad(x, stream)
        y = zero_y(plan, x)
    for name, launch in launches:
        with span(name):
            launch(xp, y, stream)
    return finish(plan, x, y)


def _plain_launch(fn, cls, x, y, stream):
    """A class's plain version fn as a launch (it takes no stream)."""
    return fn(cls, x, y)


def _reference(plan: LanePlan, x, ndim: int) -> torch.Tensor:
    plain = PLAIN[ndim == 2]
    return assemble(plan, checked_x(x, plan.dtype, plan.n, ndim), [
        (name, functools.partial(_plain_launch, plain[kind], cls))
        for name, kind, cls in class_order(plan)])


def spmv_reference(plan: LanePlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with the plain PyTorch class versions (any device), x
    cast to the plan's value dtype."""
    return _reference(plan, x, 1)


def spmm_reference(plan: LanePlan, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n, k), with the plain PyTorch class versions (any
    device), X cast to the plan's value dtype."""
    return _reference(plan, x, 2)


# The microbenchmarks' shapes (scripts/microbench_{gather,scatter}.py of
# the reference): one gather step reads src (512, 128) f32 at idx (512,
# 128) int8 in groups of R rows; one scatter step walks S slabs of an
# (S*8, 128) f32 csum with the int8 index planes pe (MB_PE_ROWS, 128).
MB_ROWS = 512
MB_GATHER_R = (8, 16, 32, 64)
MB_SLABS = 13
MB_ROUNDS = 8
MB_PE_ROWS = max(3 * MB_SLABS * SUBS * MB_ROUNDS, 96 * MB_SLABS)
MB_SCATTER_ARMS = ("rounds", "offs", "offs_nodep", "offs_noroll")


def microbench_gather_reference(src: torch.Tensor, idx: torch.Tensor,
                                r: int) -> torch.Tensor:
    """One gather step: out[i, l] = sum over rows r' = i (mod 8) of
    src[r', idx[r', l]], (8, 128). The group width r sets only how the
    kernel walks the rows, not the result."""
    if r not in MB_GATHER_R:
        raise ValueError(f"microbench_gather: R = {r}, not in {MB_GATHER_R}")
    u = src.gather(1, idx.long())
    return u.view(MB_ROWS // SUBS, SUBS, LANES).sum(dim=0)


def microbench_scatter_reference(arm: str, csum: torch.Tensor,
                                 pe: torch.Tensor) -> torch.Tensor:
    """One scatter step of `arm`, (8, 128). Slab s reads csum rows
    s*8..s*8+7 (cs below); a lane gather g(a, rows)[i, l] = a[i, pe[rows
    + i, l]].

    * rounds: for round t, slab s, o = t*3*S*8 + s*8: out[q, l] +=
      (g(cs, o) - g(cs, S*8 + o))[pe[2*S*8 + o + q, l], l];
    * offs: per slab (base s*96) diff = g(cs, base) - g(cs, base + 8),
      then pick d = g(diff, base + (2 + d)*8) for d < 8, each pick's sum
      over slabs rolled down by d sublanes before the sum over d;
    * offs_nodep: offs with diff = cs; offs_noroll: offs with no roll.
    """
    S = MB_SLABS
    cs = csum.view(S, SUBS, LANES)
    if arm == "rounds":
        p = pe[: 3 * S * SUBS * MB_ROUNDS].view(
            MB_ROUNDS, 3, S, SUBS, LANES).long()
        c = cs.expand(MB_ROUNDS, S, SUBS, LANES)
        diff = c.gather(3, p[:, 0]) - c.gather(3, p[:, 1])
        return diff.gather(2, p[:, 2]).sum(dim=(0, 1))
    if arm not in MB_SCATTER_ARMS:
        raise ValueError(f"microbench_scatter: arm {arm!r}, not one of "
                         f"{MB_SCATTER_ARMS}")
    p = pe[: 96 * S].view(S, 12, SUBS, LANES).long()
    diff = cs if arm == "offs_nodep" else (
        cs.gather(2, p[:, 0]) - cs.gather(2, p[:, 1]))
    picks = diff[:, None].expand(S, SUBS, SUBS, LANES).gather(
        3, p[:, 2:10]).sum(dim=0)                          # (d, 8, 128)
    if arm != "offs_noroll":
        picks = torch.stack([picks[d].roll(d, 0) for d in range(SUBS)])
    return picks.sum(dim=0)
