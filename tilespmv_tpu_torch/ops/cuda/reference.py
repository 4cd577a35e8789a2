"""Plain PyTorch versions of the four class kernels, and the SpMV they
assemble.

Each `*_reference(cls, x, y)` adds its class's contribution into the
flat f32 output `y` in place and returns it. `x` is the padded flat x
(see `pad_x`); the class's plan arrays are tensors on x's device. They
use the same index arithmetic as the CUDA kernels (ops/cuda/csrc) and
exact f32 elementwise products, `cumsum` and `index_add_`, so each
kernel is held to its plain version, and the plain versions to
tilespmv_tpu's Pallas kernels in interpret mode (tests/test_torch_*).

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
  y[w*1024 + q*128 + j].
"""
from __future__ import annotations

import torch

from .lane_plan import PANEL_TC, ROW_WINDOW, LanePlan, map_arrays
from .stream_plan import LANES, RW_ROWS, SPAN_ROWS, SUBS

_B = 16
# slabs per pass of stream_reference (bounds its gather temporaries)
_STREAM_SLABS_PER_PASS = 2048


def _x_blocks(pb: torch.Tensor, loc: torch.Tensor, x: torch.Tensor):
    """(rows, 16, T) x blocks of the lanes at `loc` (rows, T) given each
    row's (rows, K) panel ids."""
    tc = pb.gather(1, loc >> 8) * PANEL_TC + (loc & (PANEL_TC - 1))
    j = torch.arange(_B, device=x.device)
    return x[tc[:, None, :] * _B + j[None, :, None]]


def _route(yc, cw_of_chunk, lrow, valid, y):
    """Add chunk results yc (nchunks, 16, T) at rows
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
    acc = torch.zeros(nch, _B, T, dtype=torch.float32, device=y.device)
    for cb in range(C):
        xq = _x_blocks(pb, bloc + cb, x)                 # (nch, 16j, T)
        acc += (bd.val[:, cb] * xq[:, :, None, :]).sum(dim=1)
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
    yc = (d.val * xg[:, :, None, :]).sum(dim=1)           # (nch, 16i, T)
    return _route(yc, d.cw.long()[step], d.meta[:, 1].long(), xloc >= 0, y)


def sparse_reference(s, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """W-class: contrib[c, s, t] = val * xg[col(s)], an inclusive prefix
    over slots, row r's sum = cs[rend[r]] - cs[rend[r-1]] (slot 0 is a
    reserved zero, so rend = 0 reads 0)."""
    nch, W, T = s.val.shape
    dev = y.device
    step = torch.arange(nch, device=dev) // s.c_batch
    xloc = s.meta[:, 0].long()
    pb = s.pb.view(-1, s.k_panels).long()[step]
    xg = _x_blocks(pb, xloc.clamp(min=0), x)              # (nch, 16, T)
    slot = torch.arange(W, device=dev)
    words = s.meta[:, 2 + slot // 8]                      # (nch, W, T)
    col = (words >> ((slot % 8) * 4)[None, :, None]) & 15
    cs = torch.cumsum(s.val * xg.gather(1, col.long()), dim=1)
    r = torch.arange(_B, device=dev)
    rwords = s.meta[:, 2 + W // 8 + r // 4]               # (nch, 16, T)
    rend = (rwords >> ((r % 4) * 8)[None, :, None]) & 255
    g = cs.gather(1, rend.long())
    yc = g - torch.cat([torch.zeros_like(g[:, :1]), g[:, :-1]], dim=1)
    return _route(yc, s.cw.long()[step], s.meta[:, 1].long(), xloc >= 0, y)


def stream_reference(st, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Stream class: per slab, contrib = val * x[entry column], an
    inclusive prefix along lanes, then per round t target (q, j) adds
    csum[src, rend[src, j]] - csum[src, rstart[src, j]], src =
    rsrc[q, j]."""
    S, R, span = st.s_batch, st.rounds, st.span_rows
    dev = y.device
    nsteps = st.cw.shape[0]
    planes = st.planes.view(nsteps, R, 3, S, SUBS, LANES)
    k = torch.arange(SUBS, device=dev)[None, :, None]
    qj = torch.arange(SUBS * LANES, device=dev).view(1, SUBS, LANES)
    per = max(1, _STREAM_SLABS_PER_PASS // S)
    for s0 in range(0, nsteps, per):
        s1 = min(nsteps, s0 + per)
        sl = slice(s0 * S, s1 * S)
        nsl = (s1 - s0) * S
        v = st.vidx[sl].int() & 0xFFFF
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
        contrib = st.val[sl] * x[xrow * LANES + (v & (LANES - 1))]
        csum = torch.cumsum(contrib, dim=2)                # (nsl, 8, 128)
        p = planes[s0:s1].permute(0, 3, 1, 2, 4, 5).reshape(
            nsl, R, 3, SUBS, LANES).long()
        cs = csum[:, None].expand(nsl, R, SUBS, LANES)
        diff = cs.gather(3, p[:, :, 0]) - cs.gather(3, p[:, :, 1])
        yv = diff.gather(2, p[:, :, 2]).sum(dim=1)         # (nsl, 8, 128)
        win = st.cw[s0:s1].long().repeat_interleave(S)
        rows = win[:, None, None] * RW_ROWS + qj
        y.index_add_(0, rows.reshape(-1), yv.reshape(-1))
    return y


def to_torch(plan: LanePlan, device=None) -> LanePlan:
    """`plan` (NumPy arrays) with its arrays as tensors on `device`."""
    return map_arrays(plan, lambda _, a: torch.tensor(a, device=device))


def pad_x(plan: LanePlan, x: torch.Tensor) -> torch.Tensor:
    """Flat f32 x zero-padded to cover every class's x reads: the panel
    classes' x_padded_len and the stream classes' x_padded_len128."""
    xp = torch.zeros(max(plan.x_padded_len, plan.x_padded_len128),
                     dtype=torch.float32, device=x.device)
    xp[: plan.n] = x
    return xp


def assemble(plan: LanePlan, x: torch.Tensor, band, dense, sparse,
             stream) -> torch.Tensor:
    """y = A @ x with the given class functions, in the reference's
    class order (dense, band, W-classes, stream, stream2, residual).
    One zero y serves every class: each adds into it."""
    if x.shape != (plan.n,):
        raise ValueError(f"x has shape {tuple(x.shape)}, "
                         f"expected ({plan.n},)")
    x = x.to(torch.float32)
    xp = pad_x(plan, x)
    ylen = plan.y_padded_len
    if plan.stream is not None:
        ylen = max(ylen, plan.n_stream_windows * RW_ROWS)
    y = torch.zeros(ylen, dtype=torch.float32, device=x.device)
    if plan.dense is not None:
        dense(plan.dense, xp, y)
    if plan.band is not None:
        band(plan.band, xp, y)
    for s in plan.sparses:
        sparse(s, xp, y)
    for st in (plan.stream, plan.stream2):
        if st is not None:
            stream(st, xp, y)
    r = plan.residual
    if r.val.shape[0]:
        y.index_add_(0, r.row.long(), r.val * x[r.col.long()])
    return y[: plan.m]


def spmv_reference(plan: LanePlan, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with the plain PyTorch class versions (any device)."""
    return assemble(plan, x, band_reference, dense_reference,
                    sparse_reference, stream_reference)
