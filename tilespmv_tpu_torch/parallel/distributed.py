"""Distributed tiled SpMV: the tile grid row-partitioned over a mesh.

Port of tilespmv_tpu/parallel/distributed.py, the 1-D row partition:

* the row space is split into `ndev` contiguous, tile-aligned blocks;
  each block is converted and planned on its own and becomes a
  `TileSpMV` on its mesh device (`TileSpMV.from_plan`), which runs the
  class kernels on the card (their plain versions on the CPU);
* shard plans take the reference's shard-uniform planner options
  (`shard_ops`): the dense chunk width pinned, one stream decision
  for all shards from the COO entries summed over them;
* x reaches the shards by one of the reference's `x_mode`s:
  "replicated" (x copied to every shard), "allgather" (x sharded, then
  `mesh.all_gather`), "halo" (each shard receives only the 128-value x
  blocks its columns touch, by one `mesh.all_to_all` of packets; its
  matrix is split into a local plan over its own x segment and a foreign
  plan over [own segment ++ packets]), or "auto" (halo where it moves
  less than 0.75 of an all-gather's bytes, allgather otherwise);
* y's row blocks each stay on their shard (`shard_outputs`) or come
  back as one y on the first mesh device (`op(x)`).

On a mesh that spans processes (`mesh.initialize_multihost`), every
process runs the same program with the whole CSR and the whole x, as
every process of the reference does: it converts and plans only the
blocks it owns (the halo plan, whose packet layout every process must
agree on, is made from the whole CSR everywhere), the stream decision
sums the COO entries over the processes, `shard_outputs` gives this
process's row blocks, and `op(x)` the whole y on this process's first
device, by one all-gather of the equal row blocks.

The reference pads every shard's plan to one shape (its
`_unify_plans` / `_unify_lane_plans`), because `shard_map` runs one SPMD
program on all shards. Here each shard runs its own plan, unpadded, so
that step is not ported. One consequence (ROADMAP.md C): the reference's
inert padding entries multiply x too, so an Inf or NaN in x can put NaN
into rows of the reference's y where this operator gives the shard's own
product. With a finite x both agree.

The operator is not an `nn.Module`: a shard's place is its mesh device,
and moving the operator means building it on another mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULT_CONFIG, TileConfig
from ..core.convert import tile_create
from ..io.mmio import CSRMatrix
from ..ops.cuda.lane_plan import STREAM_MIN_ENTRIES, build_lane_plan
from ..ops.plan import build_plan
from ..ops.spmv import BACKENDS, TileSpMV
from .mesh import (Mesh, all_gather, all_to_all, gather, make_mesh, on,
                   process_reduce)

X_MODES = ("allgather", "replicated", "halo", "auto")
XB = 128  # x values per halo block


def _row_block(csr: CSRMatrix, r0: int, r1: int,
               rows_padded: int) -> CSRMatrix:
    """Rows [r0, r1) of `csr`, re-based to local indices and padded with
    empty rows to `rows_padded`."""
    r1c = max(r0, min(r1, csr.m))
    indptr = csr.indptr[r0: r1c + 1] if r0 <= csr.m else csr.indptr[-1:]
    if indptr.size == 0:
        indptr = csr.indptr[-1:]
    start = int(indptr[0])
    stop = int(indptr[-1])
    local_ptr = (indptr - start).astype(np.int64)
    pad_rows = rows_padded - (local_ptr.size - 1)
    if pad_rows > 0:
        local_ptr = np.concatenate(
            [local_ptr, np.full(pad_rows, local_ptr[-1], np.int64)])
    return CSRMatrix((rows_padded, csr.n), local_ptr,
                     csr.indices[start:stop], csr.data[start:stop])


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Selective x-exchange plan: which 128-value x blocks each shard
    receives from each peer, from the columns each shard's rows touch.

    Each shard's matrix is column-renumbered into a compact local x
    layout, [its own x rows ++ one `max_pk`-row packet segment per
    peer], so a call is a sender-side row gather, one all-to-all and a
    concatenation."""
    rx: int               # own x rows (of 128 values) per shard
    max_pk: int           # packet rows per (src, dst) pair (padded)
    n_x_pad: int          # padded global x length (ndev * rx * 128)
    traffic_ratio: float  # halo bytes / all-gather bytes (per shard)
    send_idx: np.ndarray  # (ndev, ndev*max_pk) local x rows to send
    local_blocks: list    # per-shard CSRMatrix over the OWN x segment
    foreign_blocks: list  # per-shard CSRMatrix over the packet segments


def _plan_halo(blocks: list, n: int, ndev: int) -> HaloPlan:
    rx = max(1, -(-n // (ndev * XB)))
    n_x_pad = ndev * rx * XB
    # needed foreign blocks per (dst, src)
    need = [np.unique(blk.indices.astype(np.int64) >> 7) for blk in blocks]
    per_pair = [[need[d][(need[d] // rx) == e] for e in range(ndev)]
                for d in range(ndev)]
    max_pk = max((pp.shape[0] for d in range(ndev)
                  for e, pp in enumerate(per_pair[d]) if e != d),
                 default=0)
    max_pk = max(max_pk, 1)
    # sender side: shard e sends to d the blocks per_pair[d][e], in
    # segment d of its row of send_idx
    send_idx = np.zeros((ndev, ndev * max_pk), np.int32)
    for e in range(ndev):
        for d in range(ndev):
            if d == e:
                continue
            loc = (per_pair[d][e] - e * rx).astype(np.int32)
            send_idx[e, d * max_pk: d * max_pk + loc.shape[0]] = loc
    # compact column map per shard: own rows first, then one segment per
    # sender in sender order (the all-to-all's receive layout); the
    # matrix splits into a local part (own columns) and a foreign part
    # (packet columns)
    local_blocks, foreign_blocks = [], []
    n_own = rx * XB
    n_c = (rx + ndev * max_pk) * XB
    for d, blk in enumerate(blocks):
        cmap = np.full(ndev * rx, -1, np.int64)
        cmap[np.arange(d * rx, (d + 1) * rx)] = np.arange(rx)
        for e in range(ndev):
            if e == d:
                continue
            gb = per_pair[d][e]
            cmap[gb] = rx + e * max_pk + np.arange(gb.shape[0])
        cols = blk.indices.astype(np.int64)
        newcols = cmap[cols >> 7] * XB + (cols & (XB - 1))
        rowid = np.repeat(np.arange(blk.m), np.diff(blk.indptr))
        for is_local in (True, False):
            sel = (newcols < n_own) if is_local else (newcols >= n_own)
            r_s, c_s, v_s = rowid[sel], newcols[sel], blk.data[sel]
            order = np.lexsort((c_s, r_s))
            indptr = np.concatenate(
                [[0], np.cumsum(np.bincount(r_s, minlength=blk.m))]
            ).astype(np.int64)
            sub = CSRMatrix(
                (blk.m, n_own if is_local else n_c), indptr,
                c_s[order].astype(np.int64), v_s[order])
            (local_blocks if is_local else foreign_blocks).append(sub)
    ag_bytes = (ndev - 1) * rx
    halo_bytes = ndev * max_pk
    ratio = halo_bytes / max(ag_bytes, 1)
    return HaloPlan(rx=rx, max_pk=max_pk, n_x_pad=n_x_pad,
                    traffic_ratio=ratio, send_idx=send_idx,
                    local_blocks=local_blocks,
                    foreign_blocks=foreign_blocks)


def global_counts(groups: list, backend: str, mesh: Mesh) -> tuple:
    """(the reference's one stream decision for all shards of each group
    of tile matrices: the group's COO entries, summed over every
    process's shards, reach STREAM_MIN_ENTRIES; None on the xla
    backend), and the entries stored by all of them. One all_reduce
    over the mesh's processes gives both."""
    counts = [sum(int(tm.coo.val.shape[0]) if tm.coo.num_tiles else 0
                  for tm in tms) for tms in groups]
    counts.append(sum(tm.nnz for tms in groups for tm in tms))
    *coo, nnz = process_reduce(counts, mesh)
    return ([c >= STREAM_MIN_ENTRIES if backend == "pallas" else None
             for c in coo], int(nnz))


def shard_ops(tile_matrices, devices: list, backend: str,
              dtype: torch.dtype, use_stream: Optional[bool]) -> list:
    """One TileSpMV per shard of this process, on its device, planned
    with the reference's shard-uniform options (shared by the 1-D and
    2-D partitions): force_t pins the chunk shapes, `use_stream` is the
    global decision (`global_counts`), s_batch 8 and span 64."""
    cdt = str(dtype).removeprefix("torch.")
    if backend == "pallas":
        plans = [build_lane_plan(tm, compute_dtype=cdt, force_t=128,
                                 use_stream=use_stream, stream_s_batch=8,
                                 stream_span_rows=64)
                 for tm in tile_matrices]
    else:
        plans = [build_plan(tm, compute_dtype=cdt) for tm in tile_matrices]
    return [TileSpMV.from_plan(p, device=dev, dtype=dtype)
            for p, dev in zip(plans, devices)]


def resolve_backend(backend: str, config: TileConfig) -> str:
    """The backend a shard runs: "auto" is pallas exactly at tile size
    16, as the reference picks."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    if backend == "auto":
        return "pallas" if config.tile_size == 16 else "xla"
    return backend


class DistributedSpMV:
    """Row-partitioned SpMV over a 1-D device mesh.

    >>> op = DistributedSpMV(csr, mesh=make_mesh())          # the cards
    >>> op = DistributedSpMV(csr, mesh=make_mesh(8, devices=["cpu"] * 8))
    >>> y = op(x)                  # y on the mesh's first device
    >>> blocks = op.shard_outputs(x)   # row block d on mesh device d

    On a mesh that spans processes every process builds the operator
    and calls it with the whole x (see the module doc).

    backend "pallas" runs each shard's lane plan (the class kernels on
    the card); "xla" the plain torch engines; "auto" pallas at tile size
    16. `dtype`: torch.float32, torch.float64 or torch.bfloat16.
    """

    def __init__(self, csr: CSRMatrix,
                 mesh: Optional[Mesh] = None,
                 config: TileConfig = DEFAULT_CONFIG,
                 dtype: torch.dtype = torch.float32,
                 backend: str = "auto",
                 x_mode: str = "allgather"):
        if x_mode not in X_MODES:
            raise ValueError(f"unknown x_mode {x_mode!r}")
        backend = resolve_backend(backend, config)
        self.mesh = mesh if mesh is not None else make_mesh()
        ndev = self.mesh.size
        local = self.mesh.local()
        devs = self.mesh.local_devices()
        b = config.tile_size
        m, n = csr.shape
        tilem_total = -(-m // b)
        tilem_per = -(-tilem_total // ndev)
        rows_per = tilem_per * b
        self.m, self.n = m, n
        self.rows_per_device = rows_per
        self.dtype = dtype
        self.backend = backend
        # x padded to a multiple of ndev for even sharding
        self.n_pad = -(-n // ndev) * ndev

        blocks = [_row_block(csr, d * rows_per, (d + 1) * rows_per,
                             rows_per) for d in range(ndev)]
        if x_mode in ("halo", "auto"):
            halo = _plan_halo(blocks, n, ndev)
            if x_mode == "auto":
                # halo pays when the exchanged packets are meaningfully
                # smaller than an all-gather of the full x
                x_mode = ("halo" if ndev > 1 and halo.traffic_ratio < 0.75
                          else "allgather")
            elif ndev == 1:
                x_mode = "replicated"
        self.x_mode = x_mode
        self.halo = halo if x_mode == "halo" else None

        if x_mode == "halo":
            # two plans per shard: the local plan reads only the shard's
            # own x segment; the foreign plan reads [own ++ packets]
            self.tile_matrices = [tile_create(halo.local_blocks[d], config)
                                  for d in local]
            foreign = [tile_create(halo.foreign_blocks[d], config)
                       for d in local]
            use, self.nnz = global_counts([self.tile_matrices, foreign],
                                          backend, self.mesh)
            self.shards = shard_ops(self.tile_matrices, devs, backend,
                                    dtype, use[0])
            self.foreign_shards = shard_ops(foreign, devs, backend, dtype,
                                            use[1])
            self._send_idx = [
                torch.from_numpy(halo.send_idx[d].astype(np.int64)).to(dev)
                for d, dev in zip(local, devs)]
        else:
            self.tile_matrices = [tile_create(blocks[d], config)
                                  for d in local]
            use, self.nnz = global_counts([self.tile_matrices], backend,
                                          self.mesh)
            self.shards = shard_ops(self.tile_matrices, devs, backend,
                                    dtype, use[0])
            self.foreign_shards = None
        self.use_stream = tuple(use)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.m, self.n)

    def flops(self) -> int:
        """2 * nnz of the whole matrix."""
        return 2 * self.nnz

    def exchange_bytes(self) -> int:
        """Bytes of x that one call copies between shards (into each
        shard from the others), summed over the shards."""
        ndev = self.mesh.size
        item = torch.finfo(self.dtype).bits // 8
        if self.x_mode == "halo":
            return ndev * (ndev - 1) * self.halo.max_pk * XB * item
        # allgather: each shard receives the other shards' segments;
        # replicated: the first device's x goes to the other shards
        return (ndev - 1) * self.n_pad * item

    def shard_outputs(self, x) -> list:
        """y's row blocks: block d (`rows_per_device` rows, the last ones
        past m empty) on mesh device d, the counterpart of the
        reference's y sharded P('row'); on a mesh that spans processes,
        the blocks of this process's positions."""
        devs = self.mesh.local_devices()
        x = torch.as_tensor(x, dtype=self.dtype, device=devs[0])
        if x.shape != (self.n,):
            raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                             f"({self.n},)")
        if self.x_mode == "halo":
            return self._halo_outputs(x, devs)
        x = F.pad(x, (0, self.n_pad - self.n))
        if self.x_mode == "allgather":
            chunks = x.chunk(self.mesh.size)
            xs = all_gather([chunks[d].to(dev) for d, dev in
                             zip(self.mesh.local(), devs)], devs,
                            mesh=self.mesh)
        else:
            xs = [x.to(dev) for dev in devs]
        out = []
        for op, xd, dev in zip(self.shards, xs, devs):
            with on(dev):
                out.append(op(xd[: self.n]))
        return out

    def _halo_outputs(self, x: torch.Tensor, devs: list) -> list:
        h = self.halo
        x = F.pad(x, (0, h.n_x_pad - self.n))
        segs = x.split(h.rx * XB)
        own = [segs[d].to(dev).view(h.rx, XB)
               for d, dev in zip(self.mesh.local(), devs)]
        # the packets are issued before the local plans' kernels, which
        # do not depend on them (as the reference orders them)
        send = []
        for x2, idx, dev in zip(own, self._send_idx, devs):
            with on(dev):
                send.append(x2.index_select(0, idx))
        recv = all_to_all(send, devs, mesh=self.mesh)
        ys = []
        for op, x2, dev in zip(self.shards, own, devs):
            with on(dev):
                ys.append(op(x2.reshape(-1)))
        out = []
        for op, y, x2, r, dev in zip(self.foreign_shards, ys, own, recv,
                                     devs):
            with on(dev):
                out.append(y + op(torch.cat([x2, r]).reshape(-1)))
        return out

    def __call__(self, x) -> torch.Tensor:
        """y = A @ x on the mesh's first device (on a mesh that spans
        processes, this process's first)."""
        return gather(self.shard_outputs(x), self.mesh)[: self.m]
