"""CSR -> TileMatrix converter.

Vectorized NumPy re-implementation of the reference's 4-pass OpenMP
converter (reference: src/csr2tile.h):

* pass 1 - tile occupancy count        (convert_step1, csr2tile.h:5-40)
* pass 2 - per-tile colidx/nnz/row hist (convert_step2, csr2tile.h:42-106)
* pass 3 - per-tile format selection    (convert_step3, csr2tile.h:108-328)
* pass 4 - payload fill + residual      (convert_step4, csr2tile.h:330-627)
* residual COO->CSR + index compression (Tile_create,   csr2tile.h:899-1008)

Instead of walking CSR rows per tile-row with a per-nonzero linear tile
search (csr2tile.h:403-419 — O(tiles_per_row) per nnz), this converter sorts
all nonzeros once by (tile_row, tile_col, row-in-tile, col-in-tile) and
derives every pass with histograms/scans/scatters — O(nnz log nnz) total and
fully vectorized. A C++ native implementation of the same algorithm lives in
native/tileconv.cpp; this module is the reference implementation and
fallback.

Selector thresholds reproduce the reference exactly, including the C
`int` truncation of `rowlen * collen * 0.75` (csr2tile.h:150).
"""
from __future__ import annotations

import numpy as np

from ..config import (FMT_COO, FMT_CSR, FMT_DNS, FMT_DNSCOL, FMT_DNSROW,
                      FMT_ELL, FMT_HYB, DEFAULT_CONFIG, TileConfig)
from ..io.mmio import CSRMatrix
from ..spans import phase
from .tile_matrix import (COOBucket, CSRBucket, DNSBucket, DNSColBucket,
                          DNSRowBucket, ELLBucket, HYBBucket, TileMatrix)


def _exclusive_scan(counts: np.ndarray, dtype=np.int64) -> np.ndarray:
    out = np.zeros(counts.shape[0] + 1, dtype=dtype)
    np.cumsum(counts, out=out[1:])
    return out


def _select_formats(cfg: TileConfig, counts, rowlen, collen, row_hist,
                    col_hist):
    """Vectorized format selector (reference convert_step3,
    csr2tile.h:140-328). Returns (fmt[int8], ell_width[int16],
    hyb_width[int16], hyb_coo[int32])."""
    b = cfg.tile_size
    tilenum = counts.shape[0]
    fmt = np.full(tilenum, -1, dtype=np.int8)
    ell_width = np.zeros(tilenum, dtype=np.int16)
    hyb_width = np.zeros(tilenum, dtype=np.int16)
    hyb_coo = np.zeros(tilenum, dtype=np.int32)

    if cfg.force_format is not None:
        # Bypass the selector entirely (forced-format benchmark mode).
        code = {"csr": FMT_CSR, "coo": FMT_COO, "ell": FMT_ELL,
                "dns": FMT_DNS}[cfg.force_format]
        fmt[:] = code
        if code == FMT_ELL:
            ell_width[:] = row_hist.max(axis=1).astype(np.int16)
        return fmt, ell_width, hyb_width, hyb_coo

    # (a) dense: nnz >= int(rowlen*collen*0.75)  (csr2tile.h:150-157;
    # the C code truncates the double product to int)
    dense_th = (rowlen.astype(np.float64) * collen.astype(np.float64)
                * cfg.dense_threshold).astype(np.int64)
    is_dns = counts >= dense_th
    fmt[is_dns] = FMT_DNS

    # (b) COO: nnz <= threshold (csr2tile.h:159-167)
    undecided = ~is_dns
    is_coo = undecided & (counts <= cfg.coo_nnz_threshold)
    fmt[is_coo] = FMT_COO
    undecided &= ~is_coo

    # (c) dense-row / dense-col, gated on divisibility (csr2tile.h:169-241)
    div_ok = undecided & ((counts % collen == 0) | (counts % rowlen == 0))
    # dense-row: every row count is a multiple of collen (i.e. 0 or collen,
    # since a canonical row holds <= collen entries) and >= 1 row is full.
    row_mult = (row_hist % collen[:, None] == 0).all(axis=1)
    n_full_rows = (row_hist == collen[:, None]).sum(axis=1).astype(np.int32)
    is_dnsrow = div_ok & row_mult & (n_full_rows > 0)
    fmt[is_dnsrow] = FMT_DNSROW
    # dense-col, only for tiles that failed the dense-row check
    col_mult = (col_hist % rowlen[:, None] == 0).all(axis=1)
    n_full_cols = (col_hist == rowlen[:, None]).sum(axis=1).astype(np.int32)
    is_dnscol = div_ok & ~is_dnsrow & col_mult & (n_full_cols > 0)
    fmt[is_dnscol] = FMT_DNSCOL
    undecided &= ~(is_dnsrow | is_dnscol)

    # (d) ELL if row-length coefficient of variation <= 0.2
    # (csr2tile.h:245-276). Statistics over rows [0, rowlen) only.
    row_valid = np.arange(b)[None, :] < rowlen[:, None]
    mean = counts.astype(np.float64) / rowlen
    delta = row_hist.astype(np.float64) - mean[:, None]
    variance = np.where(row_valid, delta * delta, 0.0).sum(axis=1) / rowlen
    with np.errstate(divide="ignore", invalid="ignore"):
        cv = np.sqrt(variance) / mean
    bwidth = row_hist.max(axis=1).astype(np.int16)
    is_ell = undecided & (cv <= cfg.ell_cv_threshold)
    fmt[is_ell] = FMT_ELL
    ell_width[is_ell] = bwidth[is_ell]
    undecided &= ~is_ell

    # (e) HYB width search minimizing stored bytes (csr2tile.h:279-306);
    # the reference comments the HYB branch out (csr2tile.h:308-316) so the
    # fallback is CSR — we honor cfg.enable_hyb.
    if cfg.enable_hyb and undecided.any():
        idx = np.nonzero(undecided)[0]
        h = row_hist[idx].astype(np.int64)
        rl = rowlen[idx]
        vb = np.dtype(cfg.value_dtype).itemsize
        bw = bwidth[idx].astype(np.int64)

        def iosize(w, coonum):
            ell = w * rl
            return (ell * vb + (ell + 1) // 2
                    + coonum * (vb + 1))

        w_cur = bw.copy()
        prior = iosize(bw, 0)
        coo_prior = np.zeros_like(bw)
        done = np.zeros(bw.shape, dtype=bool)
        for _ in range(cfg.tile_size):
            wi = w_cur - 1
            active = ~done & (wi > 0)
            if not active.any():
                break
            coonext = np.maximum(h - wi[:, None], 0).sum(axis=1)
            nxt = iosize(wi, coonext)
            stop = active & (prior <= nxt)
            done |= stop
            step = active & ~stop
            w_cur = np.where(step, wi, w_cur)
            prior = np.where(step, nxt, prior)
            coo_prior = np.where(step, coonext, coo_prior)
        sel_h = (coo_prior <= cfg.hyb_max_coo)
        # cv >= hyb threshold already true here (cv > ell threshold branch);
        # the reference additionally required cv >= 1.0 in the commented code
        cv_ok = cv[idx] >= cfg.hyb_cv_threshold
        chosen = sel_h & cv_ok
        gidx = idx[chosen]
        fmt[gidx] = FMT_HYB
        hyb_width[gidx] = w_cur[chosen].astype(np.int16)
        hyb_coo[gidx] = coo_prior[chosen].astype(np.int32)
        undecided[gidx] = False

    fmt[undecided] = FMT_CSR
    return fmt, ell_width, hyb_width, hyb_coo


def _analyze_numpy(cfg: TileConfig, m, n, tilem, tilen, indptr, indices,
                   data) -> dict:
    """Pure-NumPy analysis: sorted nonzero stream + tile table + histograms
    + selector. The native converter (native/tileconv.cpp) produces the
    identical dict in one O(nnz) pass."""
    b = cfg.tile_size
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(indptr.shape[0] - 1, dtype=np.int64),
                     np.diff(indptr))
    cols = indices.astype(np.int64)
    vals = np.asarray(data, dtype=np.float64)

    trow = rows // b
    tcol = cols // b
    ri = (rows - trow * b).astype(np.uint8)
    ci = (cols - tcol * b).astype(np.uint8)
    key = trow * tilen + tcol

    # One global sort puts nonzeros in (tile, row-in-tile, col-in-tile)
    # order — replaces the reference's per-tile-row scatter walk.
    order = np.lexsort((ci, ri, key))
    key_s, ri_s, ci_s, val_s = key[order], ri[order], ci[order], vals[order]

    tile_key, counts = np.unique(key_s, return_counts=True)
    tilenum = tile_key.shape[0]
    tile_rowidx = (tile_key // tilen).astype(np.int32)
    tile_colidx = (tile_key % tilen).astype(np.int32)
    tile_ptr = _exclusive_scan(
        np.bincount(tile_rowidx, minlength=tilem).astype(np.int64))

    tile_of_nnz = np.repeat(np.arange(tilenum, dtype=np.int64), counts)
    # Per-tile row/col histograms (reference tile_csr_ptr, csr2tile.h:77-101)
    row_hist = np.bincount(tile_of_nnz * b + ri_s,
                           minlength=tilenum * b).reshape(tilenum, b)
    col_hist = np.bincount(tile_of_nnz * b + ci_s,
                           minlength=tilenum * b).reshape(tilenum, b)
    row_hist = row_hist.astype(np.int32)
    col_hist = col_hist.astype(np.int32)

    rowlen = np.where(tile_rowidx == tilem - 1, m - (tilem - 1) * b,
                      b).astype(np.int64)
    collen = np.where(tile_colidx == tilen - 1, n - (tilen - 1) * b,
                      b).astype(np.int64)
    fmt, ell_width, hyb_width, hyb_coo = _select_formats(
        cfg, counts, rowlen, collen, row_hist, col_hist)
    return dict(tilem=tilem, tilen=tilen, tile_ptr=tile_ptr,
                tile_rowidx=tile_rowidx, tile_colidx=tile_colidx,
                counts=counts, row_hist=row_hist, col_hist=col_hist,
                fmt=fmt, ell_width=ell_width, hyb_width=hyb_width,
                hyb_coo=hyb_coo, val_s=val_s, ri_s=ri_s, ci_s=ci_s)


def tile_create(csr: CSRMatrix,
                config: TileConfig = DEFAULT_CONFIG,
                use_native: bool = True) -> TileMatrix:
    """Convert canonical CSR to a TileMatrix (reference `Tile_create`,
    csr2tile.h:629-1020). Uses the native C++ analysis when available
    (`use_native=False` or TILESPMV_NATIVE=0 forces the NumPy path).
    Timed as the set-up phase `plan.convert` (spans.py)."""
    with phase("plan.convert"):
        return _tile_create(csr, config, use_native)


def _tile_create(csr: CSRMatrix, config: TileConfig,
                 use_native: bool) -> TileMatrix:
    cfg = config
    b = cfg.tile_size
    m, n = csr.shape
    if cfg.truncate_rows_to_tile:
        m = (m // b) * b  # reference main.cu:71
    if m == 0 or n == 0:
        raise ValueError("empty matrix")
    tilem = -(-m // b)
    tilen = -(-n // b)

    indptr = np.ascontiguousarray(csr.indptr[: m + 1], dtype=np.int64)
    nnz = int(indptr[-1])
    indices = csr.indices[:nnz]
    data = csr.data[:nnz]

    analysis = None
    if use_native:
        from . import native
        analysis = native.analyze(m, n, indptr, indices, data, cfg)
    if analysis is None:
        analysis = _analyze_numpy(cfg, m, n, tilem, tilen, indptr, indices,
                                  data)

    tile_ptr = analysis["tile_ptr"]
    tile_rowidx = analysis["tile_rowidx"]
    tile_colidx = analysis["tile_colidx"]
    counts = analysis["counts"]

    if "fill" in analysis:
        # payload buckets came out of the native single pass
        # (tileconv.cpp tc_fill — reference csr2tile.h:330-627); skip
        # the NumPy scatters entirely
        f = analysis["fill"]
        return TileMatrix(
            shape=(m, n), nnz=nnz, config=cfg,
            tilem=tilem, tilen=tilen,
            tile_ptr=tile_ptr, tile_rowidx=tile_rowidx,
            tile_columnidx=tile_colidx,
            tile_nnz=_exclusive_scan(counts), fmt=analysis["fmt"],
            csr=CSRBucket(**f["csr"]), coo=COOBucket(**f["coo"]),
            ell=ELLBucket(**f["ell"]), hyb=HYBBucket(**f["hyb"]),
            dns=DNSBucket(**f["dns"]), dnsrow=DNSRowBucket(**f["dnsrow"]),
            dnscol=DNSColBucket(**f["dnscol"]))
    row_hist = analysis["row_hist"]
    col_hist = analysis["col_hist"]
    fmt = analysis["fmt"]
    ell_width = analysis["ell_width"]
    hyb_width = analysis["hyb_width"]
    hyb_coo_cnt = analysis["hyb_coo"]
    val_s = analysis["val_s"]
    ri_s = analysis["ri_s"]
    ci_s = analysis["ci_s"]

    tilenum = tile_rowidx.shape[0]
    tile_nnz = _exclusive_scan(counts)
    tile_of_nnz = np.repeat(np.arange(tilenum, dtype=np.int64), counts)
    pos_in_tile = np.arange(nnz, dtype=np.int64) - tile_nnz[tile_of_nnz]
    rowlen = np.where(tile_rowidx == tilem - 1, m - (tilem - 1) * b,
                      b).astype(np.int64)
    collen = np.where(tile_colidx == tilen - 1, n - (tilen - 1) * b,
                      b).astype(np.int64)

    # Per-tile exclusive row scan: start offset of each intra-tile row.
    # Restricted to the formats that consume it (CSR/ELL/HYB) — for
    # COO-dominated matrices the full (tilenum, b) table would be the
    # single biggest conversion cost.
    need_rs = ((fmt == FMT_CSR) | (fmt == FMT_ELL) | (fmt == FMT_HYB)
               | (fmt == FMT_DNSCOL))
    rs_tid = np.nonzero(need_rs)[0]
    rs_local = np.full(tilenum, -1, dtype=np.int64)
    rs_local[rs_tid] = np.arange(rs_tid.shape[0])
    row_start = np.zeros((rs_tid.shape[0], b), dtype=np.int64)
    np.cumsum(row_hist[rs_tid, :-1].astype(np.int64), axis=1,
              out=row_start[:, 1:])
    # Per-nnz: slot within its row (ELL slot index), same formats only
    slot = np.zeros(nnz, dtype=np.int64)
    sel_rs = np.nonzero(need_rs[tile_of_nnz])[0]
    slot[sel_rs] = (pos_in_tile[sel_rs]
                    - row_start[rs_local[tile_of_nnz[sel_rs]],
                                ri_s[sel_rs]])

    fmt_of_nnz = fmt[tile_of_nnz]
    vdt = np.dtype(cfg.value_dtype)

    def bucket_select(code):
        tid = np.nonzero(fmt == code)[0].astype(np.int32)
        sel = fmt_of_nnz == code
        local = np.full(tilenum, -1, dtype=np.int64)
        local[tid] = np.arange(tid.shape[0])
        return tid, sel, local

    # ---- CSR bucket (reference csr2tile.h:429-451) ----
    tid, sel, local = bucket_select(FMT_CSR)
    csr_bucket = CSRBucket(
        tile_ids=tid,
        nnz_ptr=_exclusive_scan(counts[tid]),
        rowptr=row_start[rs_local[tid]].astype(np.uint8),
        val=np.asarray(val_s[sel], dtype=vdt),
        col=ci_s[sel],
        row=ri_s[sel],
    )

    # ---- COO bucket (reference csr2tile.h:452-484) ----
    tid, sel, local = bucket_select(FMT_COO)
    coo_bucket = COOBucket(
        tile_ids=tid,
        nnz_ptr=_exclusive_scan(counts[tid]),
        val=np.asarray(val_s[sel], dtype=vdt),
        row=ri_s[sel],
        col=ci_s[sel],
    )
    # ---- ELL bucket (reference csr2tile.h:485-504) ----
    tid, sel, local = bucket_select(FMT_ELL)
    sizes = ell_width[tid].astype(np.int64) * rowlen[tid]
    eptr = _exclusive_scan(sizes)
    ell_val = np.zeros(int(eptr[-1]), dtype=vdt)
    ell_col = np.zeros(int(eptr[-1]), dtype=np.uint8)
    t_l = local[tile_of_nnz[sel]]
    dest = eptr[t_l] + slot[sel] * rowlen[tid][t_l] + ri_s[sel]
    ell_val[dest] = val_s[sel]
    ell_col[dest] = ci_s[sel]
    ell_bucket = ELLBucket(tile_ids=tid, width=ell_width[tid], ptr=eptr,
                           val=ell_val, col=ell_col)

    # ---- HYB bucket (reference csr2tile.h:505-548) ----
    tid, sel, local = bucket_select(FMT_HYB)
    widths = hyb_width[tid].astype(np.int64)
    esizes = widths * rowlen[tid]
    heptr = _exclusive_scan(esizes)
    hyb_ell_val = np.zeros(int(heptr[-1]), dtype=vdt)
    hyb_ell_col = np.zeros(int(heptr[-1]), dtype=np.uint8)
    in_ell = sel & (slot < hyb_width[tile_of_nnz].astype(np.int64))
    t_l = local[tile_of_nnz[in_ell]]
    dest = heptr[t_l] + slot[in_ell] * rowlen[tid][t_l] + ri_s[in_ell]
    hyb_ell_val[dest] = val_s[in_ell]
    hyb_ell_col[dest] = ci_s[in_ell]
    over = sel & ~in_ell
    hcptr = _exclusive_scan(hyb_coo_cnt[tid].astype(np.int64))
    hyb_bucket = HYBBucket(
        tile_ids=tid, width=hyb_width[tid], ell_ptr=heptr,
        ell_val=hyb_ell_val, ell_col=hyb_ell_col, coo_ptr=hcptr,
        coo_val=np.asarray(val_s[over], dtype=vdt), coo_row=ri_s[over],
        coo_col=ci_s[over])
    # ---- dense bucket (reference csr2tile.h:549-567) ----
    tid, sel, local = bucket_select(FMT_DNS)
    sizes = rowlen[tid] * collen[tid]
    dptr = _exclusive_scan(sizes)
    dns_val = np.zeros(int(dptr[-1]), dtype=vdt)
    t_l = local[tile_of_nnz[sel]]
    dest = dptr[t_l] + ci_s[sel].astype(np.int64) * rowlen[tid][t_l] + ri_s[sel]
    dns_val[dest] = val_s[sel]
    dns_bucket = DNSBucket(tile_ids=tid, ptr=dptr, val=dns_val)

    # ---- dense-row bucket (reference csr2tile.h:568-591) ----
    tid, sel, local = bucket_select(FMT_DNSROW)
    full_rows = row_hist[tid] == collen[tid][:, None]
    n_rows = full_rows.sum(axis=1).astype(np.int64)
    rptr = _exclusive_scan(n_rows)
    row_ids = np.nonzero(full_rows)[1].astype(np.uint8)
    vptr = _exclusive_scan(n_rows * collen[tid])
    # packed rows == tile's nonzeros in (row, col) order (all rows full)
    dnsrow_bucket = DNSRowBucket(tile_ids=tid, row_ptr=rptr, row_ids=row_ids,
                                 ptr=vptr,
                                 val=np.asarray(val_s[sel], dtype=vdt))

    # ---- dense-col bucket (reference csr2tile.h:592-617) ----
    tid, sel, local = bucket_select(FMT_DNSCOL)
    full_cols = col_hist[tid] == rowlen[tid][:, None]
    n_cols = full_cols.sum(axis=1).astype(np.int64)
    cptr = _exclusive_scan(n_cols)
    col_ids = np.nonzero(full_cols)[1].astype(np.uint8)
    vptr = _exclusive_scan(n_cols * rowlen[tid])
    dnscol_val = np.zeros(int(vptr[-1]), dtype=vdt)
    t_l = local[tile_of_nnz[sel]]
    # rank of the entry within its row == packed column index (canonical CSR
    # keeps columns sorted, so every row lists the same full columns in the
    # same order — the reference takes the order from row 0,
    # csr2tile.h:598-603)
    rank = slot[sel]
    dest = vptr[t_l] + rank * rowlen[tid][t_l] + ri_s[sel]
    dnscol_val[dest] = val_s[sel]
    dnscol_bucket = DNSColBucket(tile_ids=tid, col_ptr=cptr, col_ids=col_ids,
                                 ptr=vptr, val=dnscol_val)

    # residual COO -> CSR (reference csr2tile.h:899-960) is built
    # LAZILY by TileMatrix (its global sort costs ~1.5 s at 6M nnz and
    # only the XLA/CPU paths read it)
    tm = TileMatrix(
        shape=(m, n), nnz=nnz, config=cfg,
        tilem=tilem, tilen=tilen,
        tile_ptr=tile_ptr, tile_rowidx=tile_rowidx,
        tile_columnidx=tile_colidx, tile_nnz=tile_nnz, fmt=fmt,
        csr=csr_bucket, coo=coo_bucket, ell=ell_bucket, hyb=hyb_bucket,
        dns=dns_bucket, dnsrow=dnsrow_bucket, dnscol=dnscol_bucket)
    return tm
