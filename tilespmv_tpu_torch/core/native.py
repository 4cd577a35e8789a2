"""ctypes bridge to the native host library (native/*.cpp).

Compiles native/tileconv.cpp, streamplan.cpp and mmio_parse.cpp with
g++ into the port's build directory (`build/native/`, git-ignored) on
first use; the sources in native/ are read, never built in place. Falls
back silently to the NumPy converter and plan builders when no C++
toolchain is present or TILESPMV_NATIVE=0 — those are the reference
implementations the native code is held bit-equal to. The native
analysis does the reference's 4-pass conversion work (csr2tile.h) in one
CSR-aware O(nnz) pass; Python keeps the (vectorized, cheap) payload
bucket fills.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_NATIVE_DIR = _ROOT / "native"
_SOURCES = ("tileconv.cpp", "streamplan.cpp", "mmio_parse.cpp")
_BUILD_DIR = _ROOT / "build" / "native"
_LIB_PATH = _BUILD_DIR / "libtileconv.so"
# native/Makefile's flags without -march=native: a library built on one
# host must load on another
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """Compile the library unless an up-to-date copy exists. The output
    is written under a per-process name and renamed into place, so
    concurrent builders (test workers) never load a half-written file."""
    srcs = [_NATIVE_DIR / s for s in _SOURCES]
    if not all(s.exists() for s in srcs):
        return False
    if _LIB_PATH.exists() and all(
            _LIB_PATH.stat().st_mtime >= s.stat().st_mtime for s in srcs):
        return True
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return False
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f".libtileconv.{os.getpid()}.so"
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), *map(str, srcs)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it if needed; None if
    unavailable (disabled via TILESPMV_NATIVE=0, no toolchain, ...)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("TILESPMV_NATIVE", "1") == "0":
            return None
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        lib.tc_analyze.restype = ctypes.c_void_p
        lib.tc_analyze.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_double, ctypes.c_int64, ctypes.c_double,
            ctypes.c_int32, ctypes.c_double, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.tc_scalars.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.tc_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 13
        lib.tc_release.argtypes = [ctypes.c_void_p]
        lib.tc_fill.restype = ctypes.c_int32
        lib.tc_fill.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.tc_fill_scalars.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.tc_fill_export.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.sp_build.restype = ctypes.c_void_p
        lib.sp_build.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.sp_scalars.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.sp_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
        lib.sp_export_vlo.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.sp_export_sb2.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.sp_export_cw.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.sp_export_loads.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.sp_export_class.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32] + [ctypes.c_void_p] * 6
        lib.sp_release.argtypes = [ctypes.c_void_p]
        lib.mm_parse_coord.restype = ctypes.c_int64
        lib.mm_parse_coord.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def _export_fill(lib, h, vdt: np.dtype) -> dict:
    """Export the native payload buckets (tc_fill must have returned 1).
    Returns {bucket: {field: ndarray}} mirroring convert.py's fills."""
    sc = np.zeros(17, np.int64)
    lib.tc_fill_scalars(h, sc.ctypes.data)
    (csr_k, csr_nnz, coo_k, coo_nnz, ell_k, ell_len, hyb_k, hyb_ell,
     hyb_coo, dns_k, dns_len, dr_k, dr_rows, dr_len, dc_k, dc_cols,
     dc_len) = (int(v) for v in sc)
    f = dict(
        csr=dict(tile_ids=np.zeros(csr_k, np.int32),
                 nnz_ptr=np.zeros(csr_k + 1, np.int64),
                 rowptr=np.zeros((csr_k, 16), np.uint8),
                 row=np.zeros(csr_nnz, np.uint8),
                 col=np.zeros(csr_nnz, np.uint8),
                 val=np.zeros(csr_nnz, vdt)),
        coo=dict(tile_ids=np.zeros(coo_k, np.int32),
                 nnz_ptr=np.zeros(coo_k + 1, np.int64),
                 row=np.zeros(coo_nnz, np.uint8),
                 col=np.zeros(coo_nnz, np.uint8),
                 val=np.zeros(coo_nnz, vdt)),
        ell=dict(tile_ids=np.zeros(ell_k, np.int32),
                 width=np.zeros(ell_k, np.int16),
                 ptr=np.zeros(ell_k + 1, np.int64),
                 col=np.zeros(ell_len, np.uint8),
                 val=np.zeros(ell_len, vdt)),
        hyb=dict(tile_ids=np.zeros(hyb_k, np.int32),
                 width=np.zeros(hyb_k, np.int16),
                 ell_ptr=np.zeros(hyb_k + 1, np.int64),
                 ell_col=np.zeros(hyb_ell, np.uint8),
                 ell_val=np.zeros(hyb_ell, vdt),
                 coo_ptr=np.zeros(hyb_k + 1, np.int64),
                 coo_row=np.zeros(hyb_coo, np.uint8),
                 coo_col=np.zeros(hyb_coo, np.uint8),
                 coo_val=np.zeros(hyb_coo, vdt)),
        dns=dict(tile_ids=np.zeros(dns_k, np.int32),
                 ptr=np.zeros(dns_k + 1, np.int64),
                 val=np.zeros(dns_len, vdt)),
        dnsrow=dict(tile_ids=np.zeros(dr_k, np.int32),
                    row_ptr=np.zeros(dr_k + 1, np.int64),
                    row_ids=np.zeros(dr_rows, np.uint8),
                    ptr=np.zeros(dr_k + 1, np.int64),
                    val=np.zeros(dr_len, vdt)),
        dnscol=dict(tile_ids=np.zeros(dc_k, np.int32),
                    col_ptr=np.zeros(dc_k + 1, np.int64),
                    col_ids=np.zeros(dc_cols, np.uint8),
                    ptr=np.zeros(dc_k + 1, np.int64),
                    val=np.zeros(dc_len, vdt)))
    order = [("csr", "tile_ids"), ("csr", "nnz_ptr"), ("csr", "rowptr"),
             ("csr", "row"), ("csr", "col"), ("csr", "val"),
             ("coo", "tile_ids"), ("coo", "nnz_ptr"), ("coo", "row"),
             ("coo", "col"), ("coo", "val"),
             ("ell", "tile_ids"), ("ell", "width"), ("ell", "ptr"),
             ("ell", "col"), ("ell", "val"),
             ("hyb", "tile_ids"), ("hyb", "width"), ("hyb", "ell_ptr"),
             ("hyb", "ell_col"), ("hyb", "ell_val"), ("hyb", "coo_ptr"),
             ("hyb", "coo_row"), ("hyb", "coo_col"), ("hyb", "coo_val"),
             ("dns", "tile_ids"), ("dns", "ptr"), ("dns", "val"),
             ("dnsrow", "tile_ids"), ("dnsrow", "row_ptr"),
             ("dnsrow", "row_ids"), ("dnsrow", "ptr"), ("dnsrow", "val"),
             ("dnscol", "tile_ids"), ("dnscol", "col_ptr"),
             ("dnscol", "col_ids"), ("dnscol", "ptr"), ("dnscol", "val")]
    bufs = (ctypes.c_void_p * len(order))(
        *[f[b][k].ctypes.data for (b, k) in order])
    lib.tc_fill_export(h, bufs)
    return f


def analyze(m: int, n: int, indptr: np.ndarray, indices: np.ndarray,
            data: np.ndarray, cfg) -> Optional[dict]:
    """Run the native analysis (+ payload bucket fills when the value
    dtype allows); returns the converter-internal dict or None when the
    native path can't serve this config."""
    if cfg.tile_size != 16:
        return None
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data64 = np.ascontiguousarray(data, dtype=np.float64)
    nnz = int(indptr[-1])
    force = {"csr": 0, "coo": 1, "ell": 2, "dns": 4}.get(
        cfg.force_format, -1)
    h = lib.tc_analyze(
        m, n, nnz, cfg.tile_size,
        indptr.ctypes.data, indices.ctypes.data, data64.ctypes.data,
        cfg.dense_threshold, cfg.coo_nnz_threshold, cfg.ell_cv_threshold,
        1 if cfg.enable_hyb else 0, cfg.hyb_cv_threshold, cfg.hyb_max_coo,
        force, np.dtype(cfg.value_dtype).itemsize)
    if not h:
        return None
    try:
        scalars = np.zeros(4, np.int64)
        lib.tc_scalars(h, scalars.ctypes.data)
        tilenum, tilem, tilen, _ = (int(v) for v in scalars)
        vdt = np.dtype(cfg.value_dtype)
        fill = None
        if (vdt.itemsize in (4, 8) and vdt.kind == "f"
                and lib.tc_fill(h, vdt.itemsize)):
            fill = _export_fill(lib, h, vdt)
        out = dict(
            tilem=tilem, tilen=tilen,
            tile_ptr=np.zeros(tilem + 1, np.int64),
            tile_rowidx=np.zeros(tilenum, np.int32),
            tile_colidx=np.zeros(tilenum, np.int32),
            counts=np.zeros(tilenum, np.int64),
            fmt=np.zeros(tilenum, np.int8),
        )
        if fill is None:
            # full export: the NumPy bucket fills need the sorted stream,
            # histograms, and selector side outputs
            out.update(
                row_hist=np.zeros((tilenum, 16), np.uint8),
                col_hist=np.zeros((tilenum, 16), np.uint8),
                ell_width=np.zeros(tilenum, np.int16),
                hyb_width=np.zeros(tilenum, np.int16),
                hyb_coo=np.zeros(tilenum, np.int32),
                val_s=np.zeros(nnz, np.float64),
                ri_s=np.zeros(nnz, np.uint8),
                ci_s=np.zeros(nnz, np.uint8),
            )

        def ptr(key):
            return out[key].ctypes.data if key in out else None
        lib.tc_export(
            h,
            ptr("tile_ptr"), ptr("tile_rowidx"), ptr("tile_colidx"),
            ptr("counts"), ptr("row_hist"), ptr("col_hist"), ptr("fmt"),
            ptr("ell_width"), ptr("hyb_width"), ptr("hyb_coo"),
            ptr("val_s"), ptr("ri_s"), ptr("ci_s"))
        if fill is not None:
            out["fill"] = fill
        return out
    finally:
        lib.tc_release(h)


def stream_plan(g_row: np.ndarray, g_col: np.ndarray, val: np.ndarray,
                m: int, span_rows: int = 64, dual: bool = False,
                want_lo: bool = False,
                s_batch: Optional[int] = None) -> Optional[dict]:
    """Run the native stream-plan builder (native/streamplan.cpp),
    `s_batch` slabs per step (None: picked by its cost model); returns
    the raw plan
    arrays or None when unavailable. `val` is the f32 rounding of each
    value; `want_lo` also exports `val_lo`, the f32 rounding of the
    remainder (val + val_lo is the value the f64 plan holds). `dual`
    builds the dual-span slab packing (sbase2 exported; exact lockstep
    with stream_plan._build_dual)."""
    lib = get_lib()
    if lib is None:
        return None
    g_row = np.ascontiguousarray(g_row, dtype=np.int64)
    g_col = np.ascontiguousarray(g_col, dtype=np.int64)
    val64 = np.ascontiguousarray(val, dtype=np.float64)
    nz = g_row.shape[0]
    h = lib.sp_build(nz, g_row.ctypes.data, g_col.ctypes.data,
                     val64.ctypes.data, m, int(s_batch or 0),
                     int(span_rows),
                     int(bool(want_lo)), int(bool(dual)))
    if not h:
        return None
    try:
        sc = np.zeros(6, np.int64)
        lib.sp_scalars(h, sc.ctypes.data)
        nslabs, nsteps, s_b, nwin, plane_rows, rounds = (
            int(v) for v in sc)
        out = dict(
            nslabs=nslabs, nsteps=nsteps, s_batch=s_b, rounds=rounds,
            val=np.zeros((nslabs, 8, 128), np.float32),
            vidx=np.zeros((nslabs, 8, 128), np.int16),
            planes=np.zeros((nslabs, plane_rows, 128), np.int8),
            sbase=np.zeros(nslabs, np.int32),
            cw=np.zeros(nsteps, np.int32),
            cfirst=np.zeros(nsteps, np.int32),
        )
        lib.sp_export(
            h, out["val"].ctypes.data, out["vidx"].ctypes.data,
            out["planes"].ctypes.data, out["sbase"].ctypes.data,
            out["cw"].ctypes.data, out["cfirst"].ctypes.data)
        if want_lo:
            out["val_lo"] = np.zeros((nslabs, 8, 128), np.float32)
            lib.sp_export_vlo(h, out["val_lo"].ctypes.data)
        if dual:
            out["sbase2"] = np.zeros(nslabs, np.int32)
            lib.sp_export_sb2(h, out["sbase2"].ctypes.data)
        return out
    finally:
        lib.sp_release(h)


def stream_plan_classes(g_row: np.ndarray, g_col: np.ndarray,
                        val: np.ndarray, m: int, span_rows: int = 64,
                        dual: bool = False, split_fn=None,
                        want_lo: bool = False) -> Optional[list]:
    """Native build + fused per-class export of the stream plan (with
    each class's `val_lo` when `want_lo`, as stream_plan exports it).

    Builds once at slabs-per-step 1 (minimal builder padding), decides
    the two-rate split with `split_fn(wcnt) -> (s1, s2, heavy_mask)`
    (stream_plan.pick_stream_split, passed in to avoid a circular
    import), then exports each class directly in the final kernel
    layout (load-sorted, window-padded, per-step stacked planes) in one
    C++ pass.

    Returns a list of per-class dicts (arrays + s_batch/rounds), the
    base class first, or None when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    g_row = np.ascontiguousarray(g_row, dtype=np.int64)
    g_col = np.ascontiguousarray(g_col, dtype=np.int64)
    val64 = np.ascontiguousarray(val, dtype=np.float64)
    nz = g_row.shape[0]
    h = lib.sp_build(nz, g_row.ctypes.data, g_col.ctypes.data,
                     val64.ctypes.data, m, 1, int(span_rows),
                     int(bool(want_lo)), int(bool(dual)))
    if not h:
        return None
    try:
        sc = np.zeros(6, np.int64)
        lib.sp_scalars(h, sc.ctypes.data)
        nslabs, _, _, nwin, _, rounds = (int(v) for v in sc)
        loads = np.zeros(nslabs, np.int64)
        cw_all = np.zeros(nslabs, np.int32)      # s_batch 1: per slab
        lib.sp_export_loads(h, loads.ctypes.data)
        lib.sp_export_cw(h, cw_all.ctypes.data)
        real = loads > 0
        wcnt = np.bincount(cw_all[real].astype(np.int64),
                           minlength=nwin)
        s1, s2, heavy = split_fn(wcnt)
        if s2 is None:
            heavy = np.zeros(nwin, bool)

        def make_class(wmask, s):
            ids = np.nonzero(real & wmask[cw_all])[0]
            order = np.lexsort((-loads[ids], cw_all[ids]))
            ids = ids[order]
            sel_w = np.nonzero(wmask)[0]
            cnt = wcnt[sel_w]
            padded = np.maximum(1, -(-cnt // s)) * s
            starts = np.concatenate([[0], np.cumsum(padded)])[:-1]
            tot = int(padded.sum())
            src = np.full(tot, -1, np.int64)
            w_of = cw_all[ids].astype(np.int64)
            dst = starts[np.searchsorted(sel_w, w_of)] + _rank1(w_of)
            src[dst] = ids
            out = dict(
                s_batch=int(s), rounds=rounds,
                val=np.empty((tot, 8, 128), np.float32),
                vidx=np.empty((tot, 8, 128), np.int16),
                planes=np.empty((tot // s, rounds * 3 * 8 * s, 128),
                                np.int8),
                sbase=np.empty(tot, np.int32),
            )
            vlo_p = None
            if want_lo:
                out["val_lo"] = np.empty((tot, 8, 128), np.float32)
                vlo_p = out["val_lo"].ctypes.data
            sb2_p = None
            if dual:
                out["sbase2"] = np.empty(tot, np.int32)
                sb2_p = out["sbase2"].ctypes.data
            lib.sp_export_class(
                h, src.ctypes.data, tot, int(s), rounds,
                out["val"].ctypes.data, vlo_p,
                out["vidx"].ctypes.data, out["planes"].ctypes.data,
                out["sbase"].ctypes.data, sb2_p)
            win_full = np.repeat(sel_w, padded)
            cwc = win_full[::s].astype(np.int32)
            cf = np.ones(cwc.shape[0], np.int32)
            cf[1:] = (cwc[1:] != cwc[:-1]).astype(np.int32)
            ld = np.zeros(tot, np.int64)
            ld[dst] = loads[ids]
            out["cw"] = cwc
            out["cfirst"] = cf
            out["sactive"] = (ld.reshape(-1, s).sum(axis=1)
                              > 0).astype(np.int32)
            return out

        classes = [make_class(~heavy, s1)]
        if s2 is not None:
            classes.append(make_class(heavy, s2))
        return classes
    finally:
        lib.sp_release(h)


def _rank1(key: np.ndarray) -> np.ndarray:
    """0-based rank within equal-key groups of a SORTED key array."""
    n = key.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    new = np.ones(n, bool)
    new[1:] = key[1:] != key[:-1]
    startpos = np.maximum.accumulate(np.where(new, np.arange(n), 0))
    return np.arange(n) - startpos


def parse_coord_body(body: bytes, nnz: int, field: str):
    """Parse a Matrix Market coordinate body natively
    (native/mmio_parse.cpp); returns (rows, cols, vals) or None to fall
    back to the NumPy tokenizer."""
    lib = get_lib()
    if lib is None:
        return None
    fcode = {"pattern": 0, "real": 1, "integer": 1, "complex": 2}[field]
    rows = np.empty(nnz, np.int64)
    cols = np.empty(nnz, np.int64)
    vals = np.empty(nnz, np.float64)
    got = lib.mm_parse_coord(body, len(body), nnz, fcode,
                             rows.ctypes.data, cols.ctypes.data,
                             vals.ctypes.data)
    if got != nnz:
        return None
    return rows, cols, vals
