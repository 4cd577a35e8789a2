"""Carry a plan built by tilespmv_tpu across into this package.

`lane_plan_from_jax` takes a tilespmv_tpu LanePlan (whose fields are JAX
arrays) and returns this package's LanePlan of NumPy arrays, each field
through `np.asarray`, so both frameworks can run the identical plan. A
double-f32 (df64) plan becomes this package's f64 plan: each value array
is the reference's f32 parts summed in float64 (dense a1 + a2 + vl from
rows 3j, 3j+1, 3j+2; band hi + lo from planes 2c, 2c+1; stream
val + val_lo) in the f32 layout, and the segmented-scan planes
(`segmask`) are dropped. Stream classes gain this package's per-entry
rows (`erow`), derived from their planes, and the dense class its
column masks and active lane groups (`cmask`, `groups`), derived from
its values and meta; a source that already holds them (a plan file this
package wrote, core/serialize.py) keeps its own. Any object with the
reference's field names converts, so core/serialize.py loads plan files
of either package through this one conversion. This module imports
nothing of JAX: the caller passes the object in.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .ops.cuda.lane_plan import (BandChunks, DenseChunks, LanePlan,
                                 SparseChunks, with_dense_derived)
from .ops.cuda.stream_plan import StreamChunks, with_entry_rows
from .ops.plan import ResidualEngine


def _convert(cls, obj, **override):
    """Instance of the dataclass `cls` from the same-named fields of
    `obj` (None where `obj` has no such field); array fields go through
    np.asarray, static ones as they are; `override` replaces fields."""
    if obj is None:
        return None
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in override:
            continue
        v = getattr(obj, f.name, None)
        kw[f.name] = v if v is None or isinstance(
            v, (bool, int, str)) else np.asarray(v)
    kw.update(override)
    return cls(**kw)


def _f64(*parts) -> np.ndarray:
    """The f32 parts summed in float64."""
    out = np.asarray(parts[0]).astype(np.float64)
    for p in parts[1:]:
        out = out + np.asarray(p).astype(np.float64)
    return out


def stream_chunks_from_jax(st) -> StreamChunks:
    """This package's StreamChunks holding `st`'s arrays (rounds scatter
    only; a df64 class as f64 values val + val_lo), with the per-entry
    rows `erow` derived from its planes where `st` has none; None for
    None."""
    if st is None:
        return None
    if st.scatter != "rounds":
        raise NotImplementedError(
            "only stream classes with the rounds scatter are ported")
    if not st.df64:
        if st.segmask is not None:
            raise NotImplementedError("segmask on an f32 stream class")
        out = _convert(StreamChunks, st)
    else:
        out = _convert(StreamChunks, st, val=_f64(st.val, st.val_lo))
    return out if out.erow is not None else with_entry_rows(out)


def _dense(d):
    if d is None:
        return None
    if d.df64:
        v = np.asarray(d.val)
        out = _convert(DenseChunks, d,
                       val=_f64(v[:, 0::3], v[:, 1::3], v[:, 2::3]))
    else:
        out = _convert(DenseChunks, d)
    if out.cmask is None or out.groups is None:
        out = with_dense_derived(out)
    return out


def _band(bd):
    if bd is None or not bd.df64:
        return _convert(BandChunks, bd)
    v = np.asarray(bd.val)
    return _convert(BandChunks, bd, val=_f64(v[:, 0::2], v[:, 1::2]))


def lane_plan_from_jax(plan) -> LanePlan:
    """This package's LanePlan holding `plan`'s arrays (an f32 plan, or
    a df64 one as this package's f64 plan)."""
    if plan.dense is not None and plan.dense.route != "onehot":
        raise NotImplementedError("the prefix dense route is not ported")
    if any(s.route != "onehot" for s in plan.sparses):
        raise NotImplementedError("the prefix W-class route is not ported")
    return LanePlan(
        dense=_dense(plan.dense),
        band=_band(plan.band),
        sparses=tuple(_convert(SparseChunks, s) for s in plan.sparses),
        residual=_convert(ResidualEngine, plan.residual),
        stream=stream_chunks_from_jax(plan.stream),
        stream2=stream_chunks_from_jax(plan.stream2),
        m=plan.m, n=plan.n, tilem=plan.tilem, tilen=plan.tilen,
        tile_size=plan.tile_size, nnz=plan.nnz, n_windows=plan.n_windows)
