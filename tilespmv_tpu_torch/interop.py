"""Carry a plan built by tilespmv_tpu across into this package.

`lane_plan_from_jax` takes a tilespmv_tpu LanePlan (whose fields are JAX
arrays) and returns this package's LanePlan of NumPy arrays, each field
through `np.asarray`, so both frameworks can run the identical plan.
This module imports nothing of JAX: the caller passes the object in.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .ops.cuda.lane_plan import (BandChunks, DenseChunks, LanePlan,
                                 SparseChunks)
from .ops.cuda.stream_plan import StreamChunks
from .ops.plan import ResidualEngine


def _convert(cls, obj):
    """Instance of the dataclass `cls` from the same-named fields of
    `obj`; array fields go through np.asarray, static ones as they are."""
    if obj is None:
        return None
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        kw[f.name] = v if v is None or isinstance(
            v, (bool, int, str)) else np.asarray(v)
    return cls(**kw)


def stream_chunks_from_jax(st) -> StreamChunks:
    """This package's StreamChunks holding `st`'s arrays (f32, rounds
    scatter only); None for None."""
    if st is None:
        return None
    if st.df64 or st.scatter != "rounds" or st.segmask is not None:
        raise NotImplementedError(
            "only f32 stream classes with the rounds scatter are ported")
    return _convert(StreamChunks, st)


def lane_plan_from_jax(plan) -> LanePlan:
    """This package's LanePlan holding `plan`'s arrays (f32 plans only)."""
    if any(c is not None and c.df64 for c in (plan.dense, plan.band)):
        raise NotImplementedError("df64 plans are not ported")
    if plan.dense is not None and plan.dense.route != "onehot":
        raise NotImplementedError("the prefix dense route is not ported")
    if any(s.route != "onehot" for s in plan.sparses):
        raise NotImplementedError("the prefix W-class route is not ported")
    return LanePlan(
        dense=_convert(DenseChunks, plan.dense),
        band=_convert(BandChunks, plan.band),
        sparses=tuple(_convert(SparseChunks, s) for s in plan.sparses),
        residual=_convert(ResidualEngine, plan.residual),
        stream=stream_chunks_from_jax(plan.stream),
        stream2=stream_chunks_from_jax(plan.stream2),
        m=plan.m, n=plan.n, tilem=plan.tilem, tilen=plan.tilen,
        tile_size=plan.tile_size, nnz=plan.nnz, n_windows=plan.n_windows)
