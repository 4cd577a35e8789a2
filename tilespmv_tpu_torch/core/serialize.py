"""TileMatrix + LanePlan serialization (checkpoint/resume).

Port of tilespmv_tpu/core/serialize.py, in the same file layout, so a
file written by either package loads in the other. Converted TileMatrix
containers go to one compressed .npz; compiled LanePlans to one .npz of
their arrays under hierarchical keys (`plan.<path>.<field>`, e.g.
`plan.sparses.0.meta`) plus a `__meta__` JSON tree (version 1) of the
classes, static fields and which arrays each node holds. Plan build is
the largest one-time host cost, so sweeps and repeated runs reload
plans instead of re-planning.

The reference marks its static fields in the dataclass metadata; this
package's plan dataclasses carry no such mark, so a field is static when
its value is an int, bool or str, and an array otherwise (None: absent).
`load_lane_plan` reads a plan through interop.lane_plan_from_jax, the
conversion that carries a reference plan across: a reference file (no
`erow`, `cmask`, `groups`; df64 values as f32 parts) and a file of this
package come out as this package's LanePlan of NumPy arrays alike.
"""
from __future__ import annotations

import dataclasses
import json
import types

import numpy as np
import torch

from ..config import TileConfig
from ..interop import lane_plan_from_jax
from .tile_matrix import (COOBucket, CSRBucket, DNSBucket, DNSColBucket,
                          DNSRowBucket, ELLBucket, HYBBucket, TileMatrix)

# the residual CSR is derived lazily by TileMatrix and not serialized
_BUCKETS = ("csr", "coo", "ell", "hyb", "dns", "dnsrow", "dnscol")
_BUCKET_TYPES = dict(csr=CSRBucket, coo=COOBucket, ell=ELLBucket,
                     hyb=HYBBucket, dns=DNSBucket, dnsrow=DNSRowBucket,
                     dnscol=DNSColBucket)


def save_tile_matrix(path: str, tm: TileMatrix) -> None:
    arrays = {
        "tile_ptr": tm.tile_ptr, "tile_rowidx": tm.tile_rowidx,
        "tile_columnidx": tm.tile_columnidx, "tile_nnz": tm.tile_nnz,
        "fmt": tm.fmt,
    }
    for name in _BUCKETS:
        bucket = getattr(tm, name)
        for f in dataclasses.fields(bucket):
            arrays[f"{name}.{f.name}"] = getattr(bucket, f.name)
    cfg = dataclasses.asdict(tm.config)
    cfg["value_dtype"] = np.dtype(tm.config.value_dtype).str
    meta = dict(shape=list(tm.shape), nnz=tm.nnz, tilem=tm.tilem,
                tilen=tm.tilen, config=cfg, version=1)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_tile_matrix(path: str) -> TileMatrix:
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("version") != 1:
            raise ValueError(
                f"unknown TileMatrix file version {meta.get('version')}")
        cfg_d = meta["config"]
        cfg_d["value_dtype"] = np.dtype(cfg_d["value_dtype"])
        config = TileConfig(**cfg_d)
        buckets = {}
        for name in _BUCKETS:
            cls = _BUCKET_TYPES[name]
            kwargs = {f.name: z[f"{name}.{f.name}"]
                      for f in dataclasses.fields(cls)}
            buckets[name] = cls(**kwargs)
        return TileMatrix(
            shape=tuple(meta["shape"]), nnz=int(meta["nnz"]), config=config,
            tilem=int(meta["tilem"]), tilen=int(meta["tilen"]),
            tile_ptr=z["tile_ptr"], tile_rowidx=z["tile_rowidx"],
            tile_columnidx=z["tile_columnidx"], tile_nnz=z["tile_nnz"],
            fmt=z["fmt"], **buckets)


_PLAN_VERSION = 1
# the plan classes of both packages (same names)
_PLAN_CLASSES = ("LanePlan", "DenseChunks", "BandChunks", "SparseChunks",
                 "StreamChunks", "ResidualEngine")
# the reference's defaults of its static fields that interop reads and a
# file of this package does not hold
_REFERENCE_DEFAULTS = dict(df64=False, route="onehot", scatter="rounds")


def _flatten_node(node, key: str, arrays: dict):
    if isinstance(node, tuple):
        return [_flatten_node(c, f"{key}.{i}", arrays)
                for i, c in enumerate(node)]
    name = type(node).__name__
    if name not in _PLAN_CLASSES:
        raise TypeError(f"cannot serialize plan node {name}")
    meta = {"__class__": name, "static": {}, "arrays": []}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, np.generic):
            v = v.item()
        if v is None:
            continue  # absent optional array/child
        if isinstance(v, (bool, int, str)):
            meta["static"][f.name] = v
        elif isinstance(v, tuple) or dataclasses.is_dataclass(v):
            meta[f.name] = _flatten_node(v, f"{key}.{f.name}", arrays)
        else:
            arrays[f"{key}.{f.name}"] = (v.detach().cpu().numpy()
                                         if isinstance(v, torch.Tensor)
                                         else np.asarray(v))
            meta["arrays"].append(f.name)
    return meta


class _Node(types.SimpleNamespace):
    """A plan node as read from a file: its static fields and arrays as
    attributes; a field the file does not hold reads as the reference's
    default (None for an absent array or child)."""

    def __getattr__(self, name):
        return _REFERENCE_DEFAULTS.get(name)


def _unflatten_node(meta, key: str, z):
    if meta is None:
        return None
    if isinstance(meta, list):
        return tuple(_unflatten_node(c, f"{key}.{i}", z)
                     for i, c in enumerate(meta))
    if meta.get("__class__") not in _PLAN_CLASSES:
        raise ValueError(f"unknown plan node {meta.get('__class__')!r}")
    node = _Node(**meta["static"])
    for name in meta["arrays"]:
        setattr(node, name, z[f"{key}.{name}"])
    for name, child in meta.items():
        if name not in ("__class__", "static", "arrays"):
            setattr(node, name, _unflatten_node(child, f"{key}.{name}", z))
    return node


def save_lane_plan(path: str, plan) -> None:
    """Serialize a LanePlan (f32 or f64; arrays NumPy or tensors on any
    device, e.g. `TileSpMV.device_plan()`) to one .npz."""
    arrays: dict = {}
    tree = _flatten_node(plan, "plan", arrays)
    meta = dict(version=_PLAN_VERSION, tree=tree)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_lane_plan(path: str):
    """This package's LanePlan (NumPy arrays) from a file written by
    save_lane_plan of either package; a reference df64 plan becomes this
    package's f64 plan (interop.lane_plan_from_jax)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("version") != _PLAN_VERSION:
            raise ValueError(
                f"unknown LanePlan file version {meta.get('version')}")
        return lane_plan_from_jax(_unflatten_node(meta["tree"], "plan", z))
