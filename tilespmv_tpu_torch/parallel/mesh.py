"""Device meshes and the collectives the distributed operators use.

Port of tilespmv_tpu/parallel/mesh.py. The reference is one JAX
controller driving a mesh of devices with `shard_map`; its counterpart
here is one process driving a mesh of `torch.device`s. A `Mesh` is an
object array of devices with the reference's axis names; a device may
appear more than once, and each appearance is a shard of its own (a
virtual device: `["cpu"] * 8` is the reference tests' 8-device CPU
mesh, `["cuda:0"] * 4` four shards on one card).

The collectives are plain functions over lists of per-shard tensors,
one per mesh position in row-major order, each on its shard's device;
they are tensor copies, `torch.cat` and sums; between cards the copies
are peer copies, which do not wait for the host. They live only here, so
that a process-group implementation (one process per card, several
hosts: not ported) replaces only them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

ROW_AXIS = "row"
COL_AXIS = "col"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: object array of torch.device, one axis per name."""
    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> tuple:
        return self.devices.shape

    @property
    def size(self) -> int:
        return self.devices.size

    def flat(self) -> list:
        """The devices in row-major order, one per shard."""
        return list(self.devices.flat)

    def is_virtual(self) -> bool:
        """True where shards share a device."""
        return len(set(self.devices.flat)) < self.size


def _devices(devices: Optional[Sequence]) -> list:
    """`devices` as torch.devices; None: the visible CUDA cards (raises
    RuntimeError where there is none, never falling back to the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the mesh spans the visible CUDA cards by default and finds "
                "none; pass devices=[\"cpu\"] * n for a virtual CPU mesh")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def _object_array(devs: list, shape: tuple) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis_names: Sequence[str] = (ROW_AXIS,)) -> Mesh:
    """1-D mesh over the first `n_devices` of `devices` (default: all;
    `devices` default: the visible cards)."""
    devs = _devices(devices)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if len(axis_names) != 1:
        raise ValueError("make_mesh is 1-D; use make_mesh2d")
    return Mesh(_object_array(devs[:n], (n,)), tuple(axis_names))


def make_mesh2d(rows: int, cols: int, devices: Optional[Sequence] = None,
                axis_names: Sequence[str] = (ROW_AXIS, COL_AXIS)) -> Mesh:
    """2-D (rows x cols) mesh for block-partitioned SpMV."""
    devs = _devices(devices)
    if rows * cols > len(devs):
        raise ValueError(
            f"requested {rows}x{cols} devices, have {len(devs)}")
    return Mesh(_object_array(devs[: rows * cols], (rows, cols)),
                tuple(axis_names))


def run_devices(device: str = "cuda") -> list:
    """The devices a command-line run on `device` spreads over: "cpu",
    eight virtual CPU devices (the reference tests' mesh); "cuda", the
    visible cards, or four virtual shards of the card where only one is
    visible."""
    if device == "cpu":
        return [torch.device("cpu")] * 8
    devs = _devices(None)
    return devs if len(devs) > 1 else devs * 4


def on(device: torch.device):
    """Context that makes `device` the current CUDA device (the class
    kernels launch on its current stream); nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def all_gather(parts: list, devices: list) -> list:
    """Tiled all-gather (jax.lax.all_gather(..., tiled=True)): shard d
    receives the concatenation along dim 0 of every shard's part, on
    devices[d]."""
    return [torch.cat([p.to(dev) for p in parts]) for dev in devices]


def all_to_all(send: list, devices: list) -> list:
    """Tiled all-to-all (jax.lax.all_to_all(..., split_axis=0,
    concat_axis=0, tiled=True)): each send[e] splits along dim 0 into
    len(devices) equal chunks; shard d receives chunk d of every sender,
    in sender order, its own included."""
    ndev = len(devices)
    size = send[0].shape[0] // ndev
    if size == 0 or any(s.shape[0] != ndev * size for s in send):
        raise ValueError(f"all_to_all: each send buffer must split into "
                         f"{ndev} equal non-empty chunks")
    chunks = [s.split(size) for s in send]
    return [torch.cat([chunks[e][d].to(dev) for e in range(ndev)])
            for d, dev in enumerate(devices)]


def psum(parts: list, mesh: Mesh, axis: str = COL_AXIS) -> list:
    """Sum over one axis of a 2-D mesh (jax.lax.psum): every shard
    receives, on its device, the sum of the parts of the shards that
    share its other coordinate, added in axis order."""
    ax = mesh.axis_names.index(axis)
    grid = np.arange(mesh.size).reshape(mesh.shape)
    out = [None] * mesh.size
    for idx in np.ndindex(*mesh.shape):
        line = list(idx)
        line[ax] = slice(None)
        dev = mesh.devices[idx]
        total = None
        for src in grid[tuple(line)]:
            p = parts[int(src)].to(dev)
            total = p if total is None else total + p
        out[int(grid[idx])] = total
    return out
