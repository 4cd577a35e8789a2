"""Device meshes and the collectives the distributed operators use.

Port of tilespmv_tpu/parallel/mesh.py. The reference is one JAX
controller per host driving a mesh of devices with `shard_map`; its
counterparts here are one process driving a mesh of `torch.device`s,
and, after `initialize_multihost`, one such process per card or host
over a `torch.distributed` process group, every process running the
same program (the reference's multi-controller runs).

A `Mesh` is an object array of devices with the reference's axis names,
and `ranks`, the same shape, the process that owns each position. A
device may appear more than once, and each appearance is a shard of its
own (a virtual device: `["cpu"] * 8` is the reference tests' 8-device
CPU mesh, `["cuda:0"] * 4` four shards on one card). A mesh built
before `initialize_multihost` belongs to the one process (every rank
0). After it, `make_mesh` / `make_mesh2d` span every process's own
devices in process-major order (as `jax.devices()` orders processes);
they are then collective: every process calls them, with the same
arguments and the same number of its own devices.

The collectives are plain functions over lists of per-position tensors,
one per position this process owns, in row-major order, each on its
position's device. Within a process they are tensor copies, `torch.cat`
and sums; between cards the copies are peer copies, which do not wait
for the host. Across processes each is one `torch.distributed` call over
the mesh's process group: `all_gather_single` (`all_gather_into_tensor`
where the installed torch lacks it), `all_to_all_single`, `all_reduce`,
on the tensors where they lie. gloo takes CUDA tensors for all three in
torch 2.11 (its own copies through host memory); a torch whose gloo
refuses one raises there, and nothing here copies around it. The
operators' and the sweep's other cross-process calls are here too
(`process_sum`, `process_broadcast`, `process_reduce`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

ROW_AXIS = "row"
COL_AXIS = "col"
BACKENDS = ("nccl", "gloo")


def local_rank() -> int:
    """This process's card on its host: LOCAL_RANK (torchrun sets it),
    0 where unset."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise ValueError(f"{name} is not set: pass it to "
                         "initialize_multihost or start the processes "
                         "with torchrun")
    return int(os.environ[name])


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join this process to the process group before building meshes:
    one process per card or host, each running the same program.

    The counterpart of the reference's wrapper over
    `jax.distributed.initialize`. Arguments left out are read from the
    environment torchrun sets (MASTER_ADDR / MASTER_PORT through
    "env://", WORLD_SIZE, RANK; LOCAL_RANK picks the card). A
    `coordinator_address` "host:port" becomes "tcp://host:port"; a URL
    ("tcp://...", "file:///path" with a file every process can reach)
    is used as it is. `backend` defaults to "nccl" where a card is
    visible (after `torch.cuda.set_device(LOCAL_RANK)`) and "gloo"
    otherwise; "gloo" with CUDA tensors runs where the caller asks for
    it (two processes on one card, which nccl refuses). Raises where
    nccl is asked for without a card, and on a second call; it never
    picks another backend or device on its own.
    """
    if dist.is_initialized():
        raise RuntimeError("initialize_multihost: this process has "
                           "already joined a process group")
    has_card = torch.cuda.is_available()
    backend = backend or ("nccl" if has_card else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and not has_card:
        raise RuntimeError("initialize_multihost: nccl needs a CUDA card "
                           "and this process sees none; pass "
                           "backend=\"gloo\" for a CPU process group")
    world = num_processes if num_processes is not None else \
        _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = "tcp://" + coordinator_address
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: object array of torch.device, one axis per name;
    `ranks`: the owning process of each position (None: all this
    process's, rank 0). `group` is the process group of the mesh's
    processes (None: the world) and `line_groups` the groups of the
    processes that share a line of a 2-D mesh, by their ranks; both are
    used only where `multiprocess`."""
    devices: np.ndarray
    axis_names: tuple
    ranks: Optional[np.ndarray] = None
    multiprocess: bool = False
    group: Any = None
    line_groups: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.ranks is None:
            object.__setattr__(self, "ranks",
                               np.zeros(self.devices.shape, np.int64))

    @property
    def shape(self) -> tuple:
        return self.devices.shape

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def rank(self) -> int:
        """This process's rank (0 on a one-process mesh)."""
        return dist.get_rank() if self.multiprocess else 0

    @property
    def processes(self) -> int:
        """The number of processes that own positions of the mesh."""
        return len(set(self.ranks.flat))

    def flat(self) -> list:
        """The devices in row-major order, one per position."""
        return list(self.devices.flat)

    def local(self) -> list:
        """The flat positions this process owns, in order."""
        return [int(p) for p in np.flatnonzero(self.ranks.reshape(-1)
                                               == self.rank)]

    def local_devices(self) -> list:
        """The devices of this process's positions, in order."""
        flat = self.flat()
        return [flat[p] for p in self.local()]

    def is_virtual(self) -> bool:
        """True where shards share a device."""
        return len(set(zip(self.devices.flat, self.ranks.flat))) < self.size

    def backend(self) -> Optional[str]:
        """The process group's backend; None on a one-process mesh."""
        return dist.get_backend(self.group) if self.multiprocess else None


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


def _world_devices(devices: Optional[Sequence]) -> tuple:
    """(every position's device, its owning rank): this process's
    `devices` alone, or, in a process group, every process's own
    devices (default: its card, cuda:LOCAL_RANK) in process-major order,
    gathered once."""
    if not dist.is_initialized():
        devs = _devices(devices)
        return devs, [0] * len(devs)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a process's mesh devices default to its "
                               "card, and this process sees none; pass "
                               "devices=[\"cpu\"] * n")
        devices = [torch.device("cuda", local_rank())]
    mine = [str(torch.device(d)) for d in devices]
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, mine)
    if len({len(ds) for ds in lists}) != 1:
        raise ValueError("every process must give the mesh the same number "
                         f"of devices; they gave {[len(ds) for ds in lists]}")
    return ([torch.device(d) for ds in lists for d in ds],
            [r for r, ds in enumerate(lists) for _ in ds])


def _mesh(devs: list, ranks: list, shape: tuple, axis_names) -> Mesh:
    """The mesh of the first prod(shape) positions. In a process group
    its groups are made here, in the same order on every process
    (`new_group` is collective): the mesh's processes, unless they are
    the world, and, on a 2-D mesh, those of each line along either axis
    that spans processes."""
    n = int(np.prod(shape))
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    rk = np.asarray(ranks[:n], np.int64).reshape(shape)
    if not dist.is_initialized():
        return Mesh(arr.reshape(shape), tuple(axis_names))
    world = dist.get_world_size()
    members, counts = np.unique(rk, return_counts=True)
    if len(set(counts.tolist())) != 1:
        raise ValueError(f"a mesh of {n} positions gives its processes "
                         f"{counts.tolist()}: they must own equal shares")
    members = members.tolist()
    group = None if len(members) == world else dist.new_group(members)
    lines = {}
    if len(shape) == 2:
        for ax in (0, 1):
            for line in np.moveaxis(rk, ax, -1).reshape(-1, shape[ax]):
                key = tuple(sorted({int(r) for r in line}))
                if len(key) > 1 and key not in lines:
                    lines[key] = (dist.group.WORLD if len(key) == world
                                  else dist.new_group(list(key)))
    return Mesh(arr.reshape(shape), tuple(axis_names), ranks=rk,
                multiprocess=True, group=group, line_groups=lines)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis_names: Sequence[str] = (ROW_AXIS,)) -> Mesh:
    """1-D mesh over the first `n_devices` positions (default: all) of
    `devices` (default: the visible cards; in a process group, every
    process's own `devices`, default its card)."""
    devs, ranks = _world_devices(devices)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if len(axis_names) != 1:
        raise ValueError("make_mesh is 1-D; use make_mesh2d")
    return _mesh(devs, ranks, (n,), axis_names)


def make_mesh2d(rows: int, cols: int, devices: Optional[Sequence] = None,
                axis_names: Sequence[str] = (ROW_AXIS, COL_AXIS)) -> Mesh:
    """2-D (rows x cols) mesh for block-partitioned SpMV (`devices` as
    make_mesh's)."""
    devs, ranks = _world_devices(devices)
    if rows * cols > len(devs):
        raise ValueError(
            f"requested {rows}x{cols} devices, have {len(devs)}")
    return _mesh(devs, ranks, (rows, cols), axis_names)


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


def gather(parts: list, mesh: Mesh) -> torch.Tensor:
    """Every position's part concatenated along dim 0 in position order,
    on the device of this process's first part (`parts`: this process's
    positions', of equal shapes where the mesh spans processes)."""
    dev = parts[0].device
    mine = torch.cat([p.to(dev) for p in parts])
    if not mesh.multiprocess:
        return mine
    out = mine.new_empty((mesh.processes * mine.shape[0],) + mine.shape[1:])
    collective = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    collective(out, mine, group=mesh.group)
    return out


def all_gather(parts: list, devices: list,
               mesh: Optional[Mesh] = None) -> list:
    """Tiled all-gather (jax.lax.all_gather(..., tiled=True)): position
    d receives the concatenation along dim 0 of every position's part,
    on devices[d]. On a `mesh` that spans processes, `parts` and
    `devices` are this process's positions'."""
    if mesh is None or not mesh.multiprocess:
        return [torch.cat([p.to(dev) for p in parts]) for dev in devices]
    full = gather(parts, mesh)
    return [full.to(dev) for dev in devices]


def all_to_all(send: list, devices: list,
               mesh: Optional[Mesh] = None) -> list:
    """Tiled all-to-all (jax.lax.all_to_all(..., split_axis=0,
    concat_axis=0, tiled=True)): each send[e] splits along dim 0 into as
    many equal chunks as the mesh has positions; position d receives
    chunk d of every sender, in sender order, its own included. On a
    `mesh` that spans processes, `send` and `devices` are this process's
    positions', and the chunks travel in one all_to_all_single, laid out
    by destination process."""
    ndev = mesh.size if mesh is not None else len(devices)
    size = send[0].shape[0] // ndev
    if size == 0 or any(s.shape[0] != ndev * size for s in send):
        raise ValueError(f"all_to_all: each send buffer must split into "
                         f"{ndev} equal non-empty chunks")
    if mesh is None or not mesh.multiprocess:
        chunks = [s.split(size) for s in send]
        return [torch.cat([chunks[e][d].to(dev) for e in range(ndev)])
                for d, dev in enumerate(devices)]
    nproc, mine = mesh.processes, len(send)
    rest = tuple(send[0].shape[1:])
    dev = send[0].device
    # (destination process, sender, destination position, chunk)
    buf = torch.stack([s.to(dev).view(nproc, mine, size, *rest)
                       for s in send], dim=1).contiguous()
    out = torch.empty_like(buf)
    dist.all_to_all_single(out.view(-1), buf.view(-1), group=mesh.group)
    # (source process, sender, destination position, chunk): senders in
    # process-major order are the mesh's sender order
    return [out[:, :, d].reshape(ndev * size, *rest).to(devices[d])
            for d in range(mine)]


def psum(parts: list, mesh: Mesh, axis: str = COL_AXIS) -> list:
    """Sum over one axis of a 2-D mesh (jax.lax.psum): every position
    receives, on its device, the sum of the parts of the positions that
    share its other coordinate. Within a process the parts are added in
    axis order; where a line spans processes, each adds its own parts of
    the line so, and one all_reduce over the line's processes adds
    those. On a mesh that spans processes, `parts` and the result are
    this process's positions'."""
    ax = mesh.axis_names.index(axis)
    grid = np.arange(mesh.size).reshape(mesh.shape)
    flat = mesh.flat()
    ranks = mesh.ranks.reshape(-1)
    slot = {p: i for i, p in enumerate(mesh.local())}
    out = [None] * len(slot)
    for line in np.moveaxis(grid, ax, -1).reshape(-1, mesh.shape[ax]):
        mine = [int(p) for p in line if int(p) in slot]
        if not mine:
            continue
        dev = flat[mine[0]]
        total = None
        for p in mine:
            q = parts[slot[p]].to(dev)
            total = q if total is None else total + q
        key = tuple(sorted({int(ranks[p]) for p in line}))
        if len(key) > 1:
            total = total.clone() if len(mine) == 1 else total
            dist.all_reduce(total, group=mesh.line_groups[key])
        for p in mine:
            out[slot[p]] = total.to(flat[p])
    return out


def process_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`t` summed over the mesh's processes in place, by one all_reduce
    (every process gives a tensor of the same shape); `t` itself on a
    one-process mesh."""
    if mesh.multiprocess:
        dist.all_reduce(t, group=mesh.group)
    return t


def process_broadcast(obj: Any, mesh: Mesh) -> Any:
    """Process 0's `obj` (any picklable value) on every process of the
    mesh; `obj` itself on a one-process mesh."""
    if not mesh.multiprocess:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def process_reduce(values: Sequence[float], mesh: Mesh,
                   op: str = "sum") -> list:
    """`values` reduced ("sum" or "max") over the mesh's processes by one
    all_reduce of float64s; unchanged on a one-process mesh. It returns
    when every process has given its values, so it also serves as a
    barrier."""
    if not mesh.multiprocess:
        return [float(v) for v in values]
    dev = (mesh.local_devices()[0] if mesh.backend() == "nccl"
           else torch.device("cpu"))
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=mesh.group)
    return t.tolist()
