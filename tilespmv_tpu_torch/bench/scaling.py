"""Scaling sweep over a device mesh.

Port of tilespmv_tpu/bench/scaling.py: distributed SpMV throughput at
increasing device counts (powers of two up to the mesh's devices), work
fixed (strong scaling): per count ms, GFLOPS and parallel efficiency
against the smallest count.

Timing (`time_op`): on the card by CUDA events; where every shard
shares one card, `ms` is the replay of one CUDA graph of `iters` op(x)
calls, as bench/harness.py times a single-device operator, and
`eager_ms` the same calls issued one by one; on several cards (one
graph cannot span them) each card is synchronised, an event recorded
on each, the calls issued, and the slowest card's time taken: `ms` is
then the eager time, and a sweep over several cards times every count
so, one card included, to compare like with like. On the CPU a
`time.perf_counter` loop. Virtual shards on one card run one
after another, so a sweep there measures what partitioning costs (more
launches, smaller classes, x copies), not scaling.

On a mesh that spans processes (`parallel.mesh.initialize_multihost`)
every process times its own calls, eagerly (events on its card, or the
CPU clock), each rep starting after an all_reduce that every process
must reach, and the slowest process's time counts (all_reduce MAX). A
sweep then runs each count below the world's positions on a sub-mesh of
the first processes while the others wait, and only process 0 prints.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, TileConfig
from ..io.mmio import CSRMatrix
from ..parallel import DistributedSpMV, make_mesh
from ..parallel.mesh import process_broadcast, process_reduce
from .harness import _reps_cuda


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    ms: float
    gflops: float
    efficiency: float  # vs the smallest device count, ideal = 1.0
    eager_ms: float = float("nan")


def _events_ms(op, x: torch.Tensor, devs: list, warmup: int, reps: int,
               iters: int) -> list:
    """ms per call, per rep, of `iters` eager calls over several cards:
    the slowest device's event time after a sync of every device."""
    for _ in range(warmup):
        op(x)
    out = []
    for _ in range(reps):
        for d in devs:
            torch.cuda.synchronize(d)
        starts = [torch.cuda.Event(enable_timing=True) for _ in devs]
        ends = [torch.cuda.Event(enable_timing=True) for _ in devs]
        for d, ev in zip(devs, starts):
            ev.record(torch.cuda.current_stream(d))
        for _ in range(iters):
            op(x)
        for d, ev in zip(devs, ends):
            ev.record(torch.cuda.current_stream(d))
        for ev in ends:
            ev.synchronize()
        out.append(max(a.elapsed_time(b) for a, b in zip(starts, ends))
                   / iters)
    return out


def _process_ms(op, x: torch.Tensor, warmup: int, reps: int,
                iters: int) -> list:
    """ms per call, per rep, of `iters` eager calls on a mesh that spans
    processes: the slowest process's time (see the module doc)."""
    mesh = op.mesh
    cards = sorted({d for d in mesh.local_devices() if d.type == "cuda"},
                   key=str)
    for _ in range(warmup):
        op(x)
    out = []
    for _ in range(reps):
        for d in cards:
            torch.cuda.synchronize(d)
        process_reduce([0.0], mesh)
        if cards:
            out.append(_events_ms(op, x, cards, 0, 1, iters)[0])
            continue
        t0 = time.perf_counter()
        for _ in range(iters):
            op(x)
        out.append((time.perf_counter() - t0) * 1e3 / iters)
    return process_reduce(out, mesh, op="max")


def time_op(op, x, warmup: int = 2, reps: int = 5, iters: int = 20,
            graph: bool = True) -> tuple[float, float]:
    """(ms, eager_ms) per call of a distributed operator (see the module
    doc), medians over `reps`; `graph` False times a one-card mesh
    eagerly too."""
    devs = op.mesh.local_devices()
    xt = torch.as_tensor(x, dtype=op.dtype, device=devs[0])
    if op.mesh.multiprocess:
        e = statistics.median(_process_ms(op, xt, warmup, reps, iters))
        return e, e
    kinds = {d.type for d in devs}
    cards = sorted(set(devs), key=str)
    if kinds == {"cuda"} and graph and len(cards) == 1:
        with torch.cuda.device(devs[0]):
            g, e = _reps_cuda(op, xt, warmup, reps, iters)
        return statistics.median(g), statistics.median(e)
    if kinds == {"cuda"}:
        e = statistics.median(_events_ms(op, xt, cards, warmup, reps,
                                         iters))
        return e, e
    if kinds != {"cpu"}:
        raise ValueError(f"a mesh on one kind of device, not {kinds}")

    def loop() -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            op(xt)
        return (time.perf_counter() - t0) * 1e3 / iters
    for _ in range(warmup):
        loop()
    t = statistics.median(loop() for _ in range(reps))
    return t, t


def scaling_sweep(csr: CSRMatrix,
                  device_counts: Optional[Iterable[int]] = None,
                  x_mode: str = "auto",
                  config: TileConfig = DEFAULT_CONFIG,
                  verbose: bool = True,
                  devices: Optional[Sequence] = None,
                  warmup: int = 2, reps: int = 5,
                  iters: int = 20) -> list[ScalePoint]:
    """Throughput at each device count (powers of two up to the
    devices of `devices`, default the visible cards, by default), in
    f32 with x = (i % 10) / 4 as the reference's. Work is fixed. In a
    process group every process calls it, `devices` being its own (see
    the module doc), and every process returns process 0's points."""
    whole = make_mesh(devices=devices)
    every = whole.flat()
    total = len(every)
    graph = len(set(every)) == 1 and not whole.multiprocess
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= total]
    device_counts = list(device_counts)
    x = ((np.arange(csr.n) % 10) / 4.0).astype(np.float32)
    flops = 2.0 * csr.nnz
    out: list[ScalePoint] = []
    base = None
    for nd in device_counts:
        mesh = make_mesh(nd, devices=devices)
        ms = eager = float("nan")
        mode = None
        if mesh.local():
            op = DistributedSpMV(csr, mesh=mesh, config=config,
                                 x_mode=x_mode if nd > 1 else "replicated")
            ms, eager = time_op(op, x, warmup=warmup, reps=reps,
                                iters=iters, graph=graph)
            mode = op.x_mode
        # process 0 times every count; the others wait here
        ms, eager, mode = process_broadcast((ms, eager, mode), whole)
        dt = max(ms, 1e-9) / 1e3
        gf = flops / dt / 1e9
        if base is None:
            base = (device_counts[0], dt)
        eff = (base[1] / dt) * (base[0] / nd)
        out.append(ScalePoint(n_devices=nd, ms=ms, gflops=gf,
                              efficiency=eff, eager_ms=eager))
        if verbose and whole.rank == 0:
            print(f"devices={nd:3d}: {ms:8.4f} ms  {gf:8.2f} GFLOPS  "
                  f"efficiency={eff:.2f}  eager {eager:.4f} ms  "
                  f"x_mode={mode}  [{_where(mesh, graph)}]", flush=True)
    return out


def _where(mesh, graph: bool) -> str:
    """What a sweep line measured."""
    if mesh.multiprocess:
        return (f"{mesh.processes} process(es) over {mesh.backend()}, "
                f"{mesh.size // mesh.processes} position(s) each; eager, "
                "the slowest process")
    if mesh.is_virtual():
        return ("virtual shards on one " + mesh.flat()[0].type
                + " device: the cost of partitioning, not scaling")
    where = ", ".join(sorted({str(d) for d in mesh.flat()}))
    if not graph and mesh.flat()[0].type == "cuda":
        where += "; eager, by events on each card"
    return where
