"""Distributed SpMV walkthrough: the row partition with halo exchange,
the 2-D block partition, and a strong-scaling sweep.

Port of examples/distributed_run.py. On the visible cards by default
(four virtual shards where only one is visible: they run one after
another, so the sweep then measures what partitioning costs); with
device="cpu" on eight virtual CPU devices, the reference's test mesh.

    python -m tilespmv_tpu_torch.examples.distributed_run

This walkthrough drives every card from one process. For one process
per card or host, call `parallel.mesh.initialize_multihost(...)` first
in every process (or start them with torchrun), then build the meshes
and operators as here: `make_mesh()` then spans every process's card
(see tilespmv_tpu_torch/scripts/multiprocess_dryrun.py).
"""
import numpy as np

from ..bench.scaling import scaling_sweep
from ..io import generate
from ..parallel import (DistributedSpMV, DistributedSpMV2D, make_mesh,
                        make_mesh2d)
from ..parallel.mesh import run_devices


def _err(y, golden: np.ndarray) -> float:
    y = y.cpu().double().numpy()
    return float(np.max(np.abs(y - golden) / (1 + np.abs(golden))))


def main(quick: bool = False, device=None) -> float:
    """`quick` limits the scaling sweep to one device count. `device`:
    None (the cards) or "cpu". Returns the worst relative error of the
    operators' y."""
    devices = run_devices("cpu" if device == "cpu" else "cuda")
    ndev = len(devices)
    csr = generate.get_matrix("banded_medium")
    x = np.linspace(-1, 1, csr.n).astype(np.float32)
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    golden = np.bincount(rows, weights=csr.data * x[csr.indices].astype(
        np.float64), minlength=csr.m)

    # 1-D row partition, selective halo exchange (auto falls back to
    # all-gather when packets would not be smaller)
    nd = min(ndev, 8)
    op = DistributedSpMV(csr, mesh=make_mesh(nd, devices=devices),
                         x_mode="auto")
    err = _err(op(x), golden)
    hp = op.halo
    print(f"1-D ({op.x_mode}): devices={nd} err={err:.2e}"
          + (f"  halo packets={hp.max_pk} blocks/pair, "
             f"{hp.traffic_ratio:.2f}x of all-gather bytes" if hp else ""))

    # 2-D block partition: each device reads only its column stripe of
    # x, and the row stripes are summed over the column axis
    if ndev >= 4:
        op2 = DistributedSpMV2D(csr, mesh=make_mesh2d(2, 2, devices=devices))
        err2 = _err(op2(x), golden)
        print(f"2-D (2x2 blocks): err={err2:.2e}")
        err = max(err, err2)

    print("strong scaling:")
    counts = [d for d in (1, 2, 4, 8) if d <= ndev]
    scaling_sweep(csr, device_counts=counts[-1:] if quick else counts,
                  devices=devices, reps=3 if quick else 5,
                  iters=5 if quick else 20)
    return err


if __name__ == "__main__":
    main()
