"""Multi-process dryrun of the multi-host path: two processes, each with
four virtual shards, run one `DistributedSpMV` over a process group.

Port of scripts/multiprocess_dryrun.py. Each worker joins by
`initialize_multihost` (a file:// rendezvous in a temporary directory,
no port), builds the 8-position mesh over both processes, plans its own
four row blocks of `mixed_structure(2048, 2048, seed=5)` and calls the
operator with x_mode allgather, so the all-gathers of x and of y cross
the process boundary. Process 0 prints the relative error against
`csr.matvec`; PASS below 1e-4.

    python -m tilespmv_tpu_torch.scripts.multiprocess_dryrun              # the card
    python -m tilespmv_tpu_torch.scripts.multiprocess_dryrun --device cpu # CPU, gloo

On the card (the default): one process per card over nccl where two
cards are visible; on one card both processes on cuda:0 over gloo (nccl
refuses two ranks on one card); exit 2 where no card is visible, never
falling back to the CPU. `--device cpu` runs the reference dryrun's
layout, 2 processes x 4 CPU shards over gloo. Exit 0 = PASS.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
SHARDS = 4
WORLD = 2


def worker(device: str, init: str) -> int:
    import torch.distributed as dist
    from ..io import generate
    from ..parallel import DistributedSpMV
    from ..parallel.mesh import initialize_multihost, local_rank, make_mesh

    cards = torch.cuda.device_count() if device == "cuda" else 0
    backend = "nccl" if cards >= WORLD else "gloo"
    initialize_multihost(init, backend=backend)
    try:
        shard = "cpu" if device == "cpu" else f"cuda:{local_rank()}"
        mesh = make_mesh(devices=[shard] * SHARDS)
        csr = generate.mixed_structure(2048, 2048, seed=5)
        op = DistributedSpMV(csr, mesh=mesh, x_mode="allgather")
        x = np.linspace(-1.0, 1.0, csr.n).astype(np.float32)
        y = op(x).cpu().double().numpy()
        ref = csr.matvec(x.astype(np.float64))
        err = float(np.max(np.abs(y - ref)) / max(1e-30,
                                                   np.max(np.abs(ref))))
        if mesh.rank == 0:
            print(f"multiprocess dryrun: processes={dist.get_world_size()} "
                  f"backend={backend} ndev={mesh.size} device={shard} "
                  f"x_mode={op.x_mode} rel_err={err:.2e} "
                  f"{'PASS' if err < 1e-4 else 'FAIL'}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if err < 1e-4 else 1


def main(argv=None) -> int:
    from ..parallel.launch import spawn
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--worker", metavar="INIT", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        return worker(args.device, args.worker)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multiprocess dryrun: no CUDA card", file=sys.stderr)
        return 2
    one_card = args.device == "cuda" and torch.cuda.device_count() < WORLD
    with tempfile.TemporaryDirectory() as tmp:
        try:
            spawn([sys.executable, "-m", __spec__.name, "--device",
                   args.device, "--worker",
                   pathlib.Path(tmp, "store").as_uri()], WORLD,
                  timeout=600,
                  local_rank=(lambda r: 0) if one_card else None,
                  cwd=str(REPO))
        except (RuntimeError, TimeoutError) as e:
            print(f"multiprocess dryrun: FAIL ({e})", file=sys.stderr)
            return 1
    print("worker exit codes: [0, 0]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
