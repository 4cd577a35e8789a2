"""Start a world of worker processes on this host and wait for them.

`spawn` runs one command line once per rank, as torchrun does without
its elastic agent: rank r gets RANK=r, WORLD_SIZE and LOCAL_RANK in its
environment, so a worker joins with
`mesh.initialize_multihost(coordinator_address)` given a rendezvous
every worker can reach (a "file:///..." path under a fresh temporary
directory needs no port). A worker that fails fails the run: the others
are killed, as they are at the time limit.
"""
from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Optional, Sequence


def spawn(argv: Sequence[str], world: int, timeout: float = 600.0,
          local_rank: Optional[Callable[[int], int]] = None,
          env: Optional[dict] = None, cwd: Optional[str] = None) -> None:
    """Run `argv` as `world` processes, rank r with RANK=r,
    WORLD_SIZE=world and LOCAL_RANK=local_rank(r) (default r) added to
    this process's environment and `env`; return when all exit 0.

    OMP_NUM_THREADS, where neither sets it, becomes this host's cores
    over `world`, as torchrun bounds it: each process's CPU operators
    would otherwise start a thread per core, and `world` such pools
    oversubscribe the cores.

    Raises RuntimeError naming the ranks that failed as soon as one exits
    non-zero, and TimeoutError after `timeout` seconds; in both cases the
    workers still running are killed first. Their output goes where this
    process's goes."""
    base = dict(os.environ, **(env or {}))
    base.setdefault("OMP_NUM_THREADS",
                    str(max(1, (os.cpu_count() or 1) // world)))
    procs = []
    try:
        for r in range(world):
            lr = local_rank(r) if local_rank is not None else r
            penv = dict(base, RANK=str(r), WORLD_SIZE=str(world),
                        LOCAL_RANK=str(lr))
            procs.append(subprocess.Popen(list(argv), env=penv, cwd=cwd))
        deadline = time.monotonic() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            failed = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if failed:
                raise RuntimeError(
                    f"worker rank(s) {failed} of {world} exited with "
                    f"{[rcs[r] for r in failed]}: {' '.join(argv)}")
            if all(rc == 0 for rc in rcs):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"workers still running after "
                                   f"{timeout:.0f} s: {' '.join(argv)}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
