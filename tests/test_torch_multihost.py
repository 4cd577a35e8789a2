"""The multi-host path of the port's multi-device layer: two processes,
each with four virtual CPU shards, over one gloo process group
(`parallel.mesh.initialize_multihost` with a file:// rendezvous under
the test's temporary directory, so no port is used).

One pair of workers (this file run as a script, `parallel.launch.spawn`,
a 180 s limit) runs every case and saves what each process got. Each
case is then held against
- the one-process operator on devices=["cpu"] * 8: every shard plan of
  a process bit-equal to the plan at the same position, its row blocks
  and y bit-equal (the plain versions on the CPU are deterministic),
  except where `psum` adds a line across processes, whose order of
  addition differs: within 1e-5 * max(1, max|y|);
- the reference's DistributedSpMV / DistributedSpMV2D on its 8 virtual
  CPU devices (tests/conftest.py): f32 within 1e-5 * max(1, max|y_ref|),
  f64 max |y - y_ref| / (1 + |A|·|x|) <= 1e-10, bf16 |y - y_ref| <=
  2^-8 · |A|·|x| + 1e-6 (tests/test_torch_distributed_dtypes.py's
  bounds).
The three collectives over 2 processes x 2 shards against the
one-process functions on the same inputs; the scaling sweep across the
processes; the errors (nccl without a card, a second initialisation,
unequal device counts); and the ported dryrun script."""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = pathlib.Path(__file__).resolve().parents[1]

if __name__ != "__main__":    # the workers run the port alone
    import jax
    import jax.numpy as jnp
    from tilespmv_tpu.io import generate as j_gen
    from tilespmv_tpu.parallel import DistributedSpMV as JDist
    from tilespmv_tpu.parallel import DistributedSpMV2D as JDist2D
    from tilespmv_tpu.parallel import make_mesh as j_make_mesh
    from tilespmv_tpu.parallel import make_mesh2d as j_make_mesh2d

    from test_torch_distributed import CPU8
    from test_torch_distributed_dtypes import magnitude
    from test_torch_distributed_y import close_f32
    from test_torch_plan import assert_same

from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda.lane_plan import map_arrays
from tilespmv_tpu_torch.ops.cuda.reference import plan_array
from tilespmv_tpu_torch.parallel import (DistributedSpMV, DistributedSpMV2D,
                                         make_mesh, make_mesh2d, mesh)
from tilespmv_tpu_torch.parallel.launch import spawn

WORLD, SHARDS = 2, 4
MATRICES = {
    # the reference dryrun's matrix
    "mixed": ("mixed_structure", (2048, 2048), dict(seed=5)),
    "banded": ("banded", (2048, 2048, 8), dict(seed=1)),
    # m = 100: the last shard, process 1's, is empty
    "m100": ("mixed_structure", (100, 300), dict(seed=1)),
}
# name: (matrix, x_mode or 2-D grid, dtype)
CASES = {
    **{f"mixed_{m}": ("mixed", m, "f32")
       for m in ("allgather", "replicated", "halo", "auto")},
    **{f"banded_{m}": ("banded", m, "f32")
       for m in ("allgather", "replicated", "halo", "auto")},
    "m100_halo": ("m100", "halo", "f32"),
    "m100_allgather": ("m100", "allgather", "f32"),
    # rows are processes: psum stays within each process
    "mixed_2d_2x4": ("mixed", (2, 4), "f32"),
    # one row over both processes: psum adds across them
    "mixed_2d_1x8": ("mixed", (1, 8), "f32"),
    "mixed_f64": ("mixed", "halo", "f64"),
    "mixed_bf16": ("mixed", "allgather", "bf16"),
}
DTYPES = {"f32": torch.float32, "f64": torch.float64,
          "bf16": torch.bfloat16}


def matrix(gen, name):
    fn, args, kw = MATRICES[name]
    return getattr(gen, fn)(*args, **kw)


def x_for(n, dt):
    if dt == "f64":
        return np.random.default_rng(5).uniform(-1, 1, n)
    return np.linspace(-1, 1, n).astype(np.float32)


def build(csr, spec, dt, devices):
    """The port's operator of a case on a mesh over `devices`."""
    if isinstance(spec, tuple):
        return DistributedSpMV2D(csr, mesh=make_mesh2d(*spec, devices=devices),
                                 dtype=DTYPES[dt])
    return DistributedSpMV(csr, mesh=make_mesh(devices=devices), x_mode=spec,
                           dtype=DTYPES[dt])


def host(t) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def collective_inputs():
    """Per position of a 4-position mesh: all_gather parts, all_to_all
    send buffers (4 chunks of 2 x 3), psum parts."""
    parts = [torch.arange(6.0).reshape(2, 3) + 10 * d for d in range(4)]
    send = [torch.arange(24.0).reshape(8, 3) + 100 * e for e in range(4)]
    sums = [torch.full((5,), float(2 ** d)) + 0.1 * d for d in range(4)]
    return parts, send, sums


def shard_plans(op):
    """The lane plans of this process's shards (then foreign shards), as
    NumPy arrays (test_torch_distributed.host_plan, which the workers do
    not import: it comes with JAX)."""
    return [map_arrays(sh.device_plan(), lambda _, t: plan_array(t))
            for sh in op.shards + (getattr(op, "foreign_shards", None)
                                   or [])]


# ----------------------------------------------------------------------
# the workers


def worker(out: pathlib.Path, init: str) -> None:
    from tilespmv_tpu_torch.bench.scaling import scaling_sweep
    mesh.initialize_multihost(init, backend="gloo")
    rank = dist.get_rank()
    res = {}
    cpu4 = ["cpu"] * SHARDS
    for name, (mat, spec, dt) in CASES.items():
        csr = matrix(t_gen, mat)
        op = build(csr, spec, dt, cpu4)
        x = x_for(csr.n, dt)
        res[name] = dict(
            local=op.mesh.local(), ranks=op.mesh.ranks.tolist(),
            y=host(op(x)), blocks=[host(b) for b in op.shard_outputs(x)],
            plans=shard_plans(op), nnz=op.nnz, use_stream=op.use_stream,
            x_mode=getattr(op, "x_mode", None))
    # the collectives over 2 processes x 2 shards
    parts, send, sums = collective_inputs()
    m1 = make_mesh(devices=["cpu"] * 2)
    loc = m1.local()
    devs = m1.local_devices()
    res["all_gather"] = [g.numpy() for g in mesh.all_gather(
        [parts[d] for d in loc], devs, mesh=m1)]
    res["all_to_all"] = [g.numpy() for g in mesh.all_to_all(
        [send[d] for d in loc], devs, mesh=m1)]
    for grid in ((2, 2), (1, 4)):
        m2 = make_mesh2d(*grid, devices=["cpu"] * 2)
        for axis in ("col", "row"):
            res[f"psum_{grid}_{axis}"] = [s.numpy() for s in mesh.psum(
                [sums[d] for d in m2.local()], m2, axis)]
    csr = t_gen.mixed_structure(512, 512, seed=3)
    res["sweep"] = [(p.n_devices, p.ms) for p in scaling_sweep(
        csr, devices=cpu4, warmup=0, reps=1, iters=1, verbose=False)]
    try:
        make_mesh(devices=["cpu"] * (SHARDS - rank))
    except ValueError as e:
        res["unequal"] = str(e)
    try:
        mesh.initialize_multihost(init, backend="gloo")
    except RuntimeError as e:
        res["second"] = str(e)
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each process's results, by rank."""
    out = tmp_path_factory.mktemp("multihost")
    spawn([sys.executable, __file__, str(out), (out / "store").as_uri()],
          WORLD, timeout=180, cwd=str(REPO),
          env={"PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"})
    res = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


# ----------------------------------------------------------------------
# the cases


def reference_y(mat, spec, dt, x):
    jc = matrix(j_gen, mat)
    if isinstance(spec, tuple):
        jop = lambda **kw: JDist2D(jc, mesh=j_make_mesh2d(*spec), **kw)
    else:
        jop = lambda **kw: JDist(jc, mesh=j_make_mesh(8), x_mode=spec, **kw)
    if dt == "f64":
        with jax.enable_x64(True):
            return np.asarray(jop(compute_dtype=jnp.float64)(x))
    if dt == "bf16":
        return np.asarray(jop(compute_dtype=jnp.bfloat16)(x)).astype(
            np.float64)
    return np.asarray(jop()(x))


@pytest.mark.parametrize("name", sorted(CASES))
def test_case(name, worlds):
    mat, spec, dt = CASES[name]
    csr = matrix(t_gen, mat)
    x = x_for(csr.n, dt)
    one = build(csr, spec, dt, CPU8)
    y1 = host(one(x))
    blocks1 = [host(b) for b in one.shard_outputs(x)]
    plans1 = shard_plans(one)
    across = spec == (1, 8)
    for rank, res in enumerate(worlds):
        got = res[name]
        assert got["local"] == list(range(rank * SHARDS, (rank + 1) * SHARDS))
        assert np.array_equal(got["ranks"],
                              np.repeat([0, 1], SHARDS).reshape(
                                  np.shape(got["ranks"])))
        assert (got["nnz"], got["use_stream"], got["x_mode"]) == (
            one.nnz, one.use_stream, getattr(one, "x_mode", None))
        # plans: the 1-D operator's local (then foreign) shards; the 2-D
        # operator's blocks, at this process's positions
        nsh = len(one.shards)
        want = [plans1[d] for d in got["local"]]
        if len(plans1) > nsh:
            want += [plans1[nsh + d] for d in got["local"]]
        assert len(got["plans"]) == len(want)
        for d, (a, b) in enumerate(zip(got["plans"], want)):
            assert_same(a, b, f"rank {rank} plan {d}")
        if isinstance(spec, tuple):
            ncol = spec[1]
            want_blocks = [blocks1[d // ncol] for d in got["local"]
                           if d % ncol == 0]
        else:
            want_blocks = [blocks1[d] for d in got["local"]]
        assert len(got["blocks"]) == len(want_blocks)
        bound = 1e-5 * max(1.0, float(np.max(np.abs(y1))))
        for a, b in zip(got["blocks"] + [got["y"]], want_blocks + [y1]):
            assert a.dtype == b.dtype and a.shape == b.shape
            if across:
                assert float(np.max(np.abs(a - b))) <= bound
            else:
                np.testing.assert_array_equal(a, b)
    # against the reference
    jy = reference_y(mat, spec, dt, x)
    y = worlds[0][name]["y"]
    if dt == "f32":
        close_f32(torch.from_numpy(y), jy)
    elif dt == "f64":
        assert np.max(np.abs(y - jy) / (1.0 + magnitude(csr, x))) <= 1e-10
    else:
        xb = np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float64)
        assert np.all(np.abs(y.astype(np.float64) - jy)
                      <= 2.0 ** -8 * magnitude(csr, xb) + 1e-6)


def test_collectives_match_one_process(worlds):
    """all_gather, all_to_all and psum over 2 processes x 2 shards give
    each process the one-process functions' results at its positions
    (psum: the (1, 4) mesh's lines add across the processes)."""
    parts, send, sums = collective_inputs()
    devs = [torch.device("cpu")] * 4
    ag = mesh.all_gather(parts, devs)
    a2a = mesh.all_to_all(send, devs)
    for rank, res in enumerate(worlds):
        pos = [2 * rank, 2 * rank + 1]
        for k, d in enumerate(pos):
            np.testing.assert_array_equal(res["all_gather"][k], ag[d])
            np.testing.assert_array_equal(res["all_to_all"][k], a2a[d])
        for grid in ((2, 2), (1, 4)):
            m = make_mesh2d(*grid, devices=devs)
            for axis in ("col", "row"):
                want = mesh.psum(sums, m, axis)
                got = res[f"psum_{grid}_{axis}"]
                for k, d in enumerate(pos):
                    np.testing.assert_allclose(got[k], want[d], rtol=1e-6)


def test_sweep_across_processes(worlds):
    """Powers of two up to the 8 positions; below 4 a sub-mesh of process
    0; every process returns process 0's points."""
    a, b = (res["sweep"] for res in worlds)
    assert [n for n, _ in a] == [1, 2, 4, 8]
    assert a == b and all(ms > 0 for _, ms in a)


def test_errors_in_the_workers(worlds):
    for res in worlds:
        assert "same number of devices" in res["unequal"]
        assert "already joined" in res["second"]


def test_nccl_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("nccl", None):
        if backend is None:
            # the default is gloo without a card: the call gets as far
            # as the missing world size
            monkeypatch.delenv("WORLD_SIZE", raising=False)
            with pytest.raises(ValueError, match="WORLD_SIZE"):
                mesh.initialize_multihost()
            continue
        with pytest.raises(RuntimeError, match="nccl needs a CUDA card"):
            mesh.initialize_multihost("localhost:1", 1, 0, backend=backend)
    with pytest.raises(ValueError, match="backend"):
        mesh.initialize_multihost("localhost:1", 1, 0, backend="mpi")
    assert not dist.is_initialized()


def test_initialize_arguments(monkeypatch):
    """What initialize_multihost hands init_process_group: "host:port"
    becomes tcp://, a URL stays, nothing reads MASTER_ADDR / MASTER_PORT
    (env://); WORLD_SIZE and RANK from the environment."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    mesh.initialize_multihost("node0:29500")
    mesh.initialize_multihost("file:///tmp/x/store", 2, 1)
    mesh.initialize_multihost()
    assert calls == [
        (("gloo",), dict(init_method="tcp://node0:29500", world_size=4,
                         rank=3)),
        (("gloo",), dict(init_method="file:///tmp/x/store", world_size=2,
                         rank=1)),
        (("gloo",), dict(init_method="env://", world_size=4, rank=3))]


def test_dryrun_passes():
    res = subprocess.run(
        [sys.executable, "-m", "tilespmv_tpu_torch.scripts.multiprocess_dryrun",
         "--device", "cpu"],
        cwd=str(REPO), capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "backend=gloo ndev=8" in res.stdout and "PASS" in res.stdout


def test_dryrun_needs_a_card_by_default():
    """With no arguments the dryrun runs on the card, and without one it
    exits 2 rather than falling back to the CPU."""
    res = subprocess.run(
        [sys.executable, "-m", "tilespmv_tpu_torch.scripts.multiprocess_dryrun"],
        cwd=str(REPO), capture_output=True, text=True, timeout=60,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 2, res.stderr[-4000:]
    assert "no CUDA card" in res.stderr and "PASS" not in res.stdout


def test_cli_scaling_under_torchrun():
    """`torchrun --standalone --nproc-per-node 2 -m tilespmv_tpu_torch.cli
    -d cpu --scaling`: each process joins over gloo with eight virtual
    CPU devices, the sweep runs to 16 positions, and only process 0
    prints (torchrun's own rendezvous takes a free localhost port)."""
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "tilespmv_tpu_torch.cli", "-d",
         "cpu", "--scaling", "mixed_small", "--warmup", "0", "--reps", "1",
         "--iters", "1"], cwd=str(REPO), capture_output=True, text=True,
        timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("devices=")]
    assert [int(ln.split("=")[1].split(":")[0]) for ln in lines] == [
        1, 2, 4, 8, 16]
    assert "2 process(es) over gloo, 8 position(s) each" in lines[-1]


if __name__ == "__main__":
    worker(pathlib.Path(sys.argv[1]), sys.argv[2])
