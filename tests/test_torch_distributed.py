"""The port's multi-device layer (tilespmv_tpu_torch/parallel) against
tilespmv_tpu/parallel, without running either operator: the row blocks
(`_row_block`), column slices (`_col_slice`) and halo plans
(`_plan_halo`) bit-equal on ragged m and n and with empty shards; the
shard tile matrices and the shard plans each operator runs bit-equal to
the reference's, before its SPMD unification pads them (lane plans with
force_t=128, the global use_stream, stream_s_batch=8 and
stream_span_rows=64; build_plan on the xla backend), in f32, f64 and
bf16, including the global stream decision when every COO entry lies
in one shard; `auto`'s choice of x mode; `flops()`; the meshes and the
three collectives. The reference runs on its 8 virtual CPU devices
(tests/conftest.py), the port on devices=["cpu"] * 8."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.io.mmio import CSRMatrix as JCSR
from tilespmv_tpu.ops import plan as j_plan
from tilespmv_tpu.ops.pallas import lane_plan as j_lane
from tilespmv_tpu.parallel import DistributedSpMV as JDist
from tilespmv_tpu.parallel import DistributedSpMV2D as JDist2D
from tilespmv_tpu.parallel import distributed as j_dist
from tilespmv_tpu.parallel import distributed2d as j_dist2d
from tilespmv_tpu.parallel import make_mesh as j_make_mesh
from tilespmv_tpu.parallel import make_mesh2d as j_make_mesh2d
from tilespmv_tpu_torch.config import TileConfig
from tilespmv_tpu_torch.interop import lane_plan_from_jax, spmv_plan_from_jax
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.io.mmio import CSRMatrix as TCSR
from tilespmv_tpu_torch.ops.cuda.lane_plan import map_arrays
from tilespmv_tpu_torch.ops.cuda.reference import plan_array
from tilespmv_tpu_torch.ops.plan import map_plan_arrays
from tilespmv_tpu_torch.parallel import (DistributedSpMV, DistributedSpMV2D,
                                         make_mesh, make_mesh2d, mesh)
from tilespmv_tpu_torch.parallel import distributed as t_dist
from tilespmv_tpu_torch.parallel import distributed2d as t_dist2d

from test_torch_plan import assert_same
from test_torch_xla_plan import TM_ARRAYS, TM_BUCKETS

CPU8 = ["cpu"] * 8


def concentrated(cls, seed=13):
    """test_distributed.py's matrix whose COO entries all lie in the first
    of 8 shards' rows (8192 x 8192, 6000 entries in rows 0..1023)."""
    rng = np.random.default_rng(seed)
    m = n = 8192
    r = rng.integers(0, 1024, 6000).astype(np.int64)
    c = rng.integers(0, n, 6000).astype(np.int64)
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    v = rng.standard_normal(r.size)
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(r, minlength=m))]).astype(np.int64)
    return cls((m, n), indptr, c.astype(np.int64), v)


def ragged_n(cls):
    """tests/test_edges.py::test_halo_ragged_n's matrix: 1024 x 900, n
    not a multiple of ndev * 128."""
    rng = np.random.default_rng(3)
    d = np.where(rng.random((1024, 900)) < 0.01,
                 rng.standard_normal((1024, 900)), 0)
    r, c = np.nonzero(d)
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(r, minlength=1024))]).astype(np.int64)
    return cls((1024, 900), indptr, c.astype(np.int64), d[r, c])


# name: (generator call or builder, x mode of the shard-plan test)
MATRICES = {
    "mixed": (("mixed_structure", (1024, 1024), dict(seed=3)), "allgather"),
    # m not a multiple of ndev * 16 (test_distributed_uneven_rows)
    "uneven": (("mixed_structure", (1000, 777), dict(seed=4)), "halo"),
    # shard 7 empty (7 blocks of 16 rows hold the 100)
    "m100": (("mixed_structure", (100, 300), dict(seed=1)), "halo"),
    "banded": (("banded", (2048, 2048, 8), dict(seed=1)), "halo"),
    "powerlaw": (("power_law", (2048, 2048, 8), dict(seed=2)), "allgather"),
    "ragged_n": (ragged_n, "halo"),
    "concentrated": (concentrated, "allgather"),
}


def make(name):
    """(reference CSRMatrix, port CSRMatrix) of MATRICES[name]."""
    spec = MATRICES[name][0]
    if callable(spec):
        return spec(JCSR), spec(TCSR)
    fn, args, kw = spec
    return (getattr(j_gen, fn)(*args, **kw),
            getattr(t_gen, fn)(*args, **kw))


def csr_equal(a, b, path="csr"):
    assert tuple(a.shape) == tuple(b.shape), path
    for f in ("indptr", "indices", "data"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, (path, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{path}.{f}")


def tm_equal(jtm, ttm, path="tm"):
    for f in TM_ARRAYS:
        np.testing.assert_array_equal(getattr(ttm, f), getattr(jtm, f),
                                      err_msg=f"{path}.{f}")
    for bucket in TM_BUCKETS:
        assert_same(getattr(jtm, bucket), getattr(ttm, bucket),
                    f"{path}.{bucket}")


def host_plan(op):
    """A shard TileSpMV's plan with its buffers as NumPy arrays."""
    plan = op.device_plan()
    if op.backend == "xla":
        return map_plan_arrays(plan, lambda _, t: plan_array(t))
    return map_arrays(plan, lambda _, t: plan_array(t))


def reference_shard_plans(jtms, backend, jdt):
    """The reference's per-shard plans before unification
    (tilespmv_tpu/parallel/distributed.py:479-499), carried across; and
    the reference's global stream decision."""
    if backend == "xla":
        return [spmv_plan_from_jax(j_plan.build_plan(tm, compute_dtype=jdt))
                for tm in jtms], None
    coo = sum(int(tm.coo.val.shape[0]) if tm.coo.num_tiles else 0
              for tm in jtms)
    use = coo >= j_lane.STREAM_MIN_ENTRIES
    return [lane_plan_from_jax(j_lane.build_lane_plan(
        tm, compute_dtype=jdt, force_t=128, use_stream=use,
        stream_s_batch=8, stream_span_rows=64)) for tm in jtms], use


def check_shards(jtms, ttms, shards, use, backend, jdt):
    with jax.enable_x64(True):
        want, use_ref = reference_shard_plans(jtms, backend, jdt)
    assert use == use_ref
    assert len(jtms) == len(ttms) == len(shards) == len(want)
    for d, (jtm, ttm, op, plan) in enumerate(zip(jtms, ttms, shards, want)):
        tm_equal(jtm, ttm, f"shard {d}")
        assert op.backend == backend and op.device.type == "cpu"
        assert_same(host_plan(op), plan, f"shard {d} plan")
    return use_ref


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_row_blocks_and_halo_plan_bit_equal(name):
    jc, tc = make(name)
    for ndev in (1, 3, 8):
        # ceil(ceil(m / 16) / ndev) tiles
        rows_per = -(-(-(-jc.m // 16)) // ndev) * 16
        jb = [j_dist._row_block(jc, d * rows_per, (d + 1) * rows_per,
                                rows_per) for d in range(ndev)]
        tb = [t_dist._row_block(tc, d * rows_per, (d + 1) * rows_per,
                                rows_per) for d in range(ndev)]
        for d, (a, b) in enumerate(zip(jb, tb)):
            csr_equal(a, b, f"ndev {ndev} block {d}")
        jh = j_dist._plan_halo(jb, jc.n, ndev)
        th = t_dist._plan_halo(tb, tc.n, ndev)
        for f in ("rx", "max_pk", "n_x_pad", "traffic_ratio"):
            assert getattr(jh, f) == getattr(th, f), f
        assert jh.send_idx.dtype == th.send_idx.dtype
        np.testing.assert_array_equal(jh.send_idx, th.send_idx)
        for kind in ("local_blocks", "foreign_blocks"):
            for d, (a, b) in enumerate(zip(getattr(jh, kind),
                                           getattr(th, kind))):
                csr_equal(a, b, f"ndev {ndev} {kind} {d}")
    if name == "m100":
        # ndev 8: the last shard starts past m and is all padding
        assert tb[-1].nnz == 0 and tb[-1].m == 16


@pytest.mark.parametrize("name", ["mixed", "uneven", "ragged_n"])
def test_col_slices_bit_equal(name):
    jc, tc = make(name)
    for ncol in (2, 3, 8):
        cols_per = -(-jc.n // (ncol * 16)) * 16
        for j in range(ncol):
            args = (j * cols_per, min((j + 1) * cols_per, jc.n), cols_per)
            csr_equal(j_dist2d._col_slice(jc, *args),
                      t_dist2d._col_slice(tc, *args), f"slice {j}")


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_shard_plans_bit_equal(name):
    """The shard TileSpMVs of the port's operator hold the reference's
    per-shard plans (before unification) on the reference operator's own
    tile matrices; in halo mode the local and the foreign plans, each
    with its own global stream decision."""
    jc, tc = make(name)
    x_mode = MATRICES[name][1]
    jop = JDist(jc, mesh=j_make_mesh(8), x_mode=x_mode)
    op = DistributedSpMV(tc, mesh=make_mesh(8, devices=CPU8), x_mode=x_mode)
    assert op.x_mode == jop.x_mode == x_mode
    assert op.rows_per_device == jop.rows_per_device
    assert op.n_pad == jop.n_pad
    use = check_shards(jop.tile_matrices, op.tile_matrices, op.shards,
                       op.use_stream[0], "pallas", jnp.float32)
    if x_mode == "halo":
        # the reference keeps no foreign tile matrices: rebuild them
        from tilespmv_tpu.core.convert import tile_create as j_tc
        jf = [j_tc(b) for b in jop.halo.foreign_blocks]
        tf = [t_dist.tile_create(b) for b in op.halo.foreign_blocks]
        check_shards(jf, tf, op.foreign_shards, op.use_stream[1], "pallas",
                     jnp.float32)
        np.testing.assert_array_equal(op.halo.send_idx, jop.halo.send_idx)
    if name == "concentrated":
        # every COO entry in shard 0: the global decision still gives
        # the other shards a stream class, all inert
        assert use
        for sh in op.shards[1:]:
            st = sh.device_plan().stream
            assert st is not None and not bool(st.sactive.any())


@pytest.mark.parametrize("dtype,jdt", [
    (torch.float64, jnp.float64), (torch.bfloat16, jnp.bfloat16)])
@pytest.mark.parametrize("x_mode", ["allgather", "halo"])
def test_shard_plans_bit_equal_f64_bf16(dtype, jdt, x_mode):
    jc, tc = make("mixed")
    jop = JDist(jc, mesh=j_make_mesh(8), x_mode=x_mode)
    op = DistributedSpMV(tc, mesh=make_mesh(8, devices=CPU8), x_mode=x_mode,
                         dtype=dtype)
    check_shards(jop.tile_matrices, op.tile_matrices, op.shards,
                 op.use_stream[0], "pallas", jdt)


@pytest.mark.parametrize("x_mode", ["allgather", "halo"])
def test_shard_plans_bit_equal_xla(x_mode):
    """Tile size 8: backend "auto" takes the xla engines, each shard
    build_plan's SpMVPlan."""
    jc, tc = make("mixed")
    from tilespmv_tpu.config import TileConfig as JConfig
    jop = JDist(jc, mesh=j_make_mesh(8), x_mode=x_mode,
                config=JConfig(tile_size=8))
    op = DistributedSpMV(tc, mesh=make_mesh(8, devices=CPU8), x_mode=x_mode,
                         config=TileConfig(tile_size=8))
    assert op.backend == jop.backend == "xla"
    assert op.use_stream[0] is None
    check_shards(jop.tile_matrices, op.tile_matrices, op.shards, None,
                 "xla", jnp.float32)


@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (1, 8)])
def test_2d_shard_plans_bit_equal(grid):
    jc = j_gen.mixed_structure(1024, 2048, seed=5)
    tc = t_gen.mixed_structure(1024, 2048, seed=5)
    jop = JDist2D(jc, mesh=j_make_mesh2d(*grid))
    op = DistributedSpMV2D(tc, mesh=make_mesh2d(*grid, devices=CPU8))
    assert (op.rows_per, op.cols_per, op.n_x_pad) == (
        jop.rows_per, jop.cols_per, jop.n_x_pad)
    check_shards(jop.tile_matrices, op.tile_matrices, op.shards,
                 op.use_stream[0], "pallas", jnp.float32)


def test_auto_choice_and_flops():
    """auto: allgather on test_halo_auto_fallback's matrix, halo on
    banded_medium, as the reference picks; halo falls to replicated on
    one device. flops() is 2 * nnz of the whole matrix (the reference's
    halo operator counts only its local plans' entries, ROADMAP.md C)."""
    for args, want in (((2048, 2048), "allgather"), (None, "halo")):
        if args is None:
            jc = j_gen.get_matrix("banded_medium")
            tc = t_gen.get_matrix("banded_medium")
        else:
            jc = j_gen.mixed_structure(*args, seed=1)
            tc = t_gen.mixed_structure(*args, seed=1)
        jop = JDist(jc, mesh=j_make_mesh(8), x_mode="auto")
        op = DistributedSpMV(tc, mesh=make_mesh(8, devices=CPU8),
                             x_mode="auto")
        assert op.x_mode == jop.x_mode == want
        assert op.flops() == 2 * tc.nnz
        if want == "allgather":
            assert op.flops() == jop.flops()
        else:
            assert op.halo.traffic_ratio == jop.halo.traffic_ratio < 0.75
            local = sum(tm.nnz for tm in op.tile_matrices)
            assert jop.flops() == 2 * local < op.flops()
    jc = j_gen.mixed_structure(256, 256, seed=6)
    tc = t_gen.mixed_structure(256, 256, seed=6)
    op = DistributedSpMV(tc, mesh=make_mesh(1, devices=["cpu"]),
                         x_mode="halo")
    assert op.x_mode == JDist(jc, mesh=j_make_mesh(1),
                              x_mode="halo").x_mode == "replicated"
    op2 = DistributedSpMV2D(tc, mesh=make_mesh2d(2, 4, devices=CPU8))
    assert op2.flops() == 2 * tc.nnz == JDist2D(
        jc, mesh=j_make_mesh2d(2, 4)).flops()


def test_exchange_bytes():
    tc = t_gen.get_matrix("banded_medium")
    ops = {m: DistributedSpMV(tc, mesh=make_mesh(8, devices=CPU8), x_mode=m)
           for m in ("allgather", "replicated", "halo")}
    assert ops["allgather"].exchange_bytes() == 7 * tc.n * 4
    assert ops["replicated"].exchange_bytes() == 7 * tc.n * 4
    h = ops["halo"].halo
    assert ops["halo"].exchange_bytes() == 8 * 7 * h.max_pk * 128 * 4
    assert ops["halo"].exchange_bytes() < ops["allgather"].exchange_bytes()


def test_make_mesh(monkeypatch):
    """The default devices are the visible cards: none, RuntimeError
    (no fallback to the CPU); more devices than given, ValueError, as
    the reference (mesh.py:28-29, :38-40)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: make_mesh(), lambda: make_mesh2d(1, 1),
                 lambda: DistributedSpMV(t_gen.get_matrix("mixed_small"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(ValueError, match="requested 9 devices"):
        make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="requested 3x3 devices"):
        make_mesh2d(3, 3, devices=CPU8)
    with pytest.raises(ValueError, match="1-D"):
        make_mesh(2, devices=CPU8, axis_names=("row", "col"))
    with pytest.raises(ValueError, match="x_mode"):
        DistributedSpMV(t_gen.get_matrix("mixed_small"),
                        mesh=make_mesh(2, devices=CPU8), x_mode="ring")
    m = make_mesh2d(2, 4, devices=CPU8)
    assert m.shape == (2, 4) and m.size == 8 and m.is_virtual()
    assert m.axis_names == ("row", "col")
    assert m.flat() == [torch.device("cpu")] * 8
    assert not make_mesh(1, devices=["cpu"]).is_virtual()
    assert len(mesh.run_devices("cpu")) == 8


def test_collectives():
    """all_gather, all_to_all and psum against their definitions on
    numpy, over a virtual CPU mesh."""
    devs = [torch.device("cpu")] * 4
    parts = [torch.arange(3) + 10 * d for d in range(4)]
    for got in mesh.all_gather(parts, devs):
        assert torch.equal(got, torch.cat(parts))
    send = [torch.arange(8).reshape(4, 2) + 100 * e for e in range(4)]
    recv = mesh.all_to_all(send, devs)
    for d in range(4):
        want = np.concatenate([send[e].numpy()[d:d + 1] for e in range(4)])
        np.testing.assert_array_equal(recv[d].numpy(), want)
    with pytest.raises(ValueError, match="equal"):
        mesh.all_to_all([torch.zeros(3)] * 4, devs)
    m = make_mesh2d(2, 2, devices=devs)
    parts = [torch.full((2,), float(v)) for v in (1, 2, 4, 8)]
    sums = mesh.psum(parts, m, "col")
    assert [float(s[0]) for s in sums] == [3, 3, 12, 12]
    sums = mesh.psum(parts, m, "row")
    assert [float(s[0]) for s in sums] == [5, 10, 5, 10]
