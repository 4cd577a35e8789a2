"""The port's 2-D block partition (tilespmv_tpu_torch.parallel.
DistributedSpMV2D on devices=["cpu"] * 8) against the reference's on its
8 virtual CPU devices, on tests/test_distributed.py's grids and matrix,
in f32 and f64; its per-shard outputs; and the scaling sweep
(tilespmv_tpu_torch.bench.scaling) on a virtual CPU mesh.

Tolerances: f32 max |y - y_ref| <= 1e-5 * max(1, max|y_ref|); f64
max |y - y_ref| / (1 + |A|·|x|) <= 1e-10 (the reference's double-f32
arithmetic) and <= 1e-12 against the float64 golden."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.parallel import DistributedSpMV2D as JDist2D
from tilespmv_tpu.parallel import make_mesh2d as j_make_mesh2d
from tilespmv_tpu_torch.bench.scaling import scaling_sweep
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.parallel import DistributedSpMV2D, make_mesh2d

from test_torch_distributed import CPU8
from test_torch_distributed_dtypes import magnitude
from test_torch_distributed_y import close_f32, golden


def pair():
    return (j_gen.mixed_structure(1024, 2048, seed=5),
            t_gen.mixed_structure(1024, 2048, seed=5))


@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (1, 8)])
def test_2d_matches_reference(grid):
    jc, tc = pair()
    x = np.linspace(-1, 1, tc.n).astype(np.float32)
    op = DistributedSpMV2D(tc, mesh=make_mesh2d(*grid, devices=CPU8))
    y = op(x)
    assert y.shape == (tc.m,)
    close_f32(y, np.asarray(JDist2D(jc, mesh=j_make_mesh2d(*grid))(x)))
    np.testing.assert_allclose(y.numpy(), golden(tc, x), rtol=1e-4,
                               atol=1e-4)


def test_2d_f64_matches_reference():
    jc, tc = pair()
    x = np.random.default_rng(6).uniform(-1, 1, tc.n)
    op = DistributedSpMV2D(tc, mesh=make_mesh2d(2, 4, devices=CPU8),
                           dtype=torch.float64)
    y = op(x).numpy()
    with jax.enable_x64(True):
        jy = np.asarray(JDist2D(jc, mesh=j_make_mesh2d(2, 4),
                                compute_dtype=jnp.float64)(x))
    mag = 1.0 + magnitude(tc, x)
    assert np.max(np.abs(y - jy) / mag) <= 1e-10
    assert np.max(np.abs(y - golden(tc, x)) / mag) <= 1e-12


def test_2d_shard_outputs():
    """Row stripe i (rows_per rows) on mesh device (i, 0); an uneven
    matrix (1000 x 777) with a stripe past m."""
    tc = t_gen.mixed_structure(1000, 777, seed=4)
    op = DistributedSpMV2D(tc, mesh=make_mesh2d(4, 2, devices=CPU8))
    x = np.linspace(0.5, 1.5, tc.n).astype(np.float32)
    stripes = op.shard_outputs(x)
    assert len(stripes) == 4
    assert all(s.shape == (op.rows_per,) for s in stripes)
    assert torch.equal(torch.cat(stripes)[: tc.m], op(x))
    np.testing.assert_allclose(op(x).numpy(), golden(tc, x), rtol=1e-4,
                               atol=1e-4)


def test_scaling_sweep():
    """tests/test_distributed.py::test_scaling_sweep_smoke on the port:
    points at 1, 2 and 4 devices of a virtual CPU mesh, efficiency 1 at
    the first (CPU times are the plain versions', no device metric)."""
    csr = t_gen.mixed_structure(1024, 1024, seed=3)
    pts = scaling_sweep(csr, device_counts=[1, 2, 4], verbose=False,
                        devices=CPU8, reps=2, iters=3)
    assert [p.n_devices for p in pts] == [1, 2, 4]
    assert all(p.ms > 0 and p.gflops > 0 and p.eager_ms > 0 for p in pts)
    assert abs(pts[0].efficiency - 1.0) < 1e-9
    assert pts[2].efficiency == pytest.approx(
        pts[0].ms / pts[2].ms / 4, rel=1e-9)
