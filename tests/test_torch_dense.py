"""The dense class as the H100 kernel (dense.cu) walks it, on the CPU,
on a matrix whose dense class holds a chunk with one active lane, a
chunk with all T and tiles with zero columns (test_torch_cuda's
dense_edges_csr), in f32 and f64: the port's plan bit-equal to the
reference's, with its derived arrays (`cmask`, `groups`) following meta
and val; dense_active_reference (the active lane groups, each tile's
nonzero columns) against dense_reference and tilespmv_tpu's Pallas dense
kernel in interpret mode, and with an Inf in x; kernels.dense_launch's
counts (also of a dense_spmm.cu launch at k); the SpMV and SpMM
wrappers' checks of the derived arrays.

Tolerances: 1e-5 * max(1, max|y|) in f32; in f64 1e-12 * max(1, max|y|)
against dense_reference (the same products added in another order) and
1e-10 * (1 + |A|·|x|) against the df64 interpret arm, which emulates
double with f32 pairs (test_torch_f64_kernels' bound)."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tilespmv_tpu.core.convert import tile_create as j_tile_create
from tilespmv_tpu.io.mmio import CSRMatrix as JCSR
from tilespmv_tpu.ops.pallas import kernels as jk
from tilespmv_tpu.ops.pallas.lane_plan import build_lane_plan as j_build
from tilespmv_tpu_torch.core.convert import tile_create
from tilespmv_tpu_torch.interop import lane_plan_from_jax
from tilespmv_tpu_torch.ops.cuda import kernels, reference
from tilespmv_tpu_torch.ops.cuda.lane_plan import (DENSE_GROUP,
                                                   build_lane_plan)

from test_torch_cuda import dense_edges_csr
from test_torch_plan import assert_same, check_dense_derived

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "f64": (np.float64, jnp.float64, torch.float64)}


def plans(dtype: str):
    """(csr, the reference's plan, the port's plan as CPU tensors)."""
    n_dt, j_dt, _ = DTYPES[dtype]
    csr = dense_edges_csr()
    jplan = j_build(j_tile_create(JCSR(csr.shape, csr.indptr, csr.indices,
                                       csr.data)), compute_dtype=j_dt)
    tplan = build_lane_plan(tile_create(csr), compute_dtype=n_dt)
    carried = lane_plan_from_jax(jplan)
    assert_same(carried, tplan)
    check_dense_derived(tplan.dense)
    check_dense_derived(carried.dense)
    return csr, jplan, reference.to_torch(tplan)


def run(fn, cls, plan, x):
    xp = reference.pad_x(plan, torch.from_numpy(x))
    return fn(cls, xp, reference.zero_y(plan, xp)).numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_edges_plan(dtype):
    """One-lane and full chunks, tiles with zero columns, no band."""
    _, _, plan = plans(dtype)
    d = plan.dense
    nact = (d.meta[:, 0] >= 0).sum(dim=1).tolist()
    assert 1 in nact and d.t_lanes in nact and plan.band is None
    assert d.t_lanes == (256 if dtype == "f32" else 128)
    masks = d.cmask[d.meta[:, 0] >= 0]
    assert (masks == 0xFFFF).any() and (masks != 0xFFFF).any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_active_reference_on_edges(dtype):
    csr, jplan, plan = plans(dtype)
    x = np.random.default_rng(5).uniform(-1, 1, csr.n)
    x = x.astype(DTYPES[dtype][0])
    got = run(reference.dense_active_reference, plan.dense, plan, x)
    plain = run(reference.dense_reference, plan.dense, plan, x)
    y2dt = jk.dense_class_call(jplan.dense, jk.x_to_panels(
        jplan, jnp.asarray(x)), jplan.n_windows, interpret=True)
    if dtype == "f64":
        assert np.max(np.abs(got - plain)) <= 1e-12 * max(
            1.0, float(np.max(np.abs(plain))))
        want = (np.asarray(y2dt[0], np.float64)
                + np.asarray(y2dt[1], np.float64)).T.reshape(-1)
        rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
        mag = np.bincount(rows, weights=np.abs(csr.data * x[csr.indices]),
                          minlength=csr.m)
        err = np.abs(got[: csr.m] - want[: csr.m]) / (1.0 + mag)
        assert float(err.max()) <= 1e-10
    else:
        want = np.asarray(y2dt).T.reshape(-1)
        for other in (plain, want):
            n = min(other.size, got.size)
            bound = 1e-5 * max(1.0, float(np.max(np.abs(other[:n]))))
            assert float(np.max(np.abs(got[:n] - other[:n]))) <= bound
    assert not np.any(got[csr.m:])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_active_reference_takes_every_product(dtype):
    """An Inf in x at column 1 of tile-column 100, a zero column of tile
    (0, 100): dense.cu's walk skips that column's values but takes every
    product, so its NaN (0 * Inf) and Inf fall where dense_reference's
    do, and the finite entries agree within the tolerances above."""
    csr, _, plan = plans(dtype)
    x = np.random.default_rng(5).uniform(-1, 1, csr.n)
    x = x.astype(DTYPES[dtype][0])
    x[100 * 16 + 1] = np.inf
    got = run(reference.dense_active_reference, plan.dense, plan, x)
    plain = run(reference.dense_reference, plan.dense, plan, x)
    assert np.isnan(plain).any() and np.isinf(plain).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(plain))
    fin = np.isfinite(plain)
    tol = 1e-12 if dtype == "f64" else 1e-5
    assert float(np.max(np.abs(got[fin] - plain[fin]))) <= tol * max(
        1.0, float(np.max(np.abs(plain[fin]))))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_launch_counts(dtype):
    """Blocks, threads, lanes and bytes of one launch, counted here lane
    by lane: a value sector (32 bytes of lanes of one (c, j, i)) is read
    wherever one of its lanes has column j."""
    _, _, plan = plans(dtype)
    d = plan.dense
    meta, cmask = d.meta.numpy(), d.cmask.numpy()
    nch, T = meta.shape[0], d.t_lanes
    vb = 8 if dtype == "f64" else 4
    per = 32 // vb
    groups = [(c, t0) for c in range(nch) for t0 in range(0, T, DENSE_GROUP)
              if (meta[c, 0, t0:t0 + DENSE_GROUP] >= 0).any()]
    active = int((meta[:, 0] >= 0).sum())
    sectors = sum(
        any(cmask[c, t] >> j & 1 for t in range(s, s + per))
        for c in range(nch) for j in range(16) for s in range(0, T, per))
    got = kernels.dense_launch(d)
    assert got == dict(
        blocks=2 * len(groups), threads=16 * DENSE_GROUP * len(groups),
        active=active, slots=nch * T, val_bytes=sectors * 16 * 32,
        bytes=(sectors * 16 * 32 + len(groups) * (1 + 3 * DENSE_GROUP) * 4
               + active * 2 * 16 * vb))
    every = kernels.dense_launch(d, table=False)
    assert every["blocks"] == 2 * nch * T // DENSE_GROUP
    assert every["val_bytes"] == got["val_bytes"]


def test_dense_wrapper_checks_the_derived_arrays():
    _, _, plan = plans("f32")
    d = plan.dense
    x = reference.pad_x(plan, torch.zeros(plan.n))
    y = reference.zero_y(plan, x)
    with pytest.raises(TypeError):
        kernels.dense_spmv(dataclasses.replace(d, groups=None), x, y)
    with pytest.raises(ValueError):
        kernels.dense_spmv(dataclasses.replace(d, cmask=d.cmask[:, :-1]),
                           x, y)
    with pytest.raises(ValueError):
        kernels.dense_spmv(dataclasses.replace(
            d, groups=d.groups.view(-1, 1)), x, y)
    with pytest.raises(TypeError):
        kernels.dense_spmv(dataclasses.replace(
            d, cmask=d.cmask.to(torch.int64)), x, y)


def test_dense_spmm_wrapper_checks_the_derived_arrays():
    """kernels.dense_spmm refuses a missing or mis-shaped `groups` or
    `cmask`, as dense_spmv does: dense_spmm.cu reads both."""
    _, _, plan = plans("f32")
    d = plan.dense
    x = reference.pad_x(plan, torch.zeros(plan.n, 4))
    y = reference.zero_y(plan, x)
    with pytest.raises(TypeError):
        kernels.dense_spmm(dataclasses.replace(d, groups=None), x, y)
    with pytest.raises(TypeError):
        kernels.dense_spmm(dataclasses.replace(d, cmask=None), x, y)
    with pytest.raises(ValueError):
        kernels.dense_spmm(dataclasses.replace(d, cmask=d.cmask[:, :-1]),
                           x, y)
    with pytest.raises(ValueError):
        kernels.dense_spmm(dataclasses.replace(
            d, groups=d.groups.view(-1, 1)), x, y)
    with pytest.raises(TypeError):
        kernels.dense_spmm(dataclasses.replace(
            d, groups=d.groups.to(torch.int64)), x, y)


@pytest.mark.parametrize("k", [2, 8, 16])
def test_dense_spmm_launch_counts(k):
    """dense_spmm.cu's launch (kernels.dense_launch at k) has dense.cu's
    grid, its value sectors and group indices, and k values in each
    active tile's x block and y rows."""
    _, _, plan = plans("f32")
    d = plan.dense
    one, got = kernels.dense_launch(d), kernels.dense_launch(d, k=k)
    active = int((d.meta[:, 0] >= 0).sum())
    assert {f: got[f] for f in got if f != "bytes"} == {
        f: one[f] for f in one if f != "bytes"}
    assert got["bytes"] - one["bytes"] == active * 2 * 16 * 4 * (k - 1)
