"""The band and W-class edge cases of tests/test_torch_cuda.py, on the
CPU: each matrix has the edge its card test stands for (band C = 1 with
a last window partly inside the matrix, C = 3 with lanes whose column
blocks cross an x panel; W-classes of width 16, 24 and 96 with an inert
32-lane group, tiles of W - 1 entries and tiles whose row 0, 7 or 15 is
empty) on the port's plan, which is bit-equal to the reference's, and
there the plain versions hold to tilespmv_tpu's Pallas kernels in
interpret mode: the band class with an Inf and a NaN in x too (NaN for
NaN, Inf for Inf), the W-class by sparse_rows_reference (sparse.cu's
walk) and sparse_reference, also through the wrapper on CPU tensors;
and the W-class SpMM (sparse_spmm.cu's plain version, the rows form over
X (n, k)) against the Pallas SpMM kernel, and with an Inf and a NaN in
one column of X against the class's float64 CSR product; the band SpMM
with an Inf and a NaN in one column of X against the Pallas band SpMM
kernel, and the dense SpMM's plain version (dense.cu's walk) with an Inf
at a zero column against dense_reference.

Tolerance: max |torch - jax| <= 1e-5 * max(1, max|y|) over the finite
entries (the f32 summation order differs)."""
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
from tilespmv_tpu_torch.ops.cuda.lane_plan import build_lane_plan

from test_torch_cuda import (BAND_EDGES, INF_COL, NAN_COL,
                             SPARSE_EDGE_WIDTHS, check_band_edges,
                             check_sparse_edges, dense_edges_csr,
                             sparse_edges_csr)
from test_torch_plan import assert_same
from test_torch_spmm import close_blocks, panels_k

TOL = 1e-5


def plans(csr):
    """(the reference's plan, the port's plan as CPU tensors), the port's
    bit-equal to the reference's carried across."""
    jplan = j_build(j_tile_create(JCSR(csr.shape, csr.indptr, csr.indices,
                                       csr.data)))
    tplan = build_lane_plan(tile_create(csr))
    assert_same(lane_plan_from_jax(jplan), tplan)
    return jplan, reference.to_torch(tplan)


def run(fn, cls, plan, x):
    xp = reference.pad_x(plan, torch.from_numpy(x))
    return fn(cls, xp, reference.zero_y(plan, xp)).numpy()


def flat(y2dt, length):
    """(16, n_windows*256) class output -> flat y rows."""
    out = np.zeros(length, np.float32)
    f = np.asarray(y2dt).T.reshape(-1)
    out[: f.size] = f
    return out


def agree(got, want):
    """NaN for NaN, Inf for Inf (sign included), finite within TOL."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    err = float(np.max(np.abs(got[fin] - want[fin])))
    assert err <= TOL * max(1.0, float(np.max(np.abs(want[fin])))), err


@pytest.mark.parametrize("name", sorted(BAND_EDGES))
def test_band_edges_match_interpret(name):
    csr = BAND_EDGES[name]()
    jplan, plan = plans(csr)
    check_band_edges(name, plan)
    x = np.random.default_rng(6).uniform(-1, 1, csr.n).astype(np.float32)
    xb = x.copy()
    xb[INF_COL], xb[NAN_COL] = np.inf, np.nan
    for xh in (x, xb):
        got = run(reference.band_reference, plan.band, plan, xh)
        assert np.isfinite(got).all() == (xh is x)
        want = flat(jk.band_class_call(
            jplan.band, jk.x_to_panels(jplan, jnp.asarray(xh)),
            jplan.n_windows, interpret=True), got.size)
        agree(got, want)


@pytest.mark.parametrize("width", SPARSE_EDGE_WIDTHS)
def test_sparse_edges_match_interpret(width):
    csr = sparse_edges_csr(width)
    jplan, plan = plans(csr)
    s = check_sparse_edges(width, plan)
    x = np.random.default_rng(7).uniform(-1, 1, csr.n).astype(np.float32)
    got = run(reference.sparse_rows_reference, s, plan, x)
    want = flat(jk.sparse_class_call(
        jplan.sparses[0], jk.x_to_panels(jplan, jnp.asarray(x)),
        jplan.n_windows, interpret=True), got.size)
    agree(got, want)
    agree(got, run(reference.sparse_reference, s, plan, x))
    # the wrapper runs sparse.cu's plain version on CPU tensors
    before = kernels.launch_counts()
    np.testing.assert_array_equal(run(kernels.sparse_spmv, s, plan, x), got)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("width", SPARSE_EDGE_WIDTHS)
def test_sparse_spmm_edges_match_interpret(width):
    """test_sparse_spmm_kernel_edges on the CPU: sparse_rows_reference on
    X (n, 3) against sparse_spmm_call in interpret mode; with +Inf and
    NaN in X column 1 (at the columns of two tiles' first entries), NaN
    for NaN and Inf for Inf against the class's CSR product in float64
    (reference.class_coo), the other columns finite; the wrapper on CPU
    tensors runs the same plain version."""
    csr = sparse_edges_csr(width)
    jplan, plan = plans(csr)
    s = check_sparse_edges(width, plan)
    k = 3
    x = np.random.default_rng(8).uniform(-1, 1, (csr.n, k)).astype(
        np.float32)
    got = run(reference.sparse_rows_reference, s, plan, x)
    close_blocks(got, np.asarray(jk.sparse_spmm_call(
        jplan.sparses[0], panels_k(jplan, x), jplan.n_windows, k,
        interpret=True)))
    row, col, val = reference.class_coo(s)
    xb = x.copy()
    xb[col[0], 1], xb[col[-1], 1] = np.inf, np.nan
    got = run(reference.sparse_rows_reference, s, plan, xb)
    gold = np.zeros(got.shape)
    np.add.at(gold, row, val[:, None] * xb[col].astype(np.float64))
    assert np.isnan(gold[:, 1]).any() and np.isinf(gold[:, 1]).any()
    assert np.isfinite(gold[:, [0, 2]]).all()
    agree(got.ravel(), gold.ravel())
    before = kernels.launch_counts()
    np.testing.assert_array_equal(run(kernels.sparse_spmm, s, plan, xb),
                                  got)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("name", sorted(BAND_EDGES))
def test_band_spmm_edges_match_interpret(name):
    """band_spmm.cu's plain version (band_spmm_reference) on X (n, 3)
    with +Inf and NaN in column 1 against band_spmm_call in interpret
    mode: NaN for NaN and Inf for Inf in that column (every product is
    taken, zeros included), the other columns finite; the wrapper on CPU
    tensors runs the same plain version."""
    csr = BAND_EDGES[name]()
    jplan, plan = plans(csr)
    check_band_edges(name, plan)
    k = 3
    x = np.random.default_rng(9).uniform(-1, 1, (csr.n, k)).astype(
        np.float32)
    x[INF_COL, 1], x[NAN_COL, 1] = np.inf, np.nan
    got = run(reference.band_spmm_reference, plan.band, plan, x)
    assert np.isfinite(got[:, [0, 2]]).all()
    assert np.isnan(got[:, 1]).any() and np.isinf(got[:, 1]).any()
    want = np.asarray(jk.band_spmm_call(jplan.band, panels_k(jplan, x),
                                        jplan.n_windows, k, interpret=True))
    for r in range(k):
        agree(got[:, r], flat(want[16 * r: 16 * r + 16], got.shape[0]))
    before = kernels.launch_counts()
    np.testing.assert_array_equal(run(kernels.band_spmm, plan.band, plan, x),
                                  got)
    assert kernels.launch_counts() == before


def test_dense_spmm_edges_take_every_product():
    """dense_spmm.cu's plain version (dense_active_reference: the active
    lane groups, each tile's nonzero columns) on X (n, 3) with +Inf in
    column 1 at column 1 of tile-column 100, a zero column of tile
    (0, 100) (test_torch_cuda.dense_edges_csr): NaN for NaN (0 * Inf)
    and Inf for Inf as dense_reference, which takes every column, the
    other columns finite and within TOL; the wrapper on CPU tensors runs
    the same plain version."""
    csr = dense_edges_csr()
    _, plan = plans(csr)
    k = 3
    x = np.random.default_rng(10).uniform(-1, 1, (csr.n, k)).astype(
        np.float32)
    x[100 * 16 + 1, 1] = np.inf
    got = run(reference.dense_active_reference, plan.dense, plan, x)
    want = run(reference.dense_reference, plan.dense, plan, x)
    assert np.isfinite(want[:, [0, 2]]).all()
    assert np.isnan(want[:, 1]).any() and np.isinf(want[:, 1]).any()
    agree(got.ravel(), want.ravel())
    before = kernels.launch_counts()
    np.testing.assert_array_equal(
        run(kernels.dense_spmm, plan.dense, plan, x), got)
    assert kernels.launch_counts() == before
