"""Each plain PyTorch class version (tilespmv_tpu_torch/ops/cuda/
reference.py) against tilespmv_tpu's Pallas class kernel in interpret
mode, on the identical plan (carried across by lane_plan_from_jax).

Tolerance: max |torch - jax| <= 1e-5 * max(1, max|y|); the f32
summation order differs (the interpret path sums by exact cumsum and
scatter-add in its own order)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tilespmv_tpu.core.convert import tile_create
from tilespmv_tpu.io import generate
from tilespmv_tpu.ops.pallas import kernels as jk
from tilespmv_tpu.ops.pallas.lane_plan import build_lane_plan
from tilespmv_tpu_torch.interop import lane_plan_from_jax
from tilespmv_tpu_torch.ops.cuda import reference as ref

TOL = 1e-5


def close(got, want):
    err = float(np.max(np.abs(got - want)))
    bound = TOL * max(1.0, float(np.max(np.abs(want))))
    assert err <= bound, (err, bound)


def plans(csr):
    jplan = build_lane_plan(tile_create(csr))
    return jplan, ref.to_torch(lane_plan_from_jax(jplan))


def x_for(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)


def y_len(plan):
    return max(plan.y_padded_len, plan.n_stream_windows * 1024)


def run_torch(fn, cls, tplan, x):
    xp = ref.pad_x(tplan, torch.from_numpy(x))
    y = torch.zeros(y_len(tplan))
    fn(cls, xp, y)
    return y.numpy()


def window_flat(y2dt, length):
    """(16, n_windows*256) class output -> flat y rows."""
    flat = np.asarray(y2dt).T.reshape(-1)
    out = np.zeros(length, np.float32)
    out[: flat.size] = flat
    return out


MATRICES = {
    "band_c1": lambda: generate.banded(256 * 16 * 2 + 160,
                                       256 * 16 * 2 + 160, 2, seed=13),
    "band_c3": lambda: generate.get_matrix("banded_medium"),
    "dense_cb2": lambda: generate.mixed_structure(512, 512, seed=1),
    "dense_partial": lambda: generate.mixed_structure(1000, 777, seed=11),
    "w16": lambda: generate.random_uniform(512, 512, 0.003, seed=3),
    "w24": lambda: generate.mixed_structure(4096, 4096, seed=1),
    "w96": lambda: generate.block_random(2048, 2048, density=0.05,
                                         fill=0.33, seed=5),
}


@pytest.mark.parametrize("name", ["band_c1", "band_c3"])
def test_band_reference_matches_interpret(name):
    jplan, tplan = plans(MATRICES[name]())
    assert tplan.band is not None
    x = x_for(jplan.n)
    want = window_flat(jk.band_class_call(
        jplan.band, jk.x_to_panels(jplan, jnp.asarray(x)), jplan.n_windows,
        interpret=True), y_len(tplan))
    close(run_torch(ref.band_reference, tplan.band, tplan, x), want)


@pytest.mark.parametrize("name", ["dense_cb2", "dense_partial"])
def test_dense_reference_matches_interpret(name):
    jplan, tplan = plans(MATRICES[name]())
    assert tplan.dense is not None
    x = x_for(jplan.n)
    want = window_flat(jk.dense_class_call(
        jplan.dense, jk.x_to_panels(jplan, jnp.asarray(x)),
        jplan.n_windows, interpret=True), y_len(tplan))
    close(run_torch(ref.dense_reference, tplan.dense, tplan, x), want)


@pytest.mark.parametrize("name", ["dense_cb2", "dense_partial"])
def test_dense_active_reference_matches_interpret(name):
    """dense.cu's walk (the active lane groups, each tile's nonzero
    columns) against the Pallas kernel and against dense_reference."""
    jplan, tplan = plans(MATRICES[name]())
    x = x_for(jplan.n)
    want = window_flat(jk.dense_class_call(
        jplan.dense, jk.x_to_panels(jplan, jnp.asarray(x)),
        jplan.n_windows, interpret=True), y_len(tplan))
    got = run_torch(ref.dense_active_reference, tplan.dense, tplan, x)
    close(got, want)
    close(got, run_torch(ref.dense_reference, tplan.dense, tplan, x))


@pytest.mark.parametrize("name", ["w16", "w24", "w96"])
def test_sparse_reference_matches_interpret(name):
    jplan, tplan = plans(MATRICES[name]())
    assert tplan.sparses
    x = x_for(jplan.n)
    panels = jk.x_to_panels(jplan, jnp.asarray(x))
    for js, ts in zip(jplan.sparses, tplan.sparses):
        want = window_flat(jk.sparse_class_call(
            js, panels, jplan.n_windows, interpret=True), y_len(tplan))
        close(run_torch(ref.sparse_reference, ts, tplan, x), want)


@pytest.mark.parametrize("name", ["w16", "w24", "w96"])
def test_sparse_rows_reference_matches_interpret(name):
    """sparse.cu's walk (each row sums its own slots) against the Pallas
    kernel in interpret mode and against sparse_reference with a finite
    x. With an Inf in x at the column of a tile's first entry it gives
    the class's CSR product (class_coo, in float64): Inf in the rows that
    read it, no NaN. The Pallas kernel and sparse_reference take row sums
    as differences of a slot prefix over every slot (the reserved zero
    and the padding read column 0 as 0 * x), so Inf - Inf and 0 * Inf put
    NaN in rows whose CSR sum is finite (a deliberate difference,
    ROADMAP.md C)."""
    jplan, tplan = plans(MATRICES[name]())
    x = x_for(jplan.n)
    panels = jk.x_to_panels(jplan, jnp.asarray(x))
    for js, ts in zip(jplan.sparses, tplan.sparses):
        want = window_flat(jk.sparse_class_call(
            js, panels, jplan.n_windows, interpret=True), y_len(tplan))
        got = run_torch(ref.sparse_rows_reference, ts, tplan, x)
        close(got, want)
        close(got, run_torch(ref.sparse_reference, ts, tplan, x))

    js, ts = jplan.sparses[0], tplan.sparses[0]
    row, col, val = ref.class_coo(ts)
    x[col[0]] = np.inf
    golden = np.zeros(y_len(tplan))
    np.add.at(golden, row, val.astype(np.float64) * x[col])
    got = run_torch(ref.sparse_rows_reference, ts, tplan, x)
    assert np.isinf(golden).any() and not np.isnan(golden).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(golden))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(golden))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(golden))
    fin = np.isfinite(golden)
    close(got[fin], golden[fin])
    prefix = run_torch(ref.sparse_reference, ts, tplan, x)
    pallas = window_flat(jk.sparse_class_call(
        js, jk.x_to_panels(jplan, jnp.asarray(x)), jplan.n_windows,
        interpret=True), y_len(tplan))
    for spread in (prefix, pallas):
        assert np.isnan(spread[fin]).any()
