"""The prefix window route of the dense and W-classes: plans
tilespmv_tpu builds under its DENSE_ROUTE = "prefix", carried into the
port (interop.lane_plan_from_jax, the path plan files take), which
builds one-hot plans only. The carried f32 and bf16 plans keep the
reference's layout (lane 0 of every chunk inert, lanes sorted by tile
row, 2 * rpp boundary rows after the class's meta rows; the bf16 plan is
lane_plan.as_bf16 of the f32 one, with the native library on and off),
the reference's f64 plans route one-hot and equal the port's, the dense
class's derived arrays (cmask, groups) follow the prefix meta, and the
plain versions, which read only meta's xloc, lrow and column rows, give
the reference's interpret-mode y on the same plan. The kernel wrappers'
checks hold meta to its route's row count, so a plan whose meta stride
does not match raises before any kernel would read the wrong rows.

Bounds: f32 SpMV and SpMM (k = 2; and 8 on the dense class) within 1e-5 * max(1, max|y|)
of the reference's interpret y; bf16 y (rounded to bf16 once) within
2^-7 * |y_ref| + 1e-5 * max(1, max|y_ref|) (tests/test_torch_bf16_slice.py's
bound: one bf16 ulp either way from the order of the sums)."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.core import native as j_native
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops.pallas import lane_plan as j_lane
from tilespmv_tpu.ops.pallas.kernels import spmm_pallas, spmv_pallas
from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.core import convert as t_convert
from tilespmv_tpu_torch.core import native as t_native
from tilespmv_tpu_torch.interop import lane_plan_from_jax
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda import kernels
from tilespmv_tpu_torch.ops.cuda import lane_plan as t_lane
from tilespmv_tpu_torch.ops.cuda import reference as ref

from test_torch_bf16_slice import check_y
from test_torch_plan import assert_same, check_dense_derived

BF = jnp.bfloat16
TOL = 1e-5
# the reference's prefix test matrix (tests/test_pallas.py: a dense
# class) and a matrix whose tiles land in a W-class (W16)
MATRICES = {
    "dense": ("mixed_structure", (1024, 1024), dict(seed=16)),
    "w16": ("random_uniform", (512, 512, 0.003), dict(seed=3)),
}
DTYPES = {"float32": (np.float32, np.float32),
          "bfloat16": ("bfloat16", BF)}


def csr_of(gen, name):
    fn, args, kw = MATRICES[name]
    return getattr(gen, fn)(*args, **kw)


@pytest.fixture
def prefix(monkeypatch):
    monkeypatch.setattr(j_lane, "DENSE_ROUTE", "prefix")


def prefix_plan(name, dtype="float32"):
    """The reference's prefix plan of matrix `name` in `dtype`, carried
    into the port (with the `prefix` fixture on)."""
    return lane_plan_from_jax(j_lane.build_lane_plan(
        j_convert.tile_create(csr_of(j_gen, name)),
        compute_dtype=DTYPES[dtype][1]))


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
        monkeypatch.setattr(t_native, "get_lib", lambda: None)
    return request.param


def routed(plan):
    """The plan's dense and W-classes."""
    return [c for c in (plan.dense, *plan.sparses) if c is not None]


def check_prefix_class(c, base_rows):
    """Lane 0 of every chunk inert, the active lanes after the inert ones
    in tile-row order, and the boundary rows: rend[r] is the chunk's
    last lane of tile row <= r."""
    T = c.t_lanes
    rpp = -(-t_lane.ROW_WINDOW // T)
    meta = np.asarray(c.meta)
    assert c.route == "prefix"
    assert meta.shape[1] == base_rows + 2 * rpp
    assert meta.shape[1] == base_rows + t_lane.prefix_rows(T, "prefix")
    xloc, lrow = meta[:, t_lane.META_XLOC], meta[:, t_lane.META_LROW]
    act = xloc >= 0
    assert not act[:, 0].any()
    key = np.where(act, lrow, -1)
    assert (np.diff(key, axis=1) >= 0).all()
    rend = meta[:, base_rows:base_rows + rpp].reshape(meta.shape[0], -1)
    rend = rend[:, :t_lane.ROW_WINDOW]
    want = np.array([[int(np.flatnonzero(k <= r).max())
                      for r in range(t_lane.ROW_WINDOW)] for k in key])
    np.testing.assert_array_equal(rend, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_prefix_plan_carried_over(name, dtype, native_mode, prefix):
    carried = prefix_plan(name, dtype)
    assert routed(carried) and all(c.route == "prefix"
                                   for c in routed(carried))
    if dtype == "bfloat16":
        assert_same(carried, t_lane.as_bf16(prefix_plan(name)))
    check_dense_derived(carried.dense)
    if carried.dense is not None:
        check_prefix_class(carried.dense, t_lane.DENSE_MROWS)
    for s in carried.sparses:
        check_prefix_class(s, t_lane.sparse_meta_rows(s.width))
    if name == "w16":
        assert [s.width for s in carried.sparses] == [16]
    # the port's own plan of the matrix is one-hot
    tplan = t_lane.build_lane_plan(
        t_convert.tile_create(csr_of(t_gen, name)), compute_dtype=DTYPES[
            dtype][0])
    assert {c.route for c in routed(tplan)} == {"onehot"}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_f64_stays_onehot(name, prefix):
    jplan = j_lane.build_lane_plan(
        j_convert.tile_create(csr_of(j_gen, name)), compute_dtype=np.float64)
    tplan = t_lane.build_lane_plan(
        t_convert.tile_create(csr_of(t_gen, name)), compute_dtype=np.float64)
    assert tplan.dense is not None and not tplan.sparses
    assert jplan.dense.route == tplan.dense.route == "onehot"
    assert tplan.dense.meta.shape[1] == t_lane.DENSE_MROWS
    assert_same(lane_plan_from_jax(jplan), tplan)


def x_of(shape, seed):
    """A standard-normal x (rounded to bf16, so both dtypes read the
    same values)."""
    x = np.random.default_rng(seed).standard_normal(shape)
    return np.asarray(jnp.asarray(x, BF).astype(jnp.float32))


def check(got, want, dtype):
    got = got.float().numpy()
    if dtype == "bfloat16":
        check_y(got, want, "normal")
    else:
        err = float(np.max(np.abs(got - want)))
        assert err <= TOL * max(1.0, float(np.max(np.abs(want)))), err


# (matrix, SpMM k): SpMV and k = 2 on both matrices, k = 8 on the dense
# one (the reference's interpret W-class SpMM costs ~2 s a column)
INTERPRET_CASES = [("dense", (2, 8)), ("w16", (2,))]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,ks", INTERPRET_CASES)
def test_plain_versions_match_interpret(name, ks, dtype, prefix):
    tdt, jdt = DTYPES[dtype]
    jplan = j_lane.build_lane_plan(
        j_convert.tile_create(csr_of(j_gen, name)), compute_dtype=jdt)
    op = TileSpMV.from_plan(lane_plan_from_jax(jplan), device="cpu",
                            dtype=getattr(torch, dtype))
    assert all(c.route == "prefix" for c in routed(op.device_plan()))
    n = op.shape[1]
    before = kernels.launch_counts()
    x = x_of(n, 1)
    want = spmv_pallas(jplan, jnp.asarray(x, jdt), interpret=True)
    check(op(x), np.asarray(want.astype(jnp.float32)), dtype)
    for k in ks:
        xs = x_of((n, k), k)
        want = spmm_pallas(jplan, jnp.asarray(xs, jdt), interpret=True)
        check(op.matmat(xs), np.asarray(want.astype(jnp.float32)),
              dtype)
    assert kernels.launch_counts() == before      # plain versions only


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_wrappers_refuse_a_meta_stride_that_does_not_match(name, prefix):
    """A prefix class whose route says "onehot" (its meta rows not the
    stride that route gives) raises in every wrapper, on the CPU as on
    the card, before any kernel or plain version runs."""
    plan = ref.to_torch(prefix_plan(name))
    xp = ref.pad_x(plan, torch.zeros(plan.n))
    y = torch.zeros(max(plan.y_padded_len, plan.n_stream_windows * 1024))
    xs, ys = xp[:, None].repeat(1, 2), y[:, None].repeat(1, 2)
    pairs = ([(kernels.dense_spmv, kernels.dense_spmm)]
             if plan.dense is not None else []) + \
        [(kernels.sparse_spmv, kernels.sparse_spmm)] * len(plan.sparses)
    for cls, (spmv, spmm) in zip(routed(plan), pairs):
        spmv(cls, xp, y.clone())                  # the prefix class runs
        wrong = dataclasses.replace(cls, route="onehot")
        with pytest.raises(ValueError, match="meta"):
            spmv(wrong, xp, y.clone())
        with pytest.raises(ValueError, match="meta"):
            spmm(wrong, xs, ys.clone())
