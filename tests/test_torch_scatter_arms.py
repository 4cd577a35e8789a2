"""The stream class's offs and roll scatter encodings: plans tilespmv_tpu
builds under its STREAM_SCATTER, carried into the port
(interop.lane_plan_from_jax, the path plan files take), which builds
rounds planes only. Every carried class has its encoding's planes and the
`erow` of the port's own rounds plan, bit for bit, and every other array
of that plan (the encodings route the same entries; f32 and f64, the
native library on and off); the plain versions, which read `erow`, give
the reference's interpret-mode y on the same plan (f32) and the float64
golden (f64, whose reference y is double-f32 emulation).

Bounds: f32 SpMV and SpMM (k in {2, 8}) within 1e-5 * max(1, max|y|) of
the reference's interpret y (different f32 summation order); f64 within
1e-12 * (1 + |A|·|x|) of the float64 golden
(tests/test_torch_f64_slice.py's bound)."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.core import native as j_native
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops.pallas import lane_plan as j_lane
from tilespmv_tpu.ops.pallas import stream_plan as j_stream
from tilespmv_tpu.ops.pallas.kernels import spmm_pallas, spmv_pallas
from tilespmv_tpu_torch import TileSpMV
from tilespmv_tpu_torch.core import convert as t_convert
from tilespmv_tpu_torch.core import native as t_native
from tilespmv_tpu_torch.interop import (lane_plan_from_jax,
                                        stream_chunks_from_jax)
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda import kernels
from tilespmv_tpu_torch.ops.cuda import lane_plan as t_lane
from tilespmv_tpu_torch.ops.cuda import stream_plan as t_stream

from test_torch_plan import STREAM_CASES, _skewed, assert_same

ARMS = ("offs", "roll")
TOL = 1e-5
# the reference's own test matrix of the encodings (tests/test_stream.py)
MATRIX = ("power_law", (2048, 2048, 10), dict(seed=6))


def matrix(gen):
    fn, args, kw = MATRIX
    return getattr(gen, fn)(*args, **kw)


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
        monkeypatch.setattr(t_native, "get_lib", lambda: None)
    return request.param


def set_scatter(monkeypatch, arm):
    monkeypatch.setattr(j_stream, "STREAM_SCATTER", arm)


def streams(plan):
    return [s for s in (plan.stream, plan.stream2) if s is not None]


def check_arm_class(st, rounds_st, arm):
    """`st` has arm's planes (slab rows a step), and otherwise the rounds
    class's arrays, erow included, bit for bit."""
    assert st.scatter == arm and rounds_st.scatter == "rounds"
    assert st.planes.shape == (st.cw.shape[0],
                               t_stream.scatter_slab_rows(arm) * st.s_batch,
                               t_stream.LANES)
    assert st.planes.shape[1] == t_stream.step_rows(arm, st.rounds,
                                                    st.s_batch)
    assert st.erow.dtype == rounds_st.erow.dtype == np.int16
    np.testing.assert_array_equal(st.erow, rounds_st.erow)
    assert_same(dataclasses.replace(st, planes=rounds_st.planes,
                                    scatter="rounds",
                                    rounds_=rounds_st.rounds_), rounds_st)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("arm", ARMS)
def test_lane_plan_carried_over_and_erow_is_the_rounds_one(
        arm, dtype, native_mode, monkeypatch):
    rounds_plan = t_lane.build_lane_plan(
        t_convert.tile_create(matrix(t_gen)), compute_dtype=dtype)
    set_scatter(monkeypatch, arm)
    jplan = j_lane.build_lane_plan(j_convert.tile_create(matrix(j_gen)),
                                   compute_dtype=dtype)
    carried = lane_plan_from_jax(jplan)
    assert streams(carried) and all(s.scatter == arm
                                    for s in streams(carried))
    for st, r in zip(streams(carried), streams(rounds_plan)):
        check_arm_class(st, r, arm)
    assert_same(dataclasses.replace(carried, stream=rounds_plan.stream,
                                    stream2=rounds_plan.stream2),
                rounds_plan)
    # only the planes differ (a rounds plan holds 4 or 8 rounds of 24
    # rows a slab, offs 96 rows, roll 128)
    assert (carried.bytes_accessed() - rounds_plan.bytes_accessed()
            == sum(a.planes.nbytes - b.planes.nbytes for a, b in zip(
                streams(carried), streams(rounds_plan))))


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
@pytest.mark.parametrize("arm", ARMS)
def test_stream_chunks_carried_over(arm, case, native_mode, monkeypatch):
    make_entries, kw = STREAM_CASES[case]
    row, col, val, m = make_entries()
    rounds_st = t_stream.build_stream_chunks(row, col, val, m, **kw)
    set_scatter(monkeypatch, arm)
    jst, _ = j_stream.build_stream_chunks(row, col, val, m, **kw)
    check_arm_class(stream_chunks_from_jax(jst), rounds_st, arm)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("arm", ARMS)
def test_stream_split_carried_over(arm, dual, dtype, monkeypatch):
    row, col, val, m = _skewed()
    rounds = t_stream.build_stream_classes(row, col, val, m, span_rows=64,
                                           dual=dual, compute_dtype=dtype)
    set_scatter(monkeypatch, arm)
    (jb, jh), _ = j_stream.build_stream_classes(
        row, col, val, m, span_rows=64, dual=dual, compute_dtype=dtype)
    assert jh is not None, "the skewed population must split"
    for st, r in zip((jb, jh), rounds):
        check_arm_class(stream_chunks_from_jax(st), r, arm)


def test_step_rows_refuses_an_unknown_encoding():
    with pytest.raises(ValueError, match="scatter"):
        t_stream.step_rows("ring", 8, 4)


@pytest.mark.parametrize("arm", ARMS)
def test_plain_versions_match_interpret(arm, monkeypatch):
    set_scatter(monkeypatch, arm)
    jplan = j_lane.build_lane_plan(j_convert.tile_create(matrix(j_gen)))
    op = TileSpMV.from_plan(lane_plan_from_jax(jplan), device="cpu")
    assert op.device_plan().stream.scatter == arm
    n = op.shape[1]
    rng = np.random.default_rng(3)
    before = kernels.launch_counts()
    x = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(spmv_pallas(jplan, jnp.asarray(x), interpret=True))
    got = op(x).numpy()
    assert float(np.max(np.abs(got - want))) <= TOL * max(
        1.0, float(np.max(np.abs(want))))
    for k in (2, 8):
        xs = rng.standard_normal((n, k)).astype(np.float32)
        want = np.asarray(spmm_pallas(jplan, jnp.asarray(xs),
                                      interpret=True))
        got = op.matmat(xs).numpy()
        assert float(np.max(np.abs(got - want))) <= TOL * max(
            1.0, float(np.max(np.abs(want)))), k
    assert kernels.launch_counts() == before      # plain versions only


@pytest.mark.parametrize("arm", ARMS)
def test_f64_plain_versions_match_reference_and_golden(arm, monkeypatch):
    set_scatter(monkeypatch, arm)
    csr = matrix(t_gen)
    jplan = j_lane.build_lane_plan(j_convert.tile_create(matrix(j_gen)),
                                   compute_dtype=np.float64)
    x = np.random.default_rng(4).standard_normal(csr.n)
    op = TileSpMV.from_plan(lane_plan_from_jax(jplan), device="cpu",
                            dtype=torch.float64)
    assert all(s.scatter == arm for s in streams(op.device_plan()))
    y = op(x).numpy()
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    prod = csr.data * x[csr.indices]
    gold = np.bincount(rows, weights=prod, minlength=csr.m)
    mag = np.bincount(rows, weights=np.abs(prod), minlength=csr.m)
    assert float(np.max(np.abs(y - gold) / (1 + mag))) <= 1e-12
