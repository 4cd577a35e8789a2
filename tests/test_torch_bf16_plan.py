"""The port's bf16 plan (build_lane_plan(tm, compute_dtype=BF16)) against
tilespmv_tpu's bf16 plan (compute_dtype=jnp.bfloat16), with the native
library on and off: every array bit-equal, the value arrays compared as
their uint16 bit patterns (the port holds bf16 values as those, NumPy
having no bfloat16), on every archetype of tests/test_torch_plan.py; each
index and control array equal to the port's own f32 plan's; the stream
builders at every geometry; the rounding f64 -> bf16 pinned against
ml_dtypes and torch."""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.core import native as j_native
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.ops.pallas import lane_plan as j_lane
from tilespmv_tpu.ops.pallas import stream_plan as j_stream
from tilespmv_tpu_torch.core import convert as t_convert
from tilespmv_tpu_torch.core import native as t_native
from tilespmv_tpu_torch.interop import (lane_plan_from_jax,
                                        stream_chunks_from_jax)
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.ops.cuda import lane_plan as t_lane
from tilespmv_tpu_torch.ops.cuda import reference
from tilespmv_tpu_torch.ops.cuda import stream_plan as t_stream

from test_torch_plan import (CASES, STREAM_CASES, _skewed, assert_same,
                             check_dense_derived, make)

BF16 = t_stream.BF16
BITS = t_stream.BF16_BITS


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
        monkeypatch.setattr(t_native, "get_lib", lambda: None)
    return request.param


def value_classes(plan):
    return [c for c in (plan.dense, plan.band, *plan.sparses, plan.stream,
                        plan.stream2, plan.residual) if c is not None]


def assert_same_but_values(a, b, path="plan"):
    """Every array of the plans equal but each class's `val`; the
    classes' static fields equal."""
    def novals(p):
        return t_lane.map_arrays(
            p, lambda n, v: None if n.endswith("_val") else v)
    assert_same(novals(a), novals(b), path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_lane_plan_matches_reference(name, native_mode):
    jplan = j_lane.build_lane_plan(j_convert.tile_create(make(j_gen, name)),
                                   compute_dtype=jnp.bfloat16)
    ttm = t_convert.tile_create(make(t_gen, name))
    tplan = t_lane.build_lane_plan(ttm, compute_dtype=BF16)
    assert tplan.dtype == torch.bfloat16
    assert tplan.summary()["dtype"] == "bfloat16"
    for cls in value_classes(tplan):
        assert cls.val.dtype == BITS
    carried = lane_plan_from_jax(jplan)
    assert carried.dtype == torch.bfloat16
    assert_same(carried, tplan)
    check_dense_derived(tplan.dense)
    # the f32 plan's routing, indices and layout; its values rounded
    p32 = t_lane.build_lane_plan(ttm)
    assert_same_but_values(tplan, p32)
    for c16, c32 in zip(value_classes(tplan), value_classes(p32)):
        np.testing.assert_array_equal(c16.val, t_stream.bf16_bits(c32.val))


def test_bf16_plan_takes_the_reference_dtype_by_name():
    ttm = t_convert.tile_create(t_gen.mixed_structure(512, 512, seed=1))
    want = t_lane.build_lane_plan(ttm, compute_dtype=BF16)
    assert_same(t_lane.build_lane_plan(
        ttm, compute_dtype=jnp.dtype(jnp.bfloat16)), want)


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_bf16_stream_chunks_match_reference(case, native_mode):
    make_entries, kw = STREAM_CASES[case]
    row, col, val, m = make_entries()
    jst, _ = j_stream.build_stream_chunks(row, col, val, m,
                                          compute_dtype=jnp.bfloat16, **kw)
    tst = t_stream.bf16_values(
        t_stream.build_stream_chunks(row, col, val, m, **kw))
    assert tst.val.dtype == BITS
    assert_same(stream_chunks_from_jax(jst), tst, case)


@pytest.mark.parametrize("dual", [False, True])
def test_bf16_stream_split_matches_reference(dual, native_mode):
    row, col, val, m = _skewed()
    (jb, jh), _ = j_stream.build_stream_classes(
        row, col, val, m, compute_dtype=jnp.bfloat16, span_rows=64,
        dual=dual)
    tb, th = map(t_stream.bf16_values, t_stream.build_stream_classes(
        row, col, val, m, span_rows=64, dual=dual))
    assert th is not None, "the skewed population must split"
    assert_same(stream_chunks_from_jax(jb), tb, "base")
    assert_same(stream_chunks_from_jax(jh), th, "heavy")


def test_bf16_bits_rounds_as_the_reference():
    """1.2M float64 values: normal and wide-range ones, values near the
    halfway points between bf16 neighbours (where rounding through f32
    first can differ from one rounding), ties, bf16 and f32 denormals,
    the largest finite values and Inf / NaN."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal(200_000) * 10.0 ** rng.integers(-30, 30,
                                                              200_000)
    mids = (np.arange(1 << 16, dtype=np.uint32) << 16 | 0x8000).view(
        np.float32).astype(np.float64)
    mids = mids[np.isfinite(mids)]
    near = np.concatenate([mids, np.nextafter(mids, np.inf),
                           np.nextafter(mids, -np.inf),
                           mids * (1 + 2.0 ** -40), mids * (1 - 2.0 ** -40)])
    tiny = rng.uniform(-1, 1, 100_000) * 2.0 ** -130
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                        3.3895313892515355e38, 3.4e38, -3.4e38, 1e39,
                        2.0 ** -133, 2.0 ** -149, 2.0 ** -150])
    v = np.concatenate([base, near, tiny, special,
                        rng.standard_normal(1_200_000 - base.size
                                            - near.size - tiny.size
                                            - special.size)])
    assert v.size == 1_200_000
    with np.errstate(over="ignore", invalid="ignore"):
        got = t_stream.bf16_bits(v)
        want = v.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert got.dtype == BITS
    np.testing.assert_array_equal(got, want)
    # torch agrees but on the sign of NaN (it drops it; no plan holds NaN)
    num = ~np.isnan(v)
    np.testing.assert_array_equal(
        got[num], torch.from_numpy(v[num]).to(torch.bfloat16)
        .view(torch.int16).numpy().view(np.uint16))
    # bf16 values map to themselves
    np.testing.assert_array_equal(
        t_stream.bf16_bits(want.view(ml_dtypes.bfloat16).astype(np.float64)),
        want)


def test_bf16_plan_bytes_and_tensors():
    tm = t_convert.tile_create(t_gen.banded(2048, 2048, 8, seed=3))
    p32 = t_lane.build_lane_plan(tm)
    p16 = t_lane.build_lane_plan(tm, compute_dtype=BF16)
    band_bytes = p16.band.val.nbytes
    assert 2 * band_bytes == p32.band.val.nbytes
    # x and y stay float32: only the values halve
    assert p32.bytes_accessed() - p16.bytes_accessed() == band_bytes
    assert dataclasses.replace(p16).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        t_lane.build_lane_plan(tm, compute_dtype=np.float16)
    tp = reference.to_torch(p16)
    assert tp.dtype == torch.bfloat16
    assert tp.band.val.dtype == torch.bfloat16 and tp.band.bloc.dtype == \
        torch.int32
    np.testing.assert_array_equal(
        tp.band.val.view(torch.int16).numpy().view(np.uint16), p16.band.val)
    np.testing.assert_array_equal(tp.band.val.float().numpy(),
                                  p16.band.val.view(ml_dtypes.bfloat16)
                                  .astype(np.float32))


def test_value_dtype_reads_every_form_of_bf16_values():
    """One answer for a bf16 value array however it is held: bits,
    the reference's NumPy bfloat16, the 2-byte void items of a loaded
    plan file, a tensor; every other dtype as its torch dtype."""
    bits = t_stream.bf16_bits(np.array([1.5, -2.0, 0.0]))
    for a in (bits, bits.view(ml_dtypes.bfloat16), bits.view("V2"),
              reference.plan_tensor(bits)):
        assert t_lane.value_dtype(a) == torch.bfloat16
    for dt in (np.float32, np.float64, np.int32):
        assert t_lane.value_dtype(np.zeros(2, dt)) == torch.from_numpy(
            np.zeros(0, dt)).dtype
    assert t_stream.is_bf16(torch.bfloat16) and t_stream.is_bf16(BF16)
    assert not t_stream.is_bf16(torch.float32)
    assert t_lane.acc_dtype(torch.bfloat16) == torch.float32
    assert t_lane.acc_dtype(torch.float64) == torch.float64


@pytest.mark.parametrize("k", [1, 2])
def test_bf16_bound_reads_x_and_y_in_f32(k):
    """The hand-counted class of test_torch_yardstick in bf16: its
    values 2 B each, but x and y the kernels' float32 and the FLOP/s
    peak float32's: 4 * (2 + 4) + 4 * (3 + 1) + 4 * (3 + 3) * k B."""
    from tilespmv_tpu_torch.utils import profiling
    st = t_stream.bf16_values(t_stream.build_stream_chunks(
        np.array([0, 0, 5, 9]), np.array([3, 7, 3, 100]),
        np.array([1.0, -2.0, 0.5, 3.0]), 128, span_rows=64, dual=False))
    got = profiling.class_bound([st], k=k)
    assert got["bytes"] == 40 + 24 * k and got["flops"] == 8 * k
    assert got == profiling.csr_bound(4, 3, 3, 2, k, xbytes=4)
    assert got["bound_ms"] == pytest.approx((40 + 24 * k) / 3.35e12 * 1e3)
