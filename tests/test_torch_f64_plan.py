"""The port's f64 plan (build_lane_plan(tm, compute_dtype=np.float64))
against tilespmv_tpu's double-f32 plan, with the native library on and
off: every index and control array bit-equal, every value array equal
to the reference's f32 parts summed in float64 (lane_plan_from_jax
carries them across), on the matrices that reach each f64 routing
branch; the dense class's derived arrays follow its meta and values."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.core import native as j_native
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.io.mmio import CSRMatrix as JCSR
from tilespmv_tpu.ops.pallas import lane_plan as j_lane
from tilespmv_tpu.ops.pallas import stream_plan as j_stream
from tilespmv_tpu_torch.core import convert as t_convert
from tilespmv_tpu_torch.core import native as t_native
from tilespmv_tpu_torch.interop import (lane_plan_from_jax,
                                        stream_chunks_from_jax)
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.io.mmio import CSRMatrix as TCSR
from tilespmv_tpu_torch.ops.cuda import lane_plan as t_lane
from tilespmv_tpu_torch.ops.cuda import stream_plan as t_stream

from test_torch_plan import (STREAM_CASES, _skewed, assert_same,
                             check_dense_derived)

# (generator, args, kwargs, what the f64 plan must contain)
CASES = {
    "banded": ("banded", (2048, 2048, 8), dict(seed=3), ("band",)),
    "powerlaw": ("power_law", (4096, 4096, 12), dict(seed=3), ("stream",)),
    "mixed_xmap": ("mixed_structure", (512, 512), dict(seed=7),
                   ("dense", "xmap")),
    "mixed_deep": ("mixed_structure", (4096, 4096), dict(seed=1),
                   ("dense", "t256", "stream")),
    "dense_blocks": ("dense_blocks", (1024, 1024),
                     dict(num_blocks=24, seed=5), ("band", "xmap")),
    # seeded normal values: not representable in f32, so the value
    # arrays carry a nonzero lo part
    "normal_values": ("mixed_structure", (1024, 1024), dict(seed=5),
                      ("dense", "lo")),
}


def make(gen, csr_cls, name):
    fn, args, kw, _ = CASES[name]
    csr = getattr(gen, fn)(*args, **kw)
    if name == "normal_values":
        data = np.random.default_rng(0).standard_normal(csr.nnz)
        csr = csr_cls(csr.shape, csr.indptr, csr.indices, data)
    return csr


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
        monkeypatch.setattr(t_native, "get_lib", lambda: None)
    return request.param


@pytest.mark.parametrize("name", sorted(CASES))
def test_f64_lane_plan_matches_reference(name, native_mode):
    with jax.enable_x64(True):
        jplan = j_lane.build_lane_plan(
            j_convert.tile_create(make(j_gen, JCSR, name)),
            compute_dtype=np.float64)
    tplan = t_lane.build_lane_plan(
        t_convert.tile_create(make(t_gen, TCSR, name)),
        compute_dtype=np.float64)
    assert not tplan.sparses
    assert tplan.dtype == torch.float64
    for cls in (tplan.dense, tplan.band, tplan.stream, tplan.stream2):
        if cls is not None:
            assert cls.val.dtype == np.float64
    carried = lane_plan_from_jax(jplan)
    assert_same(carried, tplan)
    check_dense_derived(tplan.dense)
    check_dense_derived(carried.dense)

    streams = [s for s in (tplan.stream, tplan.stream2) if s is not None]
    for want in CASES[name][3]:
        if want == "band":
            assert jplan.band.df64 and tplan.band is not None
        elif want == "dense":
            assert jplan.dense.df64 and tplan.dense is not None
        elif want == "t256":
            assert tplan.dense.t_lanes == 256
        elif want == "stream":
            assert streams and jplan.stream.df64
        elif want == "xmap":
            assert any(s.xmap is not None for s in streams)
        elif want == "lo":
            v = tplan.dense.val
            assert np.any(v != v.astype(np.float32))


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_f64_stream_chunks_match_reference(case, native_mode):
    make_entries, kw = STREAM_CASES[case]
    row, col, val, m = make_entries()
    with jax.enable_x64(True):
        jst, _ = j_stream.build_stream_chunks(row, col, val, m,
                                              compute_dtype=np.float64, **kw)
    tst = t_stream.build_stream_chunks(row, col, val, m,
                                       compute_dtype=np.float64, **kw)
    assert jst.df64 and tst.val.dtype == np.float64
    assert_same(stream_chunks_from_jax(jst), tst, case)


@pytest.mark.parametrize("dual", [False, True])
def test_f64_stream_split_matches_reference(dual, native_mode):
    row, col, val, m = _skewed()
    with jax.enable_x64(True):
        (jb, jh), _ = j_stream.build_stream_classes(
            row, col, val, m, compute_dtype=np.float64, span_rows=64,
            dual=dual)
    tb, th = t_stream.build_stream_classes(row, col, val, m, span_rows=64,
                                           dual=dual,
                                           compute_dtype=np.float64)
    assert th is not None, "the skewed population must split"
    assert_same(stream_chunks_from_jax(jb), tb, "base")
    assert_same(stream_chunks_from_jax(jh), th, "heavy")


def test_f64_plan_value_is_the_reference_pair():
    v = np.random.default_rng(3).standard_normal(1000) * 10.0 ** \
        np.random.default_rng(4).integers(-12, 12, 1000)
    got = t_stream.f64_plan_value(v)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, hi.astype(np.float64) + lo)
    assert np.max(np.abs(got - v) / np.abs(v)) < 2.0 ** -46
    # sums of the reference's dense Dekker parts give the same value
    a1, a2, vl = j_lane.df64_split(v)
    np.testing.assert_array_equal(
        a1.astype(np.float64) + a2.astype(np.float64)
        + vl.astype(np.float64), got)


def test_f64_plan_bytes_and_summary():
    tm = t_convert.tile_create(t_gen.banded(2048, 2048, 8, seed=3))
    p32 = t_lane.build_lane_plan(tm)
    p64 = t_lane.build_lane_plan(tm, compute_dtype=np.float64)
    s = p64.summary()
    assert s["dtype"] == "float64" and p32.summary()["dtype"] == "float32"
    band_bytes = p64.band.val.nbytes
    assert band_bytes == 2 * p32.band.val.nbytes
    assert p64.bytes_accessed() - p32.bytes_accessed() == (
        band_bytes // 2 + (p64.x_padded_len + p64.m) * 4)
    with pytest.raises(ValueError):
        t_lane.build_lane_plan(tm, compute_dtype=np.float16)
    assert dataclasses.replace(p64).dtype == torch.float64
