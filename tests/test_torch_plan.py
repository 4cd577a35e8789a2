"""The port's NumPy host side (tilespmv_tpu_torch) against tilespmv_tpu:
tile_create and build_lane_plan must produce bit-equal arrays, with the
native library on and off, and the stream builders every geometry
(mono, dual, free placement, two-rate split)."""
import dataclasses

import numpy as np
import pytest

from tilespmv_tpu.core import convert as j_convert
from tilespmv_tpu.core import native as j_native
from tilespmv_tpu.io import generate as j_gen
from tilespmv_tpu.io import mmio as j_mmio
from tilespmv_tpu.ops.pallas import lane_plan as j_lane
from tilespmv_tpu.ops.pallas import stream_plan as j_stream
from tilespmv_tpu_torch.core import convert as t_convert
from tilespmv_tpu_torch.core import native as t_native
from tilespmv_tpu_torch.io import generate as t_gen
from tilespmv_tpu_torch.io import mmio as t_mmio
from tilespmv_tpu_torch.interop import (lane_plan_from_jax,
                                        stream_chunks_from_jax)
from tilespmv_tpu_torch.ops.cuda import lane_plan as t_lane
from tilespmv_tpu_torch.ops.cuda import stream_plan as t_stream

# tests/test_pallas.py's archetypes plus its partial-tile and
# row-window-boundary matrices, by generator call (same seeds), and a
# block matrix whose tiles land in the W96 class
CASES = {
    "mixed": ("mixed_structure", (512, 512), dict(seed=1)),
    "banded": ("banded", (600, 600, 5), dict(seed=2)),
    "uniform": ("random_uniform", (512, 512, 0.003), dict(seed=3)),
    "powerlaw": ("power_law", (512, 512, 10), dict(seed=4)),
    "ell": ("ell_regular", (512, 512, 6), dict(seed=5)),
    "dense_blocks": ("dense_blocks", (512, 512), dict(num_blocks=96,
                                                      seed=6)),
    "full_rows": ("full_rows", (512, 512), dict(num_rows=4, seed=7)),
    "full_cols": ("full_cols", (512, 512), dict(num_cols=4, seed=8)),
    "partial_tiles": ("mixed_structure", (1000, 777), dict(seed=11)),
    "row_windows": ("banded", (256 * 16 * 2 + 160,) * 2 + (2,),
                    dict(seed=13)),
    "wide_w_class": ("block_random", (2048, 2048),
                     dict(density=0.05, fill=0.33, seed=5)),
}


def make(gen, name):
    fn, args, kw = CASES[name]
    return getattr(gen, fn)(*args, **kw)


def assert_same(a, b, path="plan"):
    """Field-by-field equality: arrays bit-equal (dtype, shape, values),
    static fields equal."""
    if b is None:
        assert a is None, path
        return
    if dataclasses.is_dataclass(b):
        for f in dataclasses.fields(b):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(b, tuple):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            assert_same(u, v, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    """Both packages with the native library (if it builds) or with
    their NumPy reference paths."""
    if request.param == "numpy":
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
        monkeypatch.setattr(t_native, "get_lib", lambda: None)
    return request.param


@pytest.mark.parametrize("name", sorted(CASES))
def test_lane_plan_bit_equal(name, native_mode):
    jtm = j_convert.tile_create(make(j_gen, name))
    ttm = t_convert.tile_create(make(t_gen, name))
    for f in ("tile_ptr", "tile_rowidx", "tile_columnidx", "tile_nnz",
              "fmt"):
        np.testing.assert_array_equal(getattr(ttm, f), getattr(jtm, f))
    for bucket in ("csr", "coo", "ell", "hyb", "dns", "dnsrow", "dnscol"):
        assert_same(getattr(jtm, bucket), getattr(ttm, bucket), bucket)
    jplan = j_lane.build_lane_plan(jtm)
    tplan = t_lane.build_lane_plan(ttm)
    assert_same(lane_plan_from_jax(jplan), tplan)


def _entries(seed, m, n, nnz, heavy_rows=0):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, m, nnz).astype(np.int64)
    col = rng.integers(0, n, nnz).astype(np.int64)
    if heavy_rows:
        row[: nnz // 3] = rng.integers(0, heavy_rows, nnz // 3)
    _, ix = np.unique(row * n + col, return_index=True)
    return row[ix], col[ix], rng.standard_normal(ix.size), m


# (label, entries, builder kwargs): mono/dual at fixed geometry, the
# cost-model pick, a wide span, and free placement
STREAM_CASES = {
    "mono": (lambda: _entries(1, 4096, 4096, 30000, heavy_rows=3),
             dict(span_rows=64, dual=False)),
    "dual": (lambda: _entries(11, 16384, 16384, 100_000),
             dict(span_rows=64, dual=True)),
    "picked": (lambda: _entries(2, 2048, 2048, 5000), {}),
    "wide_span": (lambda: _entries(3, 65536, 65536, 20000),
                  dict(span_rows=256, dual=False)),
    "free_placement": (lambda: _entries(4, 65536, 65536, 4000),
                       dict(fp=True)),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_chunks_bit_equal(case, native_mode):
    make_entries, kw = STREAM_CASES[case]
    row, col, val, m = make_entries()
    jst, _ = j_stream.build_stream_chunks(row, col, val, m, **kw)
    tst = t_stream.build_stream_chunks(row, col, val, m, **kw)
    if case == "dual":
        assert tst.dual and tst.sbase2 is not None
    if case == "free_placement":
        assert tst.xmap is not None
    assert_same(stream_chunks_from_jax(jst), tst, case)


def _skewed(seed=7, n_windows=24):
    """Two heavy windows and many light ones: the population the
    two-rate (base, heavy) split exists for (tests/test_stream.py)."""
    rng = np.random.default_rng(seed)
    m = n = n_windows * 1024
    rows, cols = [], []
    for w in range(n_windows):
        k = 40000 if w < 2 else 8
        rows.append(rng.integers(w * 1024, (w + 1) * 1024, k))
        cols.append(rng.integers(0, n if w < 2 else 8192, k))
    key = np.unique(np.concatenate(rows).astype(np.int64) * n
                    + np.concatenate(cols))
    return key // n, key % n, rng.standard_normal(key.size), m


@pytest.mark.parametrize("dual", [False, True])
def test_stream_split_bit_equal(dual, native_mode):
    row, col, val, m = _skewed()
    (jb, jh), _ = j_stream.build_stream_classes(row, col, val, m,
                                                span_rows=64, dual=dual)
    tb, th = t_stream.build_stream_classes(row, col, val, m,
                                           span_rows=64, dual=dual)
    assert th is not None, "the skewed population must split"
    assert not set(tb.cw.tolist()) & set(th.cw.tolist())
    assert_same(stream_chunks_from_jax(jb), tb, "base")
    assert_same(stream_chunks_from_jax(jh), th, "heavy")


def test_corpus_and_mtx_match():
    assert sorted(t_gen.CORPUS) == sorted(j_gen.CORPUS)
    for name in ("mixed_small", "mixed_medium"):
        a, b = j_gen.get_matrix(name), t_gen.get_matrix(name)
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for fx in ("bcsstk_style_sym", "graph_pattern", "fields_complex"):
        path = f"tests/fixtures/{fx}.mtx"
        a, b = j_mmio.load_mtx(path), t_mmio.load_mtx(path)
        assert a.shape == b.shape
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_lane_plan_with_residual_bit_equal():
    # HYB enabled: overflow entries leave the tiles for the residual
    # (tests/test_pallas.py::test_pallas_hyb_overflow_residual's matrix)
    kw = dict(enable_hyb=True, hyb_cv_threshold=0.3, hyb_max_coo=64)
    from tilespmv_tpu.config import TileConfig as JConfig
    from tilespmv_tpu_torch.config import TileConfig as TConfig
    jtm = j_convert.tile_create(j_gen.power_law(512, 512, 20, seed=14),
                                JConfig(**kw))
    ttm = t_convert.tile_create(t_gen.power_law(512, 512, 20, seed=14),
                                TConfig(**kw))
    tplan = t_lane.build_lane_plan(ttm)
    assert tplan.residual.val.size > 0
    assert_same(lane_plan_from_jax(j_lane.build_lane_plan(jtm)), tplan)
