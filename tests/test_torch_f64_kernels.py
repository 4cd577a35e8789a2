"""Each plain PyTorch class version in float64 (the plain versions of
the f64 band, dense and stream kernels; the stream class in both its
planes' and its per-entry rows' form) against tilespmv_tpu's Pallas
df64 arm in interpret mode, on the identical f64 plan (carried across by
lane_plan_from_jax).

Tolerance: max |torch - jax| / (1 + |A|·|x|) <= 1e-10, the bound of
tests/test_dtypes.py: the band and stream interpret arms compute exact
f64, the dense one still emulates double with f32 pairs (~1e-11)."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tilespmv_tpu.core.convert import tile_create
from tilespmv_tpu.io import generate
from tilespmv_tpu.ops.pallas import kernels as jk
from tilespmv_tpu.ops.pallas import stream_plan as jsp
from tilespmv_tpu.ops.pallas.lane_plan import build_lane_plan
from tilespmv_tpu_torch.interop import (lane_plan_from_jax,
                                        stream_chunks_from_jax)
from tilespmv_tpu_torch.ops.cuda import reference as ref
from tilespmv_tpu_torch.ops.cuda.lane_plan import map_arrays

from test_torch_stream import _skewed

TOL = 1e-10

MATRICES = {
    "band_c3": lambda: generate.banded(2048, 2048, 8, seed=3),
    "band_c1": lambda: generate.dense_blocks(1024, 1024, num_blocks=24,
                                             seed=5),
    "dense_t128": lambda: generate.mixed_structure(512, 512, seed=7),
    "dense_t256": lambda: generate.mixed_structure(4096, 4096, seed=1),
    "stream_mono": lambda: generate.power_law(4096, 4096, 12, seed=3),
}


def plans(csr):
    jplan = build_lane_plan(tile_create(csr), compute_dtype=jnp.float64)
    return jplan, ref.to_torch(lane_plan_from_jax(jplan))


def magnitude(rows, cols, vals, x, m):
    """|A|·|x| per row, from the entries."""
    return np.bincount(rows, weights=np.abs(vals * x[cols]), minlength=m)


def csr_magnitude(csr, x):
    rows = np.repeat(np.arange(csr.m), np.diff(csr.indptr))
    return magnitude(rows, csr.indices, csr.data, x, csr.m)


def close(got, want, mag):
    n = mag.shape[0]
    err = np.abs(got[:n] - want[:n]) / (1.0 + mag)
    assert float(err.max()) <= TOL, float(err.max())
    assert not np.any(got[n:]) and not np.any(want[n:])


def pair_flat(pair, length):
    """(hi, lo) pair of (16, n_windows*256) class outputs -> flat f64 y
    rows."""
    y2dt = np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)
    flat = y2dt.T.reshape(-1)
    out = np.zeros(length)
    out[: flat.size] = flat
    return out


def y_len(plan):
    return max(plan.y_padded_len, plan.n_stream_windows * 1024)


def run_torch(fn, cls, tplan, x):
    xp = ref.pad_x(tplan, torch.from_numpy(x))
    assert xp.dtype == torch.float64
    y = torch.zeros(y_len(tplan), dtype=torch.float64)
    fn(cls, xp, y)
    return y.numpy()


def x_for(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, n)


@pytest.mark.parametrize("name", ["band_c3", "band_c1"])
def test_f64_band_reference_matches_df64_interpret(name):
    csr = MATRICES[name]()
    jplan, tplan = plans(csr)
    assert jplan.band.df64 and tplan.band.val.dtype == torch.float64
    x = x_for(csr.n)
    want = pair_flat(jk.band_class_call(
        jplan.band, jk.x_to_panels(jplan, jnp.asarray(x)), jplan.n_windows,
        interpret=True), y_len(tplan))
    close(run_torch(ref.band_reference, tplan.band, tplan, x), want,
          csr_magnitude(csr, x))


@pytest.mark.parametrize("name", ["dense_t128", "dense_t256"])
def test_f64_dense_reference_matches_df64_interpret(name):
    csr = MATRICES[name]()
    jplan, tplan = plans(csr)
    assert jplan.dense.df64 and tplan.dense.val.dtype == torch.float64
    x = x_for(csr.n, seed=1)
    want = pair_flat(jk.dense_class_call(
        jplan.dense, jk.x_to_panels(jplan, jnp.asarray(x)),
        jplan.n_windows, interpret=True), y_len(tplan))
    close(run_torch(ref.dense_reference, tplan.dense, tplan, x), want,
          csr_magnitude(csr, x))


@pytest.mark.parametrize("name", ["dense_t128", "dense_t256"])
def test_f64_dense_active_reference_matches(name):
    """dense.cu's walk (the active lane groups, each tile's nonzero
    columns) against the df64 interpret arm (TOL) and against
    dense_reference within 1e-12 * max(1, max|y|) (the same f64
    products, added in another order)."""
    csr = MATRICES[name]()
    jplan, tplan = plans(csr)
    x = x_for(csr.n, seed=2)
    want = pair_flat(jk.dense_class_call(
        jplan.dense, jk.x_to_panels(jplan, jnp.asarray(x)),
        jplan.n_windows, interpret=True), y_len(tplan))
    got = run_torch(ref.dense_active_reference, tplan.dense, tplan, x)
    close(got, want, csr_magnitude(csr, x))
    plain = run_torch(ref.dense_reference, tplan.dense, tplan, x)
    assert np.max(np.abs(got - plain)) <= 1e-12 * max(
        1.0, float(np.max(np.abs(plain))))


def torch_class(st):
    """A NumPy stream class with its arrays as CPU tensors."""
    return dataclasses.replace(st, **{
        f.name: torch.tensor(getattr(st, f.name))
        for f in dataclasses.fields(st)
        if f.type == "Any" and getattr(st, f.name) is not None})


def _stream_compare(jst, n, m, mag, seed=0, fn=ref.stream_reference):
    """One df64 stream class both ways (`fn` the torch side), on the
    class's windows."""
    x = x_for(n, seed)
    rows = -(-n // 128) + jsp.MAX_SPAN_ROWS
    rows = -(-rows // jsp.SPAN_ROWS) * jsp.SPAN_ROWS
    xpad = np.zeros(rows * 128)
    xpad[:n] = x
    nw = max(1, -(-m // 1024))
    hi, lo = jk.stream_class_call(jst, jnp.asarray(xpad.reshape(-1, 128)),
                                  nw, interpret=True)
    yj = (np.asarray(hi, np.float64) + np.asarray(lo, np.float64))
    yj = yj.reshape(8, nw, 128).transpose(1, 0, 2).reshape(-1)
    tst = torch_class(stream_chunks_from_jax(jst))
    assert tst.val.dtype == torch.float64
    yt = torch.zeros(nw * 1024, dtype=torch.float64)
    fn(tst, torch.from_numpy(xpad), yt)
    mine = np.zeros(nw, bool)
    mine[np.asarray(jst.cw)] = True
    sel = np.repeat(mine, 1024)[:m]
    err = np.abs(yt.numpy()[:m] - yj[:m]) / (1.0 + mag(x))
    assert float(err[sel].max()) <= TOL, float(err[sel].max())


@pytest.mark.parametrize("name", ["stream_mono", "dense_t128"])
def test_f64_stream_reference_matches_df64_interpret(name):
    csr = MATRICES[name]()
    jplan, _ = plans(csr)
    assert jplan.stream is not None and jplan.stream.df64
    if name == "dense_t128":
        assert jplan.stream.xmap is not None     # free placement
    for st in (jplan.stream, jplan.stream2):
        if st is not None:
            _stream_compare(st, csr.n, csr.m,
                            lambda x: csr_magnitude(csr, x))


@pytest.mark.parametrize("dual", [False, True])
def test_f64_split_stream_halves_match_df64_interpret(dual):
    row, col, val, m, n = _skewed()
    (base, heavy), _ = jsp.build_stream_classes(
        row, col, val, m, compute_dtype=jnp.float64, span_rows=64,
        dual=dual)
    assert heavy is not None and base.df64 and heavy.df64
    for st in (base, heavy):
        _stream_compare(st, n, m, lambda x: magnitude(row, col, val, x, m))


@pytest.mark.parametrize("name", ["stream_mono", "dense_t128"])
def test_f64_stream_rows_reference_matches_df64_interpret(name):
    csr = MATRICES[name]()
    jplan, _ = plans(csr)
    for st in (jplan.stream, jplan.stream2):
        if st is not None:
            _stream_compare(st, csr.n, csr.m,
                            lambda x: csr_magnitude(csr, x),
                            fn=ref.stream_rows_reference)


@pytest.mark.parametrize("dual", [False, True])
def test_f64_split_stream_halves_rows_match_df64_interpret(dual):
    row, col, val, m, n = _skewed()
    (base, heavy), _ = jsp.build_stream_classes(
        row, col, val, m, compute_dtype=jnp.float64, span_rows=64,
        dual=dual)
    for st in (base, heavy):
        _stream_compare(st, n, m, lambda x: magnitude(row, col, val, x, m),
                        fn=ref.stream_rows_reference)


def test_f64_plan_moves_to_torch_in_float64():
    jplan, tplan = plans(MATRICES["dense_t128"]())
    assert tplan.dtype == torch.float64
    names = []
    map_arrays(tplan, lambda name, a: names.append((name, a.dtype)))
    vals = {n: d for n, d in names if n.endswith("_val")}
    assert vals and all(d == torch.float64 for d in vals.values())
