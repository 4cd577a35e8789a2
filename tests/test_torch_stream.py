"""The plain PyTorch stream-class versions against tilespmv_tpu's Pallas
stream kernel in interpret mode, on identical slabs (mono, dual-span,
wide-span, free-placement and the two halves of a split class), plus
both against the exact scatter-add golden: the planes' form
(stream_reference, stream2.cu's plain version) and the per-entry rows'
form (stream_rows_reference, stream.cu's), which also agree with each
other.

Tolerance: max |torch - jax| <= 1e-5 * max(1, max|y|) (different f32
summation order)."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tilespmv_tpu.ops.pallas import kernels as jk
from tilespmv_tpu.ops.pallas import stream_plan as jsp
from tilespmv_tpu_torch.interop import stream_chunks_from_jax
from tilespmv_tpu_torch.ops.cuda import reference as ref

TOL = 1e-5


def _entries(seed, m, n, nnz, heavy_rows=0):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, m, nnz).astype(np.int64)
    col = rng.integers(0, n, nnz).astype(np.int64)
    if heavy_rows:
        row[: nnz // 3] = rng.integers(0, heavy_rows, nnz // 3)
    _, ix = np.unique(row * n + col, return_index=True)
    return row[ix], col[ix], rng.standard_normal(ix.size), m, n


def _skewed(seed=7, n_windows=24):
    rng = np.random.default_rng(seed)
    m = n = n_windows * 1024
    rows, cols = [], []
    for w in range(n_windows):
        k = 40000 if w < 2 else 8
        rows.append(rng.integers(w * 1024, (w + 1) * 1024, k))
        cols.append(rng.integers(0, n if w < 2 else 8192, k))
    key = np.unique(np.concatenate(rows).astype(np.int64) * n
                    + np.concatenate(cols))
    return key // n, key % n, rng.standard_normal(key.size), m, n


def _torch_class(st):
    tst = stream_chunks_from_jax(st)
    return dataclasses.replace(tst, **{
        f.name: torch.tensor(getattr(tst, f.name))
        for f in dataclasses.fields(tst)
        if f.type == "Any" and getattr(tst, f.name) is not None})


def _compare(st, row, col, val, m, n, seed=0, fn=ref.stream_reference):
    """Run one class both ways (`fn` the torch side); check agreement on
    the class's windows and against the golden there; returns the torch
    y and padded x."""
    x = np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)
    rows = -(-n // 128) + jsp.MAX_SPAN_ROWS
    rows = -(-rows // jsp.SPAN_ROWS) * jsp.SPAN_ROWS
    xpad = np.zeros(rows * 128, np.float32)
    xpad[:n] = x
    nw = max(1, -(-m // 1024))
    yj = np.asarray(jk.stream_class_call(
        st, jnp.asarray(xpad.reshape(-1, 128)), nw, interpret=True))
    yj = yj.reshape(8, nw, 128).transpose(1, 0, 2).reshape(-1)
    yt = torch.zeros(nw * 1024)
    fn(_torch_class(st), torch.from_numpy(xpad), yt)
    yt = yt.numpy()
    mine = np.zeros(nw, bool)
    mine[np.asarray(st.cw)] = True
    rows_mine = np.repeat(mine, 1024)
    err = float(np.max(np.abs(yt - yj)[rows_mine]))
    assert err <= TOL * max(1.0, float(np.max(np.abs(yj[rows_mine]))))
    sel = rows_mine[row]
    got_rows = np.zeros(nw * 1024)
    got_rows[rows_mine] = yt[rows_mine]
    gold = np.zeros(nw * 1024)
    np.add.at(gold, row[sel], val[sel] * x[col[sel]].astype(np.float64))
    assert np.max(np.abs(got_rows - gold) / (1 + np.abs(gold))) < 1e-4
    return yt, xpad


CASES = {
    "mono_hub_rows": (lambda: _entries(4, 4096, 4096, 30000, heavy_rows=3),
                      dict(span_rows=64, dual=False)),
    "dual": (lambda: _entries(11, 16384, 16384, 100_000),
             dict(span_rows=64, dual=True)),
    "wide_span": (lambda: _entries(3, 65536, 65536, 20000),
                  dict(span_rows=256, dual=False)),
    "free_placement": (lambda: _entries(5, 65536, 65536, 4000),
                       dict(fp=True)),
    "nonmultiple_shape": (lambda: _entries(3, 1000, 3000, 20000), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_reference_matches_interpret(case):
    make, kw = CASES[case]
    row, col, val, m, n = make()
    st, _ = jsp.build_stream_chunks(row, col, val, m, **kw)
    _compare(st, row, col, val, m, n)


@pytest.mark.parametrize("dual", [False, True])
def test_split_stream_halves_match_interpret(dual):
    row, col, val, m, n = _skewed()
    (base, heavy), _ = jsp.build_stream_classes(row, col, val, m,
                                                span_rows=64, dual=dual)
    assert heavy is not None
    for st in (base, heavy):
        _compare(st, row, col, val, m, n)


def _rows_compare(st, row, col, val, m, n):
    """stream_rows_reference against the interpret kernel, the golden
    and stream_reference."""
    yr, xpad = _compare(st, row, col, val, m, n,
                        fn=ref.stream_rows_reference)
    yp = torch.zeros(yr.shape[0])
    ref.stream_reference(_torch_class(st), torch.from_numpy(xpad), yp)
    yp = yp.numpy()
    assert np.max(np.abs(yr - yp)) <= TOL * max(1.0, np.max(np.abs(yp)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_rows_reference_matches_interpret(case):
    make, kw = CASES[case]
    row, col, val, m, n = make()
    st, _ = jsp.build_stream_chunks(row, col, val, m, **kw)
    _rows_compare(st, row, col, val, m, n)


@pytest.mark.parametrize("dual", [False, True])
def test_split_stream_halves_rows_reference_match_interpret(dual):
    row, col, val, m, n = _skewed()
    (base, heavy), _ = jsp.build_stream_classes(row, col, val, m,
                                                span_rows=64, dual=dual)
    for st in (base, heavy):
        _rows_compare(st, row, col, val, m, n)
