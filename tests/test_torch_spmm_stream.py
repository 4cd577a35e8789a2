"""The plain PyTorch stream SpMM versions against tilespmv_tpu's fused
2-RHS Pallas stream kernel (stream_class_call2) in interpret mode, on
identical slabs: tests/test_torch_stream.py's mono, dual-span,
wide-span and free-placement classes and the two halves of a split
dual-span class. Each case takes a seeded (n, k) X, k in {2, 5, 16}:
stream_rows_reference over all k columns in one call (stream2.cu's
plain version) and stream2_reference (the planes' form) on every RHS
pair (r, r+1) are held against the interpret pair kernel, an odd k's
last column against the interpret SpMV kernel, and every column against
the exact scatter-add golden.

Tolerance: max |torch - jax| <= 1e-5 * max(1, max|y|) (different f32
summation order)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tilespmv_tpu.ops.pallas import kernels as jk
from tilespmv_tpu.ops.pallas import stream_plan as jsp
from tilespmv_tpu_torch.ops.cuda import reference as ref
from test_torch_stream import CASES, TOL, _skewed, _torch_class


def _window_rows(yj, nw):
    """A Pallas stream output (8, nw*128) as flat y rows."""
    return np.asarray(yj).reshape(8, nw, 128).transpose(1, 0, 2).reshape(-1)


def _compare_all(st, row, col, val, m, n, k, seed=0):
    """Run one class on a seeded (n, k) X both ways; check agreement on
    the class's windows, pair by pair and column by column, and every
    column against the golden there."""
    x = np.random.default_rng(seed).uniform(-1, 1, (n, k)).astype(
        np.float32)
    rows = -(-n // 128) + jsp.MAX_SPAN_ROWS
    rows = -(-rows // jsp.SPAN_ROWS) * jsp.SPAN_ROWS
    xpad = np.zeros((rows * 128, k), np.float32)
    xpad[:n] = x
    nw = max(1, -(-m // 1024))
    tst, xt = _torch_class(st), torch.from_numpy(xpad)
    yt = ref.stream_rows_reference(tst, xt, torch.zeros(nw * 1024, k))
    yt = yt.numpy()
    mine = np.zeros(nw, bool)
    mine[np.asarray(st.cw)] = True
    rows_mine = np.repeat(mine, 1024)
    want = np.zeros((nw * 1024, k), np.float32)
    for r in range(0, k - 1, 2):
        pair = jk.stream_class_call2(
            st, jnp.asarray(xpad[:, r].reshape(-1, 128)),
            jnp.asarray(xpad[:, r + 1].reshape(-1, 128)), nw,
            interpret=True)
        yp = ref.stream2_reference(tst, xt, torch.zeros(nw * 1024, k), r)
        yp = yp.numpy()
        others = [c for c in range(k) if c not in (r, r + 1)]
        assert not yp[:, others].any()
        for c, yj in zip((r, r + 1), pair):
            want[:, c] = _window_rows(yj, nw)
            err = float(np.max(np.abs(yp[:, c] - want[:, c])[rows_mine]))
            assert err <= TOL * max(1.0, float(np.max(np.abs(
                want[rows_mine, c]))))
    if k % 2:
        want[:, k - 1] = _window_rows(jk.stream_class_call(
            st, jnp.asarray(xpad[:, k - 1].reshape(-1, 128)), nw,
            interpret=True), nw)
    sel = rows_mine[row]
    for c in range(k):
        err = float(np.max(np.abs(yt[:, c] - want[:, c])[rows_mine]))
        assert err <= TOL * max(1.0, float(np.max(np.abs(
            want[rows_mine, c])))), c
        got = np.where(rows_mine, yt[:, c], 0.0)
        gold = np.zeros(nw * 1024)
        np.add.at(gold, row[sel],
                  val[sel] * x[col[sel], c].astype(np.float64))
        assert np.max(np.abs(got - gold) / (1 + np.abs(gold))) < 1e-4


# case -> k: every k of {2, 5, 16}, each with all its RHS pairs (a JAX
# interpret call costs 1-3 s a pair)
PAIRS = {"mono_hub_rows": 2, "dual": 5, "wide_span": 16,
         "free_placement": 5}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_stream2_reference_matches_interpret(case):
    make, kw = CASES[case]
    row, col, val, m, n = make()
    st, _ = jsp.build_stream_chunks(row, col, val, m, **kw)
    _compare_all(st, row, col, val, m, n, PAIRS[case])


def test_split_stream2_halves_match_interpret():
    # dual spans: the mono split differs from the mono case only in its
    # window set, which the heavy half here exercises as well
    row, col, val, m, n = _skewed()
    (base, heavy), _ = jsp.build_stream_classes(row, col, val, m,
                                                span_rows=64, dual=True)
    assert heavy is not None
    for st in (base, heavy):
        _compare_all(st, row, col, val, m, n, 5, seed=1)
